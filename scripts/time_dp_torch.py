#!/usr/bin/env python3
"""Serving over a data axis across cards: the serving engine at dp = 1, 2
and 4 (a ``(dp, 1)`` mesh, 8 slots a data group), timed, its tokens held
to dp 1's.

    python3 scripts/time_dp_torch.py [OUT.json]        # 4 cards (NCCL)
    python3 scripts/time_dp_torch.py --cpu [OUT.json]  # tiny model, gloo

Rank ``r`` runs on ``cuda:{r % device_count}``: with a card a rank the
ranks talk over NCCL (``parallel/mesh.backend_for``), and the decode tick,
its logits gather over the data axis included, is captured as a CUDA
graph (``Mesh.capturable``; ``engine/step_graph.py``).  The model is
Qwen2.5-7B W4A8 with INT4 groups of 64 at its 28 layers, drawn from a
seeded generator on each card: every rank and the dp = 1 run hold the
same params.  Traffic at dp = d: 8 d requests of 512 random tokens on
8 d slots, greedy, EOS off, pages of 512, prefill pieces of 256, prefix
cache on (no prompt shares a page).  Each dp: a warm-up run of 2 d
requests; then, ``REPEATS`` times, (a) the 8 d requests served from
submission with 32 new tokens each (TTFT p50, and the engine's decode
tok/s, whose windows also hold the prefill pieces that run beside the
ticks: "tokens/s over mixed windows"), and (b) the 8 d requests
prefilled first, untimed, then their ``DECODE_NEW`` new tokens decoded
and timed alone (decode-only tok/s: every window a decode window); the
host clock around work that ends in a device sync, per card = the rate
over d; then, from the state one decode tick leaves, the captured tick
against the eager one (the sampled tokens and the pool's bytes bit for
bit).  Tokens of (a) are held to dp 1's on the same traffic by the
near-tie rule: where a request's tokens part, the dp 1 run's own top-two
logit margin at the first differing token (recorded by a step-by-step
eager dp 1 run, which must give the timed dp 1 run's tokens) must be
below twice the dp 1 W4A8 vs W4A16 distance of a first decode tick's
logits.  Prints one line a run (with the cards' name and power limit)
and writes the numbers as JSON to OUT.json when given.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NEW = 32
DECODE_NEW = 128   # the decode-only runs' new tokens a request
PROMPT = 512
SLOTS = 8          # a data group's
REPEATS = 2


def _model(torch, device, cpu):
    from qwen_inference_engine_tpu_torch.config import PRESETS, tiny_config
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = tiny_config(vocab_size=512) if cpu else PRESETS["qwen2.5-7b"]
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_quantized_params(cfg, gen, bits=4,
                                   group_size=32 if cpu else 64,
                                   dtype=torch.float32 if cpu
                                   else torch.bfloat16, device=device)
    return cfg.replace(act_bits=8), params


def _prompts(cfg, cpu, n):
    import numpy as np

    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size,
                         size=24 if cpu else PROMPT).tolist()
            for _ in range(n)]


def _engine(torch, cfg, params, mesh, device, cpu, slots):
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    page, chunk = (8, 8) if cpu else (512, 256)
    per_seq = -(-((24 if cpu else PROMPT) + DECODE_NEW) // page)
    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=slots, page_size=page,
        num_pages=slots * per_seq + 1, max_pages_per_seq=per_seq,
        prefill_chunk=chunk, prefix_cache=True,
        sampling=SamplingParams(greedy=True),
        kv_dtype=torch.float32 if cpu else torch.bfloat16, device=device)
    cb._eos = set()    # random weights can argmax onto EOS
    return cb


def _sync(torch, cb):
    if cb.device.type == "cuda":
        torch.cuda.synchronize(cb.device)


def _serve(torch, cb, prompts, margins=None):
    """``prompts`` drained, ``NEW`` tokens each: (tokens by request,
    metrics snapshot).  With ``margins`` (a dict; one rank) the engine
    steps one tick at a time, eager, and records there each token's
    top-two logit margin by request and token index (a chained window
    samples as its ticks one by one, and a replay as its eager step)."""
    import contextlib

    from qwen_inference_engine_tpu_torch.engine import step_graph
    from qwen_inference_engine_tpu_torch.engine.scheduler import Request

    if margins is not None:
        run_piece, last_piece, decode = (cb._run_piece, cb._pieces[True],
                                         cb._decode_fn)
        rid = {}

        def top2(logits):
            top = logits.float().topk(2, dim=-1).values
            return (top[..., 0] - top[..., 1]).cpu()

        def on_piece(run, *a, **k):
            rid["now"] = run.request.request_id
            return run_piece(run, *a, **k)

        def on_last_piece(*a):
            logits = last_piece(*a)
            margins.setdefault(rid["now"], {})[0] = float(top2(logits[0]))
            return logits

        def on_tick(*a):
            logits, cache = decode(*a)
            m = top2(logits)
            for run in cb._slots:
                if run is not None and run.prefill_done:
                    margins.setdefault(run.request.request_id, {})[
                        len(run.generated)] = float(m[run.slot])
            return logits, cache

        cb._run_piece, cb._decode_fn = on_piece, on_tick
        cb._pieces[True] = on_last_piece
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=NEW))
    if margins is None:
        done = cb.run_to_completion(sync_every=8)
    else:
        done = []
        with step_graph.eager_steps():
            while cb.has_work():
                done += cb.step()
    _sync(torch, cb)
    return {f.request_id: f.token_ids for f in done}, cb.metrics.snapshot()


def _decode_only(torch, cb, prompts):
    """Every prompt prefilled (untimed, its first token sampled), then the
    rest of its ``DECODE_NEW`` tokens decoded in chained windows of 8
    ticks, timed alone: (decode tokens, seconds)."""
    _prefilled(torch, cb, prompts, DECODE_NEW)
    first = sum(len(r.generated) for r in cb._slots if r is not None)
    _sync(torch, cb)
    t0 = time.perf_counter()
    done = cb.run_to_completion(sync_every=8)
    _sync(torch, cb)
    return sum(len(f.token_ids) for f in done) - first, \
        time.perf_counter() - t0


def _prefilled(torch, cb, prompts, new=NEW):
    """Every prompt admitted and prefilled, the tick's buffers loaded."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import Request

    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=new))
    with torch.inference_mode():
        while cb._try_admit():
            pass
        for run in cb._slots:
            while run is not None and not run.prefill_done:
                cb._prefill_tick(run)
        cb._load_tick([s for s in cb._slots if s is not None])


def _first_tick_logits(torch, cb, prompts):
    """The logits ``[slots, V]`` of one decode tick after every prompt's
    prefill (one rank, no mesh)."""
    _prefilled(torch, cb, prompts)
    with torch.inference_mode():
        t = cb._tick
        logits, _ = cb._decode_fn(cb.params, t.tok, t.pos, cb.cache,
                                  t.tables)
    return logits.float().cpu()


def _graph_check(torch, cb, prompts):
    """A decode tick replayed from its CUDA graph against the same tick
    eager, from the same state (the tick's buffers, the pool, the seen
    mask, the step count): whether the sampled tokens and the pool's
    bytes are equal, and the graphs captured."""
    from qwen_inference_engine_tpu_torch.engine import step_graph

    _prefilled(torch, cb, prompts)
    t = cb._tick
    state = [t.tok, t.pos, cb._seen, cb.cache.k_pages, cb.cache.v_pages]
    with torch.inference_mode():
        cb._decode_tick()               # the key's first tick: eager
        cb._decode_tick()               # captured
        snap = [x.clone() for x in state]
        count = cb._step_count
        captured = cb._decode_tick()    # a replay
        got = [x.clone() for x in state]
        for dst, src in zip(state, snap):
            dst.copy_(src)
        cb._step_count = count
        with step_graph.eager_steps():
            eager = cb._decode_tick()
        _sync(torch, cb)
        equal = bool(torch.equal(captured, eager)) and all(
            torch.equal(a, b) for a, b in zip(got, state))
    return dict(bit_equal=equal, capture=cb.graphs.capture,
                graphs=cb.graphs.captured)


def _run(torch, cfg, params, mesh, device, cpu, dp):
    """Warm-up, the timed runs and the graph check on this rank."""
    slots = SLOTS * dp
    prompts = _prompts(cfg, cpu, slots)

    def engine():
        if device != "cpu":
            torch.cuda.empty_cache()
        return _engine(torch, cfg, params, mesh, device, cpu, slots)

    _serve(torch, engine(), prompts[:2 * dp])
    reps = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        toks, snap = _serve(torch, engine(), prompts)
        wall = time.perf_counter() - t0
        n, secs = _decode_only(torch, engine(), prompts)
        reps.append(dict(
            wall_s=wall, ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
            mixed_tok_s=snap["decode_tokens_per_s"],
            mixed_tok_s_per_card=snap["decode_tokens_per_s"] / dp,
            decode_only_tokens=n, decode_only_s=secs,
            decode_only_tok_s=n / secs, decode_only_tok_s_per_card=n / secs
            / dp))
    graph = _graph_check(torch, engine(), prompts)
    return dict(tokens=toks, repeats=reps, graph=graph)


def _rank(rank, world, cpu):
    import torch

    from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if cpu else torch.device("cuda",
                                            torch.cuda.current_device())
    cfg, params = _model(torch, device, cpu)
    mesh = pmesh.make_mesh((world, 1))
    before = (pmesh.gather_data.launches, pmesh.gather_data.sent_bytes)
    out = _run(torch, cfg, params, mesh, device, cpu, world)
    out.update(backend=mesh.data_group.backend,
               capturable=mesh.capturable,
               gathers=pmesh.gather_data.launches - before[0],
               gather_bytes=pmesh.gather_data.sent_bytes - before[1])
    return out


def main() -> int:
    import torch

    from qwen_inference_engine_tpu_torch.parallel.mesh import spawn

    cpu = "--cpu" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("time_dp_torch: no CUDA device", file=sys.stderr)
        return 2
    card = "cpu"
    if not cpu:
        from qwen_inference_engine_tpu_torch.ops import cuda_lib

        cuda_lib.build()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = " | ".join(smi.stdout.strip().splitlines())
        print(f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
              f" | {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if cpu else "cuda"
    cfg, params = _model(torch, device, cpu)
    one = _run(torch, cfg, params, None, device, cpu, 1)
    prompts = _prompts(cfg, cpu, SLOTS)
    tick8 = _first_tick_logits(torch, _engine(
        torch, cfg, params, None, device, cpu, SLOTS), prompts)
    tick16 = _first_tick_logits(torch, _engine(
        torch, cfg.replace(act_bits=0), params, None, device, cpu, SLOTS),
        prompts)
    bound = 2 * float((tick8 - tick16).abs().max())
    record = {"card": card, "bound": bound, "runs": {"dp1": {
        k: v for k, v in one.items() if k != "tokens"}}}
    print(f"[dp 1] {json.dumps(record['runs']['dp1'])}", flush=True)
    for dp in (2, 4):
        per = spawn(_rank, dp, device_type="cpu" if cpu else "cuda",
                    args=(cpu,))
        # dp 1 on the same traffic (its first 8 d prompts), chained and
        # step by step with each token's top-two margin
        all_prompts = _prompts(cfg, cpu, SLOTS * dp)
        want = _serve(torch, _engine(torch, cfg, params, None, device, cpu,
                                     SLOTS * dp), all_prompts)[0]
        margins = {}
        stepped = _serve(torch, _engine(torch, cfg, params, None, device,
                                        cpu, SLOTS * dp), all_prompts,
                         margins)[0]
        same, ties = 0, []
        for rid, w in want.items():
            got = per[0]["tokens"][rid]
            i = next((j for j, (x, y) in enumerate(zip(got, w)) if x != y),
                     None)
            if i is None:
                same += len(w)
                continue
            same += i
            ties.append(dict(request=rid, position=i, dp1=w[i], dp=got[i],
                             dp1_margin=margins[rid][i]))
        numbers = dict(
            backend=per[0]["backend"], capturable=per[0]["capturable"],
            repeats=per[0]["repeats"], graph=[p["graph"] for p in per],
            gathers_rank0=per[0]["gathers"],
            gather_bytes_rank0=per[0]["gather_bytes"],
            ranks_equal=all(p["tokens"] == per[0]["tokens"] for p in per),
            dp1_stepped_equal=stepped == want,
            tokens_equal_dp1=f"{same}/{NEW * len(want)}", near_ties=ties,
            near_tie_rule=all(t["dp1_margin"] < bound for t in ties))
        record["runs"][f"dp{dp}"] = numbers
        print(f"[dp {dp}] {json.dumps(numbers)}", flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(record, f, indent=1)
    def held(name, run):
        graphs = [run["graph"]] if name == "dp1" else run["graph"]
        return all(g["bit_equal"] for g in graphs) and (
            name == "dp1" or run["ranks_equal"] and run["near_tie_rule"]
            and run["dp1_stepped_equal"])

    bad = [name for name, run in record["runs"].items()
           if not held(name, run)]
    if bad:
        print(f"time_dp_torch: a captured tick differs from its eager one, "
              f"the ranks differ, dp 1 stepped differs from dp 1 chained or "
              f"a token parts off a near-tie: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
