#!/usr/bin/env python3
"""Expert parallelism across cards: the serving engine at ep = 1, 2 and 4
(the ragged and the dense all-to-all), timed, its tokens held to ep 1's.

    python3 scripts/time_ep_torch.py [OUT.json]        # 4 cards (NCCL)
    python3 scripts/time_ep_torch.py --cpu [OUT.json]  # tiny-moe, gloo

Rank ``r`` runs on ``cuda:{r % device_count}``: with a card a rank the
ranks talk over NCCL (``parallel/mesh.backend_for``).  The model is
Qwen3-30B-A3B W4A8 with INT4 groups of 256 at its 48 layers, drawn from a
seeded generator on each card: every rank and the ep = 1 run hold the
same params.  Traffic: 32 requests of 512 random tokens on 32 slots, 32
new tokens each, greedy, EOS off, pages of 512, prefill pieces of 256
(an interior and a last piece a prompt).  Each (ep, form): a warm-up run
of 4 requests, then the 32 (TTFT p50 and decode tok/s from the engine's
metrics, the host clock around work that ends in a device sync); then a
first decode tick of the 32 slots after every prompt's prefill, with the
``all_to_all`` and ``all_gather`` calls and the bytes this rank sent in
that tick, and its logits.  Tokens are held to ep 1's on the near-tie
rule: where a request's tokens part, the ep 1 logit gap between the two
candidates there (one prefill of the prompt and the common tokens) must
be below twice the ep 1 W4A8 vs W4A16 distance of the first tick's
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
PROMPT = 512
REQUESTS = 32
FORMS = {"ragged": True, "dense": False}


def _model(torch, device, cpu):
    from qwen_inference_engine_tpu_torch.config import PRESETS, tiny_config
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = (tiny_config(vocab_size=512, qk_norm=True, num_experts=8,
                       num_experts_per_tok=2, moe_intermediate_size=64)
           if cpu else PRESETS["qwen3-30b-a3b"])
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_quantized_params(cfg, gen, bits=4,
                                   group_size=32 if cpu else 256,
                                   dtype=torch.float32 if cpu
                                   else torch.bfloat16, device=device)
    return cfg.replace(act_bits=8), params


def _prompts(cfg, cpu):
    import numpy as np

    rng = np.random.default_rng(3)
    n, length = (8, 24) if cpu else (REQUESTS, PROMPT)
    return [rng.integers(0, cfg.vocab_size, size=length).tolist()
            for _ in range(n)]


def _engine(torch, cfg, params, mesh, device, cpu, slots):
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    page, chunk = (8, 8) if cpu else (512, 256)
    per_seq = -(-(PROMPT + NEW) // page) if not cpu else 8
    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=slots, page_size=page,
        num_pages=slots * per_seq + 1, max_pages_per_seq=per_seq,
        prefill_chunk=chunk, prefix_cache=False,
        sampling=SamplingParams(greedy=True),
        kv_dtype=torch.float32 if cpu else torch.bfloat16, device=device)
    cb._eos = set()    # random weights can argmax onto EOS
    return cb


def _serve(torch, cb, prompts):
    """``prompts`` drained: (tokens by request, metrics snapshot)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import Request

    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=NEW))
    done = cb.run_to_completion(sync_every=8)
    if cb.device.type == "cuda":
        torch.cuda.synchronize()
    return {f.request_id: f.token_ids for f in done}, cb.metrics.snapshot()


def _first_tick(torch, cb, prompts):
    """One decode tick of every slot after every prompt's prefill: its
    logits [slots, V] on the host and the collectives it made (calls and
    bytes this rank sent)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import Request
    from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh

    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=NEW))
    with torch.inference_mode():
        while cb._try_admit():
            pass
        for run in cb._slots:
            while run is not None and not run.prefill_done:
                cb._prefill_tick(run)
        cb._load_tick([s for s in cb._slots if s is not None])
        coll = (pmesh.all_to_all, pmesh.all_gather)
        before = [(c.launches, c.sent_bytes) for c in coll]
        t = cb._tick
        logits, _ = cb._decode_fn(cb.params, t.tok, t.pos, cb.cache,
                                  t.tables)
        logits = logits.float().cpu()
    tick = {c.__name__: dict(calls=c.launches - b[0],
                             sent_bytes=c.sent_bytes - b[1])
            for c, b in zip(coll, before)}
    return logits, tick


def _run(torch, cfg, params, mesh, device, cpu, prompts):
    """Warm-up, the timed run and the first tick on this rank."""
    slots = len(prompts)
    _serve(torch, _engine(torch, cfg, params, mesh, device, cpu, slots),
           prompts[:4])
    t0 = time.perf_counter()
    toks, snap = _serve(torch, _engine(torch, cfg, params, mesh, device, cpu,
                                       slots), prompts)
    wall = time.perf_counter() - t0
    logits, tick = _first_tick(
        torch, _engine(torch, cfg, params, mesh, device, cpu, slots), prompts)
    return dict(tokens=toks, wall_s=wall, ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
                decode_tok_s=snap["decode_tokens_per_s"], tick=tick,
                logits=logits)


def _rank(rank, world, cpu):
    import torch

    from qwen_inference_engine_tpu_torch.parallel.mesh import make_ep_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if cpu else torch.device("cuda",
                                            torch.cuda.current_device())
    cfg, params = _model(torch, device, cpu)
    prompts = _prompts(cfg, cpu)
    out = {}
    for form, ragged in FORMS.items():
        mesh = make_ep_mesh(ragged=ragged)
        out[form] = _run(torch, cfg, params, mesh, device, cpu, prompts)
        out[form]["backend"] = mesh.ep_group.backend
    return out


def _gap(torch, cfg, params, device, prompt, a, b):
    """The ep 1 logit gap logit[a] - logit[b] after ``prompt`` (one
    prefill)."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models.qwen import prefill_chunked

    T = len(prompt)
    cache = KVCache.create(cfg.num_layers, 1, -(-T // 512) * 512,
                           cfg.num_kv_heads, cfg.head_dim,
                           dtype=params["embed"].dtype, device=device)
    with torch.inference_mode():
        logits, _ = prefill_chunked(
            params, cfg, torch.tensor([prompt], device=device),
            torch.tensor([T], device=device), cache, chunk=512)
    return (logits[0, a] - logits[0, b]).item()


def main() -> int:
    import torch

    from qwen_inference_engine_tpu_torch.parallel.mesh import spawn

    cpu = "--cpu" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("time_ep_torch: no CUDA device", file=sys.stderr)
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
    prompts = _prompts(cfg, cpu)
    one = _run(torch, cfg, params, None, device, cpu, prompts)
    tick16, _ = _first_tick(
        torch, _engine(torch, cfg.replace(act_bits=0), params, None, device,
                       cpu, len(prompts)), prompts)
    bound = 2 * float((one["logits"] - tick16).abs().max())
    record = {"card": card, "bound": bound, "runs": {"ep1": {
        k: v for k, v in one.items() if k not in ("tokens", "logits")}}}
    print(f"[ep 1] {json.dumps(record['runs']['ep1'])}", flush=True)
    for ep in (2, 4):
        ranks = spawn(_rank, ep, device_type="cpu" if cpu else "cuda",
                      args=(cpu,))
        for form in FORMS:
            per = [r[form] for r in ranks]
            same, ties = 0, []
            for rid, want in one["tokens"].items():
                got = per[0]["tokens"][rid]
                i = next((j for j, (x, y) in enumerate(zip(got, want))
                          if x != y), None)
                if i is None:
                    same += len(want)
                    continue
                same += i
                ties.append(dict(request=rid, position=i, gap=_gap(
                    torch, cfg, params, device, prompts[rid] + want[:i],
                    want[i], got[i])))
            numbers = dict(
                backend=per[0]["backend"], wall_s=per[0]["wall_s"],
                ttft_p50_ms=per[0]["ttft_p50_ms"],
                decode_tok_s=per[0]["decode_tok_s"],
                tick_collectives_rank0=per[0]["tick"],
                first_tick_max_abs_diff=float(
                    (per[0]["logits"] - one["logits"]).abs().max()),
                ranks_equal=all(p["tokens"] == per[0]["tokens"]
                                for p in per),
                tokens_equal_ep1=f"{same}/{NEW * len(prompts)}",
                near_ties=ties,
                near_tie_rule=all(abs(t["gap"]) < bound for t in ties))
            record["runs"][f"ep{ep} {form}"] = numbers
            print(f"[ep {ep} {form}] {json.dumps(numbers)}", flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(record, f, indent=1)
    bad = [k for k, v in record["runs"].items()
           if k != "ep1" and not (v["ranks_equal"] and v["near_tie_rule"])]
    if bad:
        print(f"time_ep_torch: ranks differ or a token parts off a near-tie: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
