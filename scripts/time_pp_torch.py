#!/usr/bin/env python3
"""Pipeline parallelism across cards: the pipeline's prefill and 1F1B
decode at pp = 1, 2 and 4, timed, their tokens held to pp 1's.

    python3 scripts/time_pp_torch.py [OUT.json]        # 4 cards (NCCL)
    python3 scripts/time_pp_torch.py --cpu [OUT.json]  # a tiny model, gloo

Rank ``r`` runs on ``cuda:{r % device_count}``: with a card a rank the
stages pass the stream over NCCL point-to-point
(``parallel/mesh.ring_exchange``).  The model is Qwen2.5-7B W4A8 with INT4
groups of 64 at its 28 layers, drawn from a seeded generator on each card:
every rank and the pp = 1 run hold the same params, and each stage keeps
its 28 / pp layers (``parallel/pp_step.shard_for_pp``).  pp = 1 runs the
same functions over a mesh of one stage.  Traffic: a batch of 8 aligned
prompts of 512 random tokens, one prefill (``make_pp_forward_fn``; TTFT
by the host clock around it, ending in a device sync), then the 1F1B
decode (``make_pp_decode_1f1b``, zero-copy, 8 / pp rows a microbatch) of
32 greedy steps (decode tok/s: 8 x 32 tokens over its wall time), each
after a warm-up of the same shapes.  Per run: the bytes this rank's ring
exchanges sent a tick, the resident bytes of its weights and cache, and
the tokens against pp 1's on the near-tie rule (where a row parts, the
pp 1 logit gap between the two candidates, one prefill of the prompt and
the common tokens, must be below twice the pp 1 W4A8 vs W4A16 distance of
the prefill's logits).  Prints one line a run (with the cards' name and
power limit) and writes the numbers as JSON to OUT.json when given.  The
steps run eagerly (``PpMesh.capturable`` is false).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH = 8
PROMPT = 512
STEPS = 32


def _model(torch, device, cpu):
    from qwen_inference_engine_tpu_torch.config import PRESETS, tiny_config
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = (tiny_config(num_layers=4, vocab_size=512) if cpu
           else PRESETS["qwen2.5-7b"])
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_quantized_params(cfg, gen, bits=4,
                                   group_size=32 if cpu else 64,
                                   dtype=torch.float32 if cpu
                                   else torch.bfloat16, device=device)
    return cfg.replace(act_bits=8), params


def _prompts(cfg, cpu):
    import numpy as np

    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab_size,
                        size=(BATCH, 16 if cpu else PROMPT)).tolist()


def _bytes(tree) -> int:
    from qwen_inference_engine_tpu_torch.models.qwen import map_params

    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t

    map_params(tree, add)
    return total[0]


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run(torch, cfg, params, mesh, device, prompts, steps=STEPS):
    """This stage's share of one pp run: (numbers, tokens [B, steps + 1],
    the prefill's logits)."""
    from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh
    from qwen_inference_engine_tpu_torch.parallel import pp_step

    params_l, _ = pp_step.shard_for_pp(params, None, mesh)
    del params
    S = mesh.stages
    B, T = len(prompts), len(prompts[0])
    toks = torch.tensor(prompts, device=device)
    pos = torch.arange(T, device=device)[None].expand(B, T)
    lens = torch.full((B,), T, device=device)
    pre = pp_step.make_pp_forward_fn(cfg, mesh)

    kv = (torch.float32 if torch.device(device).type == "cpu"
          else torch.bfloat16)

    def cache():
        return pp_step.pp_cache(cfg, mesh, B, T + steps + 1, dtype=kv,
                                device=device)

    out = {}
    for phase in ("warm-up", "timed"):
        n = 2 if phase == "warm-up" else steps
        c = cache()
        _sync(torch, device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, c = pre(params_l, toks, pos, lens, c)
        first = torch.argmax(logits, dim=-1)
        _sync(torch, device)
        ttft = time.perf_counter() - t0
        fn = pp_step.make_pp_decode_1f1b(cfg, mesh, microbatch_rows=B // S,
                                         steps=n, zero_copy_cache=True)
        sent = pmesh.ring_exchange.sent_bytes
        _sync(torch, device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ys, c = fn(params_l, first.reshape(S, B // S), [T] * S, c)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        ticks = S + n * S
        out = dict(ttft_ms=ttft * 1e3, decode_tok_s=B * n / wall,
                   decode_wall_s=wall, ticks=ticks,
                   ring_bytes_a_tick=(pmesh.ring_exchange.sent_bytes - sent)
                   / max(ticks - 1, 1),
                   weight_bytes=_bytes(params_l),
                   cache_bytes=_bytes({"k": c.k, "v": c.v}),
                   backend=mesh.backend)
    tokens = torch.cat([first[:, None], ys.reshape(n, B).T], dim=1)
    return out, tokens.cpu().tolist(), logits.float().cpu()


def _rank(rank, world, cpu):
    import torch

    from qwen_inference_engine_tpu_torch.parallel.mesh import make_pp_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if cpu else torch.device("cuda",
                                            torch.cuda.current_device())
    cfg, params = _model(torch, device, cpu)
    mesh = make_pp_mesh(world)
    numbers, tokens, _ = _run(torch, cfg, params, mesh, device,
                              _prompts(cfg, cpu))
    if not cpu:
        numbers["memory_allocated"] = torch.cuda.memory_allocated()
    return numbers, tokens


def _gap(torch, cfg, params, device, prompt, a, b):
    """The pp 1 logit gap logit[a] - logit[b] after ``prompt`` (one
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

    from qwen_inference_engine_tpu_torch.parallel.mesh import (
        make_pp_mesh,
        spawn,
    )

    cpu = "--cpu" in sys.argv
    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    if not cpu and not torch.cuda.is_available():
        print("time_pp_torch: no CUDA device", file=sys.stderr)
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
    one, one_toks, logits8 = _run(torch, cfg, params, make_pp_mesh(1),
                                  device, prompts)
    _, _, logits16 = _run(torch, cfg.replace(act_bits=0), params,
                          make_pp_mesh(1), device, prompts, steps=1)
    bound = 2 * float((logits8 - logits16).abs().max())
    record = {"card": card, "bound": bound, "model": f"{cfg.name} W4A8",
              "batch": BATCH, "prompt": len(prompts[0]), "steps": STEPS,
              "runs": {"pp1": one}}
    print(f"[pp 1] {json.dumps(one)}", flush=True)
    for pp in (2, 4):
        ranks = spawn(_rank, pp, device_type="cpu" if cpu else "cuda",
                      args=(cpu,))
        toks = [t for _, t in ranks]
        same, ties = 0, []
        for rid, want in enumerate(one_toks):
            got = toks[0][rid]
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
            stages=[n for n, _ in ranks],
            ranks_equal=all(t == toks[0] for t in toks),
            tokens_equal_pp1=f"{same}/{len(one_toks) * (STEPS + 1)}",
            near_ties=ties,
            near_tie_rule=all(abs(t["gap"]) < bound for t in ties))
        record["runs"][f"pp{pp}"] = numbers
        print(f"[pp {pp}] {json.dumps(numbers)}", flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(record, f, indent=1)
    bad = [k for k, v in record["runs"].items()
           if k != "pp1" and not (v["ranks_equal"] and v["near_tie_rule"])]
    if bad:
        print(f"time_pp_torch: ranks differ or a token parts off a near-tie: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
