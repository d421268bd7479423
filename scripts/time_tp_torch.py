#!/usr/bin/env python3
"""Tensor parallelism across cards: greedy ``Engine.generate`` of one model
at tp = 1 and at tp = N, timed, its tokens and first decode step compared.

    python3 scripts/time_tp_torch.py [TP] [OUT.json]          # on the card
    python3 scripts/time_tp_torch.py 2 --cpu                  # a tiny model

Rank ``r`` runs on ``cuda:{r % device_count}``: with a card a rank the
ranks talk over NCCL and the decode steps are captured CUDA graphs; where
ranks share a card they fall back to gloo (``parallel/mesh.backend_for``)
and the steps run eagerly.  The model is Qwen2.5-7B W4A8 with INT4 groups
of 64 (the tp = 4 shards' aligned group size) at its 28 layers, drawn from
a seeded generator on each rank's card: every rank and the tp = 1 run hold
the same params.  Each run: a warm-up generate, then batch 4 (prompts of
37..500 tokens) and batch 32 (512-token prompts), 32 new tokens, TTFT and
decode tok/s by the host clock around work that ends in a device sync,
and the first decode step's logits.  Prints one line a run and writes the
numbers as JSON to OUT.json when given.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NEW = 32
CASES = {"batch 4": [37, 120, 300, 500], "batch 32": [512] * 32}


def _model(torch, device, cpu):
    from qwen_inference_engine_tpu_torch.config import PRESETS, tiny_config
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = (tiny_config(num_heads=8, num_kv_heads=8, head_dim=16) if cpu
           else PRESETS["qwen2.5-7b"])
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_quantized_params(cfg, gen, bits=4,
                                   group_size=16 if cpu else 64,
                                   dtype=torch.float32 if cpu
                                   else torch.bfloat16, device=device)
    return cfg.replace(act_bits=8), params


def _run(mesh, device, cpu):
    """Every case on this rank: (numbers, first-step logits, tokens)."""
    import numpy as np
    import torch

    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _model(torch, device, cpu)
    greedy = SamplingParams(greedy=True)
    rng = np.random.default_rng(3)
    out = {}
    for case, lengths in CASES.items():
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                   for n in lengths]
        eng = Engine(cfg, params, mesh=mesh, max_batch=len(prompts),
                     max_seq=1024, sampling=greedy, device=device)
        eng.generate(prompts, max_new_tokens=NEW)          # warm-up
        with torch.inference_mode():
            eng.start(prompts, NEW, greedy)
            logits = eng.decode().float().cpu()
        res = eng.generate(prompts, max_new_tokens=NEW)
        out[case] = dict(ttft_ms=res.ttft_s * 1e3,
                         decode_tok_s=res.decode_tokens_per_s,
                         captured=eng.graphs.captured,
                         logits=logits, tokens=res.token_ids)
        del eng
    return out


def _rank(rank, world, cpu):
    from qwen_inference_engine_tpu_torch.parallel.mesh import make_mesh

    import torch

    device = "cpu" if cpu else torch.device("cuda",
                                            torch.cuda.current_device())
    mesh = make_mesh((1, world))
    return dict(backend=mesh.model_group.backend,
                runs=_run(mesh, device, cpu))


def main() -> int:
    import torch

    from qwen_inference_engine_tpu_torch.parallel.mesh import spawn

    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    cpu = "--cpu" in sys.argv
    tp = int(argv[0]) if argv else 4
    if not cpu and not torch.cuda.is_available():
        print("time_tp_torch: no CUDA device", file=sys.stderr)
        return 2
    if not cpu:
        from qwen_inference_engine_tpu_torch.ops import cuda_lib

        cuda_lib.build()
        print(torch.cuda.get_device_name(0), "x", torch.cuda.device_count(),
              flush=True)
    one = _run(None, "cpu" if cpu else "cuda", cpu)
    ranks = spawn(_rank, tp, device_type="cpu" if cpu else "cuda",
                  args=(cpu,))
    record = {"tp": tp, "backend": ranks[0]["backend"], "runs": {}}
    for case in CASES:
        per = [r["runs"][case] for r in ranks]
        got = torch.cat([p["logits"] for p in per], dim=-1)
        ref = one[case]["logits"]
        same = sum(a == b for x, y in zip(per[0]["tokens"],
                                          one[case]["tokens"])
                   for a, b in zip(x, y))
        total = sum(len(y) for y in one[case]["tokens"])
        numbers = dict(
            tp1_ttft_ms=one[case]["ttft_ms"],
            tp1_decode_tok_s=one[case]["decode_tok_s"],
            ttft_ms=per[0]["ttft_ms"], decode_tok_s=per[0]["decode_tok_s"],
            captured_graphs=per[0]["captured"],
            max_abs_logit_diff=float((got - ref).abs().max()),
            ranks_equal=all(p["tokens"] == per[0]["tokens"] for p in per),
            tokens_equal_tp1=f"{same}/{total}")
        record["runs"][case] = numbers
        print(f"[tp {tp} {record['backend']}] {case}: {json.dumps(numbers)}",
              flush=True)
    if argv[1:]:
        with open(argv[1], "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
