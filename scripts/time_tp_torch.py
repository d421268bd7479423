#!/usr/bin/env python3
"""Tensor parallelism across cards: greedy ``Engine.generate`` of one model
at tp = 1 and at tp = N, timed, its tokens and first decode step compared.

    python3 scripts/time_tp_torch.py [TP[,TP...]] [OUT.json]
        [--model PRESET] [--format w4a8-gs64|w4a8-gs256|bf16]  # on the card
    python3 scripts/time_tp_torch.py 2 --cpu                  # a tiny model

Rank ``r`` runs on ``cuda:{r % device_count}``: with a card a rank the
ranks talk over NCCL and the decode steps are captured CUDA graphs; where
ranks share a card they fall back to gloo (``parallel/mesh.backend_for``)
and the steps run eagerly.  The model is a preset (Qwen2.5-7B by
default) at its full depth in one format: W4A8 with INT4 groups of 64
(the default: 7B's tp = 4 shards split evenly on them), W4A8 with groups
of 256 (the JAX bench's format; 7B and 3B split unevenly, in the layout
``parallel/tp_step.tp_layout`` chooses) or bf16, drawn from a seeded
generator on each rank's card: every rank and the tp = 1 run hold the
same params.  Each run: a warm-up generate, then batch 4 (prompts of
37..500 tokens) and batch 32 (512-token prompts), 32 new tokens, TTFT and
decode tok/s by the host clock around work that ends in a device sync,
and the first decode step's logits (the tp = 1 run once, then each TP
of the list in its own world); then three decode steps from one
prefill, eager and captured, compared bit for bit.  Each rank's layout
and resident bytes (weights; the KV cache of the batch-32 run) are
recorded beside what the JAX package's layout would hold (its
``param_pspecs`` / ``cache_pspecs`` under ``fit_spec``: a leaf the model
axis does not divide replicated, the KV cache split on heads or on
head_dim).  Prints one line a run and writes the numbers as JSON to
OUT.json when given.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NEW = 32
CASES = {"batch 4": [37, 120, 300, 500], "batch 32": [512] * 32}
FORMATS = {"w4a8-gs64": (4, 64), "w4a8-gs256": (4, 256), "bf16": (16, 0)}


def _model(torch, device, cpu, name, fmt):
    from qwen_inference_engine_tpu_torch.config import PRESETS, tiny_config
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_params,
        init_quantized_params,
    )

    cfg = (tiny_config(num_heads=8, num_kv_heads=8, head_dim=16) if cpu
           else PRESETS[name])
    gen = torch.Generator(device=device).manual_seed(7)
    dtype = torch.float32 if cpu else torch.bfloat16
    bits, gs = FORMATS[fmt]
    if bits == 16:
        return cfg, init_params(cfg, gen, dtype=dtype, device=device)
    params = init_quantized_params(cfg, gen, bits=bits,
                                   group_size=16 if cpu else gs,
                                   dtype=dtype, device=device)
    return cfg.replace(act_bits=8), params


def _bytes(tree) -> int:
    from qwen_inference_engine_tpu_torch.models.qwen import map_params

    total = []
    map_params(tree, lambda t: total.append(t.numel() * t.element_size()))
    return sum(total)


def _jax_layout_bytes(cfg, params, tp: int, kv_bytes: int) -> dict:
    """A rank's bytes under the JAX layout: each leaf split on its model
    dimension where tp divides it, else replicated (``fit_spec``); the KV
    cache split on heads or on head_dim (``cache_pspecs``)."""
    from qwen_inference_engine_tpu_torch.parallel.sharding import split_dims

    total = []

    def walk(tree, dims):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, dims[k])
        elif hasattr(tree, "__dataclass_fields__"):
            for f in tree.__dataclass_fields__:
                t = getattr(tree, f)
                if hasattr(t, "numel"):
                    walk(t, getattr(dims, f))
        elif tree is not None:
            n = tree.numel() * tree.element_size()
            total.append(n // tp if dims is not None
                         and tree.shape[dims] % tp == 0 else n)

    walk(params, split_dims(params))
    return dict(weights=sum(total), kv=kv_bytes // tp)


def _captured_equals_eager(torch, eng, prompts, greedy):
    """Three decode steps from one prefill, eager then captured (the key's
    first step eager, its second captured, then a replay), from the same
    state: logits and tokens bit-equal."""
    from qwen_inference_engine_tpu_torch.engine import step_graph

    with torch.inference_mode():
        eng.start(prompts, NEW, greedy)
        b = eng.buffers()
        snap = b.state()
        with step_graph.eager_steps():
            for _ in range(3):
                want = eng.decode().clone()
        want_out = b.out.clone()
        b.load_state(snap)
        for _ in range(3):
            got = eng.decode().clone()
        return bool(torch.equal(got, want)) and \
            bool(torch.equal(b.out, want_out))


def _run(mesh, device, cpu, name, fmt):
    """Every case on this rank: (numbers, first-step logits, tokens)."""
    import numpy as np
    import torch

    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _model(torch, device, cpu, name, fmt)
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
        c = eng.buffers().cache
        kv = sum(t.numel() * t.element_size()
                 for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None)
        out[case] = dict(ttft_ms=res.ttft_s * 1e3,
                         decode_tok_s=res.decode_tokens_per_s,
                         captured=eng.graphs.captured,
                         logits=logits, tokens=res.token_ids,
                         weight_bytes=_bytes(eng.params), kv_bytes=kv,
                         layout=None if eng.layout is None
                         else eng.layout.summary())
        if eng.graphs.capture:
            out[case]["captured_equals_eager"] = _captured_equals_eager(
                torch, eng, prompts, greedy)
        if mesh is not None:
            # the whole cache (this rank's holds _fcfg's KV heads)
            full = kv * cfg.num_kv_heads // eng._fcfg.num_kv_heads
            out[case]["jax_layout_bytes"] = _jax_layout_bytes(
                cfg, params, mesh.tp, full)
        del eng
    return out


def _rank(rank, world, cpu, name, fmt):
    from qwen_inference_engine_tpu_torch.parallel.mesh import make_mesh

    import torch

    device = "cpu" if cpu else torch.device("cuda",
                                            torch.cuda.current_device())
    mesh = make_mesh((1, world))
    return dict(backend=mesh.model_group.backend,
                runs=_run(mesh, device, cpu, name, fmt))


def _option(argv, flag, default):
    if flag in argv:
        i = argv.index(flag)
        value = argv[i + 1]
        del argv[i:i + 2]
        return value
    return default


def main() -> int:
    import torch

    from qwen_inference_engine_tpu_torch.parallel.mesh import spawn

    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    cpu = "--cpu" in sys.argv
    name = _option(argv, "--model", "qwen2.5-7b")
    fmt = _option(argv, "--format", "w4a8-gs64")
    tps = [int(t) for t in argv[0].split(",")] if argv else [4]
    if not cpu and not torch.cuda.is_available():
        print("time_tp_torch: no CUDA device", file=sys.stderr)
        return 2
    if not cpu:
        from qwen_inference_engine_tpu_torch.ops import cuda_lib

        cuda_lib.build()
        import subprocess

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        print(torch.cuda.get_device_name(0), "x", torch.cuda.device_count(),
              "|", smi[0] if smi else "", flush=True)
    one = _run(None, "cpu" if cpu else "cuda", cpu, name, fmt)
    records = [_compare(torch, tp, one, spawn(
        _rank, tp, device_type="cpu" if cpu else "cuda",
        args=(cpu, name, fmt)), name, fmt) for tp in tps]
    if argv[1:]:
        with open(argv[1], "w") as f:
            json.dump(records if len(records) > 1 else records[0], f,
                      indent=1)
    return 0


def _compare(torch, tp, one, ranks, name, fmt):
    """The tp = N run's numbers beside the tp = 1 run's, printed."""
    record = {"tp": tp, "model": name, "format": fmt,
              "backend": ranks[0]["backend"], "runs": {}}
    for case in CASES:
        per = [r["runs"][case] for r in ranks]
        split = per[0]["logits"].shape[-1] < one[case]["logits"].shape[-1]
        got = (torch.cat([p["logits"] for p in per], dim=-1) if split
               else per[0]["logits"])
        ref = one[case]["logits"]
        same = sum(a == b for x, y in zip(per[0]["tokens"],
                                          one[case]["tokens"])
                   for a, b in zip(x, y))
        total = sum(len(y) for y in one[case]["tokens"])
        numbers = dict(
            tp1_ttft_ms=one[case]["ttft_ms"],
            tp1_decode_tok_s=one[case]["decode_tok_s"],
            ttft_ms=per[0]["ttft_ms"], decode_tok_s=per[0]["decode_tok_s"],
            decode_tok_s_per_card=per[0]["decode_tok_s"] / tp,
            captured_graphs=per[0]["captured"],
            captured_equals_eager=[p.get("captured_equals_eager")
                                   for p in per],
            max_abs_logit_diff=float((got - ref).abs().max()),
            ranks_equal=all(p["tokens"] == per[0]["tokens"] for p in per),
            tokens_equal_tp1=f"{same}/{total}",
            layout=per[0]["layout"],
            tp1_bytes=dict(weights=one[case]["weight_bytes"],
                           kv=one[case]["kv_bytes"]),
            rank_bytes=[dict(weights=p["weight_bytes"], kv=p["kv_bytes"])
                        for p in per],
            jax_layout_rank_bytes=per[0]["jax_layout_bytes"])
        record["runs"][case] = numbers
        print(f"[tp {tp} {record['backend']} {name} {fmt}] {case}: "
              f"{json.dumps(numbers)}", flush=True)
    return record


if __name__ == "__main__":
    raise SystemExit(main())
