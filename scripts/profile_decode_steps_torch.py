"""Profile two decode steps of the PyTorch port on the card: where a step's
device time goes, for two commits in one call.

    python3 scripts/profile_decode_steps_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``): its ``qwen_inference_engine_tpu_torch`` package is built
and its ``chip_smoke.py``'s ``_profile_steps`` reads ``torch.profiler``.
Weights are seeded random, drawn packed on the card:

* ``ragged 7b``: Qwen2.5-7B W4A8 gs 256 (28 layers), bf16 KV, batch 4 at
  lengths 37 / 120 / 300 / 500 (``chip_smoke.py``'s [e2e] ragged run):
  decode steps at per-row positions, so each layer writes its K/V with
  ``kv_append_ragged_t`` and attends with ``decode_attention_contiguous``;
* ``moe w8a16``: Qwen3-30B-A3B W8A16 gs 128 at 12 layers, bf16 KV, batch
  32 after a 512-token prefill (``[moe generate]``'s W8A16 run): uniform
  decode steps, three ``grouped_matmul8`` calls a layer at M = 256;
* ``moe w4a8``: the same at W4A8 gs 256, 48 layers, INT8 KV (the JAX
  bench's MoE row, ``[moe generate]``'s W4A8 run): ``grouped_matmul4_a8``;
* ``moe w4a16``: W4A16 gs 128 at 24 layers, bf16 KV (``[moe generate]``'s
  W4A16 run): ``grouped_matmul4``.

For each: a prefill twice (the second's ms on the host clock, ending in a
device sync: the MoE rows' prefill is ``[moe generate]``'s, M = 131072
rows a projection), 8 warm-up steps, 8 steps on the host clock, 8 under the
profiler; per step the host ms, the device busy ms, the device kernels,
and the device ms of each of the top kernels.  Prints one JSON
object (and writes it to OUT.json when given), with the card's name and
power limit.  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
import time

STEPS = 8


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("profile_decode_steps_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"root": root, "card": card}
    g = torch.Generator(device="cuda").manual_seed(15)

    def profile_steps(cfg, params, lengths, max_seq, uniform,
                      kv_dtype=torch.bfloat16):
        B, T = len(lengths), max(lengths)
        toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                             device="cuda")
        lens = torch.tensor(lengths, device="cuda")
        cache = KVCache.create(cfg.num_layers, B, max_seq, cfg.num_kv_heads,
                               cfg.head_dim, dtype=kv_dtype, device="cuda")
        with torch.inference_mode():
            for _ in range(2):  # the first a warm-up; the second timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = qwen.prefill_chunked(params, cfg, toks, lens,
                                                     cache, chunk=512)
                torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            state = {"tok": logits.argmax(-1), "cache": cache}

            def run(first):
                for s in range(STEPS):
                    logits, state["cache"] = qwen.decode_step(
                        params, cfg, state["tok"], lens + first + s,
                        state["cache"], uniform_decode=uniform)
                    state["tok"] = logits.argmax(-1)
                torch.cuda.synchronize()

            run(0)
            t0 = time.perf_counter()
            run(STEPS)
            host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
            busy, kernels, top = cs._profile_steps(
                torch, lambda: run(2 * STEPS), STEPS)
        return {"prefill_ms": prefill_ms, "step_ms": host_ms,
                "step_device_busy_ms": busy,
                "step_kernels": kernels,
                "top_ms_per_step": {k[:80]: ms / STEPS for k, ms, _ in top}}

    cfg = PRESETS["qwen2.5-7b"].replace(act_bits=8)
    params = qwen.init_quantized_params(cfg, g, bits=4, group_size=256,
                                        device="cuda")
    out["ragged 7b"] = profile_steps(cfg, params, [37, 120, 300, 500], 1024,
                                     uniform=False)
    del params
    torch.cuda.empty_cache()
    cfg = PRESETS["qwen3-30b-a3b"].replace(num_layers=12)
    params = cs.moe_params(torch, cfg, 8, 128, 12)
    out["moe w8a16"] = profile_steps(cfg, params, [512] * 32, 768,
                                     uniform=True)
    del params
    torch.cuda.empty_cache()
    for name, bits, gs, L, act, kv in (
            ("moe w4a8", 4, 256, 48, 8, torch.int8),
            ("moe w4a16", 4, 128, 24, 0, torch.bfloat16)):
        cfg = PRESETS["qwen3-30b-a3b"].replace(num_layers=L, act_bits=act)
        params = cs.moe_params(torch, cfg, bits, gs, L)
        out[name] = profile_steps(cfg, params, [512] * 32, 768, uniform=True,
                                  kv_dtype=kv)
        del params
        torch.cuda.empty_cache()
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
