"""Where a resent prompt's serving path differs from its first send, on
the card: the pool rows, the first token's logits and the tokens, under
the dense matmuls' default plan and with every one on one K slice.

    python3 scripts/probe_resend_torch.py [OUT.json]

Qwen2.5-7B W4A8 gs 256 at full depth, seeded random weights of two kinds:
``chip_smoke.py``'s (``quantize_params`` of the seeded bf16 init) and
packed ones drawn directly (``init_quantized_params``).  For each kind and
pool (bf16, INT8), ``chip_smoke.resend_near_max_seq``'s check without its
asserts: two 2040-token prompts sent twice each (the second send hits
2039 tokens and prefills the last row in a 16-row piece, the first in a
248-row one), under the default plan and inside
``chip_smoke.one_slice_plan``.  Then whether one row of each dense
projection (and of the RMSNorm) comes out with the same bits at M = 1,
16, 64 and 65 as at M = 248 (K split at M <= 64, one slice above).
Prints one JSON object (and writes it to OUT.json when given), with the
card's name and power limit.  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_resend_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops.linear import apply_linear
    from qwen_inference_engine_tpu_torch.ops.norms import rms_norm
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"card": card}
    failures = []
    cs.fail = failures.append  # record, do not stop: this probe measures
    cfg = PRESETS["qwen2.5-7b"].replace(act_bits=8)

    def weights(kind):
        g = torch.Generator(device="cuda").manual_seed(0)
        if kind == "packed":
            return qwen.init_quantized_params(cfg, g, bits=4, group_size=256,
                                              device="cuda")
        bf16 = qwen.init_params(cfg, g, dtype=torch.bfloat16, device="cuda")
        return quantize_params(bf16, QuantConfig(bits=4, group_size=256))

    def summary(pool):
        return {n: {"hit_rows_differ": d["hit_rows_differ"],
                    "last_row_differ": d["last_row_differ"],
                    "first_layer": (d["last_row_layers"] or [None])[0],
                    **{k: v for k, v in d.items() if k.startswith("last_row_max")}}
                for n, d in pool.items() if n != "logits"}

    for kind in ("chip_smoke", "packed"):
        params = weights(kind)
        torch.cuda.empty_cache()
        for kv in (torch.bfloat16, torch.int8):
            for one_slice in (False, True):
                cb = ContinuousBatchingEngine(
                    cfg, params, max_slots=8, page_size=512, num_pages=40,
                    max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
                    sampling=SamplingParams(greedy=True), kv_dtype=kv,
                    device="cuda")
                cb._eos = set()
                chunk = (ca.paged_chunk_attention_q8 if kv == torch.int8
                         else ca.paged_chunk_attention)
                rng = np.random.default_rng(1)
                runs = []
                for _ in range(2):
                    if one_slice:
                        with cs.one_slice_plan():
                            same, pool = cs._resend(torch, cb, cfg, rng,
                                                    chunk, exact=False)
                    else:
                        same, pool = cs._resend(torch, cb, cfg, rng, chunk,
                                                exact=False)
                    runs.append({"tokens_equal": same, "pool": summary(pool),
                                 "logits_max_abs": pool["logits"]["max_abs"]})
                plan = "one slice" if one_slice else "default"
                out[f"{kind} {str(kv)[6:]} {plan}"] = runs
                del cb
                torch.cuda.empty_cache()
        if kind == "packed":
            lyr = params["layers"]
            g = torch.Generator(device="cuda").manual_seed(1)
            rows = {}
            for n in ("q", "k", "v", "o", "gate", "up", "down"):
                K = lyr[n].in_features
                h = torch.randn((248, K), generator=g, device="cuda").to(
                    torch.bfloat16)
                full = apply_linear(h, lyr[n], 0, 8)[-1]
                for M in (1, 16, 64, 65):
                    x = torch.zeros((M, K), device="cuda", dtype=torch.bfloat16)
                    x[0] = h[-1]
                    y = apply_linear(x, lyr[n], 0, 8)[0]
                    rows[f"{n} M{M}"] = [int((y != full).sum()), y.numel()]
            h = torch.randn((1, 248, cfg.hidden_size), generator=g,
                            device="cuda").to(torch.bfloat16)
            full = rms_norm(h, lyr["input_norm"][0], cfg.rms_norm_eps)[0, -1]
            x = torch.zeros((1, 16, cfg.hidden_size), device="cuda",
                            dtype=torch.bfloat16)
            x[0, 0] = h[0, -1]
            y = rms_norm(x, lyr["input_norm"][0], cfg.rms_norm_eps)[0, 0]
            rows["rms_norm M16"] = [int((y != full).sum()), y.numel()]
            out["one row at M vs 248: elements differ, of"] = rows
        del params
        torch.cuda.empty_cache()
    out["fail_messages"] = [m[:160] for m in failures]
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
