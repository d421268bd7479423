"""Time the PyTorch port's three grouped (MoE expert) matmuls on the card,
and fingerprint their outputs.

    python3 scripts/time_grouped_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``): its ``qwen_inference_engine_tpu_torch`` package is built
and timed with its ``chip_smoke.py``'s timers (CUDA events around each
call; a CUDA graph of 20 calls replayed 5 times), so two commits compare in
one call to the card.  Shapes are Qwen3-30B-A3B's experts (128, top-8) at
layer 1 of a stacked [2, 128, ...] tensor, inputs seeded random, rows
routed by random top-8:

* ``grouped_matmul4_a8`` (INT4 gs 256 gate / gs 128 down),
  ``grouped_matmul4`` (the same) and ``grouped_matmul8`` (gs 128): the
  gate (K 2048, N 768) and down (K 768, N 2048) projections at M = 256
  (decode, batch 32 x top-8) and M = 4096 (a 512-token piece), a call and
  in a CUDA graph, beside ``torch._grouped_mm`` over the dequantized slab
  (bf16; a loop of per-expert ``matmul`` where this torch lacks it) a call
  and in a graph; a layer is two gates (gate, up) and a down;
* each kernel also at M = 131072 ([moe generate]'s prefill, batch 32 x
  512 x top-8), gate and down, a call, beside the library call;
* the SHA-256 of each output's bytes, to hold between two commits whose
  kernels compute the same bits (``grouped_matmul8`` since the INT4
  kernels moved onto its body; those two differ from the older tiles'
  bits, within the plain versions' tolerance);
* ``bodies``: the SHA-256 of the other kernels that share
  ``csrc/quant_matmul_core.cuh`` (Qwen2.5-7B shapes, no timing): the four
  dense matmuls on the gate projection (K 3584, N 18944) at M = 4 (split
  K) and 256, ``fused_mlp`` (gs 256 / 128) at M = 4 and 256,
  ``fused_attn_mlp`` (96 rows from row 96 of a 192-row cache, S 512) and
  ``fused_attn_matmul`` (56 rows, S 1024, the gate at gs 256).

Prints one JSON object (and writes it to OUT.json when given), with the
card's name and power limit.  Needs a CUDA device.
"""

import hashlib
import json
import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_grouped_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import (
        QuantLinear,
        dequantize,
    )
    from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
        quantize_activations,
    )

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    E, top, L, layer = 128, 8, 2, 1
    g = torch.Generator(device="cuda").manual_seed(15)
    out = {"root": root, "card": card}

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    routes = {M: cs._routing(torch, g, M // top, E, top)
              for M in (256, 4096, 131072)}
    for proj, K, N, gs4 in (("gate", 2048, 768, 256), ("down", 768, 2048, 128)):
        q4 = torch.randint(-128, 128, (L, E, K // 2, N), generator=g,
                           device="cuda", dtype=torch.int8)
        s4 = torch.rand((L, E, K // gs4, N), generator=g, device="cuda") \
            * (2 * K ** -0.5 / 7)
        q8 = torch.randint(-127, 128, (L, E, K, N), generator=g,
                           device="cuda", dtype=torch.int8)
        s8 = torch.rand((L, E, K // 128, N), generator=g, device="cuda") \
            * (2 * K ** -0.5 / 127)
        for M, gsz in routes.items():
            x = torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16)
            xq, sx = quantize_activations(x)
            sx = sx.reshape(-1).contiguous()
            calls = {
                "grouped_matmul8": (
                    lambda: gm.grouped_matmul8(x, q8, s8, gsz, layer), q8, s8,
                    8, 128),
                "grouped_matmul4_a8": (
                    lambda: gm.grouped_matmul4_a8(xq, sx, q4, s4, gsz, layer,
                                                  gs4), q4, s4, 4, gs4),
                "grouped_matmul4": (
                    lambda: gm.grouped_matmul4(x, q4, s4, gsz, layer, gs4),
                    q4, s4, 4, gs4)}
            for name, (fn, q, s, bits, gs) in calls.items():
                w = dequantize(QuantLinear(q=q[layer], scales=s[layer], b=None,
                                           bits=bits, group_size=gs))
                lib, lib_label = cs._grouped_library(torch, x, w, gsz)
                rec = {"ms": cs.time_ms(torch, fn), "sha256": digest(fn()),
                       "library_ms": cs.time_ms(torch, lib),
                       "library": lib_label}
                if M < 131072:
                    rec["graph_ms"] = cs.graph_ms(torch, fn)
                    rec["library_graph_ms"] = cs.graph_ms(torch, lib)
                out[f"{name} {proj} M{M}"] = rec
                del w
            del x, xq, sx
        del q4, s4, q8, s8
        torch.cuda.empty_cache()
    for name in ("grouped_matmul4_a8", "grouped_matmul4", "grouped_matmul8"):
        for M in (256, 4096):
            gate, down = out[f"{name} gate M{M}"], out[f"{name} down M{M}"]
            out[f"{name} layer M{M}"] = {
                key: 2 * gate[key] + down[key]
                for key in ("ms", "graph_ms", "library_ms",
                            "library_graph_ms")}
    out["bodies"] = bodies(torch, cs, fs, qm, quantize_activations, g, digest)
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            f.write(text)
    return 0


def bodies(torch, cs, fs, qm, quantize_activations, g, digest):
    """The SHA-256 of the other kernels on the shared tensor-core body at
    Qwen2.5-7B's shapes."""
    K, F, Hq, Hk, D = 3584, 18944, 28, 4, 128

    def int8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def bf16(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q4, s4 = int8(1, K // 2, F), torch.rand((1, K // 128, F), generator=g,
                                             device="cuda") * K ** -0.5 / 7
    q8 = int8(1, K, F).clamp_(min=-127)
    s8 = torch.rand((1, K // 128, F), generator=g, device="cuda") * 1e-3
    s8c = torch.rand((1, 1, F), generator=g, device="cuda") * 1e-3
    out = {}
    for M in (4, 256):
        x = bf16(M, K)
        xq, sx = quantize_activations(x)
        sx = sx.reshape(-1).contiguous()
        out[f"quant_matmul4_a8 M{M}"] = digest(
            qm.quant_matmul4_a8(xq, sx, q4, s4, 0, 128))
        out[f"quant_matmul4 M{M}"] = digest(qm.quant_matmul4(x, q4, s4, 0, 128))
        out[f"quant_matmul8 M{M}"] = digest(qm.quant_matmul8(x, q8, s8, 0))
        out[f"quant_matmul8_a8 M{M}"] = digest(
            qm.quant_matmul8_a8(xq, sx, q8, s8c, 0))
    del q4, s4, q8, s8, s8c
    w, _ = cs._mlp_stack(torch, g, K, F, 256, 128)
    for M in (4, 256):
        out[f"fused_mlp M{M}"] = digest(fs.fused_mlp(
            bf16(M, K), *w, 1, gs_gate=256, gs_down=128))
    Ba, Bc, S = 96, 192, 512
    kc, vc = bf16(2, Bc, Hk, S, D), bf16(2, Bc, Hk, S, D)
    lens = torch.full((Ba,), 257, dtype=torch.int32, device="cuda")
    attn, y = fs.fused_attn_mlp(lens, 1, 1, bf16(Ba, 1, Hq, D), kc, vc,
                                bf16(Ba, K), *w, gs_gate=256, gs_down=128,
                                row0=Ba)
    out["fused_attn_mlp"] = [digest(attn), digest(y)]
    del kc, vc
    Ba, Bc, S = 56, 112, 1024
    kc, vc = bf16(2, Bc, Hk, S, D), bf16(2, Bc, Hk, S, D)
    lens = torch.full((Ba,), 1017, dtype=torch.int32, device="cuda")
    attn, y = fs.fused_attn_matmul(lens, 1, bf16(Ba, 1, Hq, D), kc, vc,
                                   bf16(Ba, K), w[0], w[1], group_size=256)
    out["fused_attn_matmul"] = [digest(attn), digest(y)]
    return out


if __name__ == "__main__":
    raise SystemExit(main())
