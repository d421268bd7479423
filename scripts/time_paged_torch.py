"""Time the PyTorch port's paged decode and verify attentions on the card,
and fingerprint the other kernels whose sources the paged kernel shares.

    python3 scripts/time_paged_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``): its ``qwen_inference_engine_tpu_torch`` package is built
and timed with its ``chip_smoke.py``'s timers (CUDA events around each
call; a CUDA graph of 20 calls replayed 5 times), so two commits compare in
one call to the card.  Shapes are Qwen2.5-7B's (Hq 28, Hk 4, D 128),
inputs seeded random, NaN in every page no table holds and past each
row's length (NaN scales for int8), as ``chip_smoke.py`` builds them:

* ``paged_decode_attention_stacked`` / ``_q8`` at ``chip_smoke.PAGED_LENS``
  (8 slots, lengths 1..1440, pages of 512) through tables of the 4 pages
  the rows hold, and through tables of the scheduler's default width (64
  pages, zero past each row's pages);
* ``paged_verify_attention_stacked`` / ``_q8`` at T = 5, 16 and 17
  (``chip_smoke.verify_lens``), through the 4-page tables;

each a call and in a CUDA graph, beside SDPA over a gathered (for int8,
dequantized) copy masked as the kernel masks, a call and in a CUDA graph,
and the gather alone; with the SHA-256 of the kernel's output;

* the SHA-256 of the outputs of the other kernels built from the sources
  this slice touched (``attention_common.cuh``, ``attention_mma.cuh``,
  ``decode_attention.cu``): ``paged_chunk_attention`` / ``_q8`` (B 1, T
  256 at start 1280 of a 4-page table, ``check_paged_chunk``'s shape),
  ``decode_attention_appending`` / ``_contiguous_fresh`` (B 4 at position
  999 of S 1024; B 192 at 272 of S 512) and ``time_grouped_torch.bodies``
  (the four dense matmuls, ``fused_mlp``, ``fused_attn_mlp`` and
  ``fused_attn_matmul``), equal between two commits whose kernels compute
  the same bits.

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
        print("time_paged_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from time_grouped_torch import bodies

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["qwen2.5-7b"]
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page, layer = cs.PAGE, 1

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()

    def case(fn, q, pools, scales, tables, lens_list):
        """One paged call's numbers: a call, a CUDA graph, the SDPA
        yardstick over the gathered copy (a call, a graph), the gather, and
        the output's SHA-256."""
        T = q.shape[1]
        lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
        args = (q, *pools, *scales, tables, lens, page, layer)
        sc = scales if scales else (None, None)

        def gather():
            return pa.paged_kv_plain(*pools, *sc, tables, lens, layer,
                                     q.dtype)

        kl, vl = gather()
        pos = (lens.long() - T)[:, None] + torch.arange(T, device="cuda")
        key = torch.arange(kl.shape[2], device="cuda")
        mask = ((key[None, None, :] <= pos[:, :, None])
                & (key[None, None, :] < lens.long()[:, None, None]))[:, None]
        sdpa = cs._sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask)
        rec = {"ms": cs.time_ms(torch, lambda: fn(*args)),
               "graph_ms": cs.graph_ms(torch, lambda: fn(*args)),
               "sdpa_ms": cs.time_ms(torch, sdpa),
               "sdpa_graph_ms": cs.graph_ms(torch, sdpa),
               "gather_ms": cs.time_ms(torch, gather),
               "sha256": digest(fn(*args))}
        if hasattr(pa, "plan_paged_split"):
            groups = pa.paged_row_groups(T, Hq // Hk)
            rec["plan"] = (*pa.plan_paged_split(
                q.shape[0], Hk, groups, tables.shape[1] * page), groups)
        return rec

    out = {"root": root, "card": card, "paged": {}, "sha256": {}}
    g = torch.Generator(device="cuda").manual_seed(7)
    k0, v0, tables = cs._paged_pool(torch, cfg, g)
    B = len(cs.PAGED_LENS)
    wide = torch.zeros((B, 64), dtype=torch.int32, device="cuda")
    wide[:, :tables.shape[1]] = tables
    windows = [(1, cs.PAGED_LENS)] + [(T, cs.verify_lens(T))
                                      for T in (5, 16, 17)]
    for T, lens_list in windows:
        k, v = k0.clone(), v0.clone()
        cs._stale(torch, k, v, tables, lens_list)
        k8, v8, ks, vs = cs._q8_pool(torch, k, v)
        q = torch.randn((B, T, Hq, D), generator=g,
                        device="cuda").to(torch.bfloat16)
        kind = "decode" if T == 1 else "verify"
        for quant in (False, True):
            name = f"paged_{kind}_attention_stacked" + ("_q8" if quant else "")
            fn = getattr(pa, name)
            pools, scales = ((k8, v8), (ks, vs)) if quant else ((k, v), ())
            out["paged"][f"{name} T={T}"] = case(fn, q, pools, scales, tables,
                                                 lens_list)
            if T == 1:
                out["paged"][f"{name} T=1 default width"] = case(
                    fn, q, pools, scales, wide, lens_list)
            print(json.dumps({name: T}), flush=True)
        del k, v, k8, v8, ks, vs

    # the paged chunks (attention_common.cuh's attend)
    g = torch.Generator(device="cuda").manual_seed(8)
    k0, v0, tables = cs._paged_pool(torch, cfg, g, rows=1)
    cs._stale(torch, k0, v0, tables, [1280 + 256])
    k8, v8, ks, vs = cs._q8_pool(torch, k0, v0)
    q = torch.randn((1, 256, Hq, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    out["sha256"]["paged_chunk_attention"] = digest(ca.paged_chunk_attention(
        q, k0, v0, tables, layer, 1280, page))
    out["sha256"]["paged_chunk_attention_q8"] = digest(
        ca.paged_chunk_attention_q8(q, k8, v8, ks, vs, tables, layer, 1280,
                                    page))
    del k0, v0, k8, v8, ks, vs

    # the appending and fresh decodes (decode_attention.cu, its merge)
    g = torch.Generator(device="cuda").manual_seed(3)
    for nb, S, p in ((4, 1024, 999), (192, 512, 272)):
        kc, vc = (torch.randn((2, nb, Hk, S, D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        q = torch.randn((nb, 1, Hq, D), generator=g,
                        device="cuda").to(torch.bfloat16)
        kn, vn = (torch.randn((nb, 1, Hk, D), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        old = torch.full((nb,), p, dtype=torch.int32, device="cuda")
        fresh = da.decode_attention_contiguous_fresh(q, kc, vc, kn, vn, layer,
                                                     old)
        appended, _, _ = da.decode_attention_appending(q, kc, vc, kn, vn,
                                                       layer, p)
        out["sha256"][f"decode_attention_contiguous_fresh B={nb}"] = \
            digest(fresh)
        out["sha256"][f"decode_attention_appending B={nb}"] = \
            digest(appended)
        del kc, vc

    # the kernels on quant_matmul_core.cuh and fused_step.cu (which also
    # include both attention cores)
    out["sha256"].update(bodies(
        torch, cs, fs, qm, qm.quantize_activations,
        torch.Generator(device="cuda").manual_seed(9), digest))
    print(json.dumps(out))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
