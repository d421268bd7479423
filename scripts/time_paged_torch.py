"""Time the PyTorch port's paged decode, verify and chunk attentions on the
card, and fingerprint the other kernels whose sources they share.

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

* ``paged_chunk_attention`` / ``_q8``, the serving prefill piece (B 1, T
  256 over a 4-page table of pages of 512, ``check_paged_chunk``'s pool)
  at starts 256, 700 and 1280, with Qwen2.5-7B's heads and with
  Qwen3-30B-A3B's (Hq 32, Hk 4), each a call and in a CUDA graph, beside
  SDPA over the gathered copy (a call and in a CUDA graph) and the gather,
  with the bound (operations at the bf16 peak, or bytes) and the SHA-256
  of the output;
* the SHA-256 of the outputs of the other kernels built from the sources
  the paged kernels share (``attention_common.cuh``, ``attention_mma.cuh``,
  ``chunk_attention.cu``, ``flash_attention.cu``, ``decode_attention.cu``,
  ``paged_attention.cu``): ``flash_attention`` (B 4, T 512),
  ``chunk_attention_contiguous`` / ``_q8`` (B 4, T 512 at start 1536 of S
  2048), ``decode_attention_contiguous`` (the ragged decode, lengths 69 /
  152 / 332 / 1000 of S 1024) and ``_q8`` (lengths 69..2000 of S 2304),
  ``decode_attention_appending`` / ``_contiguous_fresh`` (B 4 at position
  999 of S 1024; B 192 at 272 of S 512) and ``time_grouped_torch.bodies``
  (the four dense matmuls, ``fused_mlp``, ``fused_attn_mlp`` and
  ``fused_attn_matmul``), equal between two commits whose kernels compute
  the same bits;
* every kernel's registers and spills as ``ptxas -v`` printed them in the
  build's ``build.log`` (names demangled where ``cu++filt`` exists).

Prints one JSON object (and writes it to OUT.json when given), with the
card's name and power limit.  Needs a CUDA device.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys


def registers(log_path: str) -> dict:
    """{kernel: "R registers, S bytes spill stores, L bytes spill loads"}
    from a build log of ``ptxas -v`` lines, names demangled by ``cu++filt``
    where the toolkit has it."""
    import re

    regs, name, spill = {}, None, ""
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = f"{m.group(1)} / {m.group(2)} bytes spilled"
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name] = f"{m.group(1)} registers, {spill}"
                name = None
    filt = os.path.join(os.path.dirname(shutil.which("nvcc")
                                        or "/usr/local/cuda/bin/nvcc"),
                        "cu++filt")
    if os.path.exists(filt):
        names = list(regs)
        plain = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            regs = {p.replace("(anonymous namespace)::", ""): regs[n]
                    for n, p in zip(names, plain)}
    return regs


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
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
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

    # the paged chunks: the serving piece at three starts, two head layouts
    def chunk_case(fn, q, pools, scales, tables, start):
        T, Hq = q.shape[1], q.shape[2]
        args = (q, *pools, *scales, tables, layer, start, page)
        end = start + T
        n = torch.tensor([end], device="cuda")
        sc = scales if scales else (None, None)

        def gather():
            return pa.paged_kv_plain(*pools, *sc, tables, n, layer, q.dtype)

        kl, vl = gather()
        kl, vl = kl[:, :, :end], vl[:, :, :end]
        qpos = start + torch.arange(T, device="cuda")
        mask = torch.arange(end, device="cuda")[None, :] <= qpos[:, None]
        sdpa = cs._sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask)
        n_ops = 4 * Hq * D * sum(start + t + 1 for t in range(T))
        n_bytes = cs._pool_bytes(pools, scales, end, Hk, D) \
            + 2 * 2 * T * Hq * D + 4 * tables.numel()
        b_ms, b_by = cs.bound(n_bytes, n_ops, "bf16")
        rec = {"ms": cs.time_ms(torch, lambda: fn(*args)),
               "graph_ms": cs.graph_ms(torch, lambda: fn(*args)),
               "sdpa_ms": cs.time_ms(torch, sdpa),
               "sdpa_graph_ms": cs.graph_ms(torch, sdpa),
               "gather_ms": cs.time_ms(torch, gather),
               "bound_ms": b_ms, "bound_by": b_by,
               "sha256": digest(fn(*args))}
        rec["tflops_graph"] = n_ops / rec["graph_ms"] / 1e9
        return rec

    g = torch.Generator(device="cuda").manual_seed(8)
    k0, v0, tables = cs._paged_pool(torch, cfg, g, rows=1)
    qs = {c: torch.randn((1, 256, PRESETS[c].num_heads, D), generator=g,
                         device="cuda").to(torch.bfloat16)
          for c in ("qwen2.5-7b", "qwen3-30b-a3b")}
    for start in (256, 700, 1280):
        k, v = k0.clone(), v0.clone()
        cs._stale(torch, k, v, tables, [start + 256])
        k8, v8, ks, vs = cs._q8_pool(torch, k, v)
        for c, q in qs.items():
            for fn, pools, scales in (
                    (ca.paged_chunk_attention, (k, v), ()),
                    (ca.paged_chunk_attention_q8, (k8, v8), (ks, vs))):
                key = f"{fn.__name__} {c} start={start}"
                out["paged"][key] = chunk_case(fn, q, pools, scales, tables,
                                               start)
                print(json.dumps({key: out["paged"][key]}), flush=True)
                if start == 1280 and c == "qwen2.5-7b":
                    out["sha256"][fn.__name__] = out["paged"][key]["sha256"]
        del k, v, k8, v8, ks, vs
    del k0, v0

    # flash and the contiguous chunks (attend_gqa_block), the ragged and
    # int8 contiguous decodes
    g = torch.Generator(device="cuda").manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    qf, kf, vf = rnd(4, 512, Hq, D), rnd(4, 512, Hk, D), rnd(4, 512, Hk, D)
    out["sha256"]["flash_attention"] = digest(fa.flash_attention(qf, kf, vf))
    kc, vc = rnd(2, 4, Hk, 2048, D), rnd(2, 4, Hk, 2048, D)
    k8, ks = cs._int8(torch, g, (2, 4, Hk, 2048, D))
    v8, vs = cs._int8(torch, g, (2, 4, Hk, 2048, D))
    out["sha256"]["chunk_attention_contiguous"] = digest(
        ca.chunk_attention_contiguous(qf, kc, vc, layer, 1536))
    out["sha256"]["chunk_attention_contiguous_q8"] = digest(
        ca.chunk_attention_contiguous_q8(qf, k8, v8, ks, vs, layer, 1536))
    qd = rnd(4, 1, Hq, D)
    lens = torch.tensor([69, 152, 332, 1000], device="cuda")
    out["sha256"]["decode_attention_contiguous"] = digest(
        da.decode_attention_contiguous(qd, kc[:, :, :, :1024].contiguous(),
                                       vc[:, :, :, :1024].contiguous(),
                                       layer, lens))
    lens = torch.tensor([69, 700, 1408, 2000], device="cuda")
    out["sha256"]["decode_attention_contiguous_q8"] = digest(
        da.decode_attention_contiguous_q8(qd, k8, v8, ks, vs, layer, lens))
    del qf, kf, vf, kc, vc, k8, v8, ks, vs

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
    out["ptxas"] = registers(os.path.join(os.path.dirname(cuda_lib.build()),
                                          "build.log"))
    print(json.dumps(out))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
