#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device: the card's name and power limit, TF32 off for the plain versions;
2. build: the CUDA kernels of ``qwen_inference_engine_tpu_torch/csrc`` with
   nvcc for sm_90a, one process per source;
3. each kernel against its plain PyTorch version on the card at the shapes
   Qwen2.5-7B gives it, with error, kernel / plain / library time and the
   bound (the larger of bytes at 3.35 TB/s and operations at the peak rate
   of their type: 989 TFLOP/s bf16, 1979 TOP/s int8); the paged kernels
   over a 40-page pool of 512-token pages with shuffled tables and NaN in
   every page no table holds (the paged attentions' library yardstick is
   SDPA over a gathered copy, the gather timed beside it; the appends' an
   ``index_put_`` scatter);
4. end to end: Qwen2.5-7B at full width and depth (28 layers), random
   weights from a seeded generator, W4A8 gs 256, through
   ``Engine.generate``, 32 new tokens each: in bf16 KV a ragged batch
   (prompts of 37, 120, 300 and 500 tokens) and an aligned batch (4 x 256)
   at max_seq 1024; then prompts longer than one 512-token chunk (bucket
   2048, three continuation chunks) at max_seq 2304: bf16 KV aligned
   (4 x 1408) and ragged (700, 1100, 1408, 1900), INT8 KV aligned
   (4 x 1408) and ragged (37, 600, 1408, 1900).  Every launch count is set
   to 0 just before each run and read just after, and each run must have
   launched the kernels of its path and none of the others';
4b. serving: ``ContinuousBatchingEngine`` on the same full-depth model at
   the JAX defaults (8 slots, pages of 512, pieces of 256, prefix cache on,
   8 decode ticks per sync), EOS off: 12 greedy requests (prompts of 37 to
   1408 tokens) onto 8 slots, then 4 that share an 1100-token prefix with a
   finished one, 32 new tokens each.  Every request must finish by length;
   the four paged kernels, flash and the W4A8 matmul must launch (one paged
   decode and append per layer per decode tick, one prefill append per
   layer per piece), no contiguous-cache kernel may, the prefix cache must
   hit and a mixed prefill + decode window must run; after the counts are
   read, a 2040-token prompt is sent twice (the second's last piece runs
   past its 4-page table) and both must finish, then 8 more requests fill
   the slots and one window of 8 decode ticks is timed, and the next one profiled (device busy time, kernels by
   device time); then the HTTP ``Server`` on 127.0.0.1 answers /generate,
   a streamed /v1/completions, /v1/chat/completions and /stats;
5. the kernel path against the plain path on the card, the same weights at
   a depth of 4 layers: in bf16 KV, prefill logits (one chunk) and 8 greedy
   tokens; in INT8 KV, the logits of a chunked prefill of prompts of 600 to
   1000 tokens (a fresh chunk and a continuation).  Both paths are held
   against an fp32 run of the plain path (over an int8 cache in the INT8
   case), and the kernel path may be at most 1.5x as far from it as the
   plain bf16 path is (with random weights, bf16 rounding alone moves the
   logits by a few tenths); the same over the page pool: a paged prefill
   of three pieces across two pages, then 4 paged decode steps.

Then one JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``.  Every number is measured in this run.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def check_quant_matmul(torch, cfg, gs, ms_list=(4, 2048)):
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize
    from qwen_inference_engine_tpu_torch.quant.quantize import _padded_k

    D, F, Qd, Kd = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    shapes = [("q", D, Qd), ("k", D, Kd), ("v", D, Kd), ("o", Qd, D),
              ("gate", D, F), ("up", D, F), ("down", F, D)]
    g = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for M in ms_list:
        for name, K, N in shapes:
            if M == 2048 and name in ("v", "up"):
                continue  # same shapes as k / gate
            kp = _padded_k(K, 4, gs)
            q = torch.randint(-128, 128, (1, kp // 2, N), generator=g,
                              device="cuda", dtype=torch.int8)
            s = torch.full((1, kp // gs, N), K ** -0.5 / 7, device="cuda")
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            xp = torch.nn.functional.pad(x, (0, kp - K))
            xq, sx = qm.quantize_activations(xp)
            sx = sx.reshape(-1).contiguous()
            got = qm.quant_matmul4_a8(xq, sx, q, s, 0, gs)
            ref = qm.quant_matmul4_a8_plain(xq, sx, q, s, 0, gs)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 ** -6 * ref.float().abs().max().item()
            w = dequantize(QuantLinear(q=q[0], scales=s[0], b=None, bits=4,
                                       group_size=gs))[:K]
            ms = time_ms(torch, lambda: qm.quant_matmul4_a8(xq, sx, q, s, 0, gs))
            plain_ms = time_ms(torch, lambda: qm.quant_matmul4_a8_plain(
                xq, sx, q, s, 0, gs), iters=3, warmup=1)
            lib_ms = time_ms(torch, lambda: torch.matmul(x, w))
            n_bytes = M * kp + 4 * M + kp // 2 * N + 4 * (kp // gs) * N + 2 * M * N
            b_ms, b_by = bound(n_bytes, 2 * M * kp * N, "int8")
            rec = dict(shape=f"{cfg.name} {name} M={M} K={kp} N={N}", M=M,
                       model=cfg.name, max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            print(f"  quant_matmul4_a8 {rec['shape']}: err {err:.3g} "
                  f"(tol {tol:.3g}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} | torch.matmul bf16 {lib_ms:.4f} | bound "
                  f"{b_ms:.4f} ({b_by})", flush=True)
            if not err <= tol:
                fail(f"quant_matmul4_a8 {rec['shape']} err {err} > {tol}")
            records.append(rec)
            del q, s, x, xp, xq, w, got, ref
    return records


def _sdpa(torch, q, k, v, mask=None, causal=False):
    """The library yardstick: PyTorch's fused attention ([B, H, T, D])."""
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)


def check_flash(torch, cfg):
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa

    B, T, Hq, Hk, D = 4, 512, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((B, T, h, D), generator=g, device="cuda"
                           ).to(torch.bfloat16) for h in (Hq, Hk, Hk))
    got = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2e-2
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), iters=3)
    lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True))
    n_ops = 4 * D * B * Hq * T * (T + 1) // 2
    n_bytes = 2 * (2 * B * T * Hq * D) + 2 * (2 * B * T * Hk * D)
    b_ms, b_by = bound(n_bytes, n_ops, "bf16")
    rec = dict(shape=f"B={B} T={T} Hq={Hq} Hk={Hk} D={D}", max_abs_err=err,
               tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by)
    print(f"  flash_attention {rec['shape']}: err {err:.3g} (tol {tol}) | "
          f"kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa {lib_ms:.4f} | "
          f"bound {b_ms:.4f} ({b_by})", flush=True)
    if not err <= tol:
        fail(f"flash_attention err {err} > {tol}")
    return [rec]


def check_decode(torch, cfg):
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da

    L, B, S = 2, 4, 1024
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    kc, vc = rnd(L, B, Hk, S, D), rnd(L, B, Hk, S, D)
    q = rnd(B, 1, Hq, D)
    kn, vn = rnd(B, 1, Hk, D), rnd(B, 1, Hk, D)
    layer = 1
    tol = 2e-2
    records = {}

    lens_list = [69, 152, 332, 1000]
    lens = torch.tensor(lens_list, device="cuda")
    got = da.decode_attention_contiguous(q, kc, vc, layer, lens)
    ref = da.decode_attention_contiguous_plain(q, kc, vc, layer, lens)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ms = time_ms(torch, lambda: da.decode_attention_contiguous(q, kc, vc, layer, lens))
    plain_ms = time_ms(torch, lambda: da.decode_attention_contiguous_plain(
        q, kc, vc, layer, lens))
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kc[layer],
                                  vc[layer], mask=mask))
    n_keys = sum(lens_list)
    n_bytes = 2 * (2 * n_keys * Hk * D) + 2 * (2 * B * Hq * D) + 4 * B
    b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
    records["decode_attention_contiguous"] = dict(
        shape=f"B={B} lens={lens_list} S={S} Hq={Hq} Hk={Hk}", max_abs_err=err,
        tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by)
    print(f"  decode_attention_contiguous lens {lens_list}: err {err:.3g} "
          f"(tol {tol}) | kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa "
          f"{lib_ms:.4f} | bound {b_ms:.4f} ({b_by})", flush=True)
    if not err <= tol:
        fail(f"decode_attention_contiguous err {err} > {tol}")

    pos = 999
    k1, v1 = kc.clone(), vc.clone()
    k2, v2 = kc.clone(), vc.clone()
    got, gk, gv = da.decode_attention_appending(q, k1, v1, kn, vn, layer, pos)
    ref, rk, rv = da.decode_attention_appending_plain(q, k2, v2, kn, vn, layer, pos)
    torch.cuda.synchronize()
    if gk is not k1 or gv is not v1:
        fail("decode_attention_appending did not return the caches it wrote")
    err = (got.float() - ref.float()).abs().max().item()
    cache_err = max((gk.float() - rk.float()).abs().max().item(),
                    (gv.float() - rv.float()).abs().max().item())
    ms = time_ms(torch, lambda: da.decode_attention_appending(
        q, k1, v1, kn, vn, layer, pos))
    plain_ms = time_ms(torch, lambda: da.decode_attention_appending_plain(
        q, k2, v2, kn, vn, layer, pos))
    lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2),
                                  kc[layer, :, :, :pos + 1],
                                  vc[layer, :, :, :pos + 1]))
    n_keys = B * (pos + 1)
    n_bytes = 2 * (2 * n_keys * Hk * D) + 2 * (2 * B * Hq * D) + 2 * (2 * B * Hk * D)
    b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
    records["decode_attention_appending"] = dict(
        shape=f"B={B} position={pos} S={S} Hq={Hq} Hk={Hk}", max_abs_err=err,
        cache_err=cache_err, tol=tol, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"  decode_attention_appending position {pos}: err {err:.3g} "
          f"(tol {tol}), cache rows err {cache_err} | kernel {ms:.4f} ms | "
          f"plain {plain_ms:.4f} | sdpa {lib_ms:.4f} | bound {b_ms:.4f} "
          f"({b_by})", flush=True)
    if not err <= tol or cache_err != 0:
        fail(f"decode_attention_appending err {err} (tol {tol}), "
             f"cache {cache_err}")
    return records


def _int8(torch, g, shape):
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    return quantize_kv(torch.randn(shape, generator=g, device="cuda"))


def check_chunk(torch, cfg):
    """Kernels 5 and 6: the continuation chunk at B=4, T=512 over a cache
    of S=2304, starts 512, 1024 and 1536 (chunks 1-3 of a 2048 bucket)."""
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

    L, B, T, S = 2, 4, 512, 2304
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(4)
    q = torch.randn((B, T, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((L, B, Hk, S, D), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hk, S, D), generator=g, device="cuda").to(torch.bfloat16)
    k8, ks = _int8(torch, g, (L, B, Hk, S, D))
    v8, vs = _int8(torch, g, (L, B, Hk, S, D))
    layer = 1
    records = {}
    for quant in (False, True):
        name = "chunk_attention_contiguous" + ("_q8" if quant else "")
        tol = 2e-2
        for start in (512, 1024, 1536):
            end = start + T
            if quant:
                args = (q, k8, v8, ks, vs, layer, start)
                kern, plain = ca.chunk_attention_contiguous_q8, \
                    ca.chunk_attention_contiguous_q8_plain
                # the library's input: a bf16 copy dequantized beforehand
                kl = dequantize_kv(k8[layer, :, :, :end], ks[layer, :, :, :end])
                vl = dequantize_kv(v8[layer, :, :, :end], vs[layer, :, :, :end])
            else:
                args = (q, kc, vc, layer, start)
                kern, plain = ca.chunk_attention_contiguous, \
                    ca.chunk_attention_contiguous_plain
                kl, vl = kc[layer, :, :, :end], vc[layer, :, :, :end]
            got = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ms = time_ms(torch, lambda: kern(*args))
            plain_ms = time_ms(torch, lambda: plain(*args), iters=3, warmup=1)
            qpos = start + torch.arange(T, device="cuda")
            mask = torch.arange(end, device="cuda")[None, :] <= qpos[:, None]
            lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kl, vl,
                                          mask=mask))
            itemsize = 1 if quant else 2
            n_bytes = 2 * B * Hk * end * D * itemsize + 2 * 2 * B * T * Hq * D
            if quant:
                n_bytes += 2 * 4 * B * Hk * end
            n_ops = 4 * B * Hq * D * (T * start + T * (T + 1) // 2)
            b_ms, b_by = bound(n_bytes, n_ops, "bf16")
            rec = dict(shape=f"B={B} T={T} start={start} S={S} Hq={Hq} "
                             f"Hk={Hk} D={D}", max_abs_err=err, tol=tol, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            print(f"  {name} start {start}: err {err:.3g} (tol {tol}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa "
                  f"{lib_ms:.4f} | bound {b_ms:.4f} ({b_by})", flush=True)
            if not err <= tol:
                fail(f"{name} start {start} err {err} > {tol}")
            # the JSON line keeps the last chunk of the 2048 bucket
            records[name] = rec
            del got, ref, kl, vl
    return records


def check_kv_append(torch, cfg):
    """Kernel 7 at B=4, position 1999 of S=2304: bit-exact."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    L, B, S, pos, layer = 2, 4, 2304, 1999, 1
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(5)
    k8, ks = _int8(torch, g, (L, B, Hk, S, D))
    v8, vs = _int8(torch, g, (L, B, Hk, S, D))
    kn, ksn = quantize_kv(torch.randn((B, 1, Hk, D), generator=g, device="cuda"))
    vn, vsn = quantize_kv(torch.randn((B, 1, Hk, D), generator=g, device="cuda"))
    new = (kn, vn, ksn, vsn)
    mine = [t.clone() for t in (k8, v8, ks, vs)]
    theirs = [t.clone() for t in (k8, v8, ks, vs)]
    got = ka.kv_append_uniform_q8(*mine, *new, pos, layer)
    ref = ka.kv_append_uniform_q8_plain(*theirs, *new, pos, layer)
    torch.cuda.synchronize()
    if any(a is not b for a, b in zip(got, mine)):
        fail("kv_append_uniform_q8 did not return the tensors it wrote")
    diff = sum(int((a != b).sum()) for a, b in zip(got, ref))
    written = int((mine[0] != k8).sum())
    pos_t = torch.tensor([pos], device="cuda")
    ms = time_ms(torch, lambda: ka.kv_append_uniform_q8(*mine, *new, pos_t, layer))
    plain_ms = time_ms(torch, lambda: ka.kv_append_uniform_q8_plain(
        *theirs, *new, pos, layer))

    def library():
        for cache, x in zip(theirs, new):
            cache[layer, :, :, pos] = x[:, 0]

    lib_ms = time_ms(torch, library)
    n_bytes = 2 * (2 * B * Hk * D + 2 * 4 * B * Hk)
    b_ms, b_by = bound(n_bytes, 0, "int8")
    print(f"  kv_append_uniform_q8 position {pos}: {diff} elements differ "
          f"(must be 0; {written} K bytes written) | kernel {ms:.4f} ms | "
          f"plain {plain_ms:.4f} | slice assignment {lib_ms:.4f} | bound "
          f"{b_ms:.6f} ({b_by})", flush=True)
    if diff != 0 or written == 0:
        fail(f"kv_append_uniform_q8 not bit-exact: {diff} elements differ")
    return {"kv_append_uniform_q8": dict(
        shape=f"B={B} position={pos} S={S} Hk={Hk} D={D}", max_abs_err=0.0,
        tol=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
        bound_by=b_by)}


def check_decode_q8(torch, cfg):
    """Kernel 8 at B=4, lengths 69 / 700 / 1408 / 2000 of S=2304."""
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

    L, B, S, layer = 2, 4, 2304, 1
    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(6)
    k8, ks = _int8(torch, g, (L, B, Hk, S, D))
    v8, vs = _int8(torch, g, (L, B, Hk, S, D))
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    lens_list = [69, 700, 1408, 2000]
    lens = torch.tensor(lens_list, device="cuda")
    args = (q, k8, v8, ks, vs, layer, lens)
    tol = 2e-2
    got = da.decode_attention_contiguous_q8(*args)
    ref = da.decode_attention_contiguous_q8_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ms = time_ms(torch, lambda: da.decode_attention_contiguous_q8(*args))
    plain_ms = time_ms(torch, lambda: da.decode_attention_contiguous_q8_plain(*args))
    kl = dequantize_kv(k8[layer], ks[layer])
    vl = dequantize_kv(v8[layer], vs[layer])
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    lib_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask))
    n_keys = sum(lens_list)
    n_bytes = 2 * n_keys * Hk * (D + 4) + 2 * (2 * B * Hq * D) + 4 * B
    b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
    print(f"  decode_attention_contiguous_q8 lens {lens_list}: err {err:.3g} "
          f"(tol {tol}) | kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa "
          f"{lib_ms:.4f} | bound {b_ms:.4f} ({b_by})", flush=True)
    if not err <= tol:
        fail(f"decode_attention_contiguous_q8 err {err} > {tol}")
    return {"decode_attention_contiguous_q8": dict(
        shape=f"B={B} lens={lens_list} S={S} Hq={Hq} Hk={Hk}",
        max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by)}


PAGE = 512          # the serving page size (scheduler default)
PAGED_LENS = [1, 37, 300, 511, 512, 513, 1100, 1440]


PAGED_TOL = 2 ** -6


def rel_err(got, ref) -> float:
    """The largest error of any output vector (one query row and head) over
    that vector's largest |value|: the bf16 rounding of both sides moves it
    by at most 2**-7, so PAGED_TOL leaves a factor 2."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _stale(torch, k, v, tables, valid):
    """NaN into every row at or past ``valid[b]`` of table row b's pages:
    stale rows inside held pages, which the kernels must never load."""
    j = torch.arange(tables.shape[1] * PAGE, device="cuda")
    for b, n in enumerate(valid):
        jj = j[n:]
        pg = tables[b].long()[jj // PAGE]
        k[:, pg, :, jj % PAGE] = float("nan")
        v[:, pg, :, jj % PAGE] = float("nan")


def _paged_pool(torch, cfg, g, L=2, P=40, max_pages=4, rows=8):
    """A bf16 pool of P pages, NaN in every page no row's table holds, and
    tables of ``rows`` rows shuffled across pages 1..P-1."""
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    k = torch.randn((L, P, Hk, PAGE, D), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((L, P, Hk, PAGE, D), generator=g, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:rows * max_pages] + 1
    tables = perm.reshape(rows, max_pages).to(torch.int32)
    unused = torch.ones(P, dtype=torch.bool, device="cuda")
    unused[tables.reshape(-1).long()] = False
    k[:, unused] = float("nan")
    v[:, unused] = float("nan")
    return k, v, tables


def check_paged_decode(torch, cfg):
    """Paged decode at 8 slots, lengths 1..1440 over pages of 512, NaN in
    the pages no table holds and in each row's pages past its length."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import paged_read
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(7)
    k, v, tables = _paged_pool(torch, cfg, g)
    _stale(torch, k, v, tables, PAGED_LENS)
    B, layer = len(PAGED_LENS), 1
    lens = torch.tensor(PAGED_LENS, device="cuda", dtype=torch.int32)
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    args = (q, k, v, tables, lens, PAGE, layer)
    tol = PAGED_TOL
    got = pa.paged_decode_attention_stacked(*args)
    ref = pa.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    rel = rel_err(got, ref)
    finite = bool(got.isfinite().all())
    ms = time_ms(torch, lambda: pa.paged_decode_attention_stacked(*args))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_plain(*args))
    gather_ms = time_ms(torch, lambda: (paged_read(k[layer], tables),
                                        paged_read(v[layer], tables)))
    kl = pa.masked_pages(k[layer], tables, lens)
    vl = pa.masked_pages(v[layer], tables, lens)
    mask = (torch.arange(kl.shape[2], device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kl, vl, mask=mask))
    n_keys = sum(PAGED_LENS)
    n_bytes = 2 * (2 * n_keys * Hk * D) + 2 * (2 * B * Hq * D) + 4 * B \
        + 4 * tables.numel()
    b_ms, b_by = bound(n_bytes, 4 * n_keys * Hq * D, "bf16")
    print(f"  paged_decode_attention_stacked lens {PAGED_LENS} page {PAGE}: "
          f"err {err:.3g}, relative {rel:.3g} (tol {tol:.3g} of each vector's "
          f"max) | kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa "
          f"{sdpa_ms:.4f} + gather {gather_ms:.4f} | bound {b_ms:.5f} "
          f"({b_by})", flush=True)
    if not rel <= tol or not finite:
        fail(f"paged_decode_attention_stacked relative err {rel} > {tol} or "
             f"non-finite ({finite})")
    return {"paged_decode_attention_stacked": dict(
        shape=f"B={B} lens={PAGED_LENS} page={PAGE} Hq={Hq} Hk={Hk}",
        max_abs_err=err, rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms,
        library_ms=sdpa_ms, gather_ms=gather_ms, bound_ms=b_ms,
        bound_by=b_by)}


def check_paged_chunk(torch, cfg):
    """The serving continuation piece: B=1, T=256 at starts 256, 1280, the
    mid-page 700, and 2040, whose bucket-padded piece runs past the 4-page
    table (its rows there attend the whole table), over pages of 512; NaN
    past each piece's end in its pages."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import paged_read
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    Hq, Hk, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(8)
    k0, v0, tables = _paged_pool(torch, cfg, g, rows=1)
    width = tables.shape[1] * PAGE
    T, layer, tol = 256, 1, PAGED_TOL
    q = torch.randn((1, T, Hq, D), generator=g, device="cuda").to(torch.bfloat16)
    rec = None
    for start in (256, 700, 2040, 1280):
        end = min(start + T, width)
        k, v = k0.clone(), v0.clone()
        _stale(torch, k, v, tables, [end])
        args = (q, k, v, tables, layer, start, PAGE)
        got = ca.paged_chunk_attention(*args)
        ref = ca.paged_chunk_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        rel = rel_err(got, ref)
        finite = bool(got.isfinite().all())
        ms = time_ms(torch, lambda: ca.paged_chunk_attention(*args))
        plain_ms = time_ms(torch, lambda: ca.paged_chunk_attention_plain(*args),
                           iters=3, warmup=1)
        gather_ms = time_ms(torch, lambda: (paged_read(k[layer], tables),
                                            paged_read(v[layer], tables)))
        n = torch.tensor([end], device="cuda")
        kl = pa.masked_pages(k[layer], tables, n)[:, :, :end]
        vl = pa.masked_pages(v[layer], tables, n)[:, :, :end]
        qpos = start + torch.arange(T, device="cuda")
        mask = torch.arange(end, device="cuda")[None, :] <= qpos[:, None]
        sdpa_ms = time_ms(torch, _sdpa(torch, q.transpose(1, 2), kl, vl,
                                       mask=mask))
        n_bytes = 2 * 2 * Hk * end * D + 2 * 2 * T * Hq * D + 4 * tables.numel()
        n_ops = 4 * Hq * D * sum(min(start + t + 1, width) for t in range(T))
        b_ms, b_by = bound(n_bytes, n_ops, "bf16")
        print(f"  paged_chunk_attention T={T} start {start} page {PAGE}: err "
              f"{err:.3g}, relative {rel:.3g} (tol {tol:.3g} of each vector's "
              f"max) | kernel {ms:.4f} ms | plain {plain_ms:.4f} | sdpa "
              f"{sdpa_ms:.4f} + gather {gather_ms:.4f} | bound {b_ms:.5f} "
              f"({b_by})", flush=True)
        if not rel <= tol or not finite:
            fail(f"paged_chunk_attention start {start} relative err {rel} > "
                 f"{tol} or non-finite ({finite})")
        if start == 1280:   # the JSON line keeps the longest in-table piece
            rec = dict(shape=f"B=1 T={T} start={start} page={PAGE} Hq={Hq} "
                             f"Hk={Hk} D={D}", max_abs_err=err, rel_err=rel,
                       tol=tol, ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                       gather_ms=gather_ms, bound_ms=b_ms, bound_by=b_by)
    return {"paged_chunk_attention": rec}


def check_paged_appends(torch, cfg):
    """Both paged appends, bit-exact: the decode step's 8 rows at the
    positions before PAGED_LENS, and a 256-token piece at start 384 (it
    crosses from page 0 to page 1 of its table)."""
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka

    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(9)
    k, v, tables = _paged_pool(torch, cfg, g)
    k, v = k.nan_to_num(), v.nan_to_num()
    layer = 1
    B = len(PAGED_LENS)
    pos = torch.tensor(PAGED_LENS, device="cuda", dtype=torch.int32) - 1
    kn = torch.randn((B, 1, Hk, D), generator=g, device="cuda").to(torch.bfloat16)
    vn = torch.randn((B, 1, Hk, D), generator=g, device="cuda").to(torch.bfloat16)
    T, start = 256, 384
    kp = torch.randn((1, T, Hk, D), generator=g, device="cuda").to(torch.bfloat16)
    vp = torch.randn((1, T, Hk, D), generator=g, device="cuda").to(torch.bfloat16)
    cases = {
        "paged_append_ragged": (
            lambda kc, vc: ka.paged_append_ragged(kc, vc, kn, vn, pos, tables,
                                                  layer, page_size=PAGE),
            lambda kc, vc: ka.paged_append_ragged_plain(
                kc, vc, kn, vn, pos, tables, layer, PAGE),
            B, f"B={B} positions={[n - 1 for n in PAGED_LENS]}"),
        "paged_append_prefill": (
            lambda kc, vc: ka.paged_append_prefill(kc, vc, kp, vp, start,
                                                   tables[:1], layer,
                                                   page_size=PAGE),
            lambda kc, vc: ka.paged_append_prefill_plain(
                kc, vc, kp, vp, start, tables[:1], layer, PAGE),
            T, f"T={T} start={start}"),
    }
    heads = torch.arange(Hk, device="cuda")[None, :]
    ids = tables.long().gather(1, (pos.long() // PAGE)[:, None])
    rows_ragged = (ids, heads, (pos.long() % PAGE)[:, None])
    ppos = start + torch.arange(T, device="cuda")
    rows_prefill = (tables[0].long()[ppos // PAGE][:, None], heads,
                    (ppos % PAGE)[:, None])

    def scatter(kc, vc, rows, new_k, new_v):
        """The library yardstick: an index_put_ scatter of the same rows
        (indices [n, Hk] over the page, head and row axes)."""
        kc[layer].index_put_(rows, new_k.reshape(-1, Hk, D))
        vc[layer].index_put_(rows, new_v.reshape(-1, Hk, D))

    out = {}
    for name, (kern, plain, n, shape) in cases.items():
        mine = (k.clone(), v.clone())
        theirs = (k.clone(), v.clone())
        got = kern(*mine)
        ref = plain(*theirs)
        torch.cuda.synchronize()
        if got[0] is not mine[0] or got[1] is not mine[1]:
            fail(f"{name} did not return the pools it wrote")
        diff = sum(int((a != b).sum()) for a, b in zip(got, ref))
        written = int((mine[0] != k).any(dim=-1).sum())
        ms = time_ms(torch, lambda: kern(*mine))
        plain_ms = time_ms(torch, lambda: plain(*theirs))
        if name == "paged_append_ragged":
            lib = lambda: scatter(theirs[0], theirs[1], rows_ragged, kn, vn)
        else:
            lib = lambda: scatter(theirs[0], theirs[1], rows_prefill, kp, vp)
        lib_ms = time_ms(torch, lib)
        n_bytes = 2 * 2 * (2 * n * Hk * D)
        b_ms, b_by = bound(n_bytes, 0, "bf16")
        print(f"  {name} {shape}: {diff} elements differ (must be 0; {written} "
              f"K rows written) | kernel {ms:.4f} ms | plain {plain_ms:.4f} | "
              f"index_put_ {lib_ms:.4f} | bound {b_ms:.6f} ({b_by})",
              flush=True)
        if diff != 0 or written != n * Hk:
            fail(f"{name} not bit-exact: {diff} elements differ, {written} "
                 f"rows written")
        out[name] = dict(shape=shape, max_abs_err=0.0, tol=0.0, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by)
    return out


# ----------------------------------------------------------------------
# phases 4 and 5
# ----------------------------------------------------------------------

def model_check(label, lk, lp, lr, extra=""):
    """The kernel path's logits ``lk`` may be at most 1.5x as far from the
    fp32 plain run ``lr`` as the plain bf16 path's ``lp`` are."""
    if not bool(lk.isfinite().all()):
        fail(f"{label}: non-finite logits on the kernel path")
    dlogit = (lk - lp).abs().max().item()
    err_k = (lk - lr).abs().max().item()
    err_p = (lp - lr).abs().max().item()
    tol = 1.5 * err_p
    print(f"[model] 4 layers, {label}, prefill logits on the card: kernels vs "
          f"plain versions max |dlogit| {dlogit:.4g} (max|logit| "
          f"{lr.abs().max().item():.4g}) | vs the fp32 plain path: kernels "
          f"{err_k:.4g}, plain bf16 {err_p:.4g} (tol: kernels <= 1.5 x plain "
          f"= {tol:.4g}){extra}", flush=True)
    if not err_k <= tol:
        fail(f"{label}: kernel path is {err_k} from the fp32 path, > {tol}")


class Swapped:
    """Swap module attributes for the length of a ``with`` block: the smoke
    run calls the plain versions by name this way, never the wrappers."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def attention_swaps():
    """The attention and append kernels of the model replaced by their
    plain versions."""
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa

    return [(qwen, "flash_attention", fa.flash_attention_plain),
            (qwen, "paged_decode_attention_stacked",
             pa.paged_decode_attention_plain),
            (qwen, "paged_chunk_attention", ca.paged_chunk_attention_plain),
            (qwen, "paged_append_ragged", ka.paged_append_ragged_plain),
            (qwen, "paged_append_prefill", ka.paged_append_prefill_plain),
            (qwen, "chunk_attention_contiguous",
             ca.chunk_attention_contiguous_plain),
            (qwen, "chunk_attention_contiguous_q8",
             ca.chunk_attention_contiguous_q8_plain),
            (qwen, "decode_attention_contiguous",
             da.decode_attention_contiguous_plain),
            (qwen, "decode_attention_appending",
             da.decode_attention_appending_plain),
            (qwen, "decode_attention_contiguous_q8",
             da.decode_attention_contiguous_q8_plain),
            (qwen, "kv_append_uniform_q8", ka.kv_append_uniform_q8_plain)]


def plain_swaps():
    """The twelve kernels replaced by their plain versions (bf16, as the
    kernels compute)."""
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm

    return [(qm, "quant_matmul4_a8", qm.quant_matmul4_a8_plain),
            *attention_swaps()]


def f32_swaps():
    """An fp32 reference path: the plain dequant matmul of ops/linear.py
    (the code the CPU tests hold against the JAX package) in place of the
    bf16 W4A8 dispatcher, and the plain attention."""
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.linear import quant_matmul

    def stacked(x, lin, layer, act_bits=0):
        return quant_matmul(x, lin.layer_slice(layer), act_bits=act_bits)

    return [(qm, "quant_matmul_stacked", stacked), *attention_swaps()]


SERVE_LENS = [37, 120, 256, 300, 511, 512, 513, 700, 900, 1100, 1300, 1408]
SHARED = 1100       # the second wave's prefix, taken from the 1300 prompt
NEW_TOKENS = 32


def count_calls(obj, name, counter):
    """Count the calls of a method of ``obj`` (instance attribute)."""
    orig = getattr(obj, name)

    def wrapped(*a, **k):
        counter[name] = counter.get(name, 0) + 1
        return orig(*a, **k)

    setattr(obj, name, wrapped)


def run_serving(torch, np, cfg, params, wrappers, rng):
    """The serving path at the JAX defaults (8 slots, pages of 512, pieces
    of 256, prefix cache on, 8 ticks per sync): 12 greedy requests onto 8
    slots, then 4 that share an 1100-token prefix with a finished one.
    Returns the launch counts of the run and its numbers."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    # sized as `qie serve` sizes it at --max-seq 2048: 4 pages per sequence
    # and 8 x 4 + 8 pages in the pool
    cb = ContinuousBatchingEngine(
        cfg, params, max_slots=8, page_size=PAGE, num_pages=40,
        max_pages_per_seq=4, prefill_chunk=256, prefix_cache=True,
        sampling=SamplingParams(greedy=True), device="cuda")
    # random weights can argmax onto EOS and end a request early
    cb._eos = set()
    calls = {}
    for name in ("_decode_tick", "_run_piece", "_mixed_chain_batch"):
        count_calls(cb, name, calls)
    first = [rng.integers(0, cfg.vocab_size, size=n).tolist()
             for n in SERVE_LENS]
    base = first[SERVE_LENS.index(1300)][:SHARED]
    second = [base + rng.integers(0, cfg.vocab_size, size=n).tolist()
              for n in (40, 100, 150, 200)]
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = []
    for wave, prompts in enumerate((first, second)):
        for i, p in enumerate(prompts):
            cb.submit(Request(request_id=100 * wave + i, prompt=p,
                              max_new_tokens=NEW_TOKENS))
        done += cb.run_to_completion(sync_every=8)
        cb.check_page_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    snap = cb.metrics.snapshot()
    print(f"[serve] {cfg.name} {cfg.num_layers} layers, 8 slots, page {PAGE}, "
          f"pieces of 256, prefix cache on: {len(done)} requests (prompts "
          f"{SERVE_LENS} then 4 x {SHARED} shared + 40-200) in {wall:.2f} s | "
          f"TTFT p50 {snap['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{snap['ttft_p99_s'] * 1e3:.1f} ms | decode "
          f"{snap['decode_tokens_per_s']:.1f} tok/s ({snap['decode_tokens']} "
          f"tokens) | prefix hits {snap['prefix_hit_tokens']} tokens | decode "
          f"ticks {calls.get('_decode_tick', 0)}, pieces "
          f"{calls.get('_run_piece', 0)}, mixed windows "
          f"{calls.get('_mixed_chain_batch', 0)} | launches {counts}",
          flush=True)
    ids = [t for f in done for t in f.token_ids]
    bad = [f.request_id for f in done
           if f.finish_reason != "length" or len(f.token_ids) != NEW_TOKENS]
    if len(done) != 16 or bad:
        fail(f"serving: {len(done)} of 16 requests done, not by length: {bad}")
    if not all(0 <= t < cfg.vocab_size for t in ids) or len(set(ids)) < 2:
        fail("serving: ids out of range or all identical")
    must = {"quant_matmul4_a8", "flash_attention", "paged_append_prefill",
            "paged_chunk_attention", "paged_append_ragged",
            "paged_decode_attention_stacked"}
    missing = sorted(n for n in must if counts[n] <= 0)
    stray = sorted(n for n in counts if n not in must and counts[n] != 0)
    if missing or stray:
        fail(f"serving: kernels of its path not launched {missing}, "
             f"contiguous-cache kernels launched {stray}")
    L = cfg.num_layers
    ticks = calls.get("_decode_tick", 0)
    if counts["paged_decode_attention_stacked"] != L * ticks or \
            counts["paged_append_ragged"] != L * ticks:
        fail(f"serving: {ticks} decode ticks but paged decode / append "
             f"launches {counts['paged_decode_attention_stacked']} / "
             f"{counts['paged_append_ragged']} (want {L} per tick)")
    if counts["paged_append_prefill"] != L * calls.get("_run_piece", 0):
        fail("serving: one paged_append_prefill per layer per piece expected")
    if snap["prefix_hit_tokens"] < 4 * 2 * PAGE or \
            calls.get("_mixed_chain_batch", 0) == 0:
        fail(f"serving: prefix hits {snap['prefix_hit_tokens']} (want >= "
             f"{4 * 2 * PAGE}), mixed windows {calls.get('_mixed_chain_batch')}")
    resend = resend_near_max_seq(torch, cb, cfg, rng,
                                 wrappers["paged_chunk_attention"])
    window = profile_decode_window(torch, cb, cfg, rng)
    del cb
    torch.cuda.empty_cache()
    return counts, dict(wall_s=wall, ticks=ticks, **snap, **resend, **window)


def resend_near_max_seq(torch, cb, cfg, rng, chunk):
    """A 2040-token prompt (8 new tokens: the whole 4-page table) sent
    twice: the second request hits 3 whole pages and 503 rows of the
    fourth, and its last piece (start 2039, padded to 16) runs past the
    table.  Both must finish by length, the second through one paged chunk
    per layer."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import Request

    prompt = rng.integers(0, cfg.vocab_size, size=2040).tolist()
    hits0 = cb.metrics.snapshot()["prefix_hit_tokens"]
    done = []
    for rid in (300, 301):
        before = chunk.launches
        cb.submit(Request(request_id=rid, prompt=prompt, max_new_tokens=8))
        done += cb.run_to_completion(sync_every=8)
        cb.check_page_invariants()
    hits = cb.metrics.snapshot()["prefix_hit_tokens"] - hits0
    pieces = (chunk.launches - before) // cfg.num_layers
    print(f"[serve] 2040-token prompt sent twice: finish "
          f"{[(f.finish_reason, len(f.token_ids)) for f in done]}, second "
          f"request's prefix hits {hits}, its continuation pieces {pieces}, "
          f"tokens equal {done[0].token_ids == done[1].token_ids}",
          flush=True)
    if [f.request_id for f in done] != [300, 301] or any(
            f.finish_reason != "length" or len(f.token_ids) != 8 for f in done):
        fail(f"serving: the resent 2040-token prompt did not finish: "
             f"{[(f.request_id, f.finish_reason) for f in done]}")
    if hits != 2039 or pieces != 1:
        fail(f"serving: the resent prompt hit {hits} tokens (want 2039) in "
             f"{pieces} pieces (want 1)")
    return {"resend_tokens_equal": done[0].token_ids == done[1].token_ids}


def profile_decode_window(torch, cb, cfg, rng, ticks=8):
    """Where a serving decode window's time goes: 8 requests fill the 8
    slots (300-token prompts), then one chained window of ``ticks`` decode
    ticks is timed by the host clock, and the next one again under
    ``torch.profiler`` (device busy time, idle share, kernels by device
    time).  Run after the serving run's launch counts were read."""
    from torch.profiler import ProfilerActivity, profile

    from qwen_inference_engine_tpu_torch.engine.scheduler import Request

    for i in range(cb.max_slots):
        cb.submit(Request(request_id=200 + i, max_new_tokens=64,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              size=300).tolist()))
    while cb.num_pending or any(s is None or not s.prefill_done
                                for s in cb._slots):
        cb.step_batch(ticks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb.step_batch(ticks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.step_batch(ticks)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    cb.run_to_completion()
    # the profiler's own host cost stretches its window; the device work of
    # the two windows is the same, so busy / the unprofiled window is the
    # busy share without the profiler
    idle = 1 - busy_ms / prof_wall_ms
    print(f"[serve profile] a window of {ticks} decode ticks at "
          f"{cb.max_slots} busy slots: {wall_ms:.2f} ms ({wall_ms / ticks:.2f} "
          f"ms per tick); under the profiler {prof_wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms (idle share {idle:.3f} under the profiler; "
          f"busy {busy_ms / wall_ms:.3f} of the unprofiled window) | by "
          f"device time: "
          + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top),
          flush=True)
    if busy_ms <= 0:
        fail("serving profile: the profiler saw no device time")
    return dict(window_ms=wall_ms, window_ticks=ticks,
                profiled_window_ms=prof_wall_ms, device_busy_ms=busy_ms,
                idle_share_profiled=idle,
                busy_share_unprofiled=busy_ms / wall_ms)


def run_http(torch, cfg, params):
    """``Server`` on 127.0.0.1 at an ephemeral port over the same params:
    one /generate, one streamed /v1/completions, one /v1/chat/completions,
    then /stats."""
    import http.client
    import threading
    import types
    from http.server import ThreadingHTTPServer

    from qwen_inference_engine_tpu_torch.server.http import (
        Server,
        _make_handler,
    )
    from qwen_inference_engine_tpu_torch.tokenizer import ByteTokenizer

    args = types.SimpleNamespace(
        temperature=0.7, top_k=50, top_p=1.0, repetition_penalty=1.0,
        greedy=True, max_slots=8, page_size=PAGE, num_pages=0, max_seq=2048,
        kv_bits=16, seed=0, step_ticks=8, device="cuda")
    server = Server(cfg, params, ByteTokenizer(), None, args)
    server.engine._eos = set()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()

    try:
        t0 = time.perf_counter()
        st, body = call("POST", "/generate", {"prompt": "Hello, H100.",
                                              "max_new_tokens": 8})
        gen = json.loads(body)
        st2, raw = call("POST", "/v1/completions",
                        {"prompt": "Once upon a time", "max_tokens": 8,
                         "temperature": 0, "stream": True})
        # a data event per text delta (ids past the byte tokenizer's 260
        # decode to nothing), the finishing chunk, then [DONE]
        events = [e for e in raw.decode().split("\n\n") if e]
        finish = (json.loads(events[-2][6:])["choices"][0]["finish_reason"]
                  if len(events) >= 2 else None)
        st3, body3 = call("POST", "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": "Hi"}],
                           "max_tokens": 8, "temperature": 0})
        chat = json.loads(body3)
        st4, body4 = call("GET", "/stats")
        stats = json.loads(body4)
        dt = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(timeout=30)
    print(f"[http] 127.0.0.1:{port}: /generate {st} {len(gen.get('token_ids', []))} "
          f"tokens ({gen.get('finish_reason')}) | /v1/completions stream "
          f"{st2}, {len(events)} events ({finish}), last "
          f"{events[-1] if events else None} "
          f"| /v1/chat/completions {st3} "
          f"({chat.get('choices', [{}])[0].get('finish_reason')}) | /stats "
          f"{st4}: {stats.get('requests')} requests | {dt:.2f} s", flush=True)
    if (st, st2, st3, st4) != (200, 200, 200, 200) or \
            len(gen.get("token_ids", [])) != 8 or events[-1] != "data: [DONE]" \
            or finish != "length" or stats.get("requests", 0) < 3 \
            or chat.get("choices", [{}])[0].get("finish_reason") != "length":
        fail("http: a request failed or answered wrongly")
    if thread.is_alive() or server._thread.is_alive():
        fail("http: a server thread is still running")


def paged_model_check(torch, cfg4, params4, params4_f32, prompts, swaps_plain,
                      swaps_f32):
    """The 4-layer model over the page pool (pages of 512, table [3, 1]): a
    prefill in pieces of 256 (a fresh piece, then continuations at 256 and
    at 512, the second on the table's second page) of a 700-token prompt,
    then 4 decode steps there; the logits of all five, kernel path vs plain
    bf16 path vs fp32 plain path."""
    from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
    from qwen_inference_engine_tpu_torch.models import qwen

    n, pieces = 700, (0, 256, 512)
    prompt = prompts([n])[0]
    feed = prompts([4])[0]
    tables = torch.tensor([[3, 1, 0, 0]], dtype=torch.int32, device="cuda")

    def run(p, dtype):
        cache = PagedKVCache.create(cfg4.num_layers, 4, PAGE, cfg4.num_kv_heads,
                                    cfg4.head_dim, dtype=dtype, device="cuda")
        out = []
        with torch.inference_mode():
            for start in pieces:
                toks = torch.zeros((1, 256), dtype=torch.long, device="cuda")
                piece = prompt[start:start + 256]
                toks[0, :len(piece)] = torch.tensor(piece, device="cuda")
                pos = start + torch.arange(256, device="cuda")[None]
                hidden, cache = qwen.forward_hidden(
                    p, cfg4, toks, pos, cache, block_tables=tables,
                    fresh_prefill=start == 0, start=start or None)
            out.append(qwen.compute_logits(p, hidden[:, n - pieces[-1] - 1],
                                           cfg4.act_bits_lm_head))
            for i, t in enumerate(feed):
                logits, cache = qwen.decode_step(
                    p, cfg4, torch.tensor([t], device="cuda"),
                    torch.tensor([n + i], device="cuda"), cache, tables)
                out.append(logits)
        return torch.cat(out, 0)

    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca

    before = ca.paged_chunk_attention.launches
    lk = run(params4, torch.bfloat16)
    if ca.paged_chunk_attention.launches - before != 2 * cfg4.num_layers:
        fail("the paged model check did not run its continuation piece "
             "through paged_chunk_attention")
    with Swapped(swaps_plain):
        lp = run(params4, torch.bfloat16)
    with Swapped(swaps_f32):
        lr = run(params4_f32, torch.float32)
    model_check(f"paged bf16 KV, pieces at {pieces} of a {n}-token prompt "
                f"across two pages, then 4 decode steps", lk, lp, lr)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.engine.engine import Engine, _bucket
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    t_start = time.perf_counter()
    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {lib_path} in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "smem" in line:
                print("  " + line.strip())

    # ---- 3. kernels vs plain versions at the Qwen2.5-7B shapes
    cfg = PRESETS["qwen2.5-7b"]
    gs = 256
    print("[kernels] each against its plain version on the card", flush=True)
    qmm_recs = check_quant_matmul(torch, cfg, gs)
    # the kernel must also take every projection of the 14B preset
    qmm_14b = check_quant_matmul(torch, PRESETS["qwen2.5-14b"], gs, ms_list=(4,))
    flash_recs = check_flash(torch, cfg)
    dec_recs = check_decode(torch, cfg)
    chunk_recs = check_chunk(torch, cfg)
    append_recs = check_kv_append(torch, cfg)
    dec8_recs = check_decode_q8(torch, cfg)
    paged_recs = {**check_paged_decode(torch, cfg),
                  **check_paged_chunk(torch, cfg),
                  **check_paged_appends(torch, cfg)}
    torch.cuda.empty_cache()

    # ---- 4. end to end: Qwen2.5-7B, full depth, W4A8 gs 256, bf16 KV
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=gs))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg8 = cfg.replace(act_bits=8)
    print(f"[e2e] {cfg.name}: {cfg.num_layers} layers, params built and "
          f"quantized in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    eng = Engine(cfg8, params, max_batch=4, max_seq=1024,
                 kv_dtype=torch.bfloat16, sampling=SamplingParams(greedy=True),
                 device="cuda")
    rng = np.random.default_rng(0)

    def prompts(lengths):
        return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]

    eng.generate(prompts([16, 16, 16, 16]), max_new_tokens=2)  # warm-up
    wrappers = {"quant_matmul4_a8": qm.quant_matmul4_a8,
                "flash_attention": fa.flash_attention,
                "decode_attention_contiguous": da.decode_attention_contiguous,
                "decode_attention_appending": da.decode_attention_appending,
                "chunk_attention_contiguous": ca.chunk_attention_contiguous,
                "chunk_attention_contiguous_q8":
                    ca.chunk_attention_contiguous_q8,
                "kv_append_uniform_q8": ka.kv_append_uniform_q8,
                "decode_attention_contiguous_q8":
                    da.decode_attention_contiguous_q8,
                "paged_decode_attention_stacked":
                    pa.paged_decode_attention_stacked,
                "paged_chunk_attention": ca.paged_chunk_attention,
                "paged_append_ragged": ka.paged_append_ragged,
                "paged_append_prefill": ka.paged_append_prefill}
    paged = {"paged_decode_attention_stacked", "paged_chunk_attention",
             "paged_append_ragged", "paged_append_prefill"}
    engines = {
        "bf16": eng,
        "bf16 long": Engine(cfg8, params, max_batch=4, max_seq=2304,
                            kv_dtype=torch.bfloat16,
                            sampling=SamplingParams(greedy=True),
                            device="cuda"),
        "int8 long": Engine(cfg8, params, max_batch=4, max_seq=2304,
                            kv_dtype=torch.int8,
                            sampling=SamplingParams(greedy=True),
                            device="cuda"),
    }
    # run, engine, prompt lengths, kernels that must run, kernels that must not
    bf16_dec = {"decode_attention_contiguous", "decode_attention_appending"}
    q8 = {"chunk_attention_contiguous_q8", "kv_append_uniform_q8",
          "decode_attention_contiguous_q8"}
    plan = [
        ("ragged", "bf16", [37, 120, 300, 500],
         {"flash_attention", "decode_attention_contiguous"},
         {"decode_attention_appending", "chunk_attention_contiguous"} | q8),
        ("aligned", "bf16", [256] * 4,
         {"flash_attention", "decode_attention_appending"},
         {"decode_attention_contiguous", "chunk_attention_contiguous"} | q8),
        ("bf16 aligned long", "bf16 long", [1408] * 4,
         {"flash_attention", "chunk_attention_contiguous",
          "decode_attention_appending"},
         {"decode_attention_contiguous"} | q8),
        ("bf16 ragged long", "bf16 long", [700, 1100, 1408, 1900],
         {"flash_attention", "chunk_attention_contiguous",
          "decode_attention_contiguous"},
         {"decode_attention_appending"} | q8),
        ("int8 aligned long", "int8 long", [1408] * 4,
         {"flash_attention"} | q8,
         {"chunk_attention_contiguous"} | bf16_dec),
        ("int8 ragged long", "int8 long", [37, 600, 1408, 1900],
         {"flash_attention", "chunk_attention_contiguous_q8",
          "decode_attention_contiguous_q8"},
         {"chunk_attention_contiguous", "kv_append_uniform_q8"} | bf16_dec),
    ]
    launches = {n: 0 for n in wrappers}
    runs = {}
    for label, which, lengths, must, must_not in plan:
        for w in wrappers.values():
            w.launches = 0
        res = engines[which].generate(prompts(lengths), max_new_tokens=32)
        counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in counts.items():
            launches[n] += c
        ids = [t for row in res.token_ids for t in row]
        print(f"[e2e] {label} {lengths}: ttft {res.ttft_s * 1e3:.1f} ms | "
              f"decode {res.decode_tokens_per_s:.1f} tok/s | steps "
              f"{res.steps} | launches {counts}", flush=True)
        print(f"      first ids {[row[:8] for row in res.token_ids]}")
        if not all(0 <= t < cfg.vocab_size for t in ids) or len(set(ids)) < 2:
            fail(f"{label}: ids out of range or all identical")
        missing = sorted(n for n in must | {"quant_matmul4_a8"}
                         if counts[n] <= 0)
        stray = sorted(n for n in must_not | paged if counts[n] != 0)
        if missing or stray:
            fail(f"{label}: kernels of its path not launched {missing}, "
                 f"kernels of other paths launched {stray}")
        # one continuation per layer for each 512-token chunk after the
        # first of the prompt bucket
        want_chunks = cfg.num_layers * max(_bucket(max(lengths)) // 512 - 1, 0)
        got_chunks = counts["chunk_attention_contiguous"] + \
            counts["chunk_attention_contiguous_q8"]
        if got_chunks != want_chunks:
            fail(f"{label}: {got_chunks} continuation-chunk launches, "
                 f"expected {want_chunks}")
        runs[label] = dict(lengths=lengths, ttft_ms=res.ttft_s * 1e3,
                           decode_tok_s=res.decode_tokens_per_s,
                           steps=res.steps, launches=counts)
    del engines, eng
    torch.cuda.empty_cache()

    # ---- 4b. serving: ContinuousBatchingEngine at full depth, then HTTP
    serve_counts, serve_stats = run_serving(torch, np, cfg8, params, wrappers,
                                            rng)
    for n, c in serve_counts.items():
        launches[n] += c
    run_http(torch, cfg8, params)
    torch.cuda.empty_cache()
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")

    # ---- 5. kernel path vs plain path, whole model at depth 4
    L4 = 4
    cfg4 = cfg8.replace(num_layers=L4)

    params4 = dict(params, layers=qwen.map_params(params["layers"],
                                                  lambda t: t[:L4]))
    p_lens = [37, 120, 300, 500]
    p_ids = prompts(p_lens)
    toks = torch.zeros((4, 512), dtype=torch.long, device="cuda")
    for i, p in enumerate(p_ids):
        toks[i, :len(p)] = torch.tensor(p, device="cuda")
    lens_t = torch.tensor(p_lens, device="cuda")

    def run_prefill(p, dtype, toks=toks, lens_t=lens_t):
        cache = KVCache.create(L4, 4, 1024, cfg.num_kv_heads, cfg.head_dim,
                               dtype=dtype, device="cuda")
        with torch.inference_mode():
            return qwen.prefill_chunked(p, cfg4, toks, lens_t, cache,
                                        chunk=512)[0]

    e4 = Engine(cfg4, params4, max_batch=4, max_seq=1024,
                sampling=SamplingParams(greedy=True), device="cuda")
    lk = run_prefill(params4, torch.bfloat16)
    tk = e4.generate(p_ids, max_new_tokens=8).token_ids
    with Swapped(plain_swaps()):
        lp = run_prefill(params4, torch.bfloat16)
        tp = e4.generate(p_ids, max_new_tokens=8).token_ids
    params4_f32 = qwen.map_params(
        params4, lambda t: t.float() if t.is_floating_point() else t)
    with Swapped(f32_swaps()):
        lr = run_prefill(params4_f32, torch.float32)
    agree = sum(a == b for x, y in zip(tk, tp) for a, b in zip(x, y))
    total = sum(len(y) for y in tp)
    model_check("bf16 KV, one chunk", lk, lp, lr,
                f" | greedy tokens agree {agree}/{total}")

    # INT8 KV over two chunks: a fresh prefill, then a continuation
    q_lens = [600, 700, 900, 1000]
    toks8 = torch.zeros((4, 1024), dtype=torch.long, device="cuda")
    for i, p in enumerate(prompts(q_lens)):
        toks8[i, :len(p)] = torch.tensor(p, device="cuda")
    lens8 = torch.tensor(q_lens, device="cuda")
    before = ca.chunk_attention_contiguous_q8.launches
    lk8 = run_prefill(params4, torch.int8, toks8, lens8)
    if ca.chunk_attention_contiguous_q8.launches - before != L4:
        fail("the INT8-KV model check did not run its continuation chunk "
             "through chunk_attention_contiguous_q8")
    with Swapped(plain_swaps()):
        lp8 = run_prefill(params4, torch.int8, toks8, lens8)
    with Swapped(f32_swaps()):
        lr8 = run_prefill(params4_f32, torch.int8, toks8, lens8)
    model_check(f"INT8 KV, prompts {q_lens}, two chunks", lk8, lp8, lr8)
    paged_model_check(torch, cfg4, params4, params4_f32, prompts,
                      plain_swaps(), f32_swaps())

    # ---- 6. results
    sources = {
        "quant_matmul4_a8": ("csrc/quant_matmul.cu",
                             "qwen_inference_engine_tpu/ops/quant_matmul.py:219"),
        "flash_attention": ("csrc/flash_attention.cu",
                            "qwen_inference_engine_tpu/ops/flash_attention.py:125"),
        "decode_attention_contiguous": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:345"),
        "decode_attention_appending": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:692"),
        "chunk_attention_contiguous": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:116"),
        "chunk_attention_contiguous_q8": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:225"),
        "kv_append_uniform_q8": (
            "csrc/kv_append.cu",
            "qwen_inference_engine_tpu/ops/kv_append.py:198"),
        "decode_attention_contiguous_q8": (
            "csrc/decode_attention.cu",
            "qwen_inference_engine_tpu/ops/decode_attention.py:319"),
        "paged_decode_attention_stacked": (
            "csrc/paged_attention.cu",
            "qwen_inference_engine_tpu/ops/paged_attention.py:167"),
        "paged_chunk_attention": (
            "csrc/chunk_attention.cu",
            "qwen_inference_engine_tpu/ops/chunk_attention.py:477"),
        "paged_append_ragged": (
            "csrc/kv_append.cu", "qwen_inference_engine_tpu/ops/kv_append.py:488"),
        "paged_append_prefill": (
            "csrc/kv_append.cu", "qwen_inference_engine_tpu/ops/kv_append.py:718"),
    }
    # kernel 1 is reported per decode layer: its seven projections at M=4
    dec = [r for r in qmm_recs if r["M"] == 4]  # 7B only
    b_bytes = sum(r["bound_ms"] for r in dec if r["bound_by"] == "bytes")
    layer_rec = dict(
        max_abs_err=max(r["max_abs_err"] for r in qmm_recs + qmm_14b),
        ms=sum(r["ms"] for r in dec), plain_ms=sum(r["plain_ms"] for r in dec),
        library_ms=sum(r["library_ms"] for r in dec),
        bound_ms=sum(r["bound_ms"] for r in dec),
        bound_by="bytes" if b_bytes * 2 >= sum(r["bound_ms"] for r in dec)
        else "operations",
        unit="the 7 projections of one layer at M=4")
    recs = {"quant_matmul4_a8": layer_rec,
            "flash_attention": flash_recs[0], **dec_recs, **chunk_recs,
            **append_recs, **dec8_recs, **paged_recs}
    kernels = []
    for name, rec in recs.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "qwen_inference_engine_tpu_torch/" + src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec.get("shape", rec.get("unit")),
            **({"gather_ms": rec["gather_ms"]} if "gather_ms" in rec else {})})
    print(f"[done] {time.perf_counter() - t_start:.1f} s | serving "
          f"{json.dumps(serve_stats)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
