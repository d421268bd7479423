"""Time the PyTorch port's decode attentions, fused attention + MLP, fused
attention + matmul and KV appends on the card, and fingerprint every
kernel's output.

    python3 scripts/time_decode_fused_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``): its ``qwen_inference_engine_tpu_torch`` package is built
and timed with its ``chip_smoke.py``'s timers (CUDA events around each
call; a CUDA graph of 20 calls replayed 5 times), so two commits compare in
one call to the card.  Shapes are Qwen2.5-7B's, inputs seeded random:

* ``decode_attention_contiguous_q8``: B = 4 at lengths 69 / 700 / 1408 /
  2000 of S 2304 (``check_decode_q8``) and 37 / 120 / 300 / 500 of S 1024
  (run (c)'s decode), a call and in a CUDA graph, and the SHA-256 of the
  output;
* ``decode_attention_appending`` and ``decode_attention_contiguous_fresh``
  (old lengths = the position): B = 4 at position 999 of S 1024
  (``check_decode``) and B = 192 at 272 of S 512 (the batch-192 default
  dispatch), a call and in a CUDA graph, beside SDPA over the first
  position + 1 keys in a CUDA graph, and whether the two outputs are
  bit-equal; ``decode_attention_contiguous`` (the ragged decode) at
  ``check_decode``'s lengths 69 / 152 / 332 / 1000 of S 1024, a call and
  in a CUDA graph, beside SDPA masked to those lengths in a CUDA graph,
  and the SHA-256 of its output;
* ``fused_attn_mlp``: 96 rows from row 96 of a 192-row cache (lens 257,
  S 512) beside the pumped weights' MLP (gs 256 / 128) on Mb = 96 and 40
  rows, a call and in a CUDA graph;
* ``fused_attn_matmul`` at ``chip_smoke.PROBE`` (56 rows of a 112-row
  cache at lens 1017 of S 1024 beside the 7B gate projection, K 3584,
  N 18944, INT4 gs 256) from row 0 and row 56, a call and in a CUDA
  graph, with its plan where the tree has one and the SHA-256 of both
  outputs; its two parts alone (``decode_attention_contiguous`` on the
  56-row cache, ``quant_matmul4`` at M 56) and the yardstick (SDPA masked
  to the lengths + bf16 ``torch.matmul`` over the dequantized slab), each
  a call and in a CUDA graph;
* the seven KV appends, a call and in a CUDA graph, each beside its
  yardstick a call and in a CUDA graph (slice assignment, or
  ``index_put_`` for the per-row and paged ones), with the bound (bytes at
  3.35 TB/s) and, for the two uniform appends, the SHA-256 of the caches
  they wrote (the all-layer append at 192 rows also with L2 cold: each
  call after a 128 MB write, less the write): ``kv_append_uniform`` (the pumped half batch: 96 rows from
  row 96 of 192, position 257 of 512), ``kv_append_all_uniform`` (28
  layers x 192 rows at 257 of 512; 28 x 4 at 1023 of 1024),
  ``kv_append_uniform_q8`` (B 4 at 1999 of 2304), ``kv_append_ragged_t``
  (B 4 of S 1024, T 1, 5 and 17, bf16 and int8; these two with the
  SHA-256 of the caches and scales after their calls),
  ``paged_append_ragged``
  (8 slots), ``paged_append_ragged_t`` (8 rows, T 5 and 17) and
  ``paged_append_prefill`` (T 256 at 384), the paged ones into bf16 and
  int8 pools of pages of 512 (``chip_smoke``'s shapes) with the SHA-256
  of the pools and scales after each one's calls; and the launch floor,
  a one-element ``zero_()`` timed the same way;
* ``flash_attention`` (B 4, T 512) and ``chunk_attention_contiguous`` /
  ``_q8`` (B 4, T 512 at start 1536 of S 2048): a call's time and the
  SHA-256 of the output's bytes, equal between two commits whose kernels
  compute the same bits;
* ``sha256``: the SHA-256 of the kernels that share the matmul body
  (``time_grouped_torch.bodies``: the four dense matmuls, ``fused_mlp``,
  ``fused_attn_mlp`` and ``fused_attn_matmul``) and of the three grouped
  matmuls at M 256; ``ptxas``: every kernel's registers and spills from
  the build's log (``time_paged_torch.registers``).

Run it for an archive of each of two commits in one call to the card
(parent, change, change, parent).  Prints one JSON object (and writes it
to OUT.json when given), with the card's name and power limit.  Needs a
CUDA device.
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
        print("time_decode_fused_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
    from time_grouped_torch import bodies
    from time_paged_torch import registers

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    Hq, Hk, D, K, F = 28, 4, 128, 3584, 18944
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {"root": root, "card": card}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def timed(fn):
        return {"ms": cs.time_ms(torch, fn), "graph_ms": cs.graph_ms(torch, fn)}

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    for S, lens_list in ((2304, [69, 700, 1408, 2000]),
                         (1024, [37, 120, 300, 500])):
        k8, ks = cs._int8(torch, g, (2, 4, Hk, S, D))
        v8, vs = cs._int8(torch, g, (2, 4, Hk, S, D))
        q = rnd(4, 1, Hq, D)
        lens = torch.tensor(lens_list, device="cuda")
        rec = timed(lambda: da.decode_attention_contiguous_q8(
            q, k8, v8, ks, vs, 1, lens))
        rec["sha256"] = digest(da.decode_attention_contiguous_q8(
            q, k8, v8, ks, vs, 1, lens))
        out[f"decode_attention_contiguous_q8 S{S}"] = rec
        del k8, v8, ks, vs
    for B, S, pos in ((4, 1024, 999), (192, 512, 272)):
        kc, vc = rnd(2, B, Hk, S, D), rnd(2, B, Hk, S, D)
        q, kn, vn = rnd(B, 1, Hq, D), rnd(B, 1, Hk, D), rnd(B, 1, Hk, D)
        old = torch.full((B,), pos, dtype=torch.int32, device="cuda")
        sdpa = cs._sdpa(torch, q.transpose(1, 2), kc[1, :, :, :pos + 1],
                        vc[1, :, :, :pos + 1])
        sdpa_graph = cs.graph_ms(torch, sdpa)
        app = timed(lambda: da.decode_attention_appending(q, kc, vc, kn, vn,
                                                          1, pos))
        fresh = timed(lambda: da.decode_attention_contiguous_fresh(
            q, kc, vc, kn, vn, 1, old))
        a = da.decode_attention_appending(q, kc, vc, kn, vn, 1, pos)[0]
        f = da.decode_attention_contiguous_fresh(q, kc, vc, kn, vn, 1, old)
        out[f"decode_attention_appending B{B}"] = dict(
            app, sdpa_graph_ms=sdpa_graph, sha256=digest(a))
        out[f"decode_attention_contiguous_fresh B{B}"] = dict(
            fresh, sdpa_graph_ms=sdpa_graph, bit_equal_to_appending=bool(
                torch.equal(a, f)))
        if B == 4:
            lens = torch.tensor([69, 152, 332, 1000], device="cuda")
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            out["decode_attention_contiguous"] = dict(
                timed(lambda: da.decode_attention_contiguous(
                    q, kc, vc, 1, lens)),
                sdpa_graph_ms=cs.graph_ms(torch, cs._sdpa(
                    torch, q.transpose(1, 2), kc[1], vc[1], mask=mask)),
                sha256=digest(da.decode_attention_contiguous(
                    q, kc, vc, 1, lens)))
        del kc, vc
    Ba, Bc, S = 96, 192, 512
    kc, vc = rnd(2, Bc, Hk, S, D), rnd(2, Bc, Hk, S, D)
    w, _ = cs._mlp_stack(torch, g, K, F, 256, 128)
    lens = torch.full((Ba,), 257, dtype=torch.int32, device="cuda")
    q = rnd(Ba, 1, Hq, D)
    for Mb in (96, 40):
        x = rnd(Mb, K)
        out[f"fused_attn_mlp Mb{Mb}"] = timed(
            lambda: fs.fused_attn_mlp(lens, 1, 1, q, kc, vc, x, *w,
                                      gs_gate=256, gs_down=128, row0=Ba))
    del kc, vc, w
    qf, kf, vf = rnd(4, 512, Hq, D), rnd(4, 512, Hk, D), rnd(4, 512, Hk, D)
    out["flash_attention"] = {
        "ms": cs.time_ms(torch, lambda: fa.flash_attention(qf, kf, vf)),
        "sha256": digest(fa.flash_attention(qf, kf, vf))}
    kc, vc = rnd(2, 4, Hk, 2048, D), rnd(2, 4, Hk, 2048, D)
    k8, ks = cs._int8(torch, g, (2, 4, Hk, 2048, D))
    v8, vs = cs._int8(torch, g, (2, 4, Hk, 2048, D))
    out["chunk_attention_contiguous"] = {
        "ms": cs.time_ms(torch, lambda: ca.chunk_attention_contiguous(
            qf, kc, vc, 1, 1536)),
        "sha256": digest(ca.chunk_attention_contiguous(qf, kc, vc, 1, 1536))}
    out["chunk_attention_contiguous_q8"] = {
        "ms": cs.time_ms(torch, lambda: ca.chunk_attention_contiguous_q8(
            qf, k8, v8, ks, vs, 1, 1536)),
        "sha256": digest(ca.chunk_attention_contiguous_q8(
            qf, k8, v8, ks, vs, 1, 1536))}
    del qf, kf, vf, kc, vc, k8, v8, ks, vs
    torch.cuda.empty_cache()
    fused_attn_matmul(torch, cs, fs, da, qm, out, timed, digest)
    torch.cuda.empty_cache()
    appends(torch, cs, out, timed, digest)
    torch.cuda.empty_cache()
    out["sha256"] = bodies(torch, cs, fs, qm, qm.quantize_activations,
                           torch.Generator(device="cuda").manual_seed(9),
                           digest)
    out["sha256"].update(grouped(torch, cs, digest))
    out["ptxas"] = registers(os.path.join(os.path.dirname(cuda_lib.build()),
                                          "build.log"))
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            f.write(text)
    return 0


def fused_attn_matmul(torch, cs, fs, da, qm, out, timed, digest):
    """fused_attn_matmul at the probe from rows 0 and 56, its two parts
    alone and the yardstick, each a call and in a CUDA graph."""
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.ops.linear import (
        QuantLinear,
        dequantize,
    )

    cfg = PRESETS["qwen2.5-7b"]
    p = cs.PROBE
    o = cs._probe_operands(torch, cfg)
    Ba, S, gs = p["Ba"], p["S"], p["gs"]
    K, N = cfg.hidden_size, cfg.intermediate_size
    plan = getattr(fs, "plan_fused_attn_matmul", None)
    for row0 in (0, Ba):
        def call():
            return fs.fused_attn_matmul(o["lens"], 1, o["q"], o["kc"],
                                        o["vc"], o["x"], o["wq"], o["ws"],
                                        group_size=gs, row0=row0)

        attn, y = call()
        out[f"fused_attn_matmul row0 {row0}"] = dict(
            timed(call), sha256=[digest(attn), digest(y)],
            plan=plan(p["Mb"], K, N, gs) if plan else None)
    kc_a = o["kc"][:, :Ba].contiguous()
    vc_a = o["vc"][:, :Ba].contiguous()
    out["probe decode_attention_contiguous"] = timed(
        lambda: da.decode_attention_contiguous(o["q"], kc_a, vc_a, 1,
                                               o["lens"]))
    out["probe quant_matmul4"] = timed(
        lambda: qm.quant_matmul4(o["x"], o["wq"], o["ws"], 1, gs))
    deq = dequantize(QuantLinear(q=o["wq"][1], scales=o["ws"][1], b=None,
                                 bits=4, group_size=gs))
    mask = (torch.arange(S, device="cuda") < S - 7)[None, None, None, :]
    sdpa = cs._sdpa(torch, o["q"].transpose(1, 2), o["kc"][1, :Ba],
                    o["vc"][1, :Ba], mask=mask)
    out["probe yardstick sdpa + matmul"] = timed(
        lambda: (sdpa(), torch.matmul(o["x"], deq)))


def appends(torch, cs, out, timed, digest):
    """The seven KV appends beside their yardsticks, a call and in a CUDA
    graph, with the byte bound."""
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.ops import kv_append as ka
    from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv

    cfg = PRESETS["qwen2.5-7b"]
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(23)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    def record(kernel, library, n_bytes, caches=None):
        rec = dict(timed(kernel), library=timed(library),
                   bound_ms=cs.bound(n_bytes, 0, "bf16")[0])
        if caches is not None:
            rec["sha256"] = [digest(c) for c in caches]
        return rec

    # the pumped half batch
    L, Bc, S, pos, layer, Bn = 2, 192, 512, 257, 1, 96
    kc, vc = rnd(L, Bc, Hk, S, D), rnd(L, Bc, Hk, S, D)
    kn, vn = rnd(Bn, 1, Hk, D), rnd(Bn, 1, Hk, D)
    pos_t = torch.tensor([pos], device="cuda", dtype=torch.int32)
    ka.kv_append_uniform(kc, vc, kn, vn, pos_t, layer, row0=Bn)

    def library():
        kc[layer, Bn:, :, pos] = kn[:, 0]
        vc[layer, Bn:, :, pos] = vn[:, 0]

    out["kv_append_uniform Bn96"] = record(
        lambda: ka.kv_append_uniform(kc, vc, kn, vn, pos_t, layer, row0=Bn),
        library, 2 * 2 * 2 * Bn * Hk * D, (kc, vc))
    del kc, vc
    # every layer at once: the deferred decode step, and B 4
    for B, S, pos in ((192, 512, 257), (4, 1024, 1023)):
        L = cfg.num_layers
        kc, vc = rnd(L, B, Hk, S, D), rnd(L, B, Hk, S, D)
        kn, vn = rnd(L, B, 1, Hk, D), rnd(L, B, 1, Hk, D)
        pos_t = torch.tensor([pos], device="cuda", dtype=torch.int32)
        ka.kv_append_all_uniform(kc, vc, kn, vn, pos_t)
        digests = [digest(kc), digest(vc)]

        def library():
            kc[:, :, :, pos] = kn[:, :, 0]
            vc[:, :, :, pos] = vn[:, :, 0]

        rec = dict(record(
            lambda: ka.kv_append_all_uniform(kc, vc, kn, vn, pos_t), library,
            2 * 2 * 2 * L * B * Hk * D + 4), sha256=digests)
        if B == 192:
            # 22 MB stay in the 50 MB L2 from one replay to the next: also
            # time each call after a 128 MB write that evicts them, less
            # that write alone
            rec["cold_graph_ms"] = cold_graph_ms(
                torch, cs, lambda: ka.kv_append_all_uniform(kc, vc, kn, vn,
                                                            pos_t))
            rec["library"]["cold_graph_ms"] = cold_graph_ms(torch, cs,
                                                            library)
        out[f"kv_append_all_uniform L{L} B{B}"] = rec
        del kc, vc
        torch.cuda.empty_cache()
    # the INT8-KV uniform append: B 4 at 1999 of 2304
    L, B, S, pos = 2, 4, 2304, 1999
    k8, ks = cs._int8(torch, g, (L, B, Hk, S, D))
    v8, vs = cs._int8(torch, g, (L, B, Hk, S, D))
    kn, ksn = quantize_kv(torch.randn((B, 1, Hk, D), generator=g,
                                      device="cuda"))
    vn, vsn = quantize_kv(torch.randn((B, 1, Hk, D), generator=g,
                                      device="cuda"))
    new = (kn, vn, ksn, vsn)
    pos_t = torch.tensor([pos], device="cuda", dtype=torch.int32)

    def library():
        for cache, x in zip((k8, v8, ks, vs), new):
            cache[layer, :, :, pos] = x[:, 0]

    # the caches and scales as the kernel's calls left them, before the
    # yardstick writes the same bytes
    rec = timed(lambda: ka.kv_append_uniform_q8(k8, v8, ks, vs, *new, pos_t,
                                                layer))
    rec["sha256"] = [digest(t) for t in (k8, v8, ks, vs)]
    rec.update(library=timed(library), bound_ms=cs.bound(
        2 * (2 * B * Hk * D + 2 * 4 * B * Hk), 0, "bf16")[0])
    out["kv_append_uniform_q8 B4"] = rec
    del k8, v8, ks, vs
    # the ragged decode's write (T 1), the verify's window (T 5) and a
    # window wider than 16 (T 17), bf16 and int8
    S = 1024
    for T, quant in ((1, False), (5, False), (1, True), (5, True),
                     (17, False), (17, True)):
        starts_l = [32, S - T, S - 2 if T > 1 else 500, 0]
        if quant:
            (kc, ks), (vc, vs) = (cs._int8(torch, g, (2, 4, Hk, S, D))
                                  for _ in range(2))
            (kn, ksn), (vn, vsn) = (quantize_kv(torch.randn(
                (4, T, Hk, D), generator=g, device="cuda")) for _ in range(2))
            caches, news = (kc, vc, ks, vs), (kn, vn, ksn, vsn)
            kw = dict(k_scale=ks, v_scale=vs, ks_new=ksn, vs_new=vsn)
        else:
            caches, news = (rnd(2, 4, Hk, S, D), rnd(2, 4, Hk, S, D)), (
                rnd(4, T, Hk, D), rnd(4, T, Hk, D))
            kw = {}
        starts = torch.tensor(starts_l, device="cuda", dtype=torch.int32)
        src = [(b, t) for b, p in enumerate(starts_l)
               for t in range(min(T, S - p))]
        bi = torch.tensor([b for b, _ in src], device="cuda")
        ti = torch.tensor([t for _, t in src], device="cuda")
        pi = torch.tensor([starts_l[b] + t for b, t in src], device="cuda")

        def library(caches=caches, news=news, bi=bi, ti=ti, pi=pi):
            for c, n in zip(caches, news):
                c[layer, bi, :, pi] = n[bi, ti]

        elem = 1 if quant else 2
        n_bytes = 2 * 2 * len(src) * Hk * (D * elem + (4 if quant else 0))
        rec = timed(lambda caches=caches, news=news, starts=starts, kw=kw:
                    ka.kv_append_ragged_t(caches[0], caches[1], news[0],
                                          news[1], starts, layer, **kw))
        rec["sha256"] = [digest(c) for c in caches]
        rec.update(library=timed(library),
                   bound_ms=cs.bound(n_bytes, 0, "bf16")[0])
        out[f"kv_append_ragged_t T{T}{' int8' if quant else ''}"] = rec
        del caches, news
    # the paged appends (bf16 and int8 pools of pages of 512)
    k, v, tables = cs._paged_pool(torch, cfg, g)
    k, v = k.nan_to_num(), v.nan_to_num()
    k8, v8, ks, vs = cs._q8_pool(torch, k, v)
    B, page = len(cs.PAGED_LENS), cs.PAGE
    positions = torch.tensor(cs.PAGED_LENS, device="cuda",
                             dtype=torch.int32) - 1
    starts = torch.tensor(cs.VERIFY_STARTS, device="cuda", dtype=torch.int32)
    T, start = 256, 384
    keep = [b for b, s in enumerate(cs.VERIFY_STARTS) if s >= 0]

    def window(n):
        return [(b, t, cs.VERIFY_STARTS[b] + t) for b in keep
                for t in range(n)]

    cases = {
        "paged_append_ragged": ((B, 1), positions, tables,
                                [(b, 0, int(cs.PAGED_LENS[b]) - 1)
                                 for b in range(B)]),
        "paged_append_ragged_t": ((B, cs.SPEC_T), starts, tables,
                                  window(cs.SPEC_T)),
        "paged_append_ragged_t T17": ((B, 17), starts, tables, window(17)),
        "paged_append_prefill": ((1, T), start, tables[:1],
                                 [(0, t, start + t) for t in range(T)])}
    heads = torch.arange(Hk, device="cuda")[None, :]
    for case, (shape, at, tab, toks) in cases.items():
        fn = getattr(ka, case.split()[0])
        x = rnd(*shape, Hk, D)
        xq, xs = quantize_kv(x)
        b_idx = torch.tensor([b for b, _, _ in toks], device="cuda")
        t_idx = torch.tensor([t for _, t, _ in toks], device="cuda")
        p_idx = torch.tensor([q for _, _, q in toks], device="cuda")
        ids = tab.long()[b_idx, p_idx // page][:, None]
        rows = (ids, heads, (p_idx % page)[:, None])
        for quant in (False, True):
            pools = (k8, v8, ks, vs) if quant else (k, v)
            nk = xq if quant else x
            kw = dict(k_scale=ks, v_scale=vs, ks_new=xs,
                      vs_new=xs) if quant else {}

            def kernel(fn=fn, pools=pools, nk=nk, at=at, tab=tab, kw=kw):
                fn(pools[0], pools[1], nk, nk, at, tab, layer,
                   page_size=page, **kw)

            def library(pools=pools, nk=nk, quant=quant):
                for pool in pools[:2]:
                    pool[layer].index_put_(rows, nk[b_idx, t_idx])
                if quant:
                    for sc in pools[2:]:
                        sc[layer].index_put_(rows, xs[b_idx, t_idx])

            elem = 1 if quant else 2
            n_bytes = 2 * 2 * len(toks) * Hk * (D * elem
                                                + (4 if quant else 0))
            # the pools and scales as the kernel's calls left them (every
            # case so far written by the kernels, then by index_put_ with
            # the same bytes), before the yardstick runs
            rec = timed(kernel)
            rec["sha256"] = [digest(t) for t in pools]
            rec.update(library=timed(library),
                       bound_ms=cs.bound(n_bytes, 0, "bf16")[0])
            out[f"{case}{' int8' if quant else ''}"] = rec
    # the launch floor: a one-element zero_() timed the same way
    one = torch.zeros(1, device="cuda")
    out["launch floor zero_"] = timed(one.zero_)


def cold_graph_ms(torch, cs, fn):
    """A call's device time in a CUDA graph with L2 cold: each call after a
    128 MB write (2.5 times the H100's L2), less the write alone."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def both():
        flush.zero_()
        fn()

    return cs.graph_ms(torch, both) - cs.graph_ms(torch, flush.zero_)


def grouped(torch, cs, digest):
    """The SHA-256 of the three grouped matmuls at M 256 (Qwen3-30B-A3B's
    gate projection, 128 experts, top-8), which share the matmul body."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
        quantize_activations,
    )

    g = torch.Generator(device="cuda").manual_seed(15)
    E, top, L, layer, K, N, M = 128, 8, 2, 1, 2048, 768, 256
    gsz = cs._routing(torch, g, M // top, E, top)
    q4 = torch.randint(-128, 128, (L, E, K // 2, N), generator=g,
                       device="cuda", dtype=torch.int8)
    s4 = torch.rand((L, E, K // 256, N), generator=g, device="cuda") \
        * (2 * K ** -0.5 / 7)
    q8 = torch.randint(-127, 128, (L, E, K, N), generator=g, device="cuda",
                       dtype=torch.int8)
    s8 = torch.rand((L, E, K // 128, N), generator=g, device="cuda") \
        * (2 * K ** -0.5 / 127)
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    xq, sx = quantize_activations(x)
    sx = sx.reshape(-1).contiguous()
    return {
        "grouped_matmul8 M256": digest(gm.grouped_matmul8(x, q8, s8, gsz,
                                                          layer)),
        "grouped_matmul4_a8 M256": digest(gm.grouped_matmul4_a8(
            xq, sx, q4, s4, gsz, layer, 256)),
        "grouped_matmul4 M256": digest(gm.grouped_matmul4(x, q4, s4, gsz,
                                                          layer, 256))}


if __name__ == "__main__":
    raise SystemExit(main())
