"""The plain versions of the INT8 page pool's and the speculative verify's
paged kernels against the JAX package's Pallas kernels in interpreter mode.

``_paged_bhgd_q8`` (decode and verify), the verify shape of
``_paged_bhgd``, ``paged_chunk_attention_q8``, ``paged_append_ragged_t``
(bf16, f32 and int8 pools) and the int8 instantiations of the two paged
appends (ragged and prefill), whose scale writes the JAX package leaves to XLA
(``paged_write_stacked``).  The port's wrappers run their plain versions
for CPU tensors; the CUDA kernels are held against the same plain versions
on the card by chip_smoke.py and tests/test_torch_cuda_kernels.py.
Tolerances: 2e-3 for the attentions in f32.  The q8 Pallas kernels cast
the queries and P * v_scale to bf16 and return bf16, so against them the
port's f32 plain versions also get one bf16 step of each value (rtol
2^-7; the queries are made bf16-representable) and the rounding of
P * v_scale, at most 2^-9 of the largest |v * v_scale| (1.5 here, so
Q8_ATOL = 2e-3 + 2.9e-3); the appends are bit-exact.  Stale pages hold NaN (NaN scales in an int8
pool); inside a row's last needed page the rows past its length hold large
finite values (or scales), since the Pallas kernels multiply masked
probabilities (zeros) with them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.chunk_attention as jca
import qwen_inference_engine_tpu.ops.kv_append as jka
import qwen_inference_engine_tpu.ops.paged_attention as jpa
from qwen_inference_engine_tpu.kvcache import cache as jcache_mod
from qwen_inference_engine_tpu_torch.ops import chunk_attention as tca
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.ops import paged_attention as tpa
from tests.helpers import interpret_pallas


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _needed(tables, n_valid, page):
    """Pages each row's first n_valid keys lie on, and its last page."""
    needed = set()
    for b, n in enumerate(n_valid):
        last = max(int(n) - 1, 0) // page
        needed.update(int(p) for p in tables[b, : last + 1])
    return needed


def _pool(rng, L, P, Hk, page, D, tables, n_valid, quant):
    """A pool with stale values: NaN (NaN scales for int8) in every page no
    row needs; rows past each row's length inside its last needed page x100
    (their scales x100 for int8).  Returns (k, v, k_scale, v_scale) as
    numpy arrays (scales None for f32)."""
    needed = _needed(tables, n_valid, page)
    stale = [p for p in range(P) if p not in needed]
    out = []
    for _ in range(2):
        if quant:
            x = rng.integers(-127, 128, size=(L, P, Hk, page, D)).astype(np.int8)
            s = (rng.uniform(0.5, 1.5, size=(L, P, Hk, page)) / 127).astype(
                np.float32)
            big = s
        else:
            x = rng.normal(size=(L, P, Hk, page, D)).astype(np.float32)
            s, big = None, x
        for b, n in enumerate(n_valid):
            if int(n) % page:
                pg = tables[b, max(int(n) - 1, 0) // page]
                big[:, pg, :, int(n) % page:] *= 100
        (s if quant else x)[:, stale] = np.nan
        out.append((x, s))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _tables(rng, B, P, max_pages):
    return rng.permutation(np.arange(1, P))[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)


Q8_ATOL = 2e-3 + 2 ** -9 * 1.5
GRID = [(T, G, page) for T in (2, 5, 16) for G in (1, 2, 7) for page in (8, 16)]


def _lens(T, page):
    """Row 0's window starts the sequence; row 1's straddles pages 0 and 1
    (for T > 2); row 2's starts at row 0 of page 2."""
    return np.asarray([T, page + T - 2, 2 * page + T], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("T,G,page", [(1, 2, 8), (1, 7, 16), (1, 1, 8)] + GRID)
def test_paged_attention_plain_matches_pallas_interpret(T, G, page, quant):
    """Decode (T = 1: lengths 5, two pages, three pages less one) and the
    verify (2 <= T <= 16, G in {1, 2, 7}, pages of 8 and 16) over a pool of
    f32 (the bf16 kernel's type on the CPU) or int8 with scales."""
    L, B, Hk, D, max_pages = 2, 3, 2, 128, 5
    Hq = G * Hk
    P = B * max_pages + 2
    rng = np.random.default_rng(T * 100 + G * 10 + page + quant)
    lens = (np.asarray([5, page * 2, page * 3 - 1], np.int32) if T == 1
            else _lens(T, page))
    tables = _tables(rng, B, P, max_pages)
    k, v, ks, vs = _pool(rng, L, P, Hk, page, D, tables, lens, quant)
    q = _bf16_values(rng.normal(size=(B, T, Hq, D)).astype(np.float32))
    layer = 1
    with interpret_pallas(jpa):
        if T == 1:
            jfn = (jpa.paged_decode_attention_stacked_q8 if quant
                   else jpa.paged_decode_attention_stacked)
        else:
            jfn = (jpa.paged_verify_attention_stacked_q8 if quant
                   else jpa.paged_verify_attention_stacked)
        scales = (jnp.asarray(ks), jnp.asarray(vs)) if quant else ()
        want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *scales,
                   jnp.asarray(tables), jnp.asarray(lens), page, layer)
    name = ("paged_decode_attention_stacked" if T == 1
            else "paged_verify_attention_stacked") + ("_q8" if quant else "")
    fn = getattr(tpa, name)
    before = fn.launches
    scales = (_t(ks), _t(vs)) if quant else ()
    got = fn(_t(q), _t(k), _t(v), *scales, _t(tables), _t(lens), page, layer)
    assert fn.launches == before
    assert got.shape == (B, T, Hq, D) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2 ** -7 if quant else 2e-3,
                               atol=Q8_ATOL if quant else 2e-3)


@pytest.mark.parametrize("T,start,page", [(16, 32, 64), (8, 0, 128),
                                          (16, 13, 8), (24, 70, 16)])
def test_paged_chunk_attention_q8_plain_matches_pallas_interpret(T, start,
                                                                 page):
    """Continuation pieces over the int8 pool, page-aligned and mid-page
    starts, NaN scales in the pages past each row's last needed page."""
    L, B, Hk, G, D = 2, 3, 2, 4, 128
    Hq = G * Hk
    S = start + T
    pps = -(-S // page) + 1
    P = B * pps + 3
    rng = np.random.default_rng(41 + T + start)
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    k, v, ks, vs = _pool(rng, L, P, Hk, page, D, tables, [S] * B, True)
    q = _bf16_values(rng.normal(size=(B, T, Hq, D)).astype(np.float32))
    layer = 1
    with interpret_pallas(jca):
        want = jca.paged_chunk_attention_q8(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(tables), layer, start, page)
    before = tca.paged_chunk_attention_q8.launches
    got = tca.paged_chunk_attention_q8(_t(q), _t(k), _t(v), _t(ks), _t(vs),
                                       _t(tables), layer, start, page)
    assert tca.paged_chunk_attention_q8.launches == before
    assert got.shape == (B, T, Hq, D) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 ** -7,
                               atol=Q8_ATOL)


@pytest.mark.parametrize("T,start,G", [(16, 700, 8), (24, 500, 8),
                                       (8, 1000, 7), (16, 256, 8)])
def test_paged_chunk_attention_q8_plain_matches_pallas_interpret_page_512(
        T, start, G):
    """The INT8 pool's pieces over pages of 512: G = 8 and 7, mid-page
    starts and a piece crossing into the next page; NaN scales in the
    pages past each row's last needed page; the tolerance of the test
    above."""
    L, B, Hk, D, page = 2, 2, 2, 128, 512
    Hq = G * Hk
    S = start + T
    pps = -(-S // page) + 1
    P = B * pps + 2
    rng = np.random.default_rng(59 + T + start + G)
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    k, v, ks, vs = _pool(rng, L, P, Hk, page, D, tables, [S] * B, True)
    q = _bf16_values(rng.normal(size=(B, T, Hq, D)).astype(np.float32))
    layer = 1
    with interpret_pallas(jca):
        want = jca.paged_chunk_attention_q8(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(tables), layer, start, page)
    before = tca.paged_chunk_attention_q8.launches
    got = tca.paged_chunk_attention_q8(_t(q), _t(k), _t(v), _t(ks), _t(vs),
                                       _t(tables), layer, start, page)
    assert tca.paged_chunk_attention_q8.launches == before
    assert got.shape == (B, T, Hq, D) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 ** -7,
                               atol=Q8_ATOL)


def _append_pools(rng, L, P, Hk, page, D, kind):
    """(numpy K, V pools, their torch and jnp forms) of ``kind``."""
    if kind == "int8":
        k = rng.integers(-100, 100, size=(L, P, Hk, page, D)).astype(np.int8)
        v = rng.integers(-100, 100, size=(L, P, Hk, page, D)).astype(np.int8)
        return k, v, _t(k), _t(v), jnp.asarray(k), jnp.asarray(v)
    k = rng.normal(size=(L, P, Hk, page, D)).astype(np.float32)
    v = rng.normal(size=(L, P, Hk, page, D)).astype(np.float32)
    if kind == "bf16":
        k, v = _bf16_values(k), _bf16_values(v)
        return (k, v, _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16),
                jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    return k, v, _t(k), _t(v), jnp.asarray(k), jnp.asarray(v)


def _rows(rng, shape, kind):
    if kind == "int8":
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    x = rng.normal(size=shape).astype(np.float32)
    return _bf16_values(x) if kind == "bf16" else x


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("T,page", [(5, 8), (8, 8), (5, 16), (16, 16)])
def test_paged_append_ragged_t_plain_bit_exact_vs_pallas_interpret(T, page,
                                                                   kind):
    """T rows per batch row at per-row starts: a window at position 0, one
    straddling two pages, one starting a fresh page, and a skipped row
    (start -1); an int8 pool's scales written as the JAX package writes
    them (paged_write_stacked on a trailing unit axis).  The scratch page 0
    is never referenced."""
    L, Hk, D, B, max_pages = 2, 2, 128, 4, 4
    P = B * max_pages + 2
    rng = np.random.default_rng(T * 10 + page + len(kind))
    tables = _tables(rng, B, P, max_pages)
    starts = np.asarray([0, page - 2, page, -1], np.int32)
    k, v, tk, tv, jk, jv = _append_pools(rng, L, P, Hk, page, D, kind)
    kn = _rows(rng, (B, T, Hk, D), kind)
    vn = _rows(rng, (B, T, Hk, D), kind)
    jdt = jk.dtype
    layer = 1
    with interpret_pallas(jka):
        wk, wv = jka.paged_append_ragged_t(
            jk, jv, jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
            jnp.asarray(starts), jnp.asarray(tables), layer, page_size=page)
    kw = {}
    if kind == "int8":
        ks = rng.normal(size=(L, P, Hk, page)).astype(np.float32)
        vs = rng.normal(size=(L, P, Hk, page)).astype(np.float32)
        ksn = rng.random(size=(B, T, Hk)).astype(np.float32)
        vsn = rng.random(size=(B, T, Hk)).astype(np.float32)
        keep = starts >= 0
        pos = starts[keep][:, None] + np.arange(T)[None, :]
        want_s = [np.asarray(jcache_mod.paged_write_stacked(
            jnp.asarray(s)[..., None], layer, jnp.asarray(n[keep])[..., None],
            jnp.asarray(pos), jnp.asarray(tables[keep]), page))[..., 0]
            for s, n in ((ks, ksn), (vs, vsn))]
        kw = dict(k_scale=_t(ks), v_scale=_t(vs), ks_new=_t(ksn),
                  vs_new=_t(vsn))
    before = tka.paged_append_ragged_t.launches
    new = [_t(x).to(tk.dtype) for x in (kn, vn)]
    gk, gv = tka.paged_append_ragged_t(tk, tv, *new, _t(starts), _t(tables),
                                       layer, page_size=page, **kw)
    assert tka.paged_append_ragged_t.launches == before
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(_as_np(gk), np.asarray(wk, np.float32)
                                  if kind == "bf16" else np.asarray(wk))
    np.testing.assert_array_equal(_as_np(gv), np.asarray(wv, np.float32)
                                  if kind == "bf16" else np.asarray(wv))
    if kind == "int8":
        np.testing.assert_array_equal(kw["k_scale"].numpy(), want_s[0])
        np.testing.assert_array_equal(kw["v_scale"].numpy(), want_s[1])
    # the skipped row wrote nothing: (B - 1) * T rows of K changed
    changed = (_as_np(gk) != k).any(axis=-1)
    assert changed.sum() == (B - 1) * T * Hk


@pytest.mark.parametrize("case", ["ragged", "prefill mid-page",
                                  "prefill multi-page"])
def test_int8_paged_appends_with_scales_bit_exact_vs_jax(case):
    """The int8 instantiations of paged_append_ragged / _prefill: the bytes
    as the Pallas kernels write them on an int8 pool (interpreter mode),
    the scales as the JAX model scatters them (paged_write_stacked)."""
    L, P, Hk, PS, D, max_pages = 2, 14, 2, 16, 128, 4
    rng = np.random.default_rng(len(case))
    k, v, tk, tv, jk, jv = _append_pools(rng, L, P, Hk, PS, D, "int8")
    ks = rng.normal(size=(L, P, Hk, PS)).astype(np.float32)
    vs = rng.normal(size=(L, P, Hk, PS)).astype(np.float32)
    layer = 1
    if case == "ragged":
        B, T = 3, 1
        tables = _tables(rng, B, P, max_pages)
        positions = np.asarray([5, 33, 47], np.int32)
        pos = positions[:, None]
    else:
        B, T = 1, 20
        start = 5 if case == "prefill mid-page" else 13
        tables = _tables(rng, 1, P, max_pages)
        pos = start + np.arange(T, dtype=np.int32)[None, :]
    kn = rng.integers(-127, 128, size=(B, T, Hk, D)).astype(np.int8)
    vn = rng.integers(-127, 128, size=(B, T, Hk, D)).astype(np.int8)
    ksn = rng.random(size=(B, T, Hk)).astype(np.float32)
    vsn = rng.random(size=(B, T, Hk)).astype(np.float32)
    with interpret_pallas(jka):
        if case == "ragged":
            wk, wv = jka.paged_append_ragged(
                jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                jnp.asarray(positions), jnp.asarray(tables), layer,
                page_size=PS)
        else:
            wk, wv = jka.paged_append_prefill(
                jk, jv, jnp.asarray(kn), jnp.asarray(vn), start,
                jnp.asarray(tables), layer, page_size=PS)
    want_s = [np.asarray(jcache_mod.paged_write_stacked(
        jnp.asarray(s)[..., None], layer, jnp.asarray(n)[..., None],
        jnp.asarray(pos), jnp.asarray(tables), PS))[..., 0]
        for s, n in ((ks, ksn), (vs, vsn))]
    tks, tvs = _t(ks), _t(vs)
    kw = dict(k_scale=tks, v_scale=tvs, ks_new=_t(ksn), vs_new=_t(vsn))
    if case == "ragged":
        fn = tka.paged_append_ragged
        got = fn(tk, tv, _t(kn), _t(vn), _t(positions), _t(tables), layer,
                 page_size=PS, **kw)
    else:
        fn = tka.paged_append_prefill
        got = fn(tk, tv, _t(kn), _t(vn), start, _t(tables), layer,
                 page_size=PS, **kw)
    assert got[0] is tk and got[1] is tv
    for g, w in zip((tk, tv, tks, tvs), (wk, wv, *want_s)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((tk.numpy() != k).any(axis=-1).sum()) == B * T * Hk


def test_int8_pool_carried_over_created_and_page_copied():
    """An INT8 pool ([L, P, Hk, page, D] int8, scales [L, P, Hk, page] f32)
    carried over from the JAX package with its scales, created with the
    JAX shapes, and copied page to page with its scales (the prefix
    cache's partial-page reuse)."""
    import jax

    from qwen_inference_engine_tpu.kvcache.cache import PagedKVCache as JPaged
    from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
    from qwen_inference_engine_tpu_torch.loader.from_jax import (
        paged_cache_from_numpy,
    )

    rng = np.random.default_rng(3)
    L, P, Hk, page, D = 2, 5, 2, 8, 32
    k = rng.integers(-127, 128, size=(L, P, Hk, page, D)).astype(np.int8)
    ks = rng.random(size=(L, P, Hk, page)).astype(np.float32)
    jp = JPaged(k_pages=jnp.asarray(k), v_pages=jnp.asarray(-k),
                k_scale=jnp.asarray(ks), v_scale=jnp.asarray(2 * ks),
                page_size=page)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp.quantized and tp.k_pages.dtype == torch.int8
    np.testing.assert_array_equal(tp.v_scale.numpy(), 2 * ks)
    created = PagedKVCache.create(L, P, page, Hk, D, dtype=torch.int8)
    want = JPaged.create(L, P, page, Hk, D, dtype=jnp.int8)
    for got, ref in ((created.k_pages, want.k_pages),
                     (created.v_scale, want.v_scale)):
        assert tuple(got.shape) == ref.shape and str(ref.dtype) in str(got.dtype)
    tp.copy_page(3, 1)
    for t, src in ((tp.k_pages, k), (tp.v_pages, -k), (tp.k_scale, ks),
                   (tp.v_scale, 2 * ks)):
        np.testing.assert_array_equal(t[:, 1].numpy(), src[:, 3])
