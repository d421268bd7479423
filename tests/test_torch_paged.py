"""The port's paged cache and its four kernels' plain versions vs the JAX
package.

The JAX Pallas kernels run in interpreter mode on the CPU, as in
tests/test_attention_kernels.py; the port's wrappers run their plain
versions for CPU tensors (the CUDA kernels are held against the same plain
versions on the card by chip_smoke.py and tests/test_torch_cuda_kernels.py).
Both packages start from one pool, carried over with
``paged_cache_from_numpy``.  Tolerances: 2e-3 for both attentions in f32;
the appends and the plain reads and writes are bit-exact.  Stale pages
(never referenced, or past a row's last needed page) hold NaN: they must
not reach any output.  Inside a row's last page the rows past its length
hold large finite values, since the Pallas kernels multiply their masked
probabilities (zeros) with those rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.chunk_attention as jca
import qwen_inference_engine_tpu.ops.kv_append as jka
import qwen_inference_engine_tpu.ops.paged_attention as jpa
from qwen_inference_engine_tpu.kvcache import cache as jcache_mod
from qwen_inference_engine_tpu.kvcache.cache import PagedKVCache as JPaged
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu_torch.kvcache import cache as tcache_mod
from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import (
    paged_cache_from_numpy,
)
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops import chunk_attention as tca
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.ops import paged_attention as tpa
from tests.helpers import interpret_pallas
from tests.test_torch_model import _build


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool(rng, L, P, Hk, page, D):
    return JPaged(
        k_pages=jnp.asarray(rng.normal(size=(L, P, Hk, page, D)), jnp.float32),
        v_pages=jnp.asarray(rng.normal(size=(L, P, Hk, page, D)), jnp.float32),
        k_scale=None, v_scale=None, page_size=page)


def _stale(pool: JPaged, tables: np.ndarray, n_valid, page: int) -> JPaged:
    """NaN in every page no row needs; rows past each row's length inside
    its last needed page x100."""
    k = np.array(pool.k_pages)
    v = np.array(pool.v_pages)
    needed = set()
    for b, n in enumerate(n_valid):
        last = max(int(n) - 1, 0) // page
        needed.update(int(p) for p in tables[b, : last + 1])
        if int(n) % page:
            pg = tables[b, last]
            k[:, pg, :, int(n) % page:] *= 100
            v[:, pg, :, int(n) % page:] *= 100
    stale = [p for p in range(k.shape[1]) if p not in needed]
    k[:, stale] = np.nan
    v[:, stale] = np.nan
    return JPaged(k_pages=jnp.asarray(k), v_pages=jnp.asarray(v), k_scale=None,
                  v_scale=None, page_size=page)


def test_paged_cache_carried_over_and_created():
    rng = np.random.default_rng(0)
    jp = _pool(rng, 2, 5, 2, 8, 32)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp.page_size == 8 and tp.num_pages == 5 and not tp.quantized
    np.testing.assert_array_equal(tp.k_pages.numpy(), np.asarray(jp.k_pages))
    q8 = PagedKVCache.create(2, 5, 16, 2, 32, dtype=torch.int8)
    j8 = JPaged.create(2, 5, 16, 2, 32, dtype=jnp.int8)
    assert q8.quantized and tuple(q8.k_pages.shape) == j8.k_pages.shape
    assert tuple(q8.k_scale.shape) == j8.k_scale.shape
    assert tcache_mod.pages_required(17, 8) == jcache_mod.pages_required(17, 8)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_read_and_write_stacked_identical_to_jax(page):
    L, P, Hk, D, B, T, max_pages = 2, 9, 2, 32, 2, 5, 4
    rng = np.random.default_rng(page)
    jp = _pool(rng, L, P, Hk, page, D)
    tables = np.asarray([[3, 1, 7, 0], [2, 8, 4, 5]], np.int32)
    new = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    pos = np.asarray([[0, 1, page - 1, page, 2 * page + 3],
                      [page - 2, page - 1, page, page + 1, 3 * page]],
                     np.int32)
    want = jcache_mod.paged_write_stacked(jp.k_pages, 1, jnp.asarray(new),
                                          jnp.asarray(pos), jnp.asarray(tables),
                                          page)
    got = _t(jp.k_pages)
    tcache_mod.paged_write_stacked(got, 1, _t(new), _t(pos), _t(tables), page)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tcache_mod.paged_read(got[1], _t(tables)).numpy(),
        np.asarray(jcache_mod.paged_read(want[1], jnp.asarray(tables))))


@pytest.mark.parametrize("G,page", [(2, 8), (7, 16), (1, 8)])
def test_paged_decode_attention_plain_matches_pallas_interpret(G, page):
    """Lengths 5, two full pages and three pages less one, tables shuffled
    over the pool, NaN in the stale pages."""
    L, B, Hk, D, max_pages = 2, 3, 2, 128, 4
    Hq = G * Hk
    P = B * max_pages + 2
    rng = np.random.default_rng(G * 10 + page)
    lens = np.asarray([5, page * 2, page * 3 - 1], np.int32)
    tables = rng.permutation(np.arange(1, P))[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    jp = _stale(_pool(rng, L, P, Hk, page, D), tables, lens, page)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    layer = 1
    with interpret_pallas(jpa):
        want = jpa.paged_decode_attention_stacked(
            jnp.asarray(q), jp.k_pages, jp.v_pages, jnp.asarray(tables),
            jnp.asarray(lens), page, layer)
    before = tpa.paged_decode_attention_stacked.launches
    got = tpa.paged_decode_attention_stacked(_t(q), tp.k_pages, tp.v_pages,
                                             _t(tables), _t(lens), page, layer)
    assert tpa.paged_decode_attention_stacked.launches == before
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    one = tpa.paged_decode_attention(_t(q), tp.k_pages[layer],
                                     tp.v_pages[layer], _t(tables), _t(lens),
                                     page)
    np.testing.assert_array_equal(one.numpy(), got.numpy())


def test_paged_decode_plain_ignores_nan_past_the_length():
    """The plain version never multiplies a stale key by zero: NaN rows past
    the length inside the last page, and a length of 0, give finite
    output."""
    L, P, Hk, page, D = 1, 4, 1, 8, 32
    rng = np.random.default_rng(4)
    k = torch.from_numpy(rng.normal(size=(L, P, Hk, page, D)).astype(np.float32))
    v = k.clone()
    k[0, 2, :, 3:] = float("nan")
    v[0, 2, :, 3:] = float("nan")
    tables = torch.tensor([[2, 1], [3, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 0])
    q = torch.randn(2, 1, 2, D)
    out = tpa.paged_decode_attention_stacked(q, k, v, tables, lens, page, 0)
    assert torch.isfinite(out).all()
    assert torch.equal(out[1], torch.zeros_like(out[1]))


def test_paged_append_ragged_plain_bit_exact_vs_pallas_interpret():
    """Rows at positions 5, 33 and -1 (skipped) through shuffled tables; the
    scratch page 0 is not compared (the Pallas kernel skips the row, the
    JAX reference scatter writes it there)."""
    L, P, Hk, PS, D = 2, 14, 2, 16, 128
    B, max_pages = 3, 4
    rng = np.random.default_rng(17)
    jp = _pool(rng, L, P, Hk, PS, D)
    kn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, P))[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    positions = np.asarray([5, 33, -1], np.int32)
    layer = 1
    with interpret_pallas(jka):
        wk, wv = jka.paged_append_ragged(
            jp.k_pages, jp.v_pages, jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(positions), jnp.asarray(tables), layer, page_size=PS)
    tk, tv = _t(jp.k_pages), _t(jp.v_pages)
    before = tka.paged_append_ragged.launches
    gk, gv = tka.paged_append_ragged(tk, tv, _t(kn), _t(vn), _t(positions),
                                     _t(tables), layer, page_size=PS)
    assert tka.paged_append_ragged.launches == before
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # the skipped row wrote nothing: only two rows of K changed
    changed = (gk.numpy() != np.asarray(jp.k_pages)).any(axis=-1)
    assert changed.sum() == 2 * Hk


@pytest.mark.parametrize("start,T", [(0, 8), (3, 8), (5, 20), (8, 16),
                                     (13, 29)])
def test_paged_append_prefill_plain_bit_exact_vs_pallas_interpret(start, T):
    """Page-aligned, mid-page and multi-page starts, one row."""
    L, P, Hk, PS, D = 2, 12, 2, 8, 128
    rng = np.random.default_rng(start * 100 + T)
    jp = _pool(rng, L, P, Hk, PS, D)
    kn = rng.normal(size=(1, T, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(1, T, Hk, D)).astype(np.float32)
    tables = (rng.permutation(P - 1)[: (start + T + PS - 1) // PS + 1][None]
              + 1).astype(np.int32)
    layer = 1
    with interpret_pallas(jka):
        wk, wv = jka.paged_append_prefill(
            jp.k_pages, jp.v_pages, jnp.asarray(kn), jnp.asarray(vn), start,
            jnp.asarray(tables), layer, page_size=PS)
    tk, tv = _t(jp.k_pages), _t(jp.v_pages)
    before = tka.paged_append_prefill.launches
    gk, gv = tka.paged_append_prefill(tk, tv, _t(kn), _t(vn), start,
                                      _t(tables), layer, page_size=PS)
    assert tka.paged_append_prefill.launches == before
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_paged_append_prefill_past_the_table_writes_nothing():
    """Bucket padding past the table's width is dropped, as the JAX
    scatter drops it; padding inside the width follows zero entries onto
    scratch page 0."""
    L, P, Hk, PS, D = 1, 4, 1, 8, 4
    k = torch.zeros(L, P, Hk, PS, D)
    v = torch.zeros(L, P, Hk, PS, D)
    tables = torch.tensor([[2, 0]], dtype=torch.int32)
    new = torch.ones(1, 20, Hk, D)
    tka.paged_append_prefill(k, v, new, new, 0, tables, 0, page_size=PS)
    assert k[0, 2].eq(1).all() and k[0, 0].eq(1).all()
    assert k[0, 1].eq(0).all() and k[0, 3].eq(0).all()
    want = jcache_mod.paged_write(jnp.zeros((P, Hk, PS, D)),
                                  jnp.ones((1, 20, Hk, D)),
                                  jnp.arange(20)[None], jnp.asarray(tables),
                                  PS)
    np.testing.assert_array_equal(k[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("T,start,page", [(16, 32, 64), (8, 0, 128),
                                          (256, 96, 128), (16, 13, 8),
                                          (24, 70, 16)])
def test_paged_chunk_attention_plain_matches_pallas_interpret(T, start, page):
    """Continuation pieces over the paged prefix, page-aligned and mid-page
    starts (13 over pages of 8, 70 over pages of 16), NaN in the pages past
    each row's last needed page; f32."""
    L, B, Hk, G, D = 2, 3, 2, 4, 128
    Hq = G * Hk
    S = start + T
    pps = -(-S // page) + 1           # one spare table entry per row
    P = B * pps + 3
    rng = np.random.default_rng(37 + T + start)
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    jp = _stale(_pool(rng, L, P, Hk, page, D), tables, [S] * B, page)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    layer = 1
    with interpret_pallas(jca):
        want = jca.paged_chunk_attention(jnp.asarray(q), jp.k_pages,
                                         jp.v_pages, jnp.asarray(tables),
                                         layer, start, page)
    before = tca.paged_chunk_attention.launches
    got = tca.paged_chunk_attention(_t(q), tp.k_pages, tp.v_pages, _t(tables),
                                    layer, start, page)
    assert tca.paged_chunk_attention.launches == before
    assert got.shape == (B, T, Hq, D) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("T,start,G", [(16, 700, 8), (24, 500, 8),
                                       (8, 1000, 7), (16, 256, 8)])
def test_paged_chunk_attention_plain_matches_pallas_interpret_page_512(
        T, start, G):
    """Pieces over the serving page of 512 tokens: Qwen3-30B-A3B's G = 8
    (the TPU kernel pads no heads) and G = 7, starts in the middle of a
    page (700, 1000) and one that crosses into the next page (500 + 24);
    NaN in the pages past each row's last needed page; f32, the tolerance
    of the test above."""
    L, B, Hk, D, page = 2, 2, 2, 128, 512
    Hq = G * Hk
    S = start + T
    pps = -(-S // page) + 1
    P = B * pps + 2
    rng = np.random.default_rng(53 + T + start + G)
    tables = rng.permutation(P)[: B * pps].reshape(B, pps).astype(np.int32)
    jp = _stale(_pool(rng, L, P, Hk, page, D), tables, [S] * B, page)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    layer = 1
    with interpret_pallas(jca):
        want = jca.paged_chunk_attention(jnp.asarray(q), jp.k_pages,
                                         jp.v_pages, jnp.asarray(tables),
                                         layer, start, page)
    before = tca.paged_chunk_attention.launches
    got = tca.paged_chunk_attention(_t(q), tp.k_pages, tp.v_pages, _t(tables),
                                    layer, start, page)
    assert tca.paged_chunk_attention.launches == before
    assert got.shape == (B, T, Hq, D) and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.fixture(scope="module", params=[False, True], ids=["qwen2", "qwen3"])
def models(request):
    return _build(request.param)


@pytest.mark.parametrize("page", [8, 16])
def test_paged_forward_and_decode_match_jax(models, page):
    """The model's three paged branches from one carried-over pool of stale
    values: a fresh piece (positions 0-15), a continuation piece at start 16
    whose 13 valid rows end mid-page, then 3 decode steps of two rows, the
    second idle at position 0 with a zeroed table row (the scheduler's idle
    slot: it writes scratch page 0).  Logits and the whole pool against the
    JAX XLA path, f32.  The seed makes no per-token int8 activation cross
    a rounding boundary between the packages (seed 0 does, in one row of
    Qwen3's fresh piece: 1.9e-2 there, 0 elsewhere)."""
    jcfg, jparams, tcfg, tparams = models
    L, Hk, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    T, P, max_pages = 16, 12, 6
    rng = np.random.default_rng(100 + page + jcfg.qk_norm)
    jp = _pool(rng, L, P, Hk, page, D)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    table = np.zeros((1, max_pages), np.int32)
    table[0, :-(-48 // page)] = rng.permutation(np.arange(1, P))[:-(-48 // page)]
    prompt = rng.integers(2, jcfg.vocab_size, size=29)
    for start in (0, T):
        toks = np.zeros((1, T), np.int32)
        piece = prompt[start:start + T]
        toks[0, :len(piece)] = piece
        pos = start + np.arange(T, dtype=np.int32)[None]
        jh, jp = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(pos), jp, jnp.asarray(table),
                                      fresh_prefill=start == 0, attn_impl="xla")
        th, tp = tqwen.forward_hidden(tparams, tcfg,
                                      torch.from_numpy(toks).long(),
                                      torch.from_numpy(pos).long(), tp,
                                      block_tables=_t(table),
                                      fresh_prefill=start == 0,
                                      start=start or None)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3,
                                   rtol=0)
    tables = np.concatenate([table, np.zeros_like(table)])
    for step in range(3):
        nxt = rng.integers(2, jcfg.vocab_size, size=(2,)).astype(np.int32)
        pos = np.asarray([29 + step, 0], np.int32)
        jl, jp = jqwen.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                   jnp.asarray(pos), jp, jnp.asarray(tables),
                                   attn_impl="xla")
        tl, tp = tqwen.decode_step(tparams, tcfg, torch.from_numpy(nxt).long(),
                                   torch.from_numpy(pos).long(), tp,
                                   _t(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=0)
    for got, want in ((tp.k_pages, jp.k_pages), (tp.v_pages, jp.v_pages)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                   rtol=0)
