"""The last four Pallas kernels' plain versions against the JAX kernels, and
the paths that run them in the port, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, the port its plain
versions (what every wrapper runs for a CPU tensor):

* ``kv_append_ragged_t_plain`` against the JAX ``kv_append_ragged_t`` bit
  for bit (f32, bf16 and int8 caches; T = 1, 5 and 17; starts -1, 0, 7,
  31, S - T and S - 2, the last a window that runs past the cache's end);
  the int8 scales against the JAX ``contiguous_write_stacked``.  No JAX
  test or script reaches this kernel;
* ``decode_attention_contiguous_fresh_plain`` against the JAX kernel at the
  JAX test's shapes (old lengths 0, 100 and 255), with 1e4 in every cache
  position at or past a row's old length (a read of one would show);
* ``kv_append_all_uniform_plain`` against the JAX kernel bit for bit;
* ``fused_attn_matmul_plain`` against the JAX kernel at both cases of
  ``tests/test_fused_step.py`` (G = 7 padded to G8 = 8 for JAX, and 8);
* the deferred-append decode step against the JAX ``decode_step`` (3 steps,
  f32), its caches and logits against the port's own
  ``decode_step(uniform_decode=True)`` bit for bit, and its refusals;
* the ragged decode and the contiguous verify now write through the
  ``kv_append_ragged_t`` wrapper.  A CPU tensor runs the plain version and
  counts no launch (the port's rule), so a spy counts the wrapper's calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.decode_attention as jda
import qwen_inference_engine_tpu.ops.fused_step as jfs
import qwen_inference_engine_tpu.ops.kv_append as jka
from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.kvcache.cache import contiguous_write_stacked
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache, PagedKVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops import decode_attention as tda
from qwen_inference_engine_tpu_torch.ops import fused_step as tfs
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv
from tests.helpers import interpret_pallas


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _to_torch(a, dtype) -> torch.Tensor:
    """A JAX array as a torch tensor of ``dtype`` (bf16 through f32)."""
    if dtype == torch.int8:
        return _t(np.asarray(a))
    return _t(_f32(a)).to(dtype)


# ---------------------------------------------------------------------------
# kv_append_ragged_t
# ---------------------------------------------------------------------------

RAGGED_DTYPES = {"float32": (jnp.float32, torch.float32),
                 "bfloat16": (jnp.bfloat16, torch.bfloat16),
                 "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("T", [1, 5, 17])
@pytest.mark.parametrize("dtype", sorted(RAGGED_DTYPES))
def test_kv_append_ragged_t_plain_matches_jax_kernel_bit_for_bit(dtype, T):
    L, Hk, S, D, layer = 2, 2, 64, 128, 1
    starts = np.asarray([-1, 0, 7, 31, S - T, S - 2], np.int32)
    B = len(starts)
    jdt, tdt = RAGGED_DTYPES[dtype]
    rng = np.random.default_rng(11 + T)
    quant = dtype == "int8"

    def cache():
        if quant:
            return jnp.asarray(rng.integers(-127, 128, (L, B, Hk, S, D)),
                               jnp.int8)
        return jnp.asarray(rng.normal(size=(L, B, Hk, S, D)),
                           jnp.float32).astype(jdt)

    kc, vc = cache(), cache()
    kn_f = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    vn_f = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    if quant:
        (kn, ksn), (vn, vsn) = quantize_kv(_t(kn_f)), quantize_kv(_t(vn_f))
        jkn, jvn = jnp.asarray(kn.numpy()), jnp.asarray(vn.numpy())
    else:
        jkn = jnp.asarray(kn_f).astype(jdt)
        jvn = jnp.asarray(vn_f).astype(jdt)
        kn, vn = _to_torch(jkn, tdt), _to_torch(jvn, tdt)
    with interpret_pallas(jka):
        jk, jv = jka.kv_append_ragged_t(kc, vc, jkn, jvn,
                                        jnp.asarray(starts), layer)
    tk, tv = _to_torch(kc, tdt), _to_torch(vc, tdt)
    k0, v0 = tk.clone(), tv.clone()
    kw = {}
    if quant:
        ks = torch.from_numpy(rng.uniform(0.1, 1, (L, B, Hk, S)).astype(
            np.float32))
        vs = ks.flip(-1).contiguous()
        kw = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                  vs_new=vsn)
    gk, gv = tka.kv_append_ragged_t_plain(tk, tv, kn, vn, _t(starts), layer,
                                          **kw)
    assert gk is tk and gv is tv
    for got, want in ((gk, jk), (gv, jv)):
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    # exactly the rows of the windows inside the cache changed (a changed
    # row may keep its value by chance, so compare against the mask)
    written = torch.zeros(L, B, Hk, S, dtype=torch.bool)
    for b, p in enumerate(starts.tolist()):
        if p >= 0:
            written[layer, b, :, p:min(p + T, S)] = True
    assert not ((gk != k0).any(-1) & ~written).any()
    if quant:
        # skipped rows' positions land far outside the cache: the JAX
        # scatter drops them, as it drops the tokens past S
        pos = np.where(starts[:, None] >= 0, starts[:, None] + np.arange(T),
                       S + 1000).astype(np.int32)
        for mine, theirs, new in ((kw["k_scale"], ks, ksn),
                                  (kw["v_scale"], vs, vsn)):
            want = contiguous_write_stacked(
                jnp.asarray(theirs.numpy())[..., None], jnp.int32(layer),
                jnp.asarray(new.numpy())[..., None], jnp.asarray(pos))
            np.testing.assert_array_equal(mine.numpy(), np.asarray(want)[..., 0])
    # the wrapper on CPU tensors: the plain version, no launch counted
    before = tka.kv_append_ragged_t.launches
    wk, wv = tka.kv_append_ragged_t(k0.clone(), v0.clone(), kn, vn,
                                    _t(starts), layer,
                                    **({} if not quant else dict(
                                        kw, k_scale=ks.clone(),
                                        v_scale=vs.clone())))
    assert torch.equal(wk, gk) and torch.equal(wv, gv)
    assert tka.kv_append_ragged_t.launches == before


# ---------------------------------------------------------------------------
# decode_attention_contiguous_fresh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fresh_decode_attention_plain_matches_jax_kernel(dtype):
    L, B, Hk, G, D, S, layer = 2, 3, 2, 7, 128, 256, 1
    Hq = G * Hk
    jdt, tdt = RAGGED_DTYPES[dtype]
    rng = np.random.default_rng(21)
    old = np.asarray([0, 100, 255], np.int32)
    kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    for b, n in enumerate(old):   # a read at or past the old length shows
        kc[:, b, :, n:] = 1e4
        vc[:, b, :, n:] = 1e4
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    jkc, jvc = jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt)
    with interpret_pallas(jda):
        want = jda.decode_attention_contiguous_fresh(
            jnp.asarray(q), jkc, jvc, jnp.asarray(kn), jnp.asarray(vn), layer,
            jnp.asarray(old))
    tkc, tvc = _to_torch(jkc, tdt), _to_torch(jvc, tdt)
    k0 = tkc.clone()
    got = tda.decode_attention_contiguous_fresh_plain(
        _t(q), tkc, tvc, _t(kn), _t(vn), layer, _t(old))
    assert got.dtype == torch.float32 and got.shape == (B, 1, Hq, D)
    assert torch.equal(tkc, k0)   # the cache is only read
    # the JAX test's tolerance: its kernel rounds the probabilities to bf16
    # (the plain version only over a bf16 cache) and sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3,
                               atol=3e-3)
    # a row of old length 0 attends its fresh token alone
    np.testing.assert_allclose(
        got[0, 0].reshape(Hk, G, D).numpy(),
        np.broadcast_to(_f32(jnp.asarray(vn[0, 0]).astype(jdt))[:, None],
                        (Hk, G, D)), rtol=0, atol=1e-6)
    before = tda.decode_attention_contiguous_fresh.launches
    again = tda.decode_attention_contiguous_fresh(
        _t(q), tkc, tvc, _t(kn), _t(vn), layer, _t(old))
    assert torch.equal(again, got)
    assert tda.decode_attention_contiguous_fresh.launches == before


def test_fresh_plain_takes_a_row_whose_old_tokens_fill_the_cache():
    """old_lengths == S: the plain version attends over a copy one slot
    longer, as the JAX kernel merges the fresh token after all S keys."""
    L, B, Hk, G, D, S = 1, 2, 1, 4, 128, 256
    rng = np.random.default_rng(3)
    kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, Hk * G, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    old = np.asarray([S, 17], np.int32)
    with interpret_pallas(jda):
        want = jda.decode_attention_contiguous_fresh(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), 0, jnp.asarray(old))
    got = tda.decode_attention_contiguous_fresh_plain(
        _t(q), _t(kc), _t(vc), _t(kn), _t(vn), 0, _t(old))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-3,
                               atol=3e-3)


# ---------------------------------------------------------------------------
# kv_append_all_uniform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("squeeze", [False, True], ids=["[L,B,1,Hk,D]",
                                                         "[L,B,Hk,D]"])
@pytest.mark.parametrize("pos", [0, 37, 63])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_all_uniform_plain_matches_jax_kernel_bit_for_bit(
        dtype, pos, squeeze):
    L, B, Hk, S, D = 3, 2, 2, 64, 128
    jdt, tdt = RAGGED_DTYPES[dtype]
    rng = np.random.default_rng(22)
    kc = jnp.asarray(rng.normal(size=(L, B, Hk, S, D)), jnp.float32).astype(jdt)
    vc = jnp.asarray(rng.normal(size=(L, B, Hk, S, D)), jnp.float32).astype(jdt)
    shape = (L, B, Hk, D) if squeeze else (L, B, 1, Hk, D)
    kn = rng.normal(size=shape).astype(np.float32)
    vn = rng.normal(size=shape).astype(np.float32)
    with interpret_pallas(jka):
        jk, jv = jka.kv_append_all_uniform(kc, vc, jnp.asarray(kn),
                                           jnp.asarray(vn), jnp.int32(pos))
    tk, tv = _to_torch(kc, tdt), _to_torch(vc, tdt)
    k0 = tk.clone()
    gk, gv = tka.kv_append_all_uniform_plain(tk, tv, _t(kn), _t(vn),
                                             torch.tensor([pos]))
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(gk.float().numpy(), _f32(jk))
    np.testing.assert_array_equal(gv.float().numpy(), _f32(jv))
    changed = (gk != k0).any(-1).nonzero()
    assert bool((changed[:, 3] == pos).all())
    before = tka.kv_append_all_uniform.launches
    wk, _ = tka.kv_append_all_uniform(k0.clone(), k0.clone(), _t(kn), _t(vn),
                                      pos)
    assert torch.equal(wk, gk)
    assert tka.kv_append_all_uniform.launches == before


# ---------------------------------------------------------------------------
# fused_attn_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [7, 8])
@pytest.mark.parametrize("S,block_s,block_n", [(256, 128, 128),
                                               (512, 256, 256)])
def test_fused_attn_matmul_plain_matches_jax_kernel(S, block_s, block_n, G):
    """tests/test_fused_step.py's two cases: L 2, a cache of 8 rows, rows
    4..7 attend (row0 4), x [8, 256] @ INT4 [256, 512] at gs 64, layer 1."""
    rng = np.random.default_rng(0)
    L, B, Hk, D = 2, 8, 2, 128
    Ba, row0, Mb, K, N, gs, layer = 4, 4, 8, 256, 512, 64, 1
    # the port's kernel takes bf16 queries (as fused_attn_mlp does): both
    # packages get the same bf16 values
    q = _t(rng.normal(size=(Ba, Hk, G, D)).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    lens = rng.integers(1, S, size=(Ba,)).astype(np.int32)
    x = rng.normal(size=(Mb, K)).astype(np.float32)
    wq = rng.integers(-128, 128, size=(L, K // 2, N)).astype(np.int8)
    ws = rng.uniform(0.01, 0.02, size=(L, K // gs, N)).astype(np.float32)
    q8 = np.pad(q, ((0, 0), (0, 0), (0, 8 - G), (0, 0)))
    with interpret_pallas(jfs):
        j_attn, j_y = jfs.fused_attn_matmul(
            jnp.asarray(lens), jnp.asarray([layer], jnp.int32),
            jnp.asarray(q8), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(x),
            jnp.asarray(wq), jnp.asarray(ws), scale=D ** -0.5, group_size=gs,
            block_n=block_n, block_s=block_s, row0=row0)
    attn, y = tfs.fused_attn_matmul_plain(
        _t(lens), layer, _t(q).reshape(Ba, 1, Hk * G, D), _t(kc), _t(vc),
        _t(x), _t(wq), _t(ws), group_size=gs, row0=row0)
    assert attn.dtype == torch.bfloat16 and attn.shape == (Ba, 1, Hk * G, D)
    assert y.dtype == torch.float32 and y.shape == (Mb, N)
    # the JAX test's tolerances (attention 2e-3, the INT4 matmul 2e-2), and
    # for the attention half a bf16 ulp more: the port's output is bf16 (its
    # kernel's, as fused_attn_mlp's), the JAX kernel's f32 here (a row of 6
    # keys gives |attn| ~ 2.1, whose bf16 rounding alone moves it 7.8e-3)
    want = np.asarray(j_attn)[:, :, :G]
    half_ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 8)
    err = np.abs(attn.float().reshape(Ba, Hk, G, D).numpy() - want)
    assert (err <= 2e-3 + 2e-3 * np.abs(want) + half_ulp).all(), err.max()
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), rtol=2e-2,
                               atol=2e-2)
    before = tfs.fused_attn_matmul.launches
    again = tfs.fused_attn_matmul(
        _t(lens), layer, _t(q).reshape(Ba, 1, Hk * G, D), _t(kc), _t(vc),
        _t(x), _t(wq), _t(ws), group_size=gs, row0=row0)
    assert torch.equal(again[0], attn) and torch.equal(again[1], y)
    assert tfs.fused_attn_matmul.launches == before


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

_MODEL = {}


def _model():
    """The tiny config in both packages, f32 dense weights (so both run
    exact f32 matmuls)."""
    if not _MODEL:
        jcfg = j_tiny_config()
        jparams = jqwen.init_params(jcfg, jax.random.PRNGKey(5),
                                    dtype=jnp.float32)
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
        _MODEL.update(j=(jcfg, jparams), t=(tiny_config(), tparams))
    return _MODEL["j"], _MODEL["t"]


def _spy(monkeypatch, name):
    """Count the calls of ``models.qwen``'s ``name`` (the wrapper runs on)."""
    calls = []
    orig = getattr(tqwen, name)

    def spy(*a, **k):
        calls.append(a[2].shape[:2] if name == "kv_append_ragged_t" else 1)
        return orig(*a, **k)

    monkeypatch.setattr(tqwen, name, spy)
    return calls


def test_deferred_decode_step_matches_jax_and_the_appending_step(monkeypatch):
    (jcfg, jparams), (tcfg, tparams) = _model()
    L, Hk, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    B, T, S = 3, 9, 64
    rng = np.random.default_rng(6)
    toks = rng.integers(2, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.full((B,), T, np.int32)
    jc = JKVCache.create(L, B, S, Hk, D, dtype=jnp.float32)
    logits, jc = jqwen.prefill(jparams, jcfg, jnp.asarray(toks),
                               jnp.asarray(lens), jc, attn_impl="xla")
    tc = KVCache(k=_t(np.asarray(jc.k)), v=_t(np.asarray(jc.v)))
    tc_plain = KVCache(k=tc.k.clone(), v=tc.v.clone())
    fresh = _spy(monkeypatch, "decode_attention_contiguous_fresh")
    all_append = _spy(monkeypatch, "kv_append_all_uniform")
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for s in range(3):
        pos = lens + s
        want, jc = jqwen.decode_step(jparams, jcfg, jnp.asarray(tok),
                                     jnp.asarray(pos), jc, attn_impl="xla",
                                     uniform_decode=True)
        got, tc = tqwen.decode_step(tparams, tcfg, _t(tok).long(),
                                    _t(pos).long(), tc, uniform_decode=True,
                                    deferred_append=True)
        ref, tc_plain = tqwen.decode_step(tparams, tcfg, _t(tok).long(),
                                          _t(pos).long(), tc_plain,
                                          uniform_decode=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=f"step {s}")
        # the same attention sums and the same rows written
        assert torch.equal(got, ref)
        assert torch.equal(tc.k, tc_plain.k) and torch.equal(tc.v, tc_plain.v)
        tok = got.argmax(-1).numpy().astype(np.int32)
    assert len(fresh) == 3 * L and len(all_append) == 3
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=0,
                               atol=1e-4)


DEFERRED_REFUSALS = {
    "int8 cache": (dict(kv=torch.int8), "unquantized"),
    "paged cache": (dict(kv="paged"), "unquantized"),
    "ragged batch": (dict(uniform=False), "aligned batch"),
    "T > 1": (dict(T=3), "T == 1"),
    "fresh prefill": (dict(T=3, fresh=True), "T == 1"),
    "f16 cache": (dict(kv=torch.float16), "bf16 cache"),
}


@pytest.mark.parametrize("case", sorted(DEFERRED_REFUSALS))
def test_deferred_decode_refuses_what_it_does_not_take(case):
    _, (tcfg, tparams) = _model()
    kw, match = DEFERRED_REFUSALS[case]
    L, Hk, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    T, B = kw.get("T", 1), 2
    tables = None
    if kw.get("kv") == "paged":
        cache = PagedKVCache.create(L, 8, 16, Hk, D, dtype=torch.float32)
        tables = torch.ones((B, 4), dtype=torch.int32)
    else:
        cache = KVCache.create(L, B, 64, Hk, D,
                               dtype=kw.get("kv", torch.float32))
    tokens = torch.full((B, T), 3)
    positions = torch.arange(T)[None].expand(B, T) + 5
    with pytest.raises(ValueError, match=match):
        tqwen.forward_hidden(tparams, tcfg, tokens, positions, cache,
                             block_tables=tables,
                             fresh_prefill=kw.get("fresh", False),
                             uniform_decode=kw.get("uniform", True),
                             deferred_append=True)


@pytest.mark.parametrize("kv", [torch.float32, torch.int8])
def test_ragged_decode_and_verify_write_through_kv_append_ragged_t(
        monkeypatch, kv):
    """A ragged decode step writes each layer's K/V with one
    kv_append_ragged_t call of T = 1, a verify forward with one of T = 5;
    an aligned decode step, a fresh prefill and a continuation chunk never
    call it."""
    _, (tcfg, tparams) = _model()
    L, Hk, D = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    B = 3
    calls = _spy(monkeypatch, "kv_append_ragged_t")
    cache = KVCache.create(L, B, 64, Hk, D, dtype=kv)
    toks = torch.randint(2, 500, (B, 16), generator=torch.Generator()
                         .manual_seed(0))
    tqwen.prefill_chunked(tparams, tcfg, toks, torch.tensor([5, 16, 9]),
                          cache, chunk=8)
    assert calls == []
    tqwen.decode_step(tparams, tcfg, toks[:, 0], torch.tensor([5, 16, 9]),
                      cache)
    assert calls == [(B, 1)] * L
    tqwen.decode_step(tparams, tcfg, toks[:, 0], torch.tensor([17] * B),
                      cache, uniform_decode=True)
    assert calls == [(B, 1)] * L
    pos = torch.tensor([6, 18, 10])[:, None] + torch.arange(5)
    tqwen.forward_hidden(tparams, tcfg, toks[:, :5], pos, cache,
                         ragged_multi=True)
    assert calls == [(B, 1)] * L + [(B, 5)] * L
    # the written rows are the quantized rows (int8) or the rows themselves
    assert bool(cache.k[:, :, :, 18:23].any())


def test_ragged_engine_generate_calls_kv_append_ragged_t_every_step(
        monkeypatch):
    """Engine.generate(device="cpu") on a ragged batch writes every decode
    step's K/V with kv_append_ragged_t (once a layer a step), and on an
    aligned batch never."""
    _, (tcfg, tparams) = _model()
    calls = _spy(monkeypatch, "kv_append_ragged_t")
    eng = Engine(tcfg, tparams, max_batch=2, max_seq=64,
                 sampling=SamplingParams(greedy=True), device="cpu")
    eng.cfg = tcfg.replace(eos_token_ids=())
    res = eng.generate([[5, 9, 17], [100, 200, 300, 400, 7]],
                       max_new_tokens=4)
    assert len(calls) == tcfg.num_layers * (res.steps - 1) > 0
    calls.clear()
    eng.generate([[5, 9, 17], [100, 200, 300]], max_new_tokens=4)
    assert calls == []
