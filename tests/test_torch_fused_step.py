"""The port's fused-MLP branch and double-pumped decode against the JAX
package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``fused_mlp``,
``fused_attn_mlp``, ``kv_append_uniform``, the attention kernels of the
forward), the port its plain versions:

* ``fused_mlp_plain`` against the JAX ``fused_mlp`` at the shapes of
  ``tests/test_fused_step.py`` (L 2, K 256, F 512, gs 64 / 128), M = 1, 8
  and 256;
* ``fused_attn_mlp_plain`` against the JAX ``fused_attn_mlp`` (row0 = 0
  and Ba, G = 7 and 8; the JAX queries padded to G8 = 8);
* ``kv_append_uniform_plain`` against the JAX ``kv_append_uniform`` bit
  for bit (f32 and bf16 caches), other rows untouched;
* ``fused_mlp_supported`` and ``pumped_supported`` against the JAX gates on
  the same params (carried by ``params_from_numpy``);
* ``decode_step_pumped`` against the JAX ``decode_step_pumped`` (3 layers,
  hidden 256, F 512, head_dim 128, pad-free INT4, B 4, S 256, 3 steps),
  and its caches against the port's ``decode_step``;
* the W4A16 forward (the fused-MLP branch) against the JAX forward with
  ``attn_impl="pallas"``, a prefill and 2 decode steps;
* ``Engine.generate(device="cpu")`` at ``max_batch=130``: an aligned batch
  decodes through ``decode_step_pumped`` only when the engine is built
  with ``pumped=True``; by default, and a ragged batch, through
  ``decode_step``.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.decode_attention as jda
import qwen_inference_engine_tpu.ops.flash_attention as jfa
import qwen_inference_engine_tpu.ops.fused_step as jfs
import qwen_inference_engine_tpu.ops.kv_append as jka
import qwen_inference_engine_tpu.ops.linear as jlin
import qwen_inference_engine_tpu.ops.quant_matmul as jqm
from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.kvcache.cache import (
    PagedKVCache as JPagedKVCache,
)
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache, PagedKVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops import fused_step as tfs
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams, sample
from tests.helpers import interpret_pallas

# the pumped parity config of tests/test_fused_step.py
PUMP = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=3, num_heads=2, num_kv_heads=1, head_dim=128)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@contextlib.contextmanager
def _interpret(*modules):
    with contextlib.ExitStack() as st:
        for m in modules:
            st.enter_context(interpret_pallas(m))
        yield


def _mlp_weights(rng, L, K, F, gs_gate, gs_down):
    wg = rng.integers(-128, 128, (L, K // 2, F)).astype(np.int8)
    wu = rng.integers(-128, 128, (L, K // 2, F)).astype(np.int8)
    wd = rng.integers(-128, 128, (L, F // 2, K)).astype(np.int8)
    sg = rng.uniform(0.01, 0.02, (L, K // gs_gate, F)).astype(np.float32)
    su = rng.uniform(0.01, 0.02, (L, K // gs_gate, F)).astype(np.float32)
    sd = rng.uniform(0.01, 0.02, (L, F // gs_down, K)).astype(np.float32)
    return wg, sg, wu, su, wd, sd


@pytest.mark.parametrize("M", [1, 8, 256])
def test_fused_mlp_plain_matches_jax_kernel(M):
    rng = np.random.default_rng(4)
    L, K, F, gs_gate, gs_down, layer = 2, 256, 512, 64, 128, 1
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = _mlp_weights(rng, L, K, F, gs_gate, gs_down)
    with interpret_pallas(jfs):
        want = jfs.fused_mlp(jnp.asarray(x), *map(jnp.asarray, w), layer,
                             gs_gate=gs_gate, gs_down=gs_down, block_n=256)
    got = tfs.fused_mlp_plain(_t(x), *map(_t, w), layer, gs_gate=gs_gate,
                              gs_down=gs_down)
    assert got.dtype == torch.float32 and got.shape == (M, K)
    want = np.asarray(want)
    # both round x and h to bf16; the sums run in another order (the TPU
    # kernel scales each group's exact integer-weight dot, the plain
    # version dots x with the scaled weights), so an h near a bf16 rounding
    # boundary may round the other way: one bf16 ulp (2^-8 relative) of
    # one of the F terms of an output, < 5e-4 of the largest output
    # (measured: 4e-7 at M = 1 and 8, 9e-5 at M = 256)
    tol = 5e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("G", [7, 8])
@pytest.mark.parametrize("row0", [0, 4])
def test_fused_attn_mlp_plain_matches_jax_kernel(row0, G):
    rng = np.random.default_rng(1)
    L, B, Hk, D, S = 2, 8, 2, 128, 256
    Ba, Mb, K, F = 4, 8, 256, 512
    gs_gate, gs_down = 64, 128
    layer_a, layer_m = 1, 0
    bf = jnp.bfloat16
    q = jnp.asarray(rng.normal(size=(Ba, Hk, G, D)), jnp.float32).astype(bf)
    k_cache = jnp.asarray(rng.normal(size=(L, B, Hk, S, D)),
                          jnp.float32).astype(bf)
    v_cache = jnp.asarray(rng.normal(size=(L, B, Hk, S, D)),
                          jnp.float32).astype(bf)
    lens = rng.integers(1, S, size=(Ba,)).astype(np.int32)
    x = rng.normal(size=(Mb, K)).astype(np.float32)
    w = _mlp_weights(rng, L, K, F, gs_gate, gs_down)
    q8 = jnp.pad(q, ((0, 0), (0, 0), (0, 8 - G), (0, 0)))
    with interpret_pallas(jfs):
        j_attn, j_y = jfs.fused_attn_mlp(
            jnp.asarray(lens), jnp.asarray([layer_a], jnp.int32),
            jnp.asarray([layer_m], jnp.int32), q8, k_cache, v_cache,
            jnp.asarray(x), *map(jnp.asarray, w), scale=D ** -0.5,
            gs_gate=gs_gate, gs_down=gs_down, block_n=256, block_s=128,
            row0=row0)

    def tbf(a):
        return _t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    t_attn, t_y = tfs.fused_attn_mlp_plain(
        _t(lens), layer_a, layer_m, tbf(q).reshape(Ba, 1, Hk * G, D),
        tbf(k_cache), tbf(v_cache), _t(x), *map(_t, w), gs_gate=gs_gate,
        gs_down=gs_down, row0=row0)
    assert t_attn.dtype == torch.bfloat16 and t_attn.shape == (Ba, 1,
                                                               Hk * G, D)
    want_attn = np.asarray(j_attn[:, :, :G].astype(jnp.float32))
    # both take f32 scores and round the probabilities to bf16 before P.V;
    # the sums run in another order and both round the output to bf16:
    # two bf16 ulps of |attn| < 1 (measured: one, 3.9e-3)
    np.testing.assert_allclose(
        t_attn.float().reshape(Ba, Hk, G, D).numpy(), want_attn, rtol=0,
        atol=8e-3)
    want_y = np.asarray(j_y)
    # the MLP half: fused_mlp's rule above
    np.testing.assert_allclose(t_y.numpy(), want_y, rtol=0,
                               atol=5e-4 * np.abs(want_y).max())


@pytest.mark.parametrize("pos", [5, 255])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_uniform_plain_matches_jax_kernel_bit_for_bit(dtype, pos):
    rng = np.random.default_rng(2)
    L, B, Hk, S, D, Bn, row0, layer = 2, 8, 2, 256, 128, 4, 4, 1
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    kc = jnp.asarray(rng.normal(size=(L, B, Hk, S, D)), jnp.float32).astype(jdt)
    vc = jnp.asarray(rng.normal(size=(L, B, Hk, S, D)), jnp.float32).astype(jdt)
    kn = rng.normal(size=(Bn, 1, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(Bn, 1, Hk, D)).astype(np.float32)

    def f32(a):
        return np.asarray(a.astype(jnp.float32))

    tk, tv = _t(f32(kc)).to(tdt), _t(f32(vc)).to(tdt)
    k0, v0 = tk.clone(), tv.clone()
    with interpret_pallas(jka):
        jk, jv = jka.kv_append_uniform(kc, vc, jnp.asarray(kn),
                                       jnp.asarray(vn), pos, layer, row0=row0)
    gk, gv = tka.kv_append_uniform_plain(tk, tv, _t(kn), _t(vn), pos, layer,
                                         row0)
    assert gk is tk and gv is tv
    np.testing.assert_array_equal(gk.float().numpy(), f32(jk))
    np.testing.assert_array_equal(gv.float().numpy(), f32(jv))
    # only the window's rows at the position changed
    changed = (gk != k0).any(dim=-1) | (gv != v0).any(dim=-1)
    assert changed.nonzero().tolist() == [
        [layer, b, h, pos] for b in range(row0, row0 + Bn) for h in range(Hk)]
    # the same through the wrapper (a CPU tensor: the plain version)
    wk, wv = tka.kv_append_uniform(k0.clone(), v0.clone(), _t(kn), _t(vn),
                                   torch.tensor([pos]), layer, row0)
    assert torch.equal(wk, gk) and torch.equal(wv, gv)


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

_GATE_MODELS = {}


def _gate_model(case):
    """(jax cfg, jax params, port cfg, port params) of one variant."""
    if case in _GATE_MODELS:
        return _GATE_MODELS[case]
    kw = dict(PUMP, num_layers=1)
    bits, gs, pad_free = 4, 64, True
    if case == "W8":
        bits = 8
    elif case == "padded down":  # F = 21 * 512: down K padded at gs 256
        kw.update(intermediate_size=21 * 512)
        gs, pad_free = 256, False
    elif case == "G > 8":
        kw.update(num_heads=18, num_kv_heads=2)
    jcfg = j_tiny_config(**kw)
    jparams = jqwen.init_quantized_params(jcfg, jax.random.PRNGKey(3),
                                          bits=bits, group_size=gs,
                                          dtype=jnp.float32, pad_free=pad_free)
    if case == "bias":
        layers = dict(jparams["layers"])
        gate = layers["gate"]
        layers["gate"] = dataclasses.replace(
            gate, b=jnp.zeros((1, gate.q.shape[-1]), jnp.float32))
        jparams = dict(jparams, layers=layers)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    _GATE_MODELS[case] = (jcfg, jparams, tiny_config(**kw), tparams)
    return _GATE_MODELS[case]


# case, model variant, batch, KV kind, pumped_supported's expected answer
PUMP_CASES = [
    ("batch 128", "base", 128, "bf16", False),
    ("batch 130", "base", 130, "bf16", True),
    ("batch 192", "base", 192, "bf16", True),
    ("odd batch", "base", 193, "bf16", False),
    ("int8 KV", "base", 192, "int8", False),
    ("paged", "base", 192, "paged", False),
    ("W8", "W8", 192, "bf16", False),
    ("padded down", "padded down", 192, "bf16", False),
    ("G > 8", "G > 8", 192, "bf16", False),
    ("bias", "bias", 192, "bf16", False),
]


@pytest.mark.parametrize("case,model,batch,kv,expect", PUMP_CASES,
                         ids=[c[0] for c in PUMP_CASES])
def test_pumped_supported_matches_jax(case, model, batch, kv, expect):
    jcfg, jparams, tcfg, tparams = _gate_model(model)
    L, Hk, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    if kv == "paged":
        jc = JPagedKVCache.create(L, 8, 256, Hk, D, dtype=jnp.float32)
        tc = PagedKVCache.create(L, 8, 256, Hk, D, dtype=torch.float32)
    else:
        jdt, tdt = ((jnp.int8, torch.int8) if kv == "int8"
                    else (jnp.bfloat16, torch.bfloat16))
        jc = JKVCache.create(L, 2, 256, Hk, D, dtype=jdt)
        tc = KVCache.create(L, 2, 256, Hk, D, dtype=tdt)
    want = jqwen.pumped_supported(jcfg, jparams, jc, batch)
    assert want == expect
    assert tqwen.pumped_supported(tcfg, tparams, tc, batch) == want


# case, model variant, rows, fused_mlp_supported's expected answer
MLP_CASES = [
    ("m 1", "base", 1, True), ("m 256", "base", 256, True),
    ("m 257", "base", 257, False), ("W8", "W8", 8, False),
    ("padded down", "padded down", 8, False), ("G > 8", "G > 8", 8, True),
    ("bias", "bias", 8, False),
]


@pytest.mark.parametrize("case,model,m,expect", MLP_CASES,
                         ids=[c[0] for c in MLP_CASES])
def test_fused_mlp_supported_matches_jax(case, model, m, expect):
    _, jparams, _, tparams = _gate_model(model)
    jl, tl = jparams["layers"], tparams["layers"]
    want = jfs.fused_mlp_supported(jl["gate"], jl["up"], jl["down"], m)
    assert want == expect
    assert tfs.fused_mlp_supported(tl["gate"], tl["up"], tl["down"],
                                   m) == want


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

_PUMP_MODEL = {}


def _pump_model():
    """The pumped parity model of tests/test_fused_step.py in both
    packages: f32, pad-free INT4 gs 64 (down gs 64 too)."""
    if not _PUMP_MODEL:
        jcfg = j_tiny_config(**PUMP)
        jparams = jqwen.init_quantized_params(
            jcfg, jax.random.PRNGKey(7), bits=4, group_size=64,
            dtype=jnp.float32, pad_free=True)
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams))
        _PUMP_MODEL.update(j=(jcfg, jparams), t=(tiny_config(**PUMP),
                                                 tparams))
    return _PUMP_MODEL["j"], _PUMP_MODEL["t"]


def _jax_kernels():
    """The JAX package's Pallas calls in interpret mode, and its projections
    through the Pallas matmul (as tests/test_fused_step.py runs them)."""
    st = contextlib.ExitStack()
    for m in (jfs, jka, jqm, jda, jfa):
        st.enter_context(interpret_pallas(m))
    st.enter_context(mock.patch.object(jlin, "_pallas_available",
                                       lambda: True))
    return st


def _cache_from_jax(jc) -> KVCache:
    return KVCache(k=_t(np.asarray(jc.k)), v=_t(np.asarray(jc.v)))


def test_decode_step_pumped_matches_jax():
    (jcfg, jparams), (tcfg, tparams) = _pump_model()
    assert tqwen.pumped_supported(tcfg, tparams,
                                  KVCache.create(3, 4, 256, 1, 128), 192)
    B, T, S = 4, 8, 256
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.full((B,), T, np.int32)
    jc = JKVCache.create(3, B, S, 1, 128, dtype=jnp.float32)
    logits, jc = jqwen.prefill(jparams, jcfg, jnp.asarray(prompts),
                               jnp.asarray(lens), jc)
    # both packages start from the JAX prefill's cache
    tc = _cache_from_jax(jc)
    tc_plain = _cache_from_jax(jc)
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    with _jax_kernels():
        for s in range(3):
            pos = lens + s
            want, jc = jqwen.decode_step_pumped(
                jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc,
                block_n=256, block_s=128)
            got, tc = tqwen.decode_step_pumped(tparams, tcfg,
                                               _t(tok).long(),
                                               _t(pos).long(), tc)
            plain, tc_plain = tqwen.decode_step(tparams, tcfg, _t(tok).long(),
                                                _t(pos).long(), tc_plain,
                                                uniform_decode=True)
            want = np.asarray(want)
            # the JAX kernel rounds the probabilities to bf16 over an f32
            # cache, the port's plain attention only over a bf16 one; the
            # MLP sums run in another order (fused_mlp's rule): logits of
            # |x| <= ~4 move by up to 4.6e-3 (measured)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2,
                                       err_msg=f"step {s}")
            # the port's plain decode_step runs the same fused MLP but
            # full-precision queries and the unfused last MLP (the JAX
            # test allows 4e-3 between its two paths; measured here: 4e-3)
            np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                       atol=1e-2, err_msg=f"step {s}")
            ids = got.argmax(-1).numpy()
            np.testing.assert_array_equal(ids, want.argmax(-1))
            np.testing.assert_array_equal(ids, plain.argmax(-1).numpy())
            tok = ids.astype(np.int32)
    # the caches: layer 0's fresh rows depend on the embeddings only (bit
    # for bit); deeper layers' carry the paths' rounding differences
    # (|k| <= ~3.5; measured up to 9.7e-3)
    written = slice(T, T + 3)
    for a, b in ((tc.k, tc_plain.k), (tc.v, tc_plain.v)):
        assert torch.equal(a[0, :, :, written], b[0, :, :, written])
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-2)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-2)
    assert not tc.k[:, :, :, T + 3:].any()


def test_w4a16_forward_takes_the_fused_mlp_like_jax(monkeypatch):
    """The W4A16 forward (pad-free INT4, F 512, M <= 256) runs ``fused_mlp``
    once a layer, as the JAX forward with attn_impl="pallas" does: a
    prefill of 2 x 8 tokens, then 2 uniform decode steps."""
    (jcfg, jparams), (tcfg, tparams) = _pump_model()
    calls = []
    orig = tqwen.fused_mlp

    def spy(x, *a, **k):
        calls.append(x.shape[0])
        return orig(x, *a, **k)

    monkeypatch.setattr(tqwen, "fused_mlp", spy)
    B, T, S = 2, 8, 256
    rng = np.random.default_rng(5)
    toks = rng.integers(2, 512, size=(B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jc = JKVCache.create(3, B, S, 1, 128, dtype=jnp.float32)
    tc = KVCache.create(3, B, S, 1, 128, dtype=torch.float32)
    with _interpret(jfs, jka, jda, jfa):
        jh, jc = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(pos), jc, fresh_prefill=True,
                                      attn_impl="pallas")
        th, tc = tqwen.forward_hidden(tparams, tcfg, _t(toks).long(),
                                      _t(pos).long(), tc, fresh_prefill=True)
        # both round the MLP's x and h to bf16 (f32 params); the sums run
        # in another order (fused_mlp's rule), and the JAX decode kernel
        # rounds the probabilities to bf16 over the f32 cache: hidden
        # states of |x| <= ~4 move by up to 6e-3 (measured)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=2e-2)
        for s in range(2):
            tok = rng.integers(2, 512, size=(B, 1)).astype(np.int32)
            p = np.full((B, 1), T + s, np.int32)
            jh, jc = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(tok),
                                          jnp.asarray(p), jc,
                                          uniform_decode=True,
                                          attn_impl="pallas")
            th, tc = tqwen.forward_hidden(tparams, tcfg, _t(tok).long(),
                                          _t(p).long(), tc,
                                          uniform_decode=True)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                       atol=2e-2, err_msg=f"step {s}")
    assert calls == [B * T] * 3 + [B] * 6


@pytest.mark.parametrize("case", ["default", "pumped aligned",
                                  "pumped ragged"])
def test_engine_pumps_aligned_batches_of_more_than_128(monkeypatch, case):
    """Engine.generate(device="cpu") at max_batch 130 with pad-free INT4
    weights decodes through decode_step_pumped only when the engine is
    built with pumped=True and the batch is aligned; by default (the JAX
    engine off a TPU) and on a ragged batch it decodes through decode_step.
    An aligned batch's ids equal prefill + its decode step by hand."""
    _, (tcfg, tparams) = _pump_model()
    B = 130
    calls = {"pumped": [], "plain": []}
    orig, orig_plain = tqwen.decode_step_pumped, tqwen.decode_step
    import qwen_inference_engine_tpu_torch.engine.engine as teng
    import qwen_inference_engine_tpu_torch.parallel.tp_step as ttp

    def spy(kind, fn):
        def wrapped(*a, **k):
            calls[kind].append(a[2].shape[0])
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(teng, "decode_step_pumped", spy("pumped", orig))
    # the engine's plain step is tp_step.make_tp_decode_fn's
    monkeypatch.setattr(ttp, "decode_step", spy("plain", orig_plain))
    greedy = SamplingParams(greedy=True)
    pumped = case != "default"
    eng = Engine(tcfg, tparams, max_batch=B, max_seq=256, sampling=greedy,
                 device="cpu", pumped=pumped)
    rng = np.random.default_rng(9)
    prompts = rng.integers(2, 512, size=(B, 6)).tolist()
    if case == "pumped ragged":
        ragged = [p[:3 + i % 3] for i, p in enumerate(prompts)]
        res = eng.generate(ragged, max_new_tokens=3)
        assert calls == {"pumped": [], "plain": [B] * 2}
        assert len(res.token_ids) == B
        return
    res = eng.generate(prompts, max_new_tokens=4)
    assert calls == ({"pumped": [B] * 3, "plain": []} if pumped
                     else {"pumped": [], "plain": [B] * 3})

    # the same steps by hand
    cache = eng.new_cache()
    toks = torch.tensor(prompts)
    lens = torch.full((B,), 6)
    toks = torch.nn.functional.pad(toks, (0, 10))   # the 16-token bucket
    with torch.inference_mode():
        logits, cache = tqwen.prefill_chunked(tparams, tcfg, toks, lens,
                                              cache)
        tok = sample(logits, greedy, None, None)
        cols = [tok]
        done = torch.isin(tok, torch.tensor(tcfg.eos_token_ids))
        for step in range(1, 4):
            pos = lens + step - 1
            if pumped:
                logits, cache = orig(tparams, tcfg, tok, pos, cache)
            else:
                logits, cache = orig_plain(tparams, tcfg, tok, pos, cache,
                                           uniform_decode=True)
            nxt = sample(logits, greedy, None, None)
            is_eos = torch.isin(nxt, torch.tensor(tcfg.eos_token_ids))
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (is_eos & ~done)
            tok = nxt
            cols.append(tok)
    by_hand = torch.stack(cols, 1).tolist()
    for got, want in zip(res.token_ids, by_hand):
        assert got == want[:len(got)]
