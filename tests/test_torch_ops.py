"""Plain modules of the port vs the JAX package: norms, RoPE, sampling,
stacked KV writes, INT8 KV quantization.  Same numpy inputs to both; f32 on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.kvcache.cache import (
    contiguous_write_stacked as j_write_stacked,
)
from qwen_inference_engine_tpu.ops import norms as jnorms
from qwen_inference_engine_tpu.ops import rope as jrope
from qwen_inference_engine_tpu.ops import sampling as jsamp
from qwen_inference_engine_tpu.quant import kv_quant as jkvq
from qwen_inference_engine_tpu_torch.kvcache.cache import (
    KVCache,
    write_prefill_stacked,
    write_stacked,
    write_window_stacked,
)
from qwen_inference_engine_tpu_torch.ops import norms, rope, sampling
from qwen_inference_engine_tpu_torch.quant import kv_quant


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_and_qk_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 4, 32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        norms.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        norms.qk_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jnorms.qk_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        rtol=1e-6, atol=1e-6)


def test_rope_tables_and_rotation():
    jc, js = jrope.precompute_rope(64, 32, 1e4)
    tc, ts = rope.precompute_rope(64, 32, 1e4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc, js)
    got = rope.apply_rope(_t(x), _t(pos).long(), _t(jc), _t(js))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_greedy_sampling_with_penalties_matches():
    rng = np.random.default_rng(2)
    B, V = 4, 300
    logits = rng.normal(size=(B, V)).astype(np.float32) * 3
    prompts = rng.integers(0, V, size=(B, 7)).astype(np.int32)
    lens = np.asarray([7, 3, 1, 5], np.int32)
    jseen = jsamp.seen_mask_from_prompts(jnp.asarray(prompts),
                                         jnp.asarray(lens), V)
    tseen = sampling.seen_mask_from_prompts(_t(prompts).long(), _t(lens).long(), V)
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    jsp = jsamp.SamplingParams(greedy=True, repetition_penalty=1.3,
                               presence_penalty=0.4)
    tsp = sampling.SamplingParams(greedy=True, repetition_penalty=1.3,
                                  presence_penalty=0.4)
    want = jsamp.sample(jnp.asarray(logits), jax.random.PRNGKey(0), jsp, jseen)
    got = sampling.sample(_t(logits), tsp, tseen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    toks = rng.integers(0, V, size=(B,)).astype(np.int32)
    np.testing.assert_array_equal(
        sampling.update_seen_mask(tseen, _t(toks)).numpy(),
        np.asarray(jsamp.update_seen_mask(jseen, jnp.asarray(toks))))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.5), (50, 0.9)])
def test_stochastic_sampling_stays_in_support(top_k, top_p):
    """Different generators than jax.random: test the support, not tokens."""
    rng = np.random.default_rng(3)
    B, V = 3, 64
    logits = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32) * 4)
    sp = sampling.SamplingParams(temperature=0.8, top_k=top_k, top_p=top_p)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sampling.sample(logits, sp, generator=gen)
                         for _ in range(200)], dim=1)
    order = torch.argsort(logits, dim=-1, descending=True)
    for b in range(B):
        allowed = set(order[b, :top_k].tolist()) if top_k else set(range(V))
        assert set(draws[b].tolist()) <= allowed
    if top_p < 1.0:
        # nucleus: tokens whose preceding cumulative mass is >= top_p never appear
        probs = torch.softmax(logits / 0.8, dim=-1)
        for b in range(B):
            p_sorted = probs[b, order[b]]
            cum_before = torch.cumsum(p_sorted, 0) - p_sorted
            banned = set(order[b, cum_before >= top_p].tolist())
            assert not (set(draws[b].tolist()) & banned)


@pytest.mark.parametrize("fresh", [False, True])
def test_stacked_cache_writes_match(fresh):
    rng = np.random.default_rng(4)
    L, B, Hk, S, D, T = 2, 3, 2, 32, 8, 4
    cache = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    new = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    if fresh:
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    else:
        pos = np.stack([np.arange(T) + s for s in (0, 9, 20)]).astype(np.int32)
    want = j_write_stacked(jnp.asarray(cache), jnp.int32(1), jnp.asarray(new),
                           jnp.asarray(pos), fresh_prefill=fresh)
    got = _t(cache)
    if fresh:
        write_prefill_stacked(got, 1, _t(new))
    else:
        write_stacked(got, 1, _t(new), _t(pos).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_kv_bit_identical_to_jax():
    """All-zero rows (scale 0 -> divisor 1), rows whose values land on .5
    after the division (round half to even), and random rows."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 5, 4, 64)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[1, 2] = 0.0
    # absmax 127 -> scale exactly 1: every x.5 is a rounding tie
    ties = (rng.integers(-126, 126, size=64) + 0.5).astype(np.float32)
    ties[0] = 127.0
    x[2, 1, 3] = ties
    x[2, 4, 0] = -ties
    jq, js = jkvq.quantize_kv(jnp.asarray(x))
    tq, ts = kv_quant.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        kv_quant.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jkvq.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
def test_window_cache_write_matches_jax(kv_dtype):
    """The continuation chunk's uniform window write (JAX:
    dynamic_update_slice at (layer, 0, 0, start)); an int8 cache stores
    quantize_kv's bytes and scales."""
    rng = np.random.default_rng(6)
    L, B, Hk, S, D, T, start = 2, 3, 2, 256, 8, 16, 40
    k = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    cache = KVCache.create(L, B, S, Hk, D, dtype=kv_dtype)
    assert cache.quantized == (kv_dtype == torch.int8)
    cache.write(1, _t(k), _t(v), lambda arr, layer, new:
                write_window_stacked(arr, layer, new, start))

    def want(arr, new):
        return jax.lax.dynamic_update_slice(
            arr, jnp.asarray(new).swapaxes(1, 2)[None].astype(arr.dtype),
            (1, 0, 0, start) + (0,) * (arr.ndim - 4))

    for got, got_s, new in ((cache.k, cache.k_scale, k),
                            (cache.v, cache.v_scale, v)):
        if kv_dtype == torch.int8:
            q, s = jkvq.quantize_kv(jnp.asarray(new))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want(jnp.zeros(got.shape, jnp.int8), q)))
            np.testing.assert_array_equal(
                got_s.numpy(), np.asarray(want(jnp.zeros(got_s.shape), s)))
        else:
            assert got_s is None
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want(jnp.zeros(got.shape), new)))
    with pytest.raises(IndexError, match="outside the cache"):
        write_window_stacked(cache.k, 0, _t(k), S - T + 1)
