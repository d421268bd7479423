"""The slice as a whole: W4A8 tiny Qwen2 / Qwen3 in both packages.

Params are built in JAX (init_params, random biases and norm weights, INT4
gs 64, act_bits 8, f32 on the CPU), carried over with params_from_numpy,
and run through both packages: prefill / decode logits against the JAX
forward with attn_impl="xla" (atol 1e-3, f32), chunked prefill (continuation
chunks) and decode in f32 and int8 caches, and greedy Engine.generate
token-identical to the JAX Engine on aligned and ragged batches.  The
long-prompt engine runs are in test_torch_engine_long.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu.quant.quantize import QuantConfig as JQuantConfig
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams


def _build(qk_norm: bool, bits: int = 4, group_size=64, act_bits: int = 8,
           quantize_lm_head: bool = False, **cfg_kw):
    """(jax cfg, jax params, port cfg, port params); ``cfg_kw`` goes to
    both packages' ``tiny_config``."""
    jcfg = j_tiny_config(qk_norm=qk_norm, **cfg_kw)
    params = jqwen.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    rng = np.random.default_rng(17 + qk_norm)
    layers = dict(params["layers"])
    for name, leaf in layers.items():
        if isinstance(leaf, JLinear) and leaf.b is not None:
            b = rng.normal(size=leaf.b.shape).astype(np.float32) * 0.5
            layers[name] = dataclasses.replace(leaf, b=jnp.asarray(b))
        elif not isinstance(leaf, JLinear):  # norm weights
            layers[name] = jnp.asarray(
                rng.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32))
    params = dict(params, layers=layers, final_norm=jnp.asarray(
        rng.uniform(0.5, 1.5, size=params["final_norm"].shape
                    ).astype(np.float32)))
    params = j_quantize_params(params, JQuantConfig(
        bits=bits, group_size=group_size, quantize_lm_head=quantize_lm_head))
    jcfg = jcfg.replace(act_bits=act_bits)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    tcfg = tiny_config(qk_norm=qk_norm, **cfg_kw).replace(act_bits=act_bits)
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module", params=[False, True], ids=["qwen2", "qwen3"])
def models(request):
    return _build(request.param)


def test_params_carried_over(models):
    _, jparams, tcfg, tparams = models
    q = tparams["layers"]["q"]
    assert isinstance(q, QuantLinear) and q.bits == 4
    assert q.q.dtype == torch.int8
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jparams["layers"]["q"].q))
    assert (q.b is not None) == tcfg.attention_bias
    if tcfg.attention_bias:
        assert float(q.b.abs().sum()) > 0


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_logits_match_jax(models, ragged):
    jcfg, jparams, tcfg, tparams = models
    B, T, S = 2, 16, 64
    lens = np.asarray([9, 16] if ragged else [16, 16], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(2, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    jcache = JKVCache.create(jcfg.num_layers, B, S, jcfg.num_kv_heads,
                             jcfg.head_dim, dtype=jnp.float32)
    tcache = KVCache.create(tcfg.num_layers, B, S, tcfg.num_kv_heads,
                            tcfg.head_dim, dtype=torch.float32)
    jl, jcache = jqwen.prefill(jparams, jcfg, jnp.asarray(toks),
                               jnp.asarray(lens), jcache, attn_impl="xla")
    tl, tcache = tqwen.prefill(tparams, tcfg, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    for step in range(3):
        nxt = rng.integers(2, jcfg.vocab_size, size=(B,)).astype(np.int32)
        pos = lens + step
        jl, jcache = jqwen.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                       jnp.asarray(pos), jcache,
                                       attn_impl="xla",
                                       uniform_decode=not ragged)
        tl, tcache = tqwen.decode_step(tparams, tcfg,
                                       torch.from_numpy(nxt).long(),
                                       torch.from_numpy(pos).long(), tcache,
                                       uniform_decode=not ragged)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=0)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("prompts,penalty", [
    ([[5, 9, 17, 3, 44, 61, 7], [100, 200, 300, 400, 500, 42, 11]], 1.0),
    ([[5, 9, 17, 3], [100, 200, 300, 400, 500, 42, 11, 12, 13, 14, 15, 16,
                      17, 18, 19, 20, 21], [7]], 1.0),
    ([[5, 9, 17, 3], [100, 200, 300, 400, 500, 42]], 1.5),
], ids=["aligned", "ragged", "ragged-penalty"])
def test_engine_greedy_token_identical_to_jax(models, prompts, penalty):
    """The penalty case runs the seen mask (prompt tokens and each sampled
    token) through both engines."""
    jcfg, jparams, tcfg, tparams = models
    jeng = JEngine(jcfg, jparams, max_batch=len(prompts), max_seq=128,
                   sampling=JSampling(greedy=True, repetition_penalty=penalty),
                   kv_dtype=jnp.float32)
    teng = Engine(tcfg, tparams, max_batch=len(prompts), max_seq=128,
                  sampling=SamplingParams(greedy=True,
                                          repetition_penalty=penalty),
                  kv_dtype=torch.float32, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=12).token_ids
    got = teng.generate(prompts, max_new_tokens=12)
    assert got.token_ids == want
    assert got.steps >= 1 and got.ttft_s > 0


def _int8_close(got: torch.Tensor, want) -> None:
    """int8 cache bytes: a 1e-6 difference of the f32 inputs may cross a
    rounding boundary, so at most 0.1% of the bytes differ, each by 1."""
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("ragged", [False, True], ids=["aligned", "ragged"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_chunked_prefill_and_decode_match_jax(models, kv, ragged):
    """prefill_chunked with chunk=16 on 40-64-token prompts (chunk 0 fresh,
    chunks 1-3 continuations), then 3 decode steps; logits and the whole
    cache against the JAX XLA path.

    In the int8 cache one byte that crosses a rounding boundary (from a
    last-bit difference of the f32 K/V the two packages compute) moves its
    value by a whole quantization step, max|x| / 127, and that moves the
    logits of every later row: by up to 5e-2 over the seeds 8-13 of this
    test on Qwen2 (seeds 8, 11, 13 cross one byte in layer 0).  The seed
    here crosses none, so the logits are held to 1e-3 in both caches."""
    jcfg, jparams, tcfg, tparams = models
    B, T, S, chunk = 2, 64, 128, 16
    lens = np.asarray([40, 57] if ragged else [53, 53], np.int32)
    rng = np.random.default_rng(9)
    toks = rng.integers(2, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "int8": (jnp.int8, torch.int8)}[kv]
    jcache = JKVCache.create(jcfg.num_layers, B, S, jcfg.num_kv_heads,
                             jcfg.head_dim, dtype=jdt)
    tcache = KVCache.create(tcfg.num_layers, B, S, tcfg.num_kv_heads,
                            tcfg.head_dim, dtype=tdt)
    jl, jcache = jqwen.prefill_chunked(jparams, jcfg, jnp.asarray(toks),
                                       jnp.asarray(lens), jcache, chunk=chunk,
                                       attn_impl="xla")
    tl, tcache = tqwen.prefill_chunked(tparams, tcfg,
                                       torch.from_numpy(toks).long(),
                                       torch.from_numpy(lens).long(), tcache,
                                       chunk=chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    for step in range(3):
        nxt = rng.integers(2, jcfg.vocab_size, size=(B,)).astype(np.int32)
        pos = lens + step
        jl, jcache = jqwen.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                       jnp.asarray(pos), jcache,
                                       attn_impl="xla",
                                       uniform_decode=not ragged)
        tl, tcache = tqwen.decode_step(tparams, tcfg,
                                       torch.from_numpy(nxt).long(),
                                       torch.from_numpy(pos).long(), tcache,
                                       uniform_decode=not ragged)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=0)
    if kv == "int8":
        _int8_close(tcache.k, jcache.k)
        _int8_close(tcache.v, jcache.v)
        for got, want in ((tcache.k_scale, jcache.k_scale),
                          (tcache.v_scale, jcache.v_scale)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6)
    else:
        assert tcache.k_scale is None
        for got, want in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-3, rtol=0)


def test_prefill_chunked_capacity_error_matches_jax(models):
    """A prompt padded to whole chunks past the cache raises the same
    ValueError in both packages (T=300 -> 3 chunks of 128 = 384 > 256)."""
    jcfg, jparams, tcfg, tparams = models
    toks = np.full((1, 300), 5, np.int32)
    lens = np.asarray([300], np.int32)
    jcache = JKVCache.create(jcfg.num_layers, 1, 256, jcfg.num_kv_heads,
                             jcfg.head_dim, dtype=jnp.float32)
    tcache = KVCache.create(tcfg.num_layers, 1, 256, tcfg.num_kv_heads,
                            tcfg.head_dim, dtype=torch.float32)
    with pytest.raises(ValueError) as jerr:
        jqwen.prefill_chunked(jparams, jcfg, jnp.asarray(toks),
                              jnp.asarray(lens), jcache, chunk=128,
                              attn_impl="xla")
    with pytest.raises(ValueError) as terr:
        tqwen.prefill_chunked(tparams, tcfg, torch.from_numpy(toks).long(),
                              torch.from_numpy(lens).long(), tcache,
                              chunk=128)
    assert str(terr.value) == str(jerr.value)
    assert "holds only 256" in str(terr.value)


# the weight formats of the CLI's defaults (act_bits 0) and W8A8, each with
# its lm_head quantized too: (bits, group_size, act_bits); group_size None
# is one INT8 scale per column
FORMATS = {"w4a16": (4, 64, 0), "w8a16": (8, 64, 0), "w8a8": (8, None, 8)}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("qk_norm", [False, True], ids=["qwen2", "qwen3"])
def test_engine_greedy_token_identical_to_jax_in_each_format(qk_norm, fmt):
    bits, gs, act_bits = FORMATS[fmt]
    jcfg, jparams, tcfg, tparams = _build(qk_norm, bits=bits, group_size=gs,
                                          act_bits=act_bits,
                                          quantize_lm_head=True)
    head = tparams["lm_head"]
    assert isinstance(head, QuantLinear) and head.bits == bits
    prompts = [[5, 9, 17, 3], [100, 200, 300, 400, 500, 42, 11, 12, 13], [7]]
    jeng = JEngine(jcfg, jparams, max_batch=3, max_seq=128,
                   sampling=JSampling(greedy=True), kv_dtype=jnp.float32)
    teng = Engine(tcfg, tparams, max_batch=3, max_seq=128,
                  sampling=SamplingParams(greedy=True),
                  kv_dtype=torch.float32, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=10).token_ids
    assert teng.generate(prompts, max_new_tokens=10).token_ids == want
