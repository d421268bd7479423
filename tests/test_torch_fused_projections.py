"""Offline-fused projections (``fuse_projections``, the ``qkv`` / ``gateup``
branches of ``forward_hidden``): the port against the JAX package on the
CPU.

* ``fuse_projections``' leaves byte-equal to the JAX function's, carried
  over with ``params_from_numpy`` (INT4 gs 16 with Qwen2 biases, INT8 gs
  64, W8A8 one scale per column, Qwen3 with qk-norm), and the pairs the
  JAX function leaves split (bf16 weights, mixed group sizes, mixed bits,
  a bias on some parts only, a different packed K) left split by both; a
  Qwen3-MoE tree fuses ``qkv`` only (the JAX function raises KeyError on
  it: it reads ``gate``, which an MoE tree lacks);
* the fused forward against the JAX fused forward (prefill and 3 decode
  steps, aligned and ragged, f32: 1e-3, the split forward's rule in
  ``tests/test_torch_model.py``), and the MoE forward against the JAX
  forward over hand-fused ``qkv`` (1e-4);
* the JAX ``test_fused_projections_match_split`` in the port: greedy
  tokens fused equal split, and equal the JAX package's;
* ``Engine.generate``, ``generate_speculative`` and the serving engine
  (plain, prompt lookup, a fused drafter) give the split parameters'
  tokens, and the JAX engine's on fused parameters;
* fused parameters never reach ``fused_mlp`` (counted) or the pumped
  decode (``pumped_supported``), as in the JAX package; ``save_quantized``
  refuses them.
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
from qwen_inference_engine_tpu.ops.linear import QuantLinear as JQuantLinear
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu.quant.quantize import QuantConfig as JQuantConfig
from qwen_inference_engine_tpu.quant.quantize import (
    fuse_projections as j_fuse_projections,
)
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_linear as j_quantize_linear,
)
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.loader.qcheckpoint import save_quantized
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from qwen_inference_engine_tpu_torch.quant.quantize import (
    QuantConfig,
    fuse_projections,
    quantize_params,
)
from tests import test_torch_moe
from tests.test_torch_model import _build

GREEDY = SamplingParams(greedy=True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test: the suite runs several workers on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def _assert_same_layers(got: dict, want: dict) -> None:
    """Equal leaf names, and every tensor of every leaf byte-equal."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w), name
        if isinstance(w, torch.Tensor):
            assert torch.equal(g, w), name
            continue
        if isinstance(w, QuantLinear):
            assert (g.bits, g.group_size) == (w.bits, w.group_size), name
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), (name, f.name)
            else:
                assert a == b, (name, f.name)


def _requant(jparams, name, **kw):
    """The JAX tree with one projection quantized again from a random f32
    weight of its shape (``kw`` to ``quantize_linear``), bias kept."""
    layers = dict(jparams["layers"])
    old = layers[name]
    K = old.q.shape[-2] * (2 if old.bits == 4 else 1)
    w = np.random.default_rng(1).normal(size=(old.q.shape[0], K,
                                              old.q.shape[-1]))
    layers[name] = dataclasses.replace(
        j_quantize_linear(JLinear(w=jnp.asarray(w, jnp.float32)), **kw),
        b=old.b)
    return dict(jparams, layers=layers)


def _case(case):
    """The JAX tree of one case and whether (qkv, gateup) fuse."""
    if case == "int4 gs 16, qwen2 biases":
        return _build(False, bits=4, group_size=16, act_bits=0)[1], (True, True)
    if case == "int8 gs 64":
        return _build(False, bits=8, group_size=64, act_bits=0)[1], (True, True)
    if case == "w8a8 per column":
        return _build(False, bits=8, group_size=None, act_bits=8)[1], (True,
                                                                      True)
    if case == "qwen3 qk_norm":
        return _build(True, bits=4, group_size=64, act_bits=8)[1], (True, True)
    if case == "bf16 stays split":
        cfg = j_tiny_config()
        return jqwen.init_params(cfg, jax.random.PRNGKey(2),
                                 dtype=jnp.float32), (False, False)
    base = _build(False, bits=4, group_size=32, act_bits=0)[1]
    if case == "mixed group size":
        return _requant(base, "k", bits=4, group_size=16), (False, True)
    if case == "mixed bits":
        return _requant(base, "up", bits=8, group_size=32), (True, False)
    if case == "bias on some parts":
        layers = dict(base["layers"])
        layers["v"] = dataclasses.replace(layers["v"], b=None)
        return dict(base, layers=layers), (False, True)
    if case == "mixed packed K":
        layers = dict(base["layers"])
        g = layers["gate"]
        layers["gate"] = JQuantLinear(
            q=jnp.pad(g.q, ((0, 0), (0, 32), (0, 0))),
            scales=jnp.pad(g.scales, ((0, 0), (0, 2), (0, 0))), b=g.b,
            bits=g.bits, group_size=g.group_size)
        return dict(base, layers=layers), (True, False)
    raise KeyError(case)


CASES = ["int4 gs 16, qwen2 biases", "int8 gs 64", "w8a8 per column",
         "qwen3 qk_norm", "bf16 stays split", "mixed group size",
         "mixed bits", "bias on some parts", "mixed packed K"]


@pytest.mark.parametrize("case", CASES)
def test_fuse_projections_leaves_equal_the_jax_function(case):
    """The port's fuse of the carried-over split tree equals the JAX fuse
    carried over (``params_from_numpy`` takes the fused tree unchanged)."""
    jparams, (qkv, gateup) = _case(case)
    jfused = j_fuse_projections(jparams)
    want = params_from_numpy(_np_tree(jfused))
    got = fuse_projections(params_from_numpy(_np_tree(jparams)))
    assert ("qkv" in got["layers"]) == qkv
    assert ("gateup" in got["layers"]) == gateup
    assert ("q" in got["layers"]) != qkv and ("gate" in got["layers"]) != gateup
    _assert_same_layers(got["layers"], want["layers"])
    for k in ("embed", "final_norm"):
        assert torch.equal(got[k], want[k])


def test_moe_tree_fuses_qkv_only():
    """A Qwen3-MoE tree: the port fuses q / k / v and leaves the experts;
    the JAX function raises KeyError ('gate') on such a tree, so the qkv
    leaf is held to the JAX concatenation of the three leaves."""
    jcfg, jparams, tcfg, tparams = test_torch_moe._models("w4a16")
    with pytest.raises(KeyError):
        j_fuse_projections(jparams)
    fused = fuse_projections(tparams)
    layers = fused["layers"]
    assert "qkv" in layers and not {"q", "k", "v", "gateup"} & set(layers)
    assert {"moe_gate", "moe_up", "moe_down", "router"} <= set(layers)
    jl = jparams["layers"]
    for f in ("q", "scales"):
        want = np.concatenate([np.asarray(getattr(jl[n], f))
                               for n in ("q", "k", "v")], axis=-1)
        np.testing.assert_array_equal(getattr(layers["qkv"], f).numpy(), want)


def _jax_fuse_qkv(jparams):
    """The JAX fused tree of an MoE model: q / k / v concatenated by hand
    (what ``fuse_projections``' qkv step builds before it fails on gate)."""
    layers = dict(jparams["layers"])
    lins = [layers.pop(n) for n in ("q", "k", "v")]
    layers["qkv"] = JQuantLinear(
        q=jnp.concatenate([lin.q for lin in lins], axis=-1),
        scales=jnp.concatenate([lin.scales for lin in lins], axis=-1),
        b=None, bits=lins[0].bits, group_size=lins[0].group_size)
    return dict(jparams, layers=layers)


def test_moe_fused_forward_matches_jax():
    """The fused qkv branch with MoE layers: a fresh prefill of 2 x 9
    tokens against the JAX forward over hand-fused qkv (W4A16 experts,
    both CPU paths dequantize: 1e-4, the MoE forward's rule)."""
    jcfg, jparams, tcfg, tparams = test_torch_moe._models("w4a16")
    jfused = _jax_fuse_qkv(jparams)
    tfused = fuse_projections(tparams)
    rng = np.random.default_rng(4)
    toks = rng.integers(2, 512, size=(2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jc = JKVCache.create(2, 2, 32, jcfg.num_kv_heads, jcfg.head_dim,
                         dtype=jnp.float32)
    tc = KVCache.create(2, 2, 32, tcfg.num_kv_heads, tcfg.head_dim,
                        dtype=torch.float32)
    jh, _ = jqwen.forward_hidden(jfused, jcfg, jnp.asarray(toks),
                                 jnp.asarray(pos), jc, fresh_prefill=True,
                                 attn_impl="xla")
    th, _ = tqwen.forward_hidden(tfused, tcfg, _t(toks).long(),
                                 _t(pos).long(), tc, fresh_prefill=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


# (qk_norm, bits, group_size, act_bits)
MODELS = {"qwen2 w4a8": (False, 4, 64, 8), "qwen3 w4a8": (True, 4, 64, 8),
          "qwen2 w8a16": (False, 8, 64, 0)}
_FUSED = {}


def _fused_models(name):
    """(jax cfg, jax fused params, port cfg, port split params, port fused
    params) of one model."""
    if name not in _FUSED:
        qk, bits, gs, act = MODELS[name]
        jcfg, jparams, tcfg, tparams = _build(qk, bits=bits, group_size=gs,
                                              act_bits=act)
        _FUSED[name] = (jcfg, j_fuse_projections(jparams), tcfg, tparams,
                        fuse_projections(tparams))
    return _FUSED[name]


@pytest.mark.parametrize("ragged", [False, True], ids=["aligned", "ragged"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_forward_matches_jax_fused_forward(name, ragged):
    """Prefill logits, 3 decode steps and the cache against the JAX fused
    forward (attn_impl="xla", f32 caches): 1e-3, as the split forward."""
    jcfg, jfused, tcfg, _, tfused = _fused_models(name)
    assert "qkv" in tfused["layers"] and "gateup" in tfused["layers"]
    B, T, S = 2, 16, 64
    lens = np.asarray([9, 16] if ragged else [16, 16], np.int32)
    rng = np.random.default_rng(5)
    toks = rng.integers(2, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    jcache = JKVCache.create(jcfg.num_layers, B, S, jcfg.num_kv_heads,
                             jcfg.head_dim, dtype=jnp.float32)
    tcache = KVCache.create(tcfg.num_layers, B, S, tcfg.num_kv_heads,
                            tcfg.head_dim, dtype=torch.float32)
    jl, jcache = jqwen.prefill(jfused, jcfg, jnp.asarray(toks),
                               jnp.asarray(lens), jcache, attn_impl="xla")
    tl, tcache = tqwen.prefill(tfused, tcfg, _t(toks).long(),
                               _t(lens).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    for step in range(3):
        nxt = rng.integers(2, jcfg.vocab_size, size=(B,)).astype(np.int32)
        pos = lens + step
        jl, jcache = jqwen.decode_step(jfused, jcfg, jnp.asarray(nxt),
                                       jnp.asarray(pos), jcache,
                                       attn_impl="xla",
                                       uniform_decode=not ragged)
        tl, tcache = tqwen.decode_step(tfused, tcfg, _t(nxt).long(),
                                       _t(pos).long(), tcache,
                                       uniform_decode=not ragged)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=0)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_forward_equals_split_forward(name):
    """The same weights fused and split: prefill hidden states within f32
    rounding of each other (1e-5; the plain matmul sums each column in
    the same order, so they are equal or nearly)."""
    _, _, tcfg, tsplit, tfused = _fused_models(name)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(2, 512, size=(2, 12))).long()
    pos = torch.arange(12)[None].expand(2, 12)
    outs = []
    for p in (tsplit, tfused):
        c = KVCache.create(tcfg.num_layers, 2, 32, tcfg.num_kv_heads,
                           tcfg.head_dim, dtype=torch.float32)
        outs.append(tqwen.forward_hidden(p, tcfg, toks, pos, c,
                                         fresh_prefill=True)[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["qwen2", "qwen3"])
def test_fused_projections_match_split(qk_norm):
    """The JAX package's test_fused_projections_match_split in the port:
    INT4 gs 16 from init_params(PRNGKey(5)), prompts of 2 x 6 tokens, a
    prefill and 4 uniform decode steps; greedy tokens fused equal split,
    and equal the JAX package's run of the same steps."""
    cfg = j_tiny_config(qk_norm=qk_norm)
    jparams = j_quantize_params(
        jqwen.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32),
        JQuantConfig(bits=4, group_size=16))
    tcfg = tiny_config(qk_norm=qk_norm)
    tparams = params_from_numpy(_np_tree(jparams))
    tfused = fuse_projections(tparams)
    assert "qkv" in tfused["layers"] and "gateup" in tfused["layers"]
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (2, 6))
    lens = np.full((2,), 6)

    def run_port(p):
        cache = KVCache.create(tcfg.num_layers, 2, 64, tcfg.num_kv_heads,
                               tcfg.head_dim, dtype=torch.float32)
        logits, cache = tqwen.prefill(p, tcfg, _t(prompts).long(),
                                      _t(lens).long(), cache)
        toks = [logits.argmax(-1)]
        for s in range(4):
            logits, cache = tqwen.decode_step(p, tcfg, toks[-1],
                                              _t(lens + s).long(), cache,
                                              uniform_decode=True)
            toks.append(logits.argmax(-1))
        return torch.stack(toks).numpy()

    def run_jax(p):
        cache = JKVCache.create(cfg.num_layers, 2, 64, cfg.num_kv_heads,
                                cfg.head_dim, dtype=jnp.float32)
        logits, cache = jqwen.prefill(p, cfg, jnp.asarray(prompts, jnp.int32),
                                      jnp.asarray(lens, jnp.int32), cache)
        toks = [jnp.argmax(logits, -1)]
        for s in range(4):
            logits, cache = jqwen.decode_step(
                p, cfg, toks[-1].astype(jnp.int32),
                jnp.asarray(lens + s, jnp.int32), cache, uniform_decode=True)
            toks.append(jnp.argmax(logits, -1))
        return np.asarray(jnp.stack(toks))

    split = run_port(tparams)
    np.testing.assert_array_equal(run_port(tfused), split)
    np.testing.assert_array_equal(split, run_jax(j_fuse_projections(jparams)))


PROMPTS = {
    "aligned": [[5, 9, 17, 3, 44, 61, 7], [100, 200, 300, 400, 500, 42, 11]],
    "ragged": [[5, 9, 17, 3], [100, 200, 300, 400, 500, 42, 11, 12, 13, 14,
                               15, 16, 17, 18, 19, 20, 21], [7]],
}


@pytest.mark.parametrize("batch", sorted(PROMPTS))
@pytest.mark.parametrize("name", ["qwen2 w4a8", "qwen3 w4a8"])
def test_engine_generate_fused_equals_split_and_jax(name, batch):
    """Greedy ``Engine.generate`` on fused parameters: the split
    parameters' tokens, and the JAX engine's on its fused tree."""
    jcfg, jfused, tcfg, tsplit, tfused = _fused_models(name)
    prompts = PROMPTS[batch]
    B = len(prompts)
    want = JEngine(jcfg, jfused, max_batch=B, max_seq=128,
                   sampling=JSampling(greedy=True),
                   kv_dtype=jnp.float32).generate(
        prompts, max_new_tokens=10).token_ids
    got = {}
    for kind, p in (("split", tsplit), ("fused", tfused)):
        eng = Engine(tcfg, p, max_batch=B, max_seq=128, sampling=GREEDY,
                     kv_dtype=torch.float32, device="cpu")
        got[kind] = eng.generate(prompts, max_new_tokens=10).token_ids
    assert got["fused"] == got["split"] == want


def test_generate_speculative_fused_equals_split():
    """Greedy prompt-lookup speculation (k 4) on fused parameters: the
    split parameters' tokens, and plain greedy generate's."""
    _, _, tcfg, tsplit, tfused = _fused_models("qwen3 w4a8")
    prompts = [[5, 9, 17, 3, 5, 9, 17, 3, 5, 9], [7, 8, 7, 8, 7, 8]]
    got = {}
    for kind, p in (("split", tsplit), ("fused", tfused)):
        eng = Engine(tcfg, p, max_batch=2, max_seq=128, sampling=GREEDY,
                     kv_dtype=torch.float32, device="cpu")
        got[kind] = eng.generate_speculative(prompts, max_new_tokens=10, k=4)
        got[kind + " plain"] = eng.generate(prompts,
                                            max_new_tokens=10).token_ids
    assert got["fused"] == got["split"] == got["fused plain"]


KW = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_seq=8,
          prefill_chunk=16)
SPEC = {"plain": {}, "pld": dict(speculative=True, spec_k=4, spec_ngram=3),
        "draft": dict(speculative=True, spec_k=3)}


def _serve(tcfg, params, spec, draft=None):
    extra = dict(draft_params=draft, draft_cfg=tcfg) if draft else {}
    eng = ContinuousBatchingEngine(tcfg, params, sampling=GREEDY,
                                   kv_dtype=torch.float32, device="cpu",
                                   **KW, **SPEC[spec], **extra)
    prompts = [[3, 14, 15, 92, 65, 35, 89, 79, 3, 14, 15, 92, 65, 35, 89, 79,
                32, 38, 46],
               [27, 18, 28, 18, 28, 45, 90, 45, 27, 18, 28]]
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, prompt=p, max_new_tokens=10))
    return {f.request_id: (f.token_ids, f.finish_reason)
            for f in eng.run_to_completion()}


@pytest.mark.parametrize("spec", sorted(SPEC))
def test_serving_fused_equals_split(spec):
    """The serving engine's ticks, pieces and verifies (prompt lookup, and
    a drafter: the fused parameters drafting for the fused target) on
    fused parameters give the split parameters' tokens."""
    _, _, tcfg, tsplit, tfused = _fused_models("qwen2 w4a8")
    want = _serve(tcfg, tsplit, spec, tsplit if spec == "draft" else None)
    got = _serve(tcfg, tfused, spec, tfused if spec == "draft" else None)
    assert got == want and len(got) == 2


# the pumped parity model of tests/test_torch_fused_step.py: pad-free INT4
# gs 64, a batch of more than 128 rows
PUMP = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=3, num_heads=2, num_kv_heads=1, head_dim=128)


def test_fused_params_decline_the_fused_mlp_and_the_pumped_decode(
        monkeypatch):
    """Pad-free INT4 weights at M <= 256 and a batch of 192: the split
    parameters take ``fused_mlp`` (once a layer) and pass
    ``pumped_supported``; fused, neither (both ask for ``gate``), and the
    forward runs gateup + down, equal to the split forward's plain
    matmuls within f32 rounding (the JAX package's trap: fused W4A16 never
    runs the fused MLP)."""
    cfg = tiny_config(**PUMP)
    jparams = jqwen.init_quantized_params(
        j_tiny_config(**PUMP), jax.random.PRNGKey(3), bits=4, group_size=64,
        dtype=jnp.float32, pad_free=True)
    tsplit = params_from_numpy(_np_tree(jparams))
    tfused = fuse_projections(tsplit)
    jfused = j_fuse_projections(jparams)
    cache = KVCache.create(3, 2, 256, 1, 128, dtype=torch.bfloat16)
    jc = JKVCache.create(3, 2, 256, 1, 128, dtype=jnp.bfloat16)
    assert tqwen.pumped_supported(cfg, tsplit, cache, 192)
    assert not tqwen.pumped_supported(cfg, tfused, cache, 192)
    assert not jqwen.pumped_supported(j_tiny_config(**PUMP), jfused, jc, 192)
    calls = []
    orig = tqwen.fused_mlp

    def spy(x, *a, **k):
        calls.append(x.shape[0])
        return orig(x, *a, **k)

    monkeypatch.setattr(tqwen, "fused_mlp", spy)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        2, 512, size=(2, 8))).long()
    pos = torch.arange(8)[None].expand(2, 8)
    out = {}
    for kind, p in (("split", tsplit), ("fused", tfused)):
        calls.clear()
        c = KVCache.create(3, 2, 256, 1, 128, dtype=torch.float32)
        out[kind] = tqwen.forward_hidden(p, cfg, toks, pos, c,
                                         fresh_prefill=True)[0]
        out[kind + " calls"] = list(calls)
    assert out["split calls"] == [16] * 3 and out["fused calls"] == []
    # fused_mlp rounds x and h to bf16 (f32 params); the three matmuls do not
    torch.testing.assert_close(out["fused"], out["split"], rtol=0, atol=2e-2)


def test_save_quantized_refuses_fused_params(tmp_path):
    """A fused checkpoint would load without its projections in either
    package's reader (both read the split names): the port refuses to
    write one."""
    cfg = tiny_config()
    gen = torch.Generator().manual_seed(0)
    params = quantize_params(tqwen.init_params(cfg, gen, dtype=torch.float32),
                             QuantConfig(bits=4, group_size=32))
    with pytest.raises(ValueError, match=r"fused \['gateup', 'qkv'\]"):
        save_quantized(str(tmp_path / "q"), cfg, fuse_projections(params))
    assert not (tmp_path / "q").exists()
    save_quantized(str(tmp_path / "q"), cfg, params)
    assert (tmp_path / "q" / "manifest.json").exists()
