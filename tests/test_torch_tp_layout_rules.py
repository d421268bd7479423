"""The TP layouts of models that do not split evenly
(``parallel/tp_step.TpLayout``): the rule at every preset's full width,
the sequence-parallel prefill and the KV-replicated cache against the JAX
package's GSPMD runs on the virtual mesh, the GSPMD steps' one MLP path
and whole-row scales, and the JAX scheduler's own failure where the port
refuses an EP mesh.

The layout of each Qwen preset at tp 2 and 4, at W4A8 gs 256, W4A16 gs
128 and bf16, is printed and re-derived here from the rule: attention
splits its heads, replicates each KV head over ``tp / Hk`` ranks or runs
whole; ``o`` stays row-parallel where its rows split on whole groups,
else runs whole after an all-gather; F splits in units of lcm(gate / up's
kernel N multiple, down's group unit), the first ranks taking the extra
unit; the vocabulary splits where tp divides it.  The shapes come from
the port's quantizer rules on meta tensors (no weights).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.parallel.sharding import (
    make_sharded_cache as j_make_sharded_cache,
    shard_params as j_shard_params,
)
from qwen_inference_engine_tpu_torch.config import PRESETS, ModelConfig
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.parallel import tp_step
from qwen_inference_engine_tpu_torch.quant import quantize as tq
from tests import torch_layout_jobs as lj
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    MOE_KW,
    jmesh,
    models,
    run,
    vocab_cat,
    worlds,
)

NAMES = [n for n in PRESETS if n.startswith("qwen")]
FORMATS = {"w4a8-gs256": (4, 256, 8), "w4a16-gs128": (4, 128, 0),
           "bf16": (16, 0, 0)}


def meta_params(cfg: ModelConfig, bits: int, gs: int) -> dict:
    """Two layers of ``cfg``'s params as meta tensors, quantized leaves
    shaped by the port's quantizer (K padding, final group size)."""
    L, D, V = 2, cfg.hidden_size, cfg.vocab_size

    def lin(k, n, bias=False):
        b = torch.empty((L, n), device="meta") if bias else None
        if bits == 16:
            return Linear(w=torch.empty((L, k, n), device="meta"), b=b)
        kp = tq._padded_k(k, bits, gs)
        g = tq._final_group_size(kp, bits, gs)
        pack = 2 if bits == 4 else 1
        return QuantLinear(q=torch.empty((L, kp // pack, n), device="meta",
                                         dtype=torch.int8),
                           scales=torch.empty((L, kp // g, n), device="meta"),
                           b=b, bits=bits, group_size=g)

    bias = cfg.attention_bias
    layers = {"input_norm": torch.empty((L, D), device="meta"),
              "post_norm": torch.empty((L, D), device="meta"),
              "q": lin(D, cfg.q_dim, bias), "k": lin(D, cfg.kv_dim, bias),
              "v": lin(D, cfg.kv_dim, bias), "o": lin(cfg.q_dim, D)}
    if cfg.is_moe:
        E, Fm = cfg.num_experts, cfg.moe_intermediate_size
        layers["router"] = Linear(w=torch.empty((L, D, E), device="meta"))
        for name, (k, n) in (("moe_gate", (D, Fm)), ("moe_up", (D, Fm)),
                             ("moe_down", (Fm, D))):
            layers[name] = torch.empty((L, E, k, n), device="meta")
    else:
        F = cfg.intermediate_size
        layers.update(gate=lin(D, F), up=lin(D, F), down=lin(F, D))
    params = {"embed": torch.empty((V, D), device="meta"), "layers": layers,
              "final_norm": torch.empty((D,), device="meta")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = Linear(w=torch.empty((D, V), device="meta"))
    return params


def _group_unit(lin) -> int:
    if not isinstance(lin, QuantLinear):
        return 1
    return lin.group_size * (2 if lin.bits == 4 else 1)


# the widths the rule gives at the formats the bench serves
EXAMPLES = {
    ("qwen2.5-7b", "w4a8-gs256", 2): "9728/9216",
    ("qwen2.5-7b", "w4a8-gs256", 4): "5120/4608/4608/4608",
    ("qwen2.5-3b", "w4a8-gs256", 2): "5632/5376",
    ("qwen2.5-3b", "w4a8-gs256", 4): "3072/3072/2560/2304",
    ("qwen2.5-0.5b", "w4a8-gs256", 4): "1536/1536/1024/768",
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("name", NAMES)
def test_layout_of_every_preset_follows_the_rule(name, fmt, tp):
    bits, gs, act = FORMATS[fmt]
    cfg = PRESETS[name].replace(num_layers=2, act_bits=act)
    params = meta_params(cfg, bits, gs)
    lay = tp_step.tp_layout(cfg, params, tp)
    print(name, fmt, lay.summary())
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lyr = params["layers"]
    # a quantizer-padded row-parallel K takes the block layout too
    padded = bits < 16 and (lyr["o"].in_features != cfg.q_dim or (
        not cfg.is_moe
        and lyr["down"].in_features != cfg.intermediate_size))
    assert lay.gspmd == (not tp_step.supports_tp(cfg, params, tp)
                         or padded)
    if not lay.gspmd:
        assert (lay.attn, lay.o, lay.vocab) == ("heads", "split", "split")
        assert lay.mlp == ("experts" if cfg.is_moe else "split")
        assert lay.local_config(cfg) == tp_step.local_config(cfg, tp)
        return
    want_attn = ("heads" if hq % tp == 0 and hk % tp == 0 else
                 "kv_replicated" if hq % tp == 0 and tp % hk == 0 else
                 "whole")
    assert lay.attn == want_attn
    if want_attn == "whole":
        assert lay.o == "whole" and lay.local_heads == (hq, hk)
    else:
        aligned = (hq // tp * d) % _group_unit(lyr["o"]) == 0
        assert lay.o == ("split" if aligned else "gather")
        assert lay.local_heads == (hq // tp, hk // tp if hk % tp == 0
                                   else 1)
    V = cfg.vocab_size
    assert lay.vocab == ("split" if V % tp == 0 else "whole")
    if cfg.is_moe:
        assert lay.mlp == ("experts" if cfg.num_experts % tp == 0
                           else "whole")
        return
    F = cfg.intermediate_size
    n_mult = 1 if bits == 16 else (128 if act == 8 else 64)
    unit = math.lcm(n_mult, _group_unit(lyr["down"]))
    n = -(-F // unit)
    if n < tp:
        assert lay.mlp == "whole"
        return
    assert lay.mlp == "split" and lay.mlp_unit == unit
    counts = [(b - a) // unit for a, b in lay.mlp_rows[:-1]]
    assert counts == [n // tp + (m < n % tp) for m in range(tp - 1)]
    assert lay.mlp_cols[-1][1] == F
    assert lay.mlp_rows[-1][1] == (tq._padded_k(F, bits, gs) if bits < 16
                                   else F)
    for (c0, c1), (r0, r1) in zip(lay.mlp_cols, lay.mlp_rows):
        assert c0 == r0 and c1 > c0 and r1 % _group_unit(lyr["down"]) == 0
        if bits < 16:
            assert (c1 - c0) % n_mult == 0
    want = EXAMPLES.get((name, fmt, tp))
    if want is not None:
        assert "/".join(str(b - a) for a, b in lay.mlp_cols) == want


# ------------------------------------------------- sequence-parallel prefill
SP_CFG = dict(CFG_KW, vocab_size=512, hidden_size=128, intermediate_size=256,
              num_layers=2)


@pytest.mark.parametrize("case,shape", [("even", (1, 2)), ("even", (1, 4)),
                                        ("kv2", (1, 4))],
                         ids=["even-(1,2)", "even-(1,4)", "kv2-(1,4)"])
def test_sequence_parallel_prefill_matches_jax_gspmd(worlds, case, shape):
    """The JAX test's sequence-sharded prefill (``tests/test_sharding.py``:
    B 2 x T 32, the token axis on ``model``, GSPMD) against the port's
    sequence-parallel prefill on the same mesh: the last tokens' logits
    within 2e-4 (rtol and atol, the JAX test's); per layer two token
    all-gathers and two reduce-scatters, the embedding's one of each and
    one all-reduce for the last rows."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    kw = dict(SP_CFG, num_kv_heads=2) if case == "kv2" else SP_CFG
    jcfg, jparams, tcfg, tparams = models(kw, seed=0)
    B, T = 2, 32
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, T))
    lens = np.array([T, 23], np.int64)
    mesh = jmesh(shape)
    cache = j_make_sharded_cache(JKVCache.create(
        jcfg.num_layers, B, 64, jcfg.num_kv_heads, jcfg.head_dim,
        dtype=jnp.float32), mesh)
    toks = jax.device_put(jnp.asarray(prompts, jnp.int32),
                          NamedSharding(mesh, P(None, "model")))
    with mesh:
        want, _ = jax.jit(lambda p, t, l, c: jqwen.prefill(p, jcfg, t, l, c))(
            j_shard_params(jparams, mesh), toks, jnp.asarray(lens, jnp.int32),
            cache)
    got = run(worlds, shape, lj.sp_prefill, tcfg, tparams,
              prompts.astype(np.int64), lens)
    logits = vocab_cat([g[0] for g in got], shape)
    np.testing.assert_allclose(logits, np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    L = jcfg.num_layers
    for r, (_, calls, _, tok_shape) in enumerate(got):
        assert tok_shape == (B, T // shape[1])
        assert calls == {"all_gather": 2 * L + 1,
                         "reduce_scatter": 2 * L + 1, "all_reduce": 1}, \
            (r, calls)


def test_local_cache_is_the_jax_cache_kv_head_of_the_rank(worlds):
    """8 query / 2 KV heads at tp 4: rank r's local cache after the TP
    prefill is the JAX GSPMD prefill's cache at KV head r // 2 (full
    head_dim), and the logits agree within 1e-5 of the largest."""
    kw = dict(SP_CFG, num_kv_heads=2)
    jcfg, jparams, tcfg, tparams = models(kw, seed=4)
    B, T = 2, 24
    prompts = np.random.default_rng(7).integers(2, jcfg.vocab_size, (B, T))
    mesh = jmesh((1, 4))
    cache = j_make_sharded_cache(JKVCache.create(
        jcfg.num_layers, B, 64, jcfg.num_kv_heads, jcfg.head_dim,
        dtype=jnp.float32), mesh)
    with mesh:
        want, jcache = jax.jit(
            lambda p, t, l, c: jqwen.prefill(p, jcfg, t, l, c))(
            j_shard_params(jparams, mesh), jnp.asarray(prompts, jnp.int32),
            jnp.full((B,), T, jnp.int32), cache)
    jk, jv = np.asarray(jcache.k), np.asarray(jcache.v)
    got = run(worlds, (1, 4), lj.prefill_cache, tcfg, tparams,
              prompts.astype(np.int64))
    for r, (_, k, v) in enumerate(got):
        assert k.shape[:3] == (jcfg.num_layers, B, 1)
        assert k.shape[4] == jcfg.head_dim
        h = slice(r // 2, r // 2 + 1)
        np.testing.assert_allclose(k[:, :, :, :T], jk[:, :, h, :T],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v[:, :, :, :T], jv[:, :, h, :T],
                                   rtol=1e-5, atol=1e-5)
    logits = vocab_cat([g[0] for g in got], (1, 4))
    want = np.asarray(want)
    assert np.abs(logits - want).max() <= 1e-5 * np.abs(want).max()


# ------------------------------------------------------- GSPMD step paths
@pytest.mark.parametrize("act", [0, 8], ids=["w4a16", "w4a8"])
def test_gspmd_layout_ranks_take_one_mlp_path_and_whole_row_scales(
        worlds, act):
    """INT4 pad-free F = 2304 at tp 4 splits 640 / 640 / 512 / 512: the
    shards of ranks 2 and 3 pass ``fused_mlp_supported`` and those of
    ranks 0 and 1 do not, yet no rank calls ``fused_mlp`` (the GSPMD
    step's MLP is the three matmuls on every rank); a decode tick's
    all-reduces are the layout's count: down's sum a layer (``o``, 32
    local rows at groups of 64, runs whole after an all-gather), the
    embedding's, and under W4A8 one whole-row maximum before down a
    layer."""
    kw = dict(CFG_KW, intermediate_size=2304, act_bits=act)
    from qwen_inference_engine_tpu_torch.config import tiny_config
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = tiny_config(**kw)
    params = init_quantized_params(cfg, torch.Generator().manual_seed(3),
                                   bits=4, group_size=64,
                                   dtype=torch.float32, pad_free=True)
    got = run(worlds, (1, 4), lj.gspmd_step_paths, cfg, params,
              [[5, 9, 17, 3, 8]])
    for r, (calls, (reduces, gathers), formula, supported, summary) in \
            enumerate(got):
        assert "GSPMD layout" in summary and "640/640/512/512" in summary
        assert "o whole after an all-gather" in summary
        assert calls == 0, r
        assert supported == (r >= 2), r
        assert reduces == formula["all_reduce"], (r, reduces, formula)
        assert formula == {"all_reduce": cfg.num_layers * (
            1 + (act == 8)) + 1, "all_gather": cfg.num_layers}
        assert gathers >= formula["all_gather"]


# --------------------------------------------------- the JAX EP fallback
@pytest.mark.parametrize("case", ["dense", "experts", "slots"])
def test_jax_scheduler_raises_where_the_port_refuses_ep(case):
    """Where ``supports_ep`` is false the JAX ``ContinuousBatchingEngine``
    drops to ``make_sharded_cache``, whose ``cache_pspecs`` reads the
    mesh's ``model`` axis: an ``("ep",)`` mesh of virtual devices has
    none, so it raises ``KeyError: 'model'`` for a dense model, for
    ``E % ep != 0`` and for ``max_slots % ep != 0``, as the port's
    refusal says."""
    from qwen_inference_engine_tpu.engine.scheduler import (
        ContinuousBatchingEngine as JCB,
    )
    from qwen_inference_engine_tpu.parallel.ep_step import (
        make_ep_mesh,
        supports_ep,
    )

    kw = {"dense": CFG_KW, "experts": dict(MOE_KW, num_experts=6),
          "slots": MOE_KW}[case]
    ep = 4 if case == "experts" else 2
    slots = 3 if case == "slots" else 4
    jcfg, jparams, _, _ = models(dict(kw, num_layers=2), seed=3)
    mesh = make_ep_mesh(ep)
    assert not supports_ep(jcfg, mesh, slots)
    with pytest.raises(KeyError, match="model"):
        JCB(jcfg, jparams, mesh=mesh, max_slots=slots, page_size=8,
            num_pages=16, max_pages_per_seq=4, kv_dtype=jnp.float32)
