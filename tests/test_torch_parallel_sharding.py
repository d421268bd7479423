"""The port's split rules (``parallel/sharding.py``) and TP gates
(``parallel/tp_step.py``) against the JAX package's, and every mesh the
port refuses on purpose.

Each model rank's local leaves equal the JAX ``param_pspecs`` shards on
the virtual mesh (``addressable_shards``), for bf16, INT8 and INT4 params
with biases and for the MoE expert stacks; ``local_config``,
``tp_aligned_group_size`` and ``supports_tp`` equal the JAX functions on a
table of cases that includes the full Qwen2.5-7B, Qwen3-14B and
Qwen3-30B-A3B shapes (abstract trees from ``jax.eval_shape``, carried to
the port as meta tensors).  No process group is needed here, but for one
world of two ranks (``generate_speculative`` under a data axis, which the
port once refused).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.config import ModelConfig as JModelConfig
from qwen_inference_engine_tpu.kvcache.cache import (
    KVCache as JKVCache,
    PagedKVCache as JPagedKVCache,
)
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.parallel import tp_step as jtp
from qwen_inference_engine_tpu.parallel.sharding import (
    cache_pspecs as j_cache_pspecs,
    shard_params as j_shard_params,
)
from qwen_inference_engine_tpu_torch.config import ModelConfig, tiny_config
from qwen_inference_engine_tpu_torch.kvcache.cache import (
    KVCache,
    PagedKVCache,
)
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.parallel import sharding, tp_step
from qwen_inference_engine_tpu_torch.parallel.tp_kernels import (
    quant_matmul_tp_row,
)
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    MOE_KW,
    jmesh,
    models,
    worlds,
)


def fake_mesh(dp, tp, d=0, m=0):
    """A mesh's shape and coordinates without process groups (what the
    split rules and the refusals read)."""
    return types.SimpleNamespace(shape={"data": dp, "model": tp}, dp=dp,
                                 tp=tp, size=dp * tp, coords=(d, m))


def _leaves(tree, path=""):
    """{path: leaf} of a params tree of either package (Linear-like
    containers matched by their fields)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if hasattr(tree, "scales"):
        return {f"{path}.{f}": getattr(tree, f) for f in ("q", "scales", "b")
                if getattr(tree, f) is not None}
    if hasattr(tree, "w"):
        return {f"{path}.{f}": getattr(tree, f) for f in ("w", "b")
                if getattr(tree, f) is not None}
    return {path: tree}


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=str)
@pytest.mark.parametrize("case", ["bf16", "int8", "int4", "moe"])
def test_local_leaves_equal_the_jax_shards(case, shape):
    """Every leaf of model rank m's local tree equals the JAX shard on the
    device at mesh position (d, m), for every d (the data axis never
    splits params)."""
    bits = {"int8": 8, "int4": 4}.get(case, 16)
    jcfg, jparams, tcfg, tparams = models(MOE_KW if case == "moe" else CFG_KW,
                                          bits=bits)
    if case == "bf16":
        jparams = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
            jparams)
        tparams = jqwen_to_port(jparams)
    mesh = jmesh(shape)
    sharded = j_shard_params(jparams, mesh)
    jl = _leaves(sharded)
    for d in range(shape[0]):
        for m in range(shape[1]):
            local = _leaves(sharding.shard_params(
                tparams, fake_mesh(*shape, d, m)))
            assert set(local) == set(jl)
            dev = mesh.devices[d, m]
            for path, leaf in jl.items():
                shard = next(s for s in leaf.addressable_shards
                             if s.device == dev)
                want = np.asarray(shard.data).astype(np.float32)
                np.testing.assert_array_equal(
                    _np(local[path]).astype(np.float32), want,
                    err_msg=f"{path} at {(d, m)}")


def jqwen_to_port(jparams):
    from qwen_inference_engine_tpu_torch.loader.from_jax import (
        params_from_numpy,
    )

    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def test_split_dims_cover_the_tree_as_param_pspecs():
    """One split dim for each leaf ``param_pspecs`` shards on the model
    axis, None for each it replicates."""
    from qwen_inference_engine_tpu.parallel.sharding import param_pspecs

    _, jparams, _, tparams = models(MOE_KW, bits=4)
    specs = _leaves(param_pspecs(jparams))
    dims = _leaves(sharding.split_dims(tparams))
    leaves = _leaves(tparams)
    for path, leaf in leaves.items():
        spec = specs[path]
        want = next((i for i, a in enumerate(spec) if a == "model"), None)
        assert dims.get(path) == want, (path, spec, dims.get(path))


# ------------------------------------------------------------- TP gates
def _abstract(cfg_name, bits, gs, pad_free, layers=None):
    """(jax cfg, abstract jax params, port cfg, port params of meta
    tensors) of a preset at full width."""
    jcfg = JModelConfig.from_pretrained(cfg_name)
    tcfg = ModelConfig.from_pretrained(cfg_name)
    if layers is not None:
        jcfg, tcfg = jcfg.replace(num_layers=layers), tcfg.replace(
            num_layers=layers)
    key = jax.random.PRNGKey(0)
    if bits == 16:
        shapes = jax.eval_shape(lambda: jqwen.init_params(jcfg, key))
    else:
        shapes = jax.eval_shape(lambda: jqwen.init_quantized_params(
            jcfg, key, bits=bits, group_size=gs, pad_free=pad_free))

    def meta(a):
        dt = {jnp.int8: torch.int8, jnp.float32: torch.float32}.get(
            a.dtype.type, torch.bfloat16)
        return torch.empty(a.shape, dtype=dt, device="meta")

    def port(v):
        if isinstance(v, dict):
            return {k: port(x) for k, x in v.items()}
        if hasattr(v, "scales"):
            return QuantLinear(q=meta(v.q), scales=meta(v.scales),
                               b=None if v.b is None else meta(v.b),
                               bits=int(v.bits), group_size=int(v.group_size))
        if hasattr(v, "w"):
            return Linear(w=meta(v.w), b=None if v.b is None else meta(v.b))
        return meta(v)

    return jcfg, shapes, tcfg, port(shapes)


GATE_CASES = [
    ("qwen2.5-7b", 4, 128, False, 2), ("qwen2.5-7b", 4, 128, False, 4),
    ("qwen2.5-7b", 4, 64, False, 4), ("qwen2.5-7b", 4, 64, True, 4),
    ("qwen2.5-7b", 4, 128, True, 8), ("qwen2.5-7b", 8, 128, False, 4),
    ("qwen2.5-7b", 16, 0, False, 4), ("qwen2.5-7b", 16, 0, False, 8),
    ("qwen3-14b", 4, 128, False, 2), ("qwen3-14b", 4, 64, False, 4),
    ("qwen3-14b", 8, 128, False, 8), ("qwen3-14b", 16, 0, False, 4),
    ("qwen2.5-0.5b", 4, 64, False, 2), ("qwen2.5-0.5b", 16, 0, False, 4),
    ("qwen3-30b-a3b", 4, 128, False, 4), ("qwen3-30b-a3b", 8, 128, False, 8),
]


@pytest.mark.parametrize("name,bits,gs,pad_free,tp", GATE_CASES,
                         ids=["-".join(map(str, c)) for c in GATE_CASES])
def test_tp_gates_equal_jax_at_full_width(name, bits, gs, pad_free, tp):
    """``supports_tp``, ``local_config`` and, for each row-parallel
    projection, ``tp_aligned_group_size`` equal the JAX functions at the
    presets' full shapes (two layers: the gates read widths only)."""
    jcfg, jshapes, tcfg, tparams = _abstract(name, bits, gs, pad_free,
                                             layers=2)
    want = jtp.supports_tp(jcfg, jshapes, tp)
    assert tp_step.supports_tp(tcfg, tparams, tp) == want
    assert (tp_step.tp_refusal(tcfg, tparams, tp) is None) == want
    if jcfg.num_heads % tp == 0 and jcfg.num_kv_heads % tp == 0:
        jl, tl = jtp.local_config(jcfg, tp), tp_step.local_config(tcfg, tp)
        for f in ("num_heads", "num_kv_heads", "intermediate_size",
                  "hidden_size", "vocab_size", "head_dim"):
            assert getattr(tl, f) == getattr(jl, f), f
    for k in (tcfg.q_dim, tcfg.intermediate_size):
        for b in (4, 8):
            if k % tp == 0 and gs:
                assert tp_step.tp_aligned_group_size(k, tp, gs, b) == \
                    jtp.tp_aligned_group_size(k, tp, gs, b)


def test_tp_aligned_group_sizes_of_the_7b_shards():
    """Qwen2.5-7B at tp = 4: o's local K 896 and down's 4736 take INT4
    groups of 64, which the W4A8 / W4A16 kernels take (gs % 32 == 0,
    K % (2 gs) == 0); at tp = 2 groups of 128."""
    assert tp_step.tp_aligned_group_size(3584, 4, 128, 4) == 64
    assert tp_step.tp_aligned_group_size(18944, 4, 128, 4) == 64
    assert tp_step.tp_aligned_group_size(3584, 2, 128, 4) == 128
    assert tp_step.tp_aligned_group_size(18944, 2, 128, 4) == 128
    for k_local, gs in ((896, 64), (4736, 64)):
        assert gs % 32 == 0 and k_local % (2 * gs) == 0


def test_local_config_refuses_heads_that_do_not_split():
    with pytest.raises(ValueError, match="do not split over tp=3"):
        tp_step.local_config(tiny_config(), 3)
    with pytest.raises(ValueError, match="K=100"):
        tp_step.tp_aligned_group_size(100, 3, 64, 4)


# ----------------------------------------------------------------- caches
CACHE_CASES = [((1, 2), False), ((2, 2), False), ((1, 4), False),
               ((1, 2), True), ((1, 4), True)]


@pytest.mark.parametrize("shape,paged", CACHE_CASES,
                         ids=[f"{s}-{'paged' if p else 'contiguous'}"
                              for s, p in CACHE_CASES])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_local_caches_equal_the_jax_cache_shards(shape, paged, int8):
    """KV heads on ``model`` (and contiguous rows on ``data``; the page
    pool is pure-TP only): each rank's local cache equals the JAX shard of
    the same global cache under ``cache_pspecs``."""
    rng = np.random.default_rng(3)
    L, B, Hk, S, D = 2, 4, 4, 256, 8
    dt = np.int8 if int8 else np.float32
    if paged:
        k, v = (rng.integers(-9, 9, (L, 6, Hk, 8, D)).astype(dt)
                for _ in range(2))
    else:
        k, v = (rng.integers(-9, 9, (L, B, Hk, S, D)).astype(dt)
                for _ in range(2))
    sc = [rng.random(k.shape[:-1]).astype(np.float32) if int8 else None
          for _ in range(2)]
    if paged:
        jc = JPagedKVCache(jnp.asarray(k), jnp.asarray(v),
                           None if sc[0] is None else jnp.asarray(sc[0]),
                           None if sc[1] is None else jnp.asarray(sc[1]), 8)
        tc = PagedKVCache(*(None if a is None else torch.from_numpy(a)
                            for a in (k, v, sc[0], sc[1])), page_size=8)
    else:
        jc = JKVCache(*(None if a is None else jnp.asarray(a)
                        for a in (k, v, sc[0], sc[1])))
        tc = KVCache(*(None if a is None else torch.from_numpy(a)
                       for a in (k, v, sc[0], sc[1])))
    mesh = jmesh(shape)
    specs = j_cache_pspecs(jc, mesh)
    names = (("k_pages", "v_pages", "k_scale", "v_scale") if paged
             else ("k", "v", "k_scale", "v_scale"))
    from jax.sharding import NamedSharding

    for d in range(shape[0]):
        for m in range(shape[1]):
            local = sharding.make_sharded_cache(tc, fake_mesh(*shape, d, m))
            for n in names:
                leaf = getattr(jc, n)
                if leaf is None:
                    assert getattr(local, n) is None
                    continue
                put = jax.device_put(leaf, NamedSharding(mesh,
                                                         getattr(specs, n)))
                shard = next(s for s in put.addressable_shards
                             if s.device == mesh.devices[d, m])
                np.testing.assert_array_equal(getattr(local, n).numpy(),
                                              np.asarray(shard.data), n)


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged"])
def test_head_dim_split_of_the_cache_is_refused(paged):
    """No longer refused: KV heads that do not split over the model axis
    (2 over tp 4), where the JAX package shards head_dim, give each rank
    the whole KV head ``r // 2`` of the same global cache (the model's
    ``TpLayout`` replicates it); attention that runs whole keeps every
    head.  Without a layout the split still needs whole heads."""
    rng = np.random.default_rng(4)
    shape = (2, 6, 2, 8, 16) if paged else (2, 2, 2, 64, 16)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    cache = (PagedKVCache(torch.from_numpy(k), torch.from_numpy(v), None,
                          None, page_size=8) if paged
             else KVCache(torch.from_numpy(k), torch.from_numpy(v)))
    cfg, params = _tiny(**dict(CFG_KW, num_kv_heads=2))
    lay = tp_step.tp_layout(cfg, params, 4)
    assert lay.attn == "kv_replicated"
    for m in range(4):
        local = sharding.make_sharded_cache(cache, fake_mesh(1, 4, 0, m),
                                            lay)
        lk = local.k_pages if paged else local.k
        lv = local.v_pages if paged else local.v
        np.testing.assert_array_equal(lk.numpy(), k[:, :, m // 2:m // 2 + 1])
        np.testing.assert_array_equal(lv.numpy(), v[:, :, m // 2:m // 2 + 1])
    whole = tp_step.tp_layout(*_tiny(**dict(CFG_KW, num_heads=6,
                                            num_kv_heads=2)), 4)
    assert whole.attn == "whole"
    local = sharding.make_sharded_cache(cache, fake_mesh(1, 4, 0, 3), whole)
    np.testing.assert_array_equal((local.k_pages if paged else local.k)
                                  .numpy(), k)
    with pytest.raises(ValueError, match="TpLayout"):
        sharding.make_sharded_cache(cache, fake_mesh(1, 4))


def test_sequence_sharded_input_is_refused():
    """No longer refused: a token axis on ``model`` gives model rank m its
    m-th slice of the tokens (the sequence-parallel prefill's input, held
    to the JAX GSPMD prefill in ``tests/test_torch_tp_layout_rules.py``);
    ``data`` still splits the rows, ``model`` never does."""
    tokens = torch.arange(16, dtype=torch.int64).reshape(2, 8)
    for m in range(2):
        got = sharding.batch_shard(tokens, fake_mesh(1, 2, 0, m),
                                   (None, "model"))
        assert torch.equal(got, tokens[:, 4 * m:4 * m + 4])
    got = sharding.batch_shard(tokens, fake_mesh(2, 2, 1, 1),
                               ("data", "model"))
    assert torch.equal(got, tokens[1:, 4:])
    assert sharding.batch_shard(tokens, fake_mesh(2, 1, 1, 0),
                                ("data", None)).shape == (1, 8)
    with pytest.raises(ValueError, match="token axis"):
        sharding.batch_shard(tokens, fake_mesh(1, 2), ("model", None))


def _tiny(**kw):
    from qwen_inference_engine_tpu_torch.models.qwen import init_params

    cfg = tiny_config(**kw)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32)


def test_engines_refuse_a_model_that_does_not_split():
    """No longer refused: KV heads 2 over tp = 4 (the JAX engines then
    drop to GSPMD's XLA ops).  ``Engine`` and the serving engine take the
    GSPMD layout: each rank holds one KV head of the cache and of the
    pool, its 1 of 4 query heads' columns and its KV head's k / v
    columns, and samples on its vocabulary shard
    (``tests/test_torch_tp_layouts.py`` holds their tokens to the JAX
    GSPMD run)."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )
    from qwen_inference_engine_tpu_torch.parallel.mesh import Group

    cfg, params = _tiny()
    for m in range(4):
        mesh = fake_mesh(1, 4, 0, m)
        mesh.capturable = False
        mesh.model_group = Group(pg=None, size=4, rank=m, backend="gloo",
                                 ranks=(0, 1, 2, 3))
        eng = Engine(cfg, params, mesh=mesh, max_batch=4, max_seq=64,
                     device="cpu")
        assert eng.layout.gspmd and eng.layout.attn == "kv_replicated"
        assert eng.new_cache().k.shape[2] == 1
        lyr = eng.params["layers"]
        h = m // 2 * cfg.head_dim
        assert torch.equal(lyr["k"].w, params["layers"]["k"].w[
            ..., h:h + cfg.head_dim])
        assert lyr["q"].w.shape[-1] == cfg.q_dim // 4
        cb = ContinuousBatchingEngine(cfg, params, mesh=mesh, max_slots=2,
                                      page_size=8, num_pages=8,
                                      max_pages_per_seq=4, device="cpu")
        assert cb._gspmd and cb.cache.k_pages.shape[2] == 1
        assert cb._vocab.v_local == cfg.vocab_size // 4


def test_fused_projections_and_row_biases_do_not_split():
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        fuse_projections,
    )

    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    cfg, params = _tiny(**CFG_KW)
    assert tp_step.supports_tp(cfg, params, 2)
    qp = quantize_params(params, QuantConfig(bits=8, group_size=16))
    assert tp_step.supports_tp(cfg, qp, 2)
    fused = fuse_projections(qp)
    assert "split layout" in tp_step.tp_refusal(cfg, fused, 2)
    lyr = dict(params["layers"])
    lyr["o"] = dataclasses.replace(lyr["o"], b=torch.ones(2, 128))
    biased = dict(params, layers=lyr)
    assert "bias" in tp_step.tp_refusal(cfg, biased, 2)
    # no longer refused: both run in the GSPMD layout (their tokens:
    # tests/test_torch_tp_fused.py, tests/test_torch_tp_layouts.py).  A
    # rank's qkv is its q heads' columns, then its KV heads' k and v; its
    # gateup its gate columns, then its up columns
    lay = tp_step.tp_layout(cfg, fused, 2)
    assert lay.gspmd and (lay.attn, lay.o, lay.mlp) == ("heads", "split",
                                                       "split")
    split = sharding.shard_params(qp, fake_mesh(1, 2, 0, 1))
    local = sharding.shard_params(fused, fake_mesh(1, 2, 0, 1), lay)
    for fname, names in (("qkv", ("q", "k", "v")), ("gateup", ("gate",
                                                               "up"))):
        for f in ("q", "scales", "b"):
            want = [getattr(split["layers"][n], f) for n in names]
            got = getattr(local["layers"][fname], f)
            if want[0] is None:
                assert got is None
                continue
            assert torch.equal(got, torch.cat(want, dim=-1)), (fname, f)
    # the row-parallel bias stays whole on every rank (added once, after
    # the all-reduce)
    lay = tp_step.tp_layout(cfg, biased, 2)
    assert lay.gspmd and lay.o == "split"
    local = sharding.shard_params(biased, fake_mesh(1, 2, 0, 1), lay)
    assert torch.equal(local["layers"]["o"].b, lyr["o"].b)
    assert local["layers"]["o"].w.shape[-2] == cfg.q_dim // 2


def test_generate_speculative_under_a_mesh_is_refused(worlds):
    """No longer refused: ``generate_speculative`` under a (2, 1) mesh
    (once refused as GSPMD-only) returns on every rank the ids of the
    JAX engine on the same mesh and of the port's one-rank run
    (``tests/test_torch_mesh_spec.py`` covers the other meshes)."""
    from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
    from tests import torch_parallel_jobs as jobs

    jcfg, jparams, cfg, params = models(dict(CFG_KW, num_layers=2), seed=3)
    prompts = [[1, 2, 3], [5, 9, 17, 5, 9, 17, 5]]
    mesh = jmesh((2, 1))
    want = JEngine(jcfg, j_shard_params(jparams, mesh), mesh=mesh,
                   max_batch=2, max_seq=64, kv_dtype=jnp.float32
                   ).generate_speculative(prompts, max_new_tokens=6, k=3)
    assert jobs.spec_generate(None, 0, None, cfg, params, prompts, 6, 2,
                              3) == want
    got = worlds(2).run(jobs.spec_generate, (2, 1), cfg, params, prompts, 6,
                        2, 3, timeout=240)
    assert got == [want, want]


@pytest.mark.parametrize("mesh,err,match", [
    (types.SimpleNamespace(shape={"ep": 2}, size=2), ValueError,
     "EP serving step does not take this model.*not a MoE model"),
    (types.SimpleNamespace(shape={"stage": 2}, size=2), NotImplementedError,
     "pipeline-parallel mesh is served by .*PPFifoScheduler"),
    (fake_mesh(2, 2), ValueError,
     "max_slots 3 does not split over the data axis of 2"),
], ids=["ep", "pp", "dp2"])
def test_serving_refuses_ep_pp_and_data_parallel_meshes(mesh, err, match):
    """The meshes the slot scheduler refuses: an EP mesh for a dense model,
    a stage mesh (``PPFifoScheduler`` serves it), and a data axis that
    does not divide ``max_slots`` (a data axis itself is served)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )

    cfg, params = _tiny(**CFG_KW)
    with pytest.raises(err, match=match):
        ContinuousBatchingEngine(cfg, params, mesh=mesh,
                                 max_slots=3 if "data" in mesh.shape else 2,
                                 page_size=8, num_pages=8,
                                 max_pages_per_seq=4, device="cpu")


@pytest.mark.parametrize("flag,match", [
    ("--ep", r"generate --ep: the JAX Engine raises under an "
             r'expert-parallel mesh \(it builds NamedSharding\(mesh, '
             r'P\("data"\)\) .* no data axis\); serve --ep'),
    ("--pp", r"generate --pp: the JAX CLI hands the stage mesh to Engine, "
             r"which has no pipeline branch and raises on it \(it builds "
             r'NamedSharding\(mesh, P\("data"\)\) .* no data axis\); '
             r"serve --pp")], ids=["--ep", "--pp"])
def test_cli_generate_ep_and_pp_name_why(flag, match):
    """``generate --ep`` and ``generate --pp`` name why they are refused:
    the JAX ``Engine`` raises on both meshes
    (``test_jax_engine_raises_under_ep_and_pp_meshes``); ``serve --ep`` /
    ``serve --pp`` serve them."""
    from qwen_inference_engine_tpu_torch.server.cli import main

    with pytest.raises(NotImplementedError, match=match):
        main(["generate", "--model", "tiny", "--device", "cpu", flag, "2"])


@pytest.mark.parametrize("kind", ["ep", "pp"])
def test_jax_engine_raises_under_ep_and_pp_meshes(kind):
    """What the port's refusals say: the JAX ``Engine`` under
    ``make_ep_mesh(2)`` or ``make_pp_mesh(2)`` on the virtual CPU devices
    raises, because it builds ``NamedSharding(mesh, P("data"))`` on a mesh
    that has no data axis."""
    from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
    from qwen_inference_engine_tpu.parallel.ep_step import make_ep_mesh
    from qwen_inference_engine_tpu.parallel.pp_step import make_pp_mesh

    jcfg, jparams, _, _ = models(dict(MOE_KW if kind == "ep" else CFG_KW,
                                      num_layers=2), seed=3)
    mesh = (make_ep_mesh if kind == "ep" else make_pp_mesh)(2)
    axis = "ep" if kind == "ep" else "stage"
    with pytest.raises(ValueError, match=f"Resource axis: data of "
                                         f"PartitionSpec\\('data',\\) is "
                                         f"not found in mesh: \\('{axis}',\\)"):
        JEngine(jcfg, jparams, mesh=mesh, max_batch=2, max_seq=64,
                kv_dtype=jnp.float32).generate([[1, 2, 3], [4, 5]],
                                               max_new_tokens=2)


def test_tp_row_refuses_padded_and_straddling_k():
    """The row-parallel matmul's two guards (JAX ``tp_kernels.py:78-83``):
    a quantizer-padded K, and row shards that cut a group."""
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        quantize_linear,
    )

    w = torch.randn(1376, 256)
    padded = quantize_linear(Linear(w), bits=4, group_size=32)
    assert padded.in_features != 1376
    with pytest.raises(ValueError, match="pad_free"):
        quant_matmul_tp_row(torch.ones(8, 1376 // 4), padded,
                            fake_mesh(2, 4))
    lin = quantize_linear(Linear(torch.randn(1024, 256)), bits=4,
                          group_size=128, pad_free=True)
    with pytest.raises(ValueError, match="tp_aligned_group_size"):
        quant_matmul_tp_row(torch.ones(8, 1024 // 8), lin, fake_mesh(1, 8))
