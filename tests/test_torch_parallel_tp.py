"""The port's TP steps in gloo worlds of CPU processes vs the JAX package
on its virtual mesh of the same shape: the TP matmuls, the prefill /
decode / piece / verify steps, the sharded argmax and sampling on
vocabulary shards.

Two worlds per module (``tests/torch_parallel_world.World``: 2 and 4 ranks,
spawned once, a ``file://`` rendezvous each) host the meshes (1, 2),
(1, 4) and (2, 2).  The JAX package runs the same shape on its virtual
CPU devices (``tests/conftest.py``): its TP matmuls with the Pallas kernel
in interpret mode and its ``shard_map`` steps.  f32 logits agree within
1e-5 of the largest logit (the all-reduce sums in another order than
XLA's ``psum``), and every rank draws the same tokens.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.kvcache.cache import (
    KVCache as JKVCache,
    PagedKVCache as JPagedKVCache,
)
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.parallel import tp_step as jtp
from qwen_inference_engine_tpu.parallel.tp_kernels import (
    quant_matmul_tp_column as j_tp_column,
    quant_matmul_tp_row as j_tp_row,
)
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_linear as j_quantize_linear,
)
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from tests import torch_parallel_jobs as jobs
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    SHAPES,
    TP_SHAPES,
    close,
    jmesh,
    models,
    run,
    vocab_cat,
    worlds,
)


# ---------------------------------------------------------------- matmuls
def _interpret_pallas():
    import qwen_inference_engine_tpu.ops.linear as lin_mod
    import qwen_inference_engine_tpu.ops.quant_matmul as qm

    orig = qm.pl.pallas_call

    def call(*a, **k):
        k.pop("compiler_params", None)
        k["interpret"] = True
        return orig(*a, **k)

    return (mock.patch.object(qm.pl, "pallas_call", call),
            mock.patch.object(lin_mod, "_pallas_available", lambda: True))


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tp_matmuls_match_jax_tp_kernels(worlds, shape, stacked):
    """Column- and row-parallel W4A16 products vs the JAX ``tp_kernels``
    (the Pallas kernel in interpret mode): each rank's columns, and the
    row product's sum on every rank."""
    kin, out, gs = 256, 128, 16
    rng = np.random.default_rng(7)
    w = jnp.asarray(rng.normal(size=(kin, out)).astype(np.float32) * 0.05)
    lin = j_quantize_linear(JLinear(w, jnp.asarray(
        rng.normal(size=(out,)).astype(np.float32))), bits=4,
        group_size=gs, pad_free=True)
    if stacked:
        lin = jax.tree_util.tree_map(lambda a: jnp.stack([a * 0.5, a]), lin)
    x = rng.normal(size=(4, kin)).astype(np.float32)
    layer = 1 if stacked else None
    mesh_j = jmesh(shape)
    p1, p2 = _interpret_pallas()
    with p1, p2:
        jl = None if layer is None else jnp.int32(layer)
        want_col = np.asarray(j_tp_column(jnp.asarray(x), lin, mesh_j,
                                          layer=jl))
        want_row = np.asarray(j_tp_row(jnp.asarray(x), lin, mesh_j,
                                       layer=jl))
    tlin = params_from_numpy({"l": jax.tree_util.tree_map(np.asarray,
                                                          lin)})["l"]
    got = run(worlds, shape, jobs.tp_matmuls, tlin, x, layer)
    n_l = out // shape[1]
    for r, (col, row) in enumerate(got):
        m = r % shape[1]
        close(col, want_col[:, m * n_l:(m + 1) * n_l], f"column rank {r}")
        close(row, want_row, f"row rank {r}")


# ------------------------------------------------------------------ steps
@pytest.fixture(scope="module", params=[16, 4, 8], ids=["f32", "int4",
                                                        "int8"])
def model(request):
    return models(bits=request.param)


def _j_contiguous(jcfg, jparams, mesh, prompts, steps, chunk):
    B, T = prompts.shape
    cache = JKVCache.create(jcfg.num_layers, B, 64, jcfg.num_kv_heads,
                            jcfg.head_dim, dtype=jnp.float32)
    params_s, cache_s = jtp.shard_for_tp(jparams, cache, mesh)
    pre = jax.jit(jtp.make_tp_prefill_fn(jcfg, mesh, jparams, cache,
                                         chunk=chunk))
    dec = jax.jit(jtp.make_tp_decode_fn(jcfg, mesh, jparams, cache,
                                        uniform_decode=True))
    lens = jnp.full((B,), T, jnp.int32)
    logits, cache_s = pre(params_s, jnp.asarray(prompts, jnp.int32), lens,
                          cache_s)
    outs = [np.asarray(logits)]
    for s in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache_s = dec(params_s, tok, lens + s, cache_s)
        outs.append(np.asarray(logits))
    return outs


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tp_prefill_and_decode_logits_match_jax(worlds, model, shape):
    """The chunked TP prefill (two chunks) and three uniform decode steps
    over the contiguous cache: f32 logits within 1e-5 of the JAX
    ``shard_map`` steps on the same mesh; every model rank's argmax
    equal."""
    jcfg, jparams, tcfg, tparams = model
    prompts = np.random.default_rng(1).integers(0, 512, (4, 12))
    want = _j_contiguous(jcfg, jparams, jmesh(shape), prompts, 3, chunk=8)
    got = run(worlds, shape, jobs.contiguous_steps, tcfg, tparams,
               prompts, 3, 8)
    for s in range(len(want)):
        close(vocab_cat([g[s] for g in got], shape), want[s], f"step {s}")


def _j_paged(jcfg, jparams, mesh, prompts, page_size, tables, verify):
    pool = JPagedKVCache.create(jcfg.num_layers, 32, page_size,
                                jcfg.num_kv_heads, jcfg.head_dim,
                                dtype=jnp.float32)
    params_s, pool_s = jtp.shard_for_tp(jparams, pool, mesh)
    outs = []
    half = prompts.shape[1] // 2
    tables = jnp.asarray(tables, jnp.int32)
    for r in range(prompts.shape[0]):
        for start, n, first in ((0, half, True),
                                (half, prompts.shape[1] - half, False)):
            fn = jax.jit(jtp.make_tp_prefill_piece_fn(
                jcfg, mesh, jparams, pool, T=n, first=first, last=True))
            logits, pool_s = fn(params_s, jnp.asarray(
                prompts[r:r + 1, start:start + n], jnp.int32),
                jnp.int32(start), jnp.asarray([n], jnp.int32), pool_s,
                tables[r:r + 1])
            outs.append(np.asarray(logits))
    pos0 = jnp.full((prompts.shape[0],), prompts.shape[1], jnp.int32)
    vfn = jax.jit(jtp.make_tp_verify_fn(jcfg, mesh, jparams, pool,
                                        T=verify.shape[1]))
    logits, pool_s = vfn(params_s, jnp.asarray(verify, jnp.int32), pos0,
                         pool_s, tables)
    outs.append(np.asarray(logits))
    dec = jax.jit(jtp.make_tp_decode_fn(jcfg, mesh, jparams, pool,
                                        paged=True))
    logits, pool_s = dec(params_s, jnp.asarray(verify[:, -1], jnp.int32),
                         pos0 + verify.shape[1], pool_s, tables)
    outs.append(np.asarray(logits))
    return outs


@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_tp_pieces_verify_and_paged_decode_match_jax(worlds, model, shape):
    """Over a page pool split on its KV heads: two prefill pieces a prompt
    (fresh, then a continuation), a T = 4 verify of both rows and a
    paged decode step: f32 logits within 1e-5 of the JAX steps."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, 512, (2, 20))
    verify = rng.integers(0, 512, (2, 4))
    tables = np.asarray([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 0]])
    want = _j_paged(jcfg, jparams, jmesh(shape), prompts, 8, tables,
                    verify)
    got = run(worlds, shape, jobs.paged_steps, tcfg, tparams, prompts, 8,
               tables, verify)
    for s in range(len(want)):
        close(vocab_cat([g[s] for g in got], shape), want[s], f"out {s}")


@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_tp_spec_model_round_matches_one_process(worlds, shape):
    """``make_tp_spec_model_fn``: the drafter's k + 1 decode steps (greedy
    by the sharded argmax) and the target's verify on each rank's heads
    give one process's drafts exactly and its verify logits within 1e-5
    (the port's drafter protocol, which never rewrites a row, differs from
    the JAX round's, so one process is the reference)."""
    _, _, tcfg, tparams = models(bits=8)
    prompts = np.random.default_rng(4).integers(0, 512, (2, 11))
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 0]])
    want_logits, want_drafts = jobs.spec_model_round(
        None, 0, None, tcfg, tparams, prompts, 8, tables, 3)
    got = run(worlds, shape, jobs.spec_model_round, tcfg, tparams, prompts,
              8, tables, 3)
    for logits, drafts in got:
        np.testing.assert_array_equal(drafts, want_drafts)
    close(vocab_cat([g[0] for g in got], shape), want_logits)


# --------------------------------------------------------------- sampling
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sharded_argmax_ties_go_to_the_lowest_global_id(worlds, shape):
    """Rows whose maximum repeats within a shard, across shards, at shard
    edges and everywhere: the sharded argmax is the first global index,
    as ``torch.argmax`` over the whole row."""
    V = 16
    logits = np.zeros((5, V), np.float32)
    logits[0, [3, 11]] = 2.0           # across shards
    logits[1, [4, 5, 6]] = 1.0         # within / across a shard edge
    logits[2, [V - 1, V // 2]] = 3.0   # last column and a shard's first
    logits[3] = -1.0                   # every column ties
    logits[4, 9] = 5.0                 # one maximum
    want = torch.argmax(torch.from_numpy(logits), dim=-1).numpy()
    got = run(worlds, shape, jobs.argmax_ties, logits)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("kind", ["greedy", "top_k", "top_p", "plain",
                                  "rows"])
@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_sampling_on_vocab_shards_draws_the_whole_rows_token(worlds, shape,
                                                             kind):
    """``sample`` / ``sample_rows`` on each rank's vocabulary shard (the
    penalties on its columns of the whole seen mask, top-k from every
    rank's candidates, top-p and plain draws over the gathered row) draw
    the same tokens as on the whole row with a generator seeded alike, on
    every rank."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(4, 64)).astype(np.float32) * 3
    seen = rng.random((4, 64)) < 0.2
    want = jobs.draw(torch.from_numpy(logits), torch.from_numpy(seen), kind,
                     5)
    got = run(worlds, shape, jobs.sample_sharded, logits, seen, kind, 5)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g, want, err_msg=f"rank {r}")
