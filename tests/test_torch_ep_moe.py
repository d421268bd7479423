"""The port's expert-parallel MoE layer and forward in gloo worlds of CPU
processes against the JAX package's on its virtual mesh of the same size.

* ``ep_moe_layer`` at (ep, E, top_k) = (4, 8, 2), (2, 8, 3) and (4, 4, 2),
  with skewed routing (two experts of rank 0 biased hard), and over W8,
  W4 and W4A8 expert stacks (the JAX grouped Pallas kernels in interpret
  mode, ``tests/test_ep_moe.py``'s set-up), and W4A8 stacks whose
  ``w_down`` fails the shape gate (both packages then dequantize the
  shard and run the bf16 stacks' path): against JAX's
  ``ep_moe_layer`` under ``shard_map``: f32 stacks within 1e-5 (the
  combine sums the k rows in another order than JAX's scatter-add);
  weight-only stacks within 2e-2 (``tests/test_torch_grouped_matmul.py``:
  the plain versions dequantize to bf16 weights where the kernels scale
  in f32); W4A8 within 2e-2 of the largest output (the int8
  requantization of the SiLU product between the products can move a
  rounding step: the port's single-rank ``moe_mlp`` lies as far from
  JAX's).  Every rank's rows are bit-equal to the port's single-rank
  ``moe_mlp`` over the whole batch (where its per-product act_bits gate
  agrees with JAX's two-weight one), the ragged and dense forms bit-equal
  to each other, and a layer makes one all-gather and two all-to-alls.
* ``forward_hidden(ep_group=...)``: a fresh prefill and 3 greedy decode
  steps at ep 4 against JAX's ``forward_hidden(ep_axis=...)`` in
  ``test_full_forward_dp_ep_matches_single_device``'s set-up, f32 logits
  within 1e-5 of the largest logit; both forms bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.parallel.ep_moe import (
    ep_moe_layer as j_ep_moe_layer,
)
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_linear as j_quantize_linear,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.models.qwen import moe_mlp
from qwen_inference_engine_tpu_torch.ops.grouped_matmul import (
    grouped_quant_matmul_supported,
)
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear
from tests import torch_ep_jobs as jobs
from tests.helpers import interpret_pallas
from tests.torch_parallel_ref import close, worlds  # noqa: F401 (fixture)


def _jmesh(ep):
    return JMesh(np.asarray(jax.devices()[:ep]), ("ep",))


def _stacks(E, D, Fm, seed, kind):
    """(JAX stacks, port stacks) of one layer ``[1, E, K, N]``: f32, or
    quantized by the JAX package (``kind`` "w8" / "w4", gs 128) with the
    port's carrying the same bytes and scales."""
    rng = np.random.default_rng(seed)
    ws = [rng.normal(size=(1, E, D, Fm)).astype(np.float32) * D ** -0.5,
          rng.normal(size=(1, E, D, Fm)).astype(np.float32) * D ** -0.5,
          rng.normal(size=(1, E, Fm, D)).astype(np.float32) * Fm ** -0.5]
    if kind == "f32":
        return [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]
    bits = 8 if kind == "w8" else 4
    jq = [j_quantize_linear(JLinear(w=jnp.asarray(w)), bits, 128,
                            pad_free=True) for w in ws]
    tq = [QuantLinear(q=torch.from_numpy(np.asarray(q.q).copy()),
                      scales=torch.from_numpy(np.asarray(q.scales).copy()),
                      b=None, bits=bits, group_size=q.group_size)
          for q in jq]
    return jq, tq


def _j_ep_layer(ep, h, router, jw, top_k, norm, quant, act_bits):
    """JAX's ``ep_moe_layer`` under ``shard_map`` over the virtual mesh."""
    import qwen_inference_engine_tpu.ops.grouped_matmul as jgm

    split = P(None, "ep", None, None)
    if quant:
        wspecs = [dataclasses.replace(w, q=split, scales=split) for w in jw]

        def first(w):
            return dataclasses.replace(w, q=w.q[0], scales=w.scales[0])
    else:
        wspecs = [split] * 3

        def first(w):
            return w[0]

    def fn(h, router, wg, wu, wd):
        return j_ep_moe_layer(h, router, first(wg), first(wu), first(wd),
                              top_k, norm, "ep", use_quant_kernel=quant,
                              act_bits=act_bits)

    run = jax.shard_map(fn, mesh=_jmesh(ep),
                        in_specs=(P("ep", None), P(None, None), *wspecs),
                        out_specs=P("ep", None), check_vma=False)
    with interpret_pallas(jgm):
        return np.asarray(jax.jit(run)(jnp.asarray(h), jnp.asarray(router),
                                       *jw))


# case: (ep, E, top_k, N a rank, D, Fm, stacks, act_bits, skewed, norm)
CASES = {
    "ep4 e8 k2": (4, 8, 2, 24, 64, 32, "f32", 0, False, True),
    "ep2 e8 k3": (2, 8, 3, 24, 64, 32, "f32", 0, False, True),
    "ep4 e4 k2": (4, 4, 2, 24, 64, 32, "f32", 0, False, True),
    "ep4 e8 k2 skewed": (4, 8, 2, 16, 64, 32, "f32", 0, True, False),
    "ep2 e4 w8": (2, 4, 2, 16, 256, 128, "w8", 0, False, True),
    "ep2 e4 w4": (2, 4, 2, 16, 256, 256, "w4", 0, False, True),
    # w_down's K = 128 fails the INT4 gate (K % 2gs): the dequantized path
    "ep2 e4 w4 gate fails": (2, 4, 2, 16, 256, 128, "w4", 8, False, True),
    "ep4 e8 w4a8 skewed": (4, 8, 2, 16, 256, 256, "w4", 8, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ep_moe_layer_matches_jax(worlds, case):
    ep, E, top_k, N, D, Fm, kind, act_bits, skewed, norm = CASES[case]
    rng = np.random.default_rng(len(case))
    h = rng.normal(size=(ep * N, D)).astype(np.float32)
    router = rng.normal(size=(D, E)).astype(np.float32)
    if skewed:
        router[:, :2] += 8.0          # experts 0 and 1, both on rank 0
    jw, tw = _stacks(E, D, Fm, seed=E + D, kind=kind)
    want = _j_ep_layer(ep, h, router, jw, top_k, norm, kind != "f32",
                       act_bits)
    got = worlds(ep).run(jobs.moe_layer, h, router, tw, top_k, norm,
                         act_bits)
    tol = (dict(rtol=1e-5, atol=1e-5) if kind == "f32"
           else dict(rtol=0, atol=2e-2 * np.abs(want).max()) if act_bits
           else dict(rtol=2e-2, atol=2e-2))
    single = moe_mlp(torch.from_numpy(h), torch.from_numpy(router), *tw,
                     top_k, norm, act_bits=act_bits).numpy()
    # moe_mlp gates int8 activations per product; the EP layer, as JAX's,
    # on w_gate and w_down together
    same_gate = not act_bits or all(
        grouped_quant_matmul_supported(w, 0) for w in (tw[0], tw[2]))
    for r, (ragged, dense, counts) in enumerate(got):
        assert np.array_equal(ragged, dense), r
        assert counts == {"all_gather": 1, "all_to_all": 2,
                          "all_reduce": 0}, counts
        rows = slice(r * N, (r + 1) * N)
        if same_gate:
            assert np.array_equal(ragged, single[rows]), r
        np.testing.assert_allclose(ragged, want[rows], **tol)


def test_forward_hidden_ep_matches_jax(worlds):
    """``test_full_forward_dp_ep_matches_single_device``'s model, prompts
    and steps at ep 4: the JAX forward under ``shard_map`` (tokens and the
    cache's rows on the ep axis, experts split, the rest whole) against
    ``forward_hidden(ep_group=...)`` on each rank's rows."""
    ep = 4
    kw = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64)
    jcfg = j_tiny_config(**kw)
    jparams = jqwen.init_params(jcfg, jax.random.PRNGKey(4),
                                dtype=jnp.float32)
    B, T, steps = ep * 2, 6, 3
    prompts = np.asarray(np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, T)), np.int32)

    lspec = {}
    for name, leaf in jparams["layers"].items():
        if name in ("moe_gate", "moe_up", "moe_down"):
            lspec[name] = P(None, "ep", None, None)
        else:
            lspec[name] = jax.tree.map(lambda x: P(*([None] * x.ndim)), leaf)
    pspec = {k: (lspec if k == "layers" else
                 jax.tree.map(lambda x: P(*([None] * x.ndim)), v))
             for k, v in jparams.items()}
    cspec = JKVCache(k=P(None, "ep", None, None, None),
                     v=P(None, "ep", None, None, None),
                     k_scale=None, v_scale=None)

    def make(fresh):
        def body(p, t, q, c):
            hidden, c = jqwen.forward_hidden(p, jcfg, t, q, c,
                                             fresh_prefill=fresh,
                                             use_pallas=False, ep_axis="ep")
            return jqwen.compute_logits(p, hidden[:, -1], False), c
        return jax.jit(jax.shard_map(
            body, mesh=_jmesh(ep),
            in_specs=(pspec, P("ep", None), P("ep", None), cspec),
            out_specs=(P("ep", None), cspec), check_vma=False))

    cache = JKVCache.create(jcfg.num_layers, B, 32, jcfg.num_kv_heads,
                            jcfg.head_dim, dtype=jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    logits, cache = make(True)(jparams, jnp.asarray(prompts), pos, cache)
    want = [np.asarray(logits)]
    dec = make(False)
    for s in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = dec(jparams, tok[:, None],
                            jnp.full((B, 1), T + s, jnp.int32), cache)
        want.append(np.asarray(logits))

    tcfg = tiny_config(**kw)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    got = {ragged: worlds(ep).run(jobs.forward_steps, tcfg, tparams,
                                  prompts, steps, ragged)
           for ragged in (True, False)}
    for r in range(ep):
        rows = slice(r * 2, (r + 1) * 2)
        for s in range(steps + 1):
            assert np.array_equal(got[True][r][s], got[False][r][s]), (r, s)
            close(got[True][r][s], want[s][rows], f"rank {r} step {s}")
