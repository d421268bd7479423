"""JAX-side helpers of the port's TP / DP tests
(``tests/test_torch_parallel_*.py``): the two packages' params of one
seeded tiny model, the JAX virtual mesh of a shape, the comparison rule,
and the module-scoped worlds of gloo ranks
(``tests/torch_parallel_world.World``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.parallel.mesh import make_mesh as j_make_mesh
from qwen_inference_engine_tpu.quant.quantize import (
    QuantConfig as JQuantConfig,
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from tests.torch_parallel_world import World

CFG_KW = dict(num_heads=8, num_kv_heads=8, head_dim=16)
MOE_KW = dict(CFG_KW, num_experts=8, num_experts_per_tok=2,
              moe_intermediate_size=64)
SHAPES = [(1, 2), (1, 4), (2, 2)]
TP_SHAPES = [(1, 2), (1, 4)]


@pytest.fixture(scope="module")
def worlds():
    """``worlds(n)``: this module's world of ``n`` ranks (spawned at first
    use, closed with the module)."""
    made = {}

    def get(n):
        if n not in made:
            made[n] = World(n)
        return made[n]

    yield get
    for w in made.values():
        w.close()


def run(worlds, shape, fn, *args, timeout=120):
    """``fn`` on every rank of the world of ``shape``'s size."""
    return worlds(shape[0] * shape[1]).run(fn, shape, *args,
                                           timeout=timeout)


def jmesh(shape):
    return j_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def models(cfg_kw=CFG_KW, bits=16, group_size=16, seed=3):
    """(jax cfg, jax params, port cfg, port params): f32 weights, q/k/v
    biases drawn non-zero, quantized at ``bits`` < 16."""
    jcfg = j_tiny_config(**cfg_kw)
    params = jqwen.init_params(jcfg, jax.random.PRNGKey(seed),
                               dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    layers = dict(params["layers"])
    for name, leaf in layers.items():
        if isinstance(leaf, JLinear) and leaf.b is not None:
            layers[name] = dataclasses.replace(leaf, b=jnp.asarray(
                rng.normal(size=leaf.b.shape).astype(np.float32) * 0.5))
    params = dict(params, layers=layers)
    if bits < 16:
        params = j_quantize_params(params, JQuantConfig(
            bits=bits, group_size=group_size))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, params, tiny_config(**cfg_kw), tparams


def close(got, want, what=""):
    """f32 logits within 1e-5 of the largest reference logit."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= 1e-5 * scale, (what, err, scale)


def vocab_cat(per_rank, shape, axis=-1):
    """The global logits from every rank's [rows, V/tp] shards: model
    ranks concatenated on the vocabulary, data ranks on the rows."""
    dp, tp = shape
    rows = [np.concatenate(per_rank[d * tp:(d + 1) * tp], axis=axis)
            for d in range(dp)]
    return np.concatenate(rows, axis=0)
