"""Port of the W4A8 matmul (kernel 1) and the INT4 packer vs the JAX package.

The JAX Pallas kernel ``_quant_matmul4_a8`` runs in interpreter mode on the
CPU; the port's wrapper runs its plain version for CPU tensors.  The CUDA
kernel itself is held against the same plain version by chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.quant_matmul as jqmm
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.ops.linear import _quant_matmul_xla
from qwen_inference_engine_tpu.ops.linear import unpack_int4 as j_unpack_int4
from qwen_inference_engine_tpu.quant.quantize import pack_int4 as j_pack_int4
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_linear as j_quantize_linear,
)
from qwen_inference_engine_tpu_torch.ops import quant_matmul as tqmm
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.ops.linear import unpack_int4
from qwen_inference_engine_tpu_torch.quant.quantize import (
    _padded_k,
    pack_int4,
    quantize_linear,
)
from tests.helpers import interpret_pallas


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """Round to bf16 and back, so both packages see the same values."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("K,gs", [(512, 128), (448, 128)])
def test_w4a8_plain_matches_pallas_interpret(K, gs):
    """M=8, N=256 as tests/test_ops.py; K=448 is padded to 512 by the
    quantizer, and x is zero-padded to match, as the CUDA dispatcher does."""
    rng = np.random.default_rng(9)
    M, N = 8, 256
    x = _bf16_values(rng.normal(size=(M, K)).astype(np.float32))
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), 4, gs)
    kp = jq.in_features
    assert kp == 512
    with interpret_pallas(jqmm):
        ref = np.asarray(jqmm.quant_matmul_pallas(
            jnp.asarray(x).astype(jnp.bfloat16), jq, act_bits=8), np.float32)

    x_pad = torch.nn.functional.pad(torch.from_numpy(x), (0, kp - K))
    xq, sx = tqmm.quantize_activations(x_pad)
    q = torch.from_numpy(np.array(jq.q))[None]
    s = torch.from_numpy(np.array(jq.scales))[None]
    before = tqmm.quant_matmul4_a8.launches
    got = tqmm.quant_matmul4_a8(xq, sx.reshape(-1), q, s, 0, jq.group_size)
    assert tqmm.quant_matmul4_a8.launches == before  # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=5e-2, atol=5e-2)


def test_quant_matmul_dispatch_matches_xla_oracle():
    """The CPU dispatcher is the port of _quant_matmul_xla (act_bits 0/8)."""
    rng = np.random.default_rng(3)
    M, K, N, gs = 5, 256, 128, 64
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(2, K, N)) * 0.05).astype(np.float32)
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), 4, gs)
    tq = QuantLinear(q=torch.from_numpy(np.array(jq.q)),
                     scales=torch.from_numpy(np.array(jq.scales)), b=None,
                     bits=4, group_size=jq.group_size)
    one = dataclasses.replace(jq, q=jq.q[1], scales=jq.scales[1], b=None)
    for act_bits in (0, 8):
        ref = np.asarray(_quant_matmul_xla(jnp.asarray(x), one,
                                           act_bits=act_bits))
        got = tqmm.quant_matmul_stacked(torch.from_numpy(x), tq, 1,
                                        act_bits=act_bits)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_quantize_activations_identical():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 384)) * 3).astype(np.float32)
    jq, js = jqmm.quantize_activations(jnp.asarray(x))
    tq, ts = tqmm.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("gs", [64, 128])
def test_pack_unpack_int4_bit_exact_both_ways(gs):
    rng = np.random.default_rng(gs)
    K, N = 4 * gs, 96
    vals = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    j_packed = np.array(j_pack_int4(jnp.asarray(vals), gs))
    t_packed = pack_int4(torch.from_numpy(vals), gs).numpy()
    np.testing.assert_array_equal(t_packed, j_packed)
    # JAX pack -> port unpack, and port pack -> JAX unpack
    np.testing.assert_array_equal(
        unpack_int4(torch.from_numpy(j_packed), gs).numpy(), vals)
    np.testing.assert_array_equal(
        np.asarray(j_unpack_int4(jnp.asarray(t_packed), gs)), vals)


@pytest.mark.parametrize("K,gs", [(448, 128), (672, 16), (256, 256)])
def test_quantize_linear_identical_on_padded_k(K, gs):
    """Same K-padding rule, same bytes and scales (448 -> 512 with gs 128,
    672 -> 704: 21 k-tiles of 2*16 is an odd chain > 20)."""
    rng = np.random.default_rng(K)
    w = (rng.normal(size=(3, K, 64)) * 0.1).astype(np.float32)
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), 4, gs)
    tq = quantize_linear(Linear(torch.from_numpy(w)), 4, gs)
    assert tq.group_size == jq.group_size
    assert tq.in_features == jq.in_features
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))


def test_padding_rule_for_qwen25_7b_down_proj():
    assert _padded_k(18944, 4, 256) == 19456
    assert _padded_k(3584, 4, 256) == 3584
