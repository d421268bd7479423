"""Port of the W4A8 matmul (kernel 1) and the INT4 packer vs the JAX package.

The JAX Pallas kernel ``_quant_matmul4_a8`` runs in interpreter mode on the
CPU; the port's wrapper runs its plain version for CPU tensors.  The CUDA
kernel itself is held against the same plain version by chip_smoke.py.
"""

import dataclasses
from unittest import mock

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


def _pallas_only(jq, x, act_bits):
    """quant_matmul_pallas with its Pallas kernel in interpret mode, and the
    XLA fallback made to raise, so the kernel itself is what ran."""
    def no_fallback(*a, **k):
        raise AssertionError("quant_matmul_pallas fell back to XLA")

    with interpret_pallas(jqmm), \
            mock.patch.object(jqmm._linear, "_quant_matmul_xla", no_fallback):
        return np.asarray(jqmm.quant_matmul_pallas(
            jnp.asarray(x).astype(jnp.bfloat16), jq, act_bits=act_bits),
            np.float32)


def _port_args(jq, x):
    """The port's kernel inputs: x zero-padded to the weight's K (as the
    dispatcher pads it), the weight stacked as one layer."""
    kp = jq.in_features
    x_pad = torch.nn.functional.pad(torch.from_numpy(x), (0, kp - x.shape[1]))
    q = torch.from_numpy(np.array(jq.q))[None]
    s = torch.from_numpy(np.array(jq.scales))[None]
    return x_pad, q, s


def _close_to_bf16(got, ref):
    """Both sides round one f32 sum to bf16 and differ in the order of the
    f32 sums: within 2^-7 of the largest output (one bf16 ulp there)."""
    assert got.dtype == torch.bfloat16
    tol = 2 ** -7 * np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("K,gs", [(512, 128), (448, 128), (1024, 256)])
def test_w4a16_plain_matches_pallas_interpret(K, gs):
    """_quant_matmul4; K=448 is padded to 512 by the quantizer."""
    rng = np.random.default_rng(K + gs)
    M, N = 8, 256
    x = _bf16_values(rng.normal(size=(M, K)).astype(np.float32))
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), 4, gs)
    ref = _pallas_only(jq, x, 0)
    x_pad, q, s = _port_args(jq, x)
    before = tqmm.quant_matmul4.launches
    got = tqmm.quant_matmul4(x_pad.to(torch.bfloat16), q, s, 0, jq.group_size)
    assert tqmm.quant_matmul4.launches == before  # CPU: plain version
    _close_to_bf16(got, ref)


@pytest.mark.parametrize("act_bits", [0, 8], ids=["w8a16", "w8a8"])
@pytest.mark.parametrize("gs", [128, None], ids=["group", "column"])
def test_int8_plain_matches_pallas_interpret(gs, act_bits):
    """_quant_matmul8 and _quant_matmul8_a8, a scale per group of 128 rows
    (one k-tile each) or one per column (applied in the epilogue)."""
    rng = np.random.default_rng(3 + act_bits)
    M, K, N = 8, 512, 256
    x = _bf16_values(rng.normal(size=(M, K)).astype(np.float32))
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), 8, gs)
    assert jq.scales.shape[0] == (1 if gs is None else K // gs)
    ref = _pallas_only(jq, x, act_bits)
    x_pad, q, s = _port_args(jq, x)
    if act_bits:
        xq, sx = tqmm.quantize_activations(x_pad.to(torch.bfloat16))
        got = tqmm.quant_matmul8_a8(xq, sx.reshape(-1), q, s, 0)
    else:
        got = tqmm.quant_matmul8(x_pad.to(torch.bfloat16), q, s, 0)
    _close_to_bf16(got, ref)


@pytest.mark.parametrize("M,gs", [(1, 32), (17, 32), (1, None), (17, 256)])
def test_w8a8_plain_matches_pallas_interpret_at_decode_shapes(M, gs):
    """_quant_matmul8_a8 itself (its dispatcher takes groups of a multiple
    of 128 rows only), K = 2048 in 64 groups of 32, 8 of 256 or one scale
    per column, one row and 17 (padded to the kernel's 8-row blocks): the
    same int8 activations and row scales go to both."""
    rng = np.random.default_rng(M + (gs or 0))
    K, N = 2048, 128
    G = 1 if gs is None else K // gs
    xq = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    sx = (rng.random(M) * 0.02 + 1e-3).astype(np.float32)
    q = rng.integers(-127, 128, size=(1, K, N)).astype(np.int8)
    s = (rng.random((1, G, N)) * 0.01).astype(np.float32)
    m_pad = -(-M // 8) * 8
    xp = np.zeros((m_pad, K), np.int8)
    xp[:M] = xq
    sxb = np.ones((m_pad, 128), np.float32)
    sxb[:M] = sx[:, None]
    with interpret_pallas(jqmm):
        ref = np.asarray(jqmm._quant_matmul8_a8(
            jnp.asarray(xp), jnp.asarray(sxb), jnp.asarray(q), jnp.asarray(s),
            jnp.asarray(0, jnp.int32), group_size=gs or K, block_m=8,
            block_k=gs or K, block_n=128), np.float32)[:M]
    got = tqmm.quant_matmul8_a8(torch.from_numpy(xq), torch.from_numpy(sx),
                                torch.from_numpy(q), torch.from_numpy(s), 0)
    assert got.shape == (M, N)
    _close_to_bf16(got, ref)


# the Qwen2.5-7B projections (K, N) and the lm_head
_PROJ_7B = {"q/o": (3584, 3584), "k/v": (3584, 512), "gate/up": (3584, 18944),
            "down": (18944, 3584), "lm_head": (3584, 152064)}


@pytest.mark.parametrize("G", ["column", 32, 128])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 40, 64, 65, 2048])
@pytest.mark.parametrize("proj", sorted(_PROJ_7B))
def test_w8a8_split_plan_covers_k_once_on_group_boundaries(proj, M, G):
    """The W8A8 kernel's plan: M <= 64 streams the weight with K split into
    slices that end on group boundaries (multiples of 32 and of K/G), cover
    every row of K once (the last slice may be shorter, none empty), and
    give the grid at least 132 blocks of 128 columns (one on each SM)
    wherever slices of 256 rows allow it; M > 64 takes the prefill tiles
    over the whole of K."""
    K, N = _PROJ_7B[proj]
    G = 1 if G == "column" else K // G
    mt, splits, slice_rows = tqmm.plan_quant_matmul8_a8(M, K, N, G)
    if M > 64:
        assert (mt, splits, slice_rows) == (0, 1, K)
        return
    assert mt == (1 if M <= 16 else 4)
    assert slice_rows % 32 == 0 and (G == 1 or slice_rows % (K // G) == 0)
    assert (splits - 1) * slice_rows < K <= splits * slice_rows
    assert slice_rows >= min(K, tqmm.SPLIT_MIN_ROWS)
    blocks = N // 128 * -(-M // (16 * mt)) * splits
    reachable = N // 128 * -(-K // max(tqmm.SPLIT_MIN_ROWS, K // G
                                       if G > 1 else 64))
    assert blocks >= min(132, reachable)
    assert splits == 1 or blocks <= 2 * tqmm.SPLIT_TARGET_BLOCKS


@pytest.mark.parametrize("gs", [32, 128, 256])
@pytest.mark.parametrize("M", [1, 17, 40])
def test_w4a8_plain_matches_pallas_interpret_at_decode_shapes(M, gs):
    """_quant_matmul4_a8 itself at the shapes the split-K decode stream
    takes (K = 2048 in 1024 packed rows: 4 slices of 256 at N = 128), one
    row, 17 and 40 (padded to the kernel's 8-row blocks): the same bf16
    activations go to both, and both quantize them per token alike."""
    rng = np.random.default_rng(M + gs)
    K, N = 2048, 128
    assert tqmm.plan_quant_matmul4_a8(M, K, N, gs)[1] > 1
    x = _bf16_values(rng.normal(size=(M, K)).astype(np.float32))
    q = rng.integers(-128, 128, size=(1, K // 2, N)).astype(np.int8)
    s = (rng.random((1, K // gs, N)) * 0.01).astype(np.float32)
    m_pad = -(-M // 8) * 8
    xp = np.zeros((m_pad, K), np.float32)
    xp[:M] = x
    with interpret_pallas(jqmm):
        ref = np.asarray(jqmm._quant_matmul4_a8(
            jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(q),
            jnp.asarray(s), jnp.asarray(0, jnp.int32), group_size=gs,
            block_m=8, block_n=128), np.float32)[:M]
    xq, sx = tqmm.quantize_activations(torch.from_numpy(x).to(torch.bfloat16))
    got = tqmm.quant_matmul4_a8(xq, sx.reshape(-1), torch.from_numpy(q),
                                torch.from_numpy(s), 0, gs)
    assert got.shape == (M, N)
    _close_to_bf16(got, ref)


@pytest.mark.parametrize("gs", [32, 128, 256, None])
@pytest.mark.parametrize("M", [1, 17, 40])
def test_w8a16_plain_matches_pallas_interpret_at_decode_shapes(M, gs):
    """_quant_matmul8 itself at the shapes the split-K decode stream takes
    (K = 2048: slices of 256 rows at N = 128), a scale per group of 32,
    128 or 256 rows (one k-tile each) or one per column, one row, 17 and
    40 (padded to the kernel's 8-row blocks)."""
    rng = np.random.default_rng(M + (gs or 0))
    K, N = 2048, 128
    G = 1 if gs is None else K // gs
    assert tqmm.plan_quant_matmul8(M, K, N, G)[1] > 1
    x = _bf16_values(rng.normal(size=(M, K)).astype(np.float32))
    q = rng.integers(-127, 128, size=(1, K, N)).astype(np.int8)
    s = (rng.random((1, G, N)) * 0.01).astype(np.float32)
    m_pad = -(-M // 8) * 8
    xp = np.zeros((m_pad, K), np.float32)
    xp[:M] = x
    with interpret_pallas(jqmm):
        ref = np.asarray(jqmm._quant_matmul8(
            jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(q),
            jnp.asarray(s), jnp.asarray(0, jnp.int32), group_size=gs or K,
            block_m=8, block_k=gs or K, block_n=128), np.float32)[:M]
    got = tqmm.quant_matmul8(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(q), torch.from_numpy(s), 0)
    assert got.shape == (M, N)
    _close_to_bf16(got, ref)


def _dense_projections(preset: str) -> dict:
    """The dense matmuls (K, N) of a preset: q, k/v, o, the dense MLP's
    gate/up and down (not for an MoE model), and the lm_head."""
    from qwen_inference_engine_tpu_torch.config import PRESETS

    c = PRESETS[preset]
    shapes = {"q": (c.hidden_size, c.q_dim), "k/v": (c.hidden_size, c.kv_dim),
              "o": (c.q_dim, c.hidden_size),
              "lm_head": (c.hidden_size, c.vocab_size)}
    if not c.is_moe:
        shapes.update({"gate/up": (c.hidden_size, c.intermediate_size),
                       "down": (c.intermediate_size, c.hidden_size)})
    return shapes


def _check_split_plan(plan, M, rows, N, unit):
    """The rules every split-K plan keeps (see the W8A8 plan test)."""
    mt, splits, slice_rows = plan
    if M > 64:
        assert plan == (0, 1, rows)
        return
    assert mt == (1 if M <= 16 else 4)
    assert slice_rows % 32 == 0 and slice_rows % unit == 0
    assert (splits - 1) * slice_rows < rows <= splits * slice_rows
    assert slice_rows >= min(rows, tqmm.SPLIT_MIN_ROWS)
    tiles = -(-N // 128) * -(-M // (16 * mt))
    reachable = -(-N // 128) * -(-rows // max(tqmm.SPLIT_MIN_ROWS, unit))
    assert tiles * splits >= min(132, reachable)
    assert splits == 1 or tiles * splits <= 2 * tqmm.SPLIT_TARGET_BLOCKS


_PLAN_PRESETS = ["qwen2.5-7b", "qwen2.5-14b", "qwen3-30b-a3b"]


@pytest.mark.parametrize("gs", [32, 128, 256])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 40, 64, 65, 2048])
@pytest.mark.parametrize("preset", _PLAN_PRESETS)
def test_w4a8_split_plan_covers_k_once_on_pair_boundaries(preset, M, gs):
    """The W4A8 kernel's plan for every dense projection and the lm_head,
    in packed rows of the quantizer-padded K (the 7B down projection pads
    to a multiple of 2 gs): slices of whole plane pairs (gs packed rows),
    every packed row once, at least 132 blocks of 128 columns wherever
    slices of 256 rows allow it; M > 64 takes the prefill tiles over all
    of K."""
    for K, N in _dense_projections(preset).values():
        kp = _padded_k(K, 4, gs)
        plan = tqmm.plan_quant_matmul4_a8(M, kp, N, gs)
        _check_split_plan(plan, M, kp // 2, N, gs)


@pytest.mark.parametrize("G", ["column", 32, 128])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 40, 64, 65, 2048])
@pytest.mark.parametrize("preset", _PLAN_PRESETS)
def test_w8a16_split_plan_covers_k_once_on_group_boundaries(preset, M, G):
    """The W8A16 kernel's plan for every dense projection and the lm_head,
    and a width 64 past a multiple of 128 (its last column tile counts):
    slices end on group boundaries (per column, on 64-row stages) and
    cover K once."""
    for K, N in [*_dense_projections(preset).values(), (3584, 576)]:
        g = 1 if G == "column" else K // G
        plan = tqmm.plan_quant_matmul8(M, K, N, g)
        _check_split_plan(plan, M, K, N, 64 if g == 1 else K // g)


@pytest.mark.parametrize("bits,act_bits,gs", [(4, 8, 128), (4, 0, 128),
                                              (8, 0, 128), (8, 8, None)],
                         ids=["w4a8", "w4a16", "w8a16", "w8a8"])
def test_dispatcher_matches_quant_matmul_pallas_for_every_pair(bits, act_bits,
                                                               gs):
    """quant_matmul_stacked (the port's CPU dispatcher) against the JAX
    package's quant_matmul_pallas on a 2-layer stack, layer 1, padded K for
    INT4; the Pallas side rounds its output to bf16: 2^-8 of the largest."""
    rng = np.random.default_rng(bits * 10 + act_bits)
    M, K, N = 6, 448 if bits == 4 else 512, 256
    x = _bf16_values(rng.normal(size=(M, K)).astype(np.float32))
    w = (rng.normal(size=(2, K, N)) * 0.05).astype(np.float32)
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), bits, gs)
    with interpret_pallas(jqmm):
        ref = np.asarray(jqmm.quant_matmul_pallas(
            jnp.asarray(x).astype(jnp.bfloat16), jq, layer=1,
            act_bits=act_bits), np.float32)
    tq = QuantLinear(q=torch.from_numpy(np.array(jq.q)),
                     scales=torch.from_numpy(np.array(jq.scales)), b=None,
                     bits=bits, group_size=jq.group_size)
    got = tqmm.quant_matmul_stacked(torch.from_numpy(x), tq, 1,
                                    act_bits=act_bits)
    assert got.shape == (M, N)
    tol = 2 ** -8 * np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= tol


@pytest.mark.parametrize("K,gs", [(512, None), (512, 128), (384, 32),
                                  (96, None)])
def test_quantize_linear_int8_identical(K, gs):
    """INT8 per column (group_size None: one group over K) and per group:
    the same bytes and scales as the JAX quantize_linear."""
    rng = np.random.default_rng(K)
    w = (rng.normal(size=(3, K, 64)) * 0.1).astype(np.float32)
    w[0, :, 5] = 0.0  # an all-zero column: scale 0, q 0
    jq = j_quantize_linear(JLinear(jnp.asarray(w)), 8, gs)
    tq = quantize_linear(Linear(torch.from_numpy(w)), 8, gs)
    assert tq.group_size == jq.group_size == (gs or K)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))


@pytest.mark.parametrize("bits,gs,pad_free,lm_head", [
    (4, 128, False, True), (4, 256, False, True), (4, 128, True, False),
    (8, 128, False, True), (8, 256, False, False)])
@pytest.mark.parametrize("preset", ["qwen2.5-7b", "qwen3-14b", "qwen2.5-0.5b"])
def test_init_quantized_params_shapes_match_jax(preset, bits, gs, pad_free,
                                                lm_head):
    """The port's pre-quantized random params have the JAX
    function's shapes, dtypes, group sizes and K padding, traced without
    allocating the 7B-class arrays (jax.eval_shape; meta tensors)."""
    import jax

    from qwen_inference_engine_tpu.config import PRESETS as J_PRESETS
    from qwen_inference_engine_tpu.models.qwen import (
        init_quantized_params as j_init,
    )
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    want = jax.eval_shape(lambda k: j_init(
        J_PRESETS[preset], k, bits=bits, group_size=gs,
        quantize_lm_head=lm_head, pad_free=pad_free), jax.random.PRNGKey(0))
    got = init_quantized_params(PRESETS[preset], None, bits=bits,
                                group_size=gs, quantize_lm_head=lm_head,
                                pad_free=pad_free, device="meta")

    def leaves(tree):
        out = {}
        for name, v in tree["layers"].items():
            for f in ("q", "scales", "b", "w"):
                t = getattr(v, f, None)
                if t is not None:
                    out[f"layers.{name}.{f}"] = t
            if not hasattr(v, "q") and not hasattr(v, "w"):
                out[f"layers.{name}"] = v
            if hasattr(v, "group_size"):
                out[f"layers.{name}.gs"] = v.group_size
        for name in ("embed", "final_norm", "rope_cos", "rope_sin"):
            out[name] = tree[name]
        head = tree.get("lm_head")
        if head is not None:
            for f in ("q", "scales", "w"):
                if getattr(head, f, None) is not None:
                    out[f"lm_head.{f}"] = getattr(head, f)
            if hasattr(head, "group_size"):
                out["lm_head.gs"] = head.group_size
        return out

    a, b = leaves(got), leaves(want)
    assert sorted(a) == sorted(b)
    for name in a:
        if name.endswith(".gs"):
            assert a[name] == b[name], name
        else:
            assert tuple(a[name].shape) == tuple(b[name].shape), name
            assert str(a[name].dtype).split(".")[-1] == str(b[name].dtype), name
