"""The grouped (MoE expert) matmuls: the port against the JAX package.

* The three plain versions (``grouped_matmul4``, ``_4_a8``, ``_8``, what
  the card's kernels are held to) against the JAX package's Pallas
  kernels in interpret mode, on the size lists of
  ``tests/test_grouped_matmul.py``: empty experts, one expert taking every
  row, every tile straddling, per-group INT8 scales, a stacked layer index
  of 1 and a single-layer stack.  Tolerance 2e-2 (atol and rtol, outputs
  ~N(0, 1)): the plain versions dequantize to bf16 weights (a relative
  2^-9 each) where the kernels scale in f32, and both round to bf16.
* The dispatcher ``grouped_quant_matmul`` on the CPU (weight-only experts
  in the caller's dtype) against the JAX package's XLA path, dequantize +
  ``ragged_dot`` in f32: the same function, 1e-5.
* The act_bits gate: ``grouped_quant_matmul_supported`` equal to the JAX
  package's on the shapes that decide it, and ``_expert_matmul`` quantizing
  expert activations only for INT4 experts that pass it.
* ``quantize_linear`` of an expert stack ``[L, E, K, N]``: the JAX
  package's bytes and scales.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.grouped_matmul as jgm
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.ops.linear import QuantLinear as JQuantLinear
from qwen_inference_engine_tpu.ops.linear import dequantize as j_dequantize
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_linear as j_quantize_linear,
)
from qwen_inference_engine_tpu_torch.models.qwen import _expert_matmul
from qwen_inference_engine_tpu_torch.ops import grouped_matmul as tgm
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
    quantize_activations,
)
from qwen_inference_engine_tpu_torch.quant.quantize import quantize_linear
from tests.helpers import interpret_pallas

TOL = dict(rtol=2e-2, atol=2e-2)


def _experts(L, E, K, N, bits, gs, seed):
    """(JAX stack, port stack) quantized by the JAX package (pad_free, as
    its tests do), the port's carrying the same bytes and scales."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(L, E, K, N)).astype(np.float32) * K ** -0.5
    jq = j_quantize_linear(JLinear(w=jnp.asarray(w)), bits, gs, pad_free=True)
    tq = QuantLinear(q=torch.from_numpy(np.asarray(jq.q).copy()),
                     scales=torch.from_numpy(np.asarray(jq.scales).copy()),
                     b=None, bits=bits, group_size=jq.group_size)
    return jq, tq


# kind, (L, E, K, N), group sizes, layer
CASES = {
    "int8 multi-tile, empties, straddles": ("w8", (2, 5, 256, 256),
                                            [0, 200, 7, 0, 93], 1),
    "int8 one expert takes all": ("w8", (2, 5, 256, 256),
                                  [300, 0, 0, 0, 0], 1),
    "int4 multi-tile, empties": ("w4", (2, 5, 256, 256),
                                 [0, 200, 7, 0, 93], 1),
    "int4 every tile straddles": ("w4", (2, 5, 256, 256),
                                  [37, 61, 64, 70, 68], 1),
    "w4a8 multi-tile, empties": ("w4a8", (2, 5, 256, 256),
                                 [0, 200, 7, 0, 93], 0),
    "w4a8 every tile straddles": ("w4a8", (2, 5, 256, 256),
                                  [37, 61, 64, 70, 68], 1),
    "int8 per-group scales": ("w8", (1, 3, 256, 128), [5, 0, 130], 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_the_pallas_kernels(case):
    kind, (L, E, K, N), sizes, layer = CASES[case]
    bits = 8 if kind == "w8" else 4
    jq, tq = _experts(L, E, K, N, bits, 128, seed=len(case))
    if case == "int8 per-group scales":
        assert tq.scales.shape[-2] == 2
    M = sum(sizes)
    assert jgm.grouped_quant_matmul_supported(jq, M)
    assert tgm.grouped_quant_matmul_supported(tq, M)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(M, K)).astype(np.float32)
    act_bits = 8 if kind == "w4a8" else 0
    with interpret_pallas(jgm):
        want = np.asarray(jgm.grouped_quant_matmul(
            jnp.asarray(x), jq, jnp.asarray(sizes, jnp.int32), layer,
            act_bits=act_bits))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gsz = torch.tensor(sizes, dtype=torch.int32)
    if kind == "w4a8":
        xq, sx = quantize_activations(xb)
        got = tgm.grouped_matmul4_a8_plain(xq, sx.reshape(-1), tq.q,
                                           tq.scales, gsz, layer,
                                           tq.group_size)
    elif kind == "w4":
        got = tgm.grouped_matmul4_plain(xb, tq.q, tq.scales, gsz, layer,
                                        tq.group_size)
    else:
        got = tgm.grouped_matmul8_plain(xb, tq.q, tq.scales, gsz, layer)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_dispatcher_matches_dequantize_and_ragged_dot(bits, stacked):
    """CPU, f32 activations: the JAX package's XLA path for experts."""
    jq, tq = _experts(2, 4, 192, 128, bits, 64, seed=bits)
    sizes = [3, 0, 41, 20]
    layer = 1
    if not stacked:
        jq = JQuantLinear(q=jq.q[layer], scales=jq.scales[layer], b=None,
                          bits=bits, group_size=jq.group_size)
        tq = QuantLinear(q=tq.q[layer], scales=tq.scales[layer], b=None,
                         bits=bits, group_size=tq.group_size)
    x = np.random.default_rng(2).normal(size=(64, 192)).astype(np.float32)
    wl = j_dequantize(JQuantLinear(
        q=jq.q[layer] if stacked else jq.q,
        scales=jq.scales[layer] if stacked else jq.scales, b=None,
        bits=bits, group_size=jq.group_size))
    want = jax.lax.ragged_dot(jnp.asarray(x), wl[:, :192].astype(jnp.float32),
                              jnp.asarray(sizes, jnp.int32))
    got = tgm.grouped_quant_matmul(torch.from_numpy(x), tq,
                                   torch.tensor(sizes), layer)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# (bits, K, N, group size): the shapes that decide the JAX package's gate
GATE_CASES = [(4, 256, 256, 128), (4, 128, 256, 64), (4, 256, 192, 128),
              (4, 2048, 768, 256), (4, 768, 2048, 128), (8, 256, 256, 128),
              (8, 256, 256, 64), (8, 2048, 768, None), (8, 96, 128, 32)]


@pytest.mark.parametrize("bits,K,N,gs", GATE_CASES)
def test_act_bits_gate_is_the_jax_packages(bits, K, N, gs):
    """W4A8 experts quantize their activations where the JAX package's
    shape gate holds, and compute the weight-only function elsewhere;
    INT8 experts never quantize activations."""
    rng = np.random.default_rng(K + N)
    w = rng.normal(size=(1, 2, K, N)).astype(np.float32) * K ** -0.5
    jq = j_quantize_linear(JLinear(w=jnp.asarray(w)), bits, gs)
    tq = quantize_linear(Linear(w=torch.from_numpy(w)), bits, gs)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    gate = jgm.grouped_quant_matmul_supported(jq, 16)
    assert tgm.grouped_quant_matmul_supported(tq, 16) == gate
    x = torch.from_numpy(rng.normal(size=(16, K)).astype(np.float32))
    gsz = torch.tensor([9, 7], dtype=torch.int32)
    got = _expert_matmul(x, tq, gsz, 0, act_bits=8)
    a8 = gate and bits == 4
    want = tgm.grouped_quant_matmul(x, tq, gsz, 0, act_bits=8 if a8 else 0)
    assert torch.equal(got, want)
    if not a8:
        assert torch.equal(got, tgm.grouped_quant_matmul(x, tq, gsz, 0))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_linear_takes_expert_stacks(bits):
    """[L, E, K, N] -> q [L, E, K/pack, N], scales [L, E, K/gs, N]: the
    JAX package's bytes and scales (K = 320 pads to 512 for INT4 gs 128;
    INT8 takes groups of 64 rows)."""
    w = np.random.default_rng(bits).normal(size=(2, 3, 320, 128)).astype(
        np.float32)
    gs = 128 if bits == 4 else 64
    jq = j_quantize_linear(JLinear(w=jnp.asarray(w)), bits, gs)
    tq = quantize_linear(Linear(w=torch.from_numpy(w)), bits, gs)
    assert tq.q.shape == tuple(jq.q.shape) and tq.group_size == jq.group_size
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))


class _FakeLibrary:
    """Stands in for the kernel library on the CPU: records each grouped
    entry point's arguments and returns 0 (launched)."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


def _launch_on_meta(kernel: str, M: int, E: int):
    """Call a grouped wrapper on meta tensors (the kernel path: not a CPU
    tensor) at M rows over E experts, K 256 and N 128."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    gsz = meta(E, dtype=torch.int32)
    if kernel == "grouped_matmul4_a8":
        return tgm.grouped_matmul4_a8(
            meta(M, 256, dtype=torch.int8), meta(M),
            meta(2, E, 128, 128, dtype=torch.int8), meta(2, E, 2, 128), gsz, 1,
            128)
    if kernel == "grouped_matmul4":
        return tgm.grouped_matmul4(
            meta(M, 256, dtype=torch.bfloat16),
            meta(2, E, 128, 128, dtype=torch.int8), meta(2, E, 2, 128), gsz, 1,
            128)
    return tgm.grouped_matmul8(
        meta(M, 256, dtype=torch.bfloat16),
        meta(2, E, 256, 128, dtype=torch.int8), meta(2, E, 2, 128), gsz, 1)


@pytest.mark.parametrize("kernel", ["grouped_matmul4_a8", "grouped_matmul4",
                                    "grouped_matmul8"])
@pytest.mark.parametrize("M,E,mt", [
    (1, 128, 1), (256, 128, 1), (2048, 128, 1), (2049, 128, 4),
    (4096, 128, 4), (131072, 128, 4), (16, 1, 1), (17, 1, 4), (300, 5, 4),
])
def test_grouped_matmul8_plan_follows_the_mean_rows_per_expert(
        monkeypatch, M, E, mt, kernel):
    """plan_grouped_matmul (plan_grouped_matmul8 is its other name), the
    one plan of the three grouped kernels: the tensor-core body's 16-row
    tiles (mt 1) where ceil(M / E) <= 16, as at every 30B-A3B decode step
    (batch 32 x top-8 = 256 rows over 128 experts), 64-row tiles (mt 4)
    above, as a 512-token piece (4096 rows) and a batch of such prompts
    take; each wrapper hands that mt to its entry point (the library
    replaced by a recorder, meta tensors for the kernel path)."""
    assert tgm.plan_grouped_matmul(M, E) == mt
    assert tgm.plan_grouped_matmul8 is tgm.plan_grouped_matmul
    assert mt in (1, 4) and (mt == 1) == (-(-M // E) <= 16)
    lib = _FakeLibrary()
    monkeypatch.setattr(tgm.cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(tgm.cuda_lib, "stream_handle", lambda device: 0)
    fn = getattr(tgm, kernel)
    before = fn.launches
    out = _launch_on_meta(kernel, M, E)
    assert out.shape == (M, 128) and fn.launches == before + 1
    (args,) = lib.calls.values()
    # the entry points take (..., E, mt, layer, L, stream)
    assert args[-5:-1] == (E, mt, 1, 2)
