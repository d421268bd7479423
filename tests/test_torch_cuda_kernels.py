"""The port's CUDA kernels against their plain versions, on the card.

These tests need a GPU and the CUDA toolkit (marker ``cuda``); without a
card they skip (the decision is made in a fixture, never at import).  They
cover the edges the smoke run's Qwen2.5-7B shapes do not: ragged M, any T,
G in 1..8, D=64, B smaller than the cache batch, continuation chunks from
1 to 512 tokens at the first, a mid-tile and the last start and per-row
starts on the device (G 2, 5, 7 and 8, D 64 and 128, packed row tiles that
T * G does not fill, NaN past each row's window, two calls bit for bit),
the INT8 KV
append at the first and last position, the paged kernels over pages of 8,
16, 48 and 512 tokens (tiles that cross pages, mid-page starts, pieces of
1, 7, 256 and 512 tokens, lengths of 1 and whole pages, idle rows and
scratch-page writes), the INT8 pool's kernels and the speculative verify
(T = 2, 16 and 17, windows straddling pages and windows wider than their
page, the int8 scale writes), the grouped MoE matmuls (one row, one
expert taking every row, 127 empty experts of 128, decode- and
prefill-like expert sizes, odd column tiles, a padded K), the fused
single-pass MLP, the fused attention + MLP and the uniform bf16 append of
the double-pumped decode (tiny and Qwen2.5-7B shapes, NaN past each row's
length, two calls bit for bit), ``decode_step_pumped`` against
``decode_step``, the last four sites' kernels (the ragged window append at
starts -1, band edges and past the cache's end in bf16, f32 and int8; the
fresh-merge decode attention with NaN at and past each old length and
bit-identical to the appending kernel; the all-layer append at 28 layers;
the fused attention + matmul at the probe's shapes), the deferred-append
decode step against ``decode_step`` bit for bit, flash attention on the
tensor cores (T 1 to 512, G 1, 4, 7 and 8, D 64 and 128, two calls bit for
bit), the split-K weight streams and tensor-core tiles of W8A8, W4A8 and
W8A16 (M 1 to 300, K split unevenly, gs 32, 64, 128, 256 and per column,
the lm_head's width, the 7B down projection, W8A16 widths of 64 past a
multiple of 128; two calls bit for bit, and W8A8 per column bit for bit
against the exact product rounded as the kernel rounds it), the ragged
``Engine.generate`` and ``generate_speculative`` through
``kv_append_ragged_t``, the serving engine (INT8 pools and speculation
too), and the wrappers' refusals.  On
a GPU machine, from the repo root (this file imports no JAX, so the
JAX-pinning conftest can be skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import dataclasses

import pytest
import torch

from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models import qwen
from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
from qwen_inference_engine_tpu_torch.ops import decode_attention as da
from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
from qwen_inference_engine_tpu_torch.ops import fused_step as fs
from qwen_inference_engine_tpu_torch.ops import kv_append as ka
from qwen_inference_engine_tpu_torch.ops import paged_attention as pa
from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from qwen_inference_engine_tpu_torch.quant.quantize import (
    QuantConfig,
    quantize_params,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for the first build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("M,K,N,gs", [(1, 512, 128, 128), (17, 1024, 256, 64),
                                      (65, 768, 384, 128), (130, 2048, 128, 256)])
def test_quant_matmul4_a8_matches_plain(gen, M, K, N, gs):
    L = 3
    q = torch.randint(-128, 128, (L, K // 2, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01
    xq, sx = qm.quantize_activations(_bf16(gen, M, K))
    sx = sx.reshape(-1).contiguous()
    before = qm.quant_matmul4_a8.launches
    got = qm.quant_matmul4_a8(xq, sx, q, s, 2, gs)
    ref = qm.quant_matmul4_a8_plain(xq, sx, q, s, 2, gs)
    assert qm.quant_matmul4_a8.launches == before + 1
    # both round one f32 value to bf16: at most 2 ulps of the largest output
    tol = 2 ** -6 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_quant_matmul4_a8_refuses_what_it_cannot_take(gen):
    q = torch.zeros((1, 256, 200), dtype=torch.int8, device="cuda")
    s = torch.zeros((1, 4, 200), device="cuda")
    xq = torch.zeros((2, 512), dtype=torch.int8, device="cuda")
    sx = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="N % 128"):
        qm.quant_matmul4_a8(xq, sx, q, s, 0, 128)
    q = torch.zeros((1, 256, 256), dtype=torch.int8, device="cuda")
    s = torch.zeros((1, 4, 256), device="cuda")
    with pytest.raises(IndexError):
        qm.quant_matmul4_a8(xq, sx, q, s, 1, 128)


# M: decode rows (the split-K stream at M <= 64) and prefill rows (the
# 128 x 128 tiles above), ragged against the 16 / 64 / 128-row tiles;
# N = 152064 is the Qwen2.5-7B lm_head
W16_SHAPES = [(1, 512, 128, 32), (5, 1024, 256, 64), (17, 768, 192, 128),
              (300, 2048, 128, 256), (4, 256, 152064, 128), (64, 512, 64, 64)]


def _check_matmul(got, ref, rel):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    tol = rel * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("M,K,N,gs", W16_SHAPES)
def test_quant_matmul4_matches_plain(gen, M, K, N, gs):
    """bf16 activations: the bf16 tensor cores' f32 sums are not
    IEEE-ordered and the plain version's differ in order, and both round
    to bf16: 2^-6 of the largest output, the rule of the W4A8 kernel's
    test."""
    L = 2
    q = torch.randint(-128, 128, (L, K // 2, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01
    x = _bf16(gen, M, K)
    before = qm.quant_matmul4.launches
    got = qm.quant_matmul4(x, q, s, 1, gs)
    ref = qm.quant_matmul4_plain(x, q, s, 1, gs)
    assert qm.quant_matmul4.launches == before + 1
    _check_matmul(got, ref, 2 ** -6)


@pytest.mark.parametrize("per_column", [False, True], ids=["group", "column"])
@pytest.mark.parametrize("M,K,N,gs", W16_SHAPES)
def test_quant_matmul8_matches_plain(gen, M, K, N, gs, per_column):
    L = 2
    G = 1 if per_column else K // gs
    q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, G, N), generator=gen, device="cuda") * 0.01
    x = _bf16(gen, M, K)
    before = qm.quant_matmul8.launches
    got = qm.quant_matmul8(x, q, s, 1)
    ref = qm.quant_matmul8_plain(x, q, s, 1)
    assert qm.quant_matmul8.launches == before + 1
    _check_matmul(got, ref, 2 ** -6)


@pytest.mark.parametrize("per_column", [False, True], ids=["group", "column"])
@pytest.mark.parametrize("M,K,N,gs", [(1, 512, 128, 32), (5, 1024, 256, 64),
                                      (17, 768, 384, 128), (300, 2048, 128, 256),
                                      (4, 256, 152064, 128)])
def test_quant_matmul8_a8_matches_plain(gen, M, K, N, gs, per_column):
    """Integer sums are exact in the kernel, the plain version's f32 sums
    are not, and both round to bf16: one bf16 ulp of the largest output
    (2^-7 of it)."""
    L = 2
    G = 1 if per_column else K // gs
    q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, G, N), generator=gen, device="cuda") * 0.01
    xq, sx = qm.quantize_activations(_bf16(gen, M, K))
    sx = sx.reshape(-1).contiguous()
    before = qm.quant_matmul8_a8.launches
    got = qm.quant_matmul8_a8(xq, sx, q, s, 0)
    ref = qm.quant_matmul8_a8_plain(xq, sx, q, s, 0)
    assert qm.quant_matmul8_a8.launches == before + 1
    _check_matmul(got, ref, 2 ** -7)


# M: the decode stream (1, 4, 16: one m16 tile a warp; 17, 64: four) and
# the prefill tiles (300: ragged against 128); K = 1664 splits
# into 7 slices of 256 rows (the last 128) at N <= 384; N = 152064 is the
# Qwen2.5-7B lm_head (no split)
W8A8_SHAPES = [(1, 1664, 128), (4, 1664, 256), (16, 1664, 384),
               (17, 1664, 128), (64, 1664, 256), (300, 1664, 256),
               (4, 512, 152064)]


@pytest.mark.parametrize("gs", [32, 64, 128, None])
@pytest.mark.parametrize("M,K,N", W8A8_SHAPES)
def test_quant_matmul8_a8_split_and_tensor_core_paths(gen, M, K, N, gs):
    """Within 2^-7 of the largest output of the plain version; two calls
    bit for bit (the split-K partials are added in a fixed order); with one
    scale per column, bit for bit the exact product rounded as the kernel
    rounds it: float(x . q) * scale * sx, then bf16."""
    L = 2
    G = 1 if gs is None else K // gs
    q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, G, N), generator=gen, device="cuda") * 0.01
    xq, sx = qm.quantize_activations(_bf16(gen, M, K))
    sx = sx.reshape(-1).contiguous()
    mt, splits, _ = qm.plan_quant_matmul8_a8(M, K, N, G)
    assert (mt == 0) == (M > 64) and (splits > 1) == (N <= 384 and M <= 64)
    before = qm.quant_matmul8_a8.launches
    got = qm.quant_matmul8_a8(xq, sx, q, s, 1)
    again = qm.quant_matmul8_a8(xq, sx, q, s, 1)
    ref = qm.quant_matmul8_a8_plain(xq, sx, q, s, 1)
    assert qm.quant_matmul8_a8.launches == before + 2
    _check_matmul(got, ref, 2 ** -7)
    assert torch.equal(got, again)
    if gs is None:
        exact = (xq.double() @ q[1].double()).float() * s[1, 0] * sx[:, None]
        assert torch.equal(got, exact.to(torch.bfloat16))


# (M, N, K): the decode stream (1, 4, 16: one m16 tile a warp; 17, 40, 64:
# four) and the prefill tiles (65, 300: ragged against 128).  K None: 3328
# (1664 packed rows: 7 slices of 256, the last 128) below gs 256, 3584 (7
# slices) at gs 256; the Qwen2.5-7B lm_head's width (no split) and its down
# projection at the quantizer-padded K
W4A8_SPLIT_SHAPES = [(1, 512, None), (4, 256, None), (16, 384, None),
                     (17, 128, None), (40, 512, None), (64, 256, None),
                     (65, 128, None), (300, 256, None), (4, 152064, 512),
                     (4, 3584, "down"), (40, 3584, "down")]


@pytest.mark.parametrize("gs", [32, 64, 128, 256])
@pytest.mark.parametrize("M,N,K", W4A8_SPLIT_SHAPES)
def test_quant_matmul4_a8_split_and_tensor_core_paths(gen, M, N, K, gs):
    """Within 2^-7 of the largest output of the plain version (the int32
    plane sums are exact, the f32 folds and the plain version's f32 sums
    differ in order, and both round to bf16); two calls bit for bit (the
    split-K partials are added in a fixed order)."""
    from qwen_inference_engine_tpu_torch.quant.quantize import _padded_k

    if K is None:
        K = 3328 if gs < 256 else 3584
    elif K == "down":
        K = _padded_k(18944, 4, gs)
    L = 2
    q = torch.randint(-128, 128, (L, K // 2, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01
    xq, sx = qm.quantize_activations(_bf16(gen, M, K))
    sx = sx.reshape(-1).contiguous()
    mt, splits, _ = qm.plan_quant_matmul4_a8(M, K, N, gs)
    assert (mt == 0) == (M > 64)
    assert (splits > 1) == (M <= 64 and N < 152064)
    before = qm.quant_matmul4_a8.launches
    got = qm.quant_matmul4_a8(xq, sx, q, s, 1, gs)
    again = qm.quant_matmul4_a8(xq, sx, q, s, 1, gs)
    ref = qm.quant_matmul4_a8_plain(xq, sx, q, s, 1, gs)
    assert qm.quant_matmul4_a8.launches == before + 2
    _check_matmul(got, ref, 2 ** -7)
    assert torch.equal(got, again)


# as W4A8_SPLIT_SHAPES, with widths of 64 past a multiple of 128 (a
# block's last 64 columns empty) in the decode stream's two tiles and the
# prefill tiles
W4A16_SPLIT_SHAPES = W4A8_SPLIT_SHAPES + [(1, 64, None), (17, 192, None),
                                          (300, 320, None)]


@pytest.mark.parametrize("gs", [32, 64, 128, 256])
@pytest.mark.parametrize("M,N,K", W4A16_SPLIT_SHAPES)
def test_quant_matmul4_split_and_tensor_core_paths(gen, M, N, K, gs):
    """Within 2^-6 of the largest output of the plain version, the rule of
    test_quant_matmul4_matches_plain (the bf16 tensor cores' f32 plane sums
    are not IEEE-ordered); two calls bit for bit (the split-K partials are
    added in a fixed order)."""
    from qwen_inference_engine_tpu_torch.quant.quantize import _padded_k

    if K is None:
        K = 3328 if gs < 256 else 3584
    elif K == "down":
        K = _padded_k(18944, 4, gs)
    L = 2
    q = torch.randint(-128, 128, (L, K // 2, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01
    x = _bf16(gen, M, K)
    mt, splits, _ = qm.plan_quant_matmul4(M, K, N, gs)
    assert (mt == 0) == (M > 64)
    assert (splits > 1) == (M <= 64 and N < 152064)
    before = qm.quant_matmul4.launches
    got = qm.quant_matmul4(x, q, s, 1, gs)
    again = qm.quant_matmul4(x, q, s, 1, gs)
    ref = qm.quant_matmul4_plain(x, q, s, 1, gs)
    assert qm.quant_matmul4.launches == before + 2
    _check_matmul(got, ref, 2 ** -6)
    assert torch.equal(got, again)


# (M, K, N): as W8A8_SHAPES, with widths of 64 past a multiple of 128 (a
# block's last 64 columns empty) and the Qwen2.5-7B down projection
W8A16_SPLIT_SHAPES = W8A8_SHAPES + [(1, 1664, 64), (17, 1664, 192),
                                    (300, 1664, 320), (4, 18944, 3584)]


@pytest.mark.parametrize("gs", [32, 64, 128, None])
@pytest.mark.parametrize("M,K,N", W8A16_SPLIT_SHAPES)
def test_quant_matmul8_split_and_tensor_core_paths(gen, M, K, N, gs):
    """Within 2^-6 of the largest output of the plain version, the rule of
    test_quant_matmul8_matches_plain (the bf16 tensor cores' f32 sums are
    not IEEE-ordered); two calls bit for bit."""
    L = 2
    G = 1 if gs is None else K // gs
    q = torch.randint(-127, 128, (L, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, G, N), generator=gen, device="cuda") * 0.01
    x = _bf16(gen, M, K)
    mt, splits, _ = qm.plan_quant_matmul8(M, K, N, G)
    assert (mt == 0) == (M > 64)
    assert (splits > 1) == (M <= 64 and N < 152064)
    before = qm.quant_matmul8.launches
    got = qm.quant_matmul8(x, q, s, 1)
    again = qm.quant_matmul8(x, q, s, 1)
    ref = qm.quant_matmul8_plain(x, q, s, 1)
    assert qm.quant_matmul8.launches == before + 2
    _check_matmul(got, ref, 2 ** -6)
    assert torch.equal(got, again)


@pytest.mark.parametrize("bits,act_bits,gs", [(4, 0, 128), (8, 0, 128),
                                              (8, 0, None), (8, 8, None),
                                              (8, 8, 64), (4, 8, 128)])
def test_dispatcher_on_padded_k_matches_plain(gen, bits, act_bits, gs):
    """K = 448 pads to 512 for INT4 (the dispatcher zero-pads x); every
    (bits, act_bits) pair launches its own kernel and agrees with the plain
    dequant matmul of ops/linear.py."""
    from qwen_inference_engine_tpu_torch.ops.linear import Linear
    from qwen_inference_engine_tpu_torch.quant.quantize import quantize_linear

    K = 448 if bits == 4 else 512
    w = torch.randn((2, K, 256), generator=gen, device="cuda") * 0.05
    lin = quantize_linear(Linear(w), bits, gs)
    x = _bf16(gen, 3, 37, K)
    kern = {(4, 0): qm.quant_matmul4, (8, 0): qm.quant_matmul8,
            (8, 8): qm.quant_matmul8_a8, (4, 8): qm.quant_matmul4_a8}
    counts = {k: f.launches for k, f in kern.items()}
    got = qm.quant_matmul_stacked(x, lin, 1, act_bits=act_bits)
    ref = qm.quant_matmul_stacked(x.cpu().float(), dataclasses.replace(
        lin, q=lin.q.cpu(), scales=lin.scales.cpu()), 1, act_bits=act_bits)
    assert {k: f.launches - counts[k] for k, f in kern.items()} == {
        k: int(k == (bits, act_bits)) for k in kern}
    assert got.shape == (3, 37, 256) and got.dtype == torch.bfloat16
    rel = 2 ** -7 if act_bits else 2 ** -6
    tol = rel * ref.abs().max().item() + 2 ** -8 * ref.abs().max().item()
    assert (got.float().cpu() - ref).abs().max().item() <= tol


# (E, group sizes, N): one row to one expert; one expert taking every row;
# E = 128 with 127 empty; decode (256 rows over 128 experts, ~2 each: the
# CUDA-core tiles); prefill-like experts of 7..200 rows (the 64-row tiles)
# with every tile straddling; N of an odd number of column tiles
GROUPED_SIZES = {
    "M=1": (4, [0, 0, 1, 0], 256),
    "one expert": (5, [300, 0, 0, 0, 0], 256),
    "127 empty": (128, [0] * 90 + [37] + [0] * 37, 256),
    "decode": (128, None, 384),
    "prefill": (5, [0, 200, 7, 0, 93], 384),
    "straddling": (5, [37, 61, 64, 70, 68], 256),
}


def _group_sizes(gen, E, sizes):
    if sizes is not None:
        return torch.tensor(sizes, dtype=torch.int32, device="cuda")
    ids = torch.randint(0, E, (256,), generator=gen, device="cuda")
    return torch.bincount(ids, minlength=E).to(torch.int32)


@pytest.mark.parametrize("kind", ["w4a8", "w4", "w8 group", "w8 column"])
@pytest.mark.parametrize("case", sorted(GROUPED_SIZES))
def test_grouped_matmuls_match_plain(gen, case, kind):
    """The three grouped kernels at layer 1 of a stacked [2, E, ...] tensor
    against their plain versions (bf16-dequantized weights: 2^-6 of the
    largest output, the dense kernels' rule)."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    E, sizes, N = GROUPED_SIZES[case]
    gsz = _group_sizes(gen, E, sizes)
    M, K, gs = int(gsz.sum()), 512, 128
    bits = 8 if kind.startswith("w8") else 4
    rows = K // 2 if bits == 4 else K
    G = 1 if kind == "w8 column" else K // gs
    q = torch.randint(-128 if bits == 4 else -127, 128, (2, E, rows, N),
                      generator=gen, device="cuda", dtype=torch.int8)
    s = torch.rand((2, E, G, N), generator=gen, device="cuda") * 0.01
    x = _bf16(gen, M, K)
    if kind == "w4a8":
        xq, sx = qm.quantize_activations(x)
        args = (xq, sx.reshape(-1).contiguous(), q, s, gsz, 1, gs)
        fn, plain = gm.grouped_matmul4_a8, gm.grouped_matmul4_a8_plain
    elif kind == "w4":
        args = (x, q, s, gsz, 1, gs)
        fn, plain = gm.grouped_matmul4, gm.grouped_matmul4_plain
    else:
        args = (x, q, s, gsz, 1)
        fn, plain = gm.grouped_matmul8, gm.grouped_matmul8_plain
    before = fn.launches
    got = fn(*args)
    ref = plain(*args)
    assert fn.launches == before + 1
    assert bool(got.isfinite().all())
    _check_matmul(got, ref, 2 ** -6)


@pytest.mark.parametrize("bits,act_bits", [(4, 0), (4, 8), (8, 0)])
def test_grouped_dispatcher_pads_k_and_picks_its_kernel(gen, bits, act_bits):
    """K = 448 pads to 512 for INT4 (the dispatcher zero-pads x); each
    (bits, act_bits) pair launches its kernel (INT8 experts ignore
    act_bits) and agrees with the CPU path."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.ops.linear import Linear
    from qwen_inference_engine_tpu_torch.quant.quantize import quantize_linear

    K = 448 if bits == 4 else 512
    w = torch.randn((2, 6, K, 256), generator=gen, device="cuda") * 0.05
    qe = quantize_linear(Linear(w), bits, 128)
    gsz = torch.tensor([5, 0, 0, 30, 1, 9], dtype=torch.int32, device="cuda")
    x = _bf16(gen, 45, K)
    kern = {(4, 0): gm.grouped_matmul4, (4, 8): gm.grouped_matmul4_a8,
            (8, 0): gm.grouped_matmul8}
    counts = {k: f.launches for k, f in kern.items()}
    got = gm.grouped_quant_matmul(x, qe, gsz, 1, act_bits=act_bits)
    cpu = dataclasses.replace(qe, q=qe.q.cpu(), scales=qe.scales.cpu())
    ref = gm.grouped_quant_matmul(x.cpu().float(), cpu, gsz.cpu(), 1,
                                  act_bits=act_bits)
    assert {k: f.launches - counts[k] for k, f in kern.items()} == {
        k: int(k == (bits, act_bits if bits == 4 else 0)) for k in kern}
    assert got.shape == (45, 256) and got.dtype == torch.bfloat16
    tol = 2 ** -6 * ref.abs().max().item()
    assert (got.float().cpu() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("bits,act_bits", [(4, 8), (4, 0), (8, 0)])
def test_moe_model_runs_through_the_grouped_kernels(gen, bits, act_bits):
    """A tiny Qwen3-MoE (hidden 256, 8 experts of 256, top-2) on the card:
    Engine.generate launches its format's grouped kernel 3 times a layer a
    forward; the serving engine with prompt lookup runs through it too."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    cfg = tiny_config(qk_norm=True, hidden_size=256, num_heads=4,
                      num_kv_heads=2, head_dim=64, num_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=256)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=bits, group_size=128))
    cfg = cfg.replace(act_bits=act_bits)
    kern = {(4, 8): gm.grouped_matmul4_a8, (4, 0): gm.grouped_matmul4,
            (8, 0): gm.grouped_matmul8}[(bits, act_bits)]
    prompts = [[5, 9, 17, 3, 5, 9, 17, 3], [40, 41, 42]]
    eng = Engine(cfg, params, max_batch=2, max_seq=64,
                 sampling=SamplingParams(greedy=True), device="cuda")
    before = kern.launches
    res = eng.generate(prompts, max_new_tokens=6)
    # res.steps counts the prefill and each decode step
    assert kern.launches - before == 3 * cfg.num_layers * res.steps
    cb = ContinuousBatchingEngine(cfg, params, max_slots=2, page_size=16,
                                  num_pages=16, max_pages_per_seq=4,
                                  sampling=SamplingParams(greedy=True),
                                  speculative=True, spec_k=3, spec_ngram=2,
                                  device="cuda")
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=6))
    before = kern.launches
    out = {f.request_id: f.token_ids for f in cb.run_to_completion()}
    assert sorted(out) == [0, 1] and kern.launches > before
    assert all(0 < len(v) <= 6 and all(0 <= t < cfg.vocab_size for t in v)
               for v in out.values())


def test_grouped_matmuls_refuse_what_they_cannot_take(gen):
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    gsz = torch.tensor([1, 1], dtype=torch.int32, device="cuda")
    q = torch.zeros((1, 2, 128, 192), dtype=torch.int8, device="cuda")
    s = torch.zeros((1, 2, 2, 192), device="cuda")
    xq = torch.zeros((2, 256), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="N % 128"):
        gm.grouped_matmul4_a8(xq, torch.ones(2, device="cuda"), q, s, gsz, 0,
                              128)
    with pytest.raises(IndexError):
        gm.grouped_matmul4(_bf16(gen, 2, 256), q, s, gsz, 1, 128)
    with pytest.raises(ValueError, match="shapes"):
        gm.grouped_matmul4(_bf16(gen, 2, 256), q, s, gsz[:1].contiguous(), 0,
                           128)


def test_new_quant_matmuls_refuse_what_they_cannot_take(gen):
    x = _bf16(gen, 2, 512)
    q4 = torch.zeros((1, 256, 256), dtype=torch.int8, device="cuda")
    s4 = torch.zeros((1, 4, 256), device="cuda")
    with pytest.raises(TypeError, match="bfloat16 activations"):
        qm.quant_matmul4(x.float(), q4, s4, 0, 128)
    with pytest.raises(ValueError, match="gs % 32"):
        qm.quant_matmul4(x, q4, torch.zeros((1, 32, 256), device="cuda"), 0, 16)
    with pytest.raises(ValueError, match="N % 64"):
        qm.quant_matmul4(x, q4[..., :96].contiguous(), s4[..., :96].contiguous(),
                         0, 128)
    q8 = torch.zeros((1, 512, 256), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="shapes"):
        qm.quant_matmul8(x, q8, torch.zeros((1, 4, 128), device="cuda"), 0)
    with pytest.raises(ValueError, match="K/G % 32"):
        qm.quant_matmul8(x, q8, torch.zeros((1, 32, 256), device="cuda"), 0)
    with pytest.raises(IndexError):
        qm.quant_matmul8(x, q8, torch.zeros((1, 1, 256), device="cuda"), 1)
    xq = torch.zeros((2, 512), dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError, match="f32 scales"):
        qm.quant_matmul8_a8(xq, torch.ones(2, device="cuda").half(), q8,
                            torch.zeros((1, 1, 256), device="cuda"), 0)
    with pytest.raises(ValueError, match="N % 128"):
        qm.quant_matmul8_a8(xq, torch.ones(2, device="cuda"),
                            q8[..., :192].contiguous(),
                            torch.zeros((1, 1, 192), device="cuda"), 0)


@pytest.mark.parametrize("bits,act_bits,gs,lm_head", [
    (4, 0, 128, True), (8, 0, 128, True), (8, 8, None, False)],
    ids=["w4a16", "w8a16", "w8a8"])
def test_engine_runs_each_weight_format_on_the_card(gen, bits, act_bits, gs,
                                                    lm_head):
    """Engine.generate at W4A16 and W8A16 (quantized lm_heads) and W8A8 (one
    scale per column): only the format's own matmul kernel launches, 7 per
    layer per forward (+1 for a quantized lm_head); W4A16 (pad-free at gs
    128, F = 512, M <= 256) runs its MLP as fused_mlp, once a layer, and
    4 matmuls a layer."""
    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=bits, group_size=gs,
                                                 quantize_lm_head=lm_head))
    cfg = cfg.replace(act_bits=act_bits)
    eng = Engine(cfg, params, max_batch=2, max_seq=128,
                 sampling=SamplingParams(greedy=True))
    kern = {(4, 0): qm.quant_matmul4, (8, 0): qm.quant_matmul8,
            (8, 8): qm.quant_matmul8_a8, (4, 8): qm.quant_matmul4_a8}
    kern["fused_mlp"] = fs.fused_mlp
    for k in kern.values():
        k.launches = 0
    res = eng.generate([[5, 9, 17], [100, 200, 300, 400, 500]],
                       max_new_tokens=6)
    forwards = res.steps  # one prefill + one decode step per further token
    fused = (bits, act_bits) == (4, 0)
    per_layer = 4 if fused else 7
    want = forwards * (per_layer * cfg.num_layers + int(lm_head))
    assert {k: f.launches for k, f in kern.items()} == {
        k: want if k == (bits, act_bits)
        else forwards * cfg.num_layers if k == "fused_mlp" and fused
        else 0 for k in kern}
    assert all(0 <= t < cfg.vocab_size for row in res.token_ids for t in row)


@pytest.mark.parametrize("B,T,Hq,Hk,D", [(1, 1, 2, 1, 128), (2, 17, 4, 2, 64),
                                         (1, 100, 14, 2, 128), (3, 64, 5, 1, 128)])
def test_flash_attention_matches_plain(gen, B, T, Hq, Hk, D):
    q, k, v = _bf16(gen, B, T, Hq, D), _bf16(gen, B, T, Hk, D), _bf16(gen, B, T, Hk, D)
    got = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    # bf16 output; the plain version rounds probabilities to bf16
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("T", [1, 63, 65, 130, 512])
def test_flash_attention_tensor_core_tiles_match_plain(gen, T, G, D):
    """The packed-row tiles (64 rows r = t * G + g, straddling tokens for G
    7), one or several 64-key tiles with a ragged edge, B up to 4; two
    calls bit for bit."""
    B, Hk = (4, 2) if T <= 130 else (2, 2)
    Hq = G * Hk
    q, k, v = _bf16(gen, B, T, Hq, D), _bf16(gen, B, T, Hk, D), _bf16(gen, B, T, Hk, D)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    assert fa.flash_attention.launches == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(got, fa.flash_attention(q, k, v))


@pytest.mark.parametrize("B,Bc,Hk,G,D,S,lens", [
    (3, 3, 2, 7, 128, 256, [1, 100, 256]),
    (2, 4, 1, 5, 64, 512, [300, 7]),
    (1, 1, 4, 8, 128, 256, [64]),
])
def test_decode_attention_contiguous_matches_plain(gen, B, Bc, Hk, G, D, S, lens):
    L = 2
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    lengths = torch.tensor(lens, device="cuda")
    got = da.decode_attention_contiguous(q, kc, vc, 1, lengths)
    ref = da.decode_attention_contiguous_plain(q, kc, vc, 1, lengths)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("pos,G", [(0, 7), (63, 7), (64, 1), (255, 4)])
def test_decode_attention_appending_matches_plain(gen, pos, G):
    L, B, Hk, D, S = 2, 3, 2, 128, 256
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, gk, gv = da.decode_attention_appending(q, k1, v1, kn, vn, 1, pos)
    ref, rk, rv = da.decode_attention_appending_plain(q, k2, v2, kn, vn, 1, pos)
    assert gk is k1 and gv is v1
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(gk, rk) and torch.equal(gv, rv)
    # the position may also come as a tensor on the card (read on device)
    got2, _, _ = da.decode_attention_appending(
        q, k1, v1, kn, vn, 1, torch.tensor([pos], device="cuda"))
    assert torch.equal(got2, got)


def test_decode_attention_refuses_f32_cache(gen):
    kc = torch.zeros((1, 1, 1, 256, 128), device="cuda")
    q = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        da.decode_attention_contiguous(q, kc, kc, 0, torch.ones(1, device="cuda"))


def test_engine_runs_w4a8_on_the_card_through_all_four_kernels(gen):
    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    eng = Engine(cfg, params, max_batch=2, max_seq=128,
                 sampling=SamplingParams(greedy=True))
    wrappers = [qm.quant_matmul4_a8, fa.flash_attention,
                da.decode_attention_contiguous, da.decode_attention_appending]
    before = [w.launches for w in wrappers]
    ragged = eng.generate([[5, 9, 17], [100, 200, 300, 400, 500]], max_new_tokens=6)
    aligned = eng.generate([[5, 9, 17, 3], [7, 8, 9, 10]], max_new_tokens=6)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    for res in (ragged, aligned):
        assert all(0 <= t < cfg.vocab_size for row in res.token_ids for t in row)


def _int8_cache(gen, *shape):
    q, s = quantize_kv(torch.randn(shape, generator=gen, device="cuda"))
    return q, s


def _nan_past_window(kc, vc, ks, vs, layer, past):
    """Copies of the cache with NaN at every key past each row's window
    (``past`` [B, S], True there): in K/V for bf16, in the scales for
    int8."""
    nan = float("nan")
    B = past.shape[0]
    if ks is None:
        kn, vn = kc.clone(), vc.clone()
        for t in (kn, vn):
            t[layer, :B].masked_fill_(past[:, None, :, None], nan)
        return kn, vn, None, None
    ksn, vsn = ks.clone(), vs.clone()
    for t in (ksn, vsn):
        t[layer, :B].masked_fill_(past[:, None, :], nan)
    return kc, vc, ksn, vsn


def _chunk_case(gen, quant, L, B, Bc, Hk, G, D, S, T, start):
    """The kernel (twice, over a cache with NaN past each row's window) and
    the plain version (over the same cache without the NaN) on one chunk;
    returns (got, got_again, ref)."""
    q = _bf16(gen, B, T, G * Hk, D)
    if isinstance(start, torch.Tensor):
        ends = start.long() + T
    else:
        ends = torch.full((B,), start + T, device="cuda")
    past = torch.arange(S, device="cuda")[None, :] >= ends[:, None]
    if quant:
        kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
        vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    else:
        kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
        ks = vs = None
    kn, vn, ksn, vsn = _nan_past_window(kc, vc, ks, vs, 1, past)
    if quant:
        fn = ca.chunk_attention_contiguous_q8
        before = fn.launches
        got = fn(q, kn, vn, ksn, vsn, 1, start)
        again = fn(q, kn, vn, ksn, vsn, 1, start)
        ref = ca.chunk_attention_contiguous_q8_plain(q, kc, vc, ks, vs, 1,
                                                     start)
    else:
        fn = ca.chunk_attention_contiguous
        before = fn.launches
        got = fn(q, kn, vn, 1, start)
        again = fn(q, kn, vn, 1, start)
        ref = ca.chunk_attention_contiguous_plain(q, kc, vc, 1, start)
    assert fn.launches == before + 2
    return got, again, ref


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T,where,G,D", [
    (1, "first", 7, 128), (1, "mid", 4, 128), (1, "last", 8, 128),
    (7, "first", 4, 128), (7, "mid", 8, 128), (7, "last", 7, 128),
    (64, "first", 8, 128), (64, "mid", 7, 128), (64, "last", 4, 128),
    (512, "first", 7, 128), (512, "mid", 4, 128), (512, "last", 8, 128),
    # the packed row tiles: G of Qwen3-0.6B (2), Qwen3-14B (5), Qwen2.5-7B
    # (7), Qwen3-30B-A3B (8); T * G no multiple of the 64-row tile
    (9, "mid", 2, 128), (13, "mid", 5, 128), (100, "mid", 7, 128),
    (300, "first", 8, 128), (511, "mid", 5, 128), (333, "last", 2, 128),
    # D = 64 (Qwen2.5-0.5B: G = 7)
    (1, "mid", 7, 64), (35, "first", 7, 64), (200, "mid", 7, 64),
    (512, "last", 7, 64), (77, "mid", 5, 64),
])
def test_chunk_attention_matches_plain(gen, T, where, G, D, quant):
    """Continuation chunks of 1..512 tokens starting at 0, mid-tile (a start
    that is no multiple of the 64-key tile) and at S - T, over a cache with
    more rows than the batch and NaN past the chunk's window (in the
    scales for int8); two calls are bit-identical."""
    L, B, Bc, Hk, S = 2, 2, 3, 2, 1024
    start = {"first": 0, "mid": 100, "last": S - T}[where]
    got, again, ref = _chunk_case(gen, quant, L, B, Bc, Hk, G, D, S, T,
                                  start)
    assert torch.equal(got, again)
    # bf16 output; the plain version rounds probabilities to bf16
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("G,D", [(7, 128), (2, 128), (5, 128), (8, 128),
                                 (7, 64)])
@pytest.mark.parametrize("T", [2, 5, 16, 17])
def test_chunk_attention_per_row_starts_match_plain(gen, T, G, D, quant):
    """Per-row starts read on the device (the fixed-batch speculative
    verify): rows at 0, mid-tile, mid-cache and S - T.  The kernel reads a
    cache with NaN past each row's window (NaN scales for int8); the plain
    version reads the same cache without them; two calls are
    bit-identical."""
    L, B, Bc, Hk, S = 2, 4, 5, 2, 512
    starts = torch.tensor([0, 100, 259, S - T], dtype=torch.int32,
                          device="cuda")
    got, again, ref = _chunk_case(gen, quant, L, B, Bc, Hk, G, D, S, T,
                                  starts)
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("pos", [0, 255])
def test_kv_append_uniform_q8_bit_exact(gen, pos):
    L, B, Bc, Hk, D, S = 2, 2, 3, 4, 128, 256
    kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    kn, ksn = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen, device="cuda"))
    vn, vsn = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen, device="cuda"))
    mine = [t.clone() for t in (kc, vc, ks, vs)]
    ref = ka.kv_append_uniform_q8_plain(*[t.clone() for t in (kc, vc, ks, vs)],
                                        kn, vn, ksn, vsn, pos, 1)
    got = ka.kv_append_uniform_q8(*mine, kn, vn, ksn, vsn,
                                  torch.tensor([pos], device="cuda"), 1)
    assert all(g is m for g, m in zip(got, mine))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("lens", [[1, 1], [256, 1], [256, 256]])
def test_decode_attention_q8_matches_plain(gen, lens):
    """Lengths 1 and S, G = 7, B smaller than the cache batch."""
    L, Bc, Hk, G, D, S = 2, 3, 2, 7, 128, 256
    kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, len(lens), 1, G * Hk, D)
    lengths = torch.tensor(lens, device="cuda")
    before = da.decode_attention_contiguous_q8.launches
    got = da.decode_attention_contiguous_q8(q, kc, vc, ks, vs, 1, lengths)
    ref = da.decode_attention_contiguous_q8_plain(q, kc, vc, ks, vs, 1, lengths)
    assert da.decode_attention_contiguous_q8.launches == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


def test_new_wrappers_refuse_wrong_dtype_or_shape(gen):
    kc = _bf16(gen, 1, 1, 2, 256, 128)
    k8, ks = _int8_cache(gen, 1, 1, 2, 256, 128)
    q = _bf16(gen, 1, 4, 4, 128)
    with pytest.raises(TypeError, match="bf16 queries"):
        ca.chunk_attention_contiguous(q.float(), kc, kc, 0, 0)
    with pytest.raises(TypeError, match="int8 cache"):
        ca.chunk_attention_contiguous_q8(q, kc, kc, ks, ks, 0, 0)
    with pytest.raises(ValueError, match="1..512"):
        ca.chunk_attention_contiguous(_bf16(gen, 1, 513, 4, 128),
                                      _bf16(gen, 1, 1, 2, 1024, 128),
                                      _bf16(gen, 1, 1, 2, 1024, 128), 0, 0)
    with pytest.raises(IndexError, match="outside the cache"):
        ca.chunk_attention_contiguous(q, kc, kc, 0, 253)
    with pytest.raises(ValueError, match="f32 scales"):
        da.decode_attention_contiguous_q8(q[:, :1], k8, k8, ks.half(), ks, 0,
                                          torch.ones(1, device="cuda"))
    with pytest.raises(TypeError, match="int8 cache"):
        da.decode_attention_contiguous_q8(q[:, :1], kc, kc, ks, ks, 0,
                                          torch.ones(1, device="cuda"))
    kn, ksn = quantize_kv(torch.randn((1, 1, 2, 128), generator=gen, device="cuda"))
    with pytest.raises(TypeError, match="f32 new scales"):
        ka.kv_append_uniform_q8(k8, k8, ks, ks, kn, kn, ksn.half(), ksn, 0, 0)
    with pytest.raises(ValueError, match="shapes"):
        ka.kv_append_uniform_q8(k8, k8, ks, ks, kn[:, :, :1], kn, ksn, ksn, 0, 0)
    with pytest.raises(IndexError, match="outside the cache"):
        ka.kv_append_uniform_q8(k8, k8, ks, ks, kn, kn, ksn, ksn, 256, 0)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_engine_runs_long_prompts_on_the_card(gen, kv_dtype):
    """Prompts over one 512-token chunk (a continuation chunk per layer) in
    bf16 and INT8 KV, aligned and ragged, through the kernels of the path."""
    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    eng = Engine(cfg, params, max_batch=2, max_seq=1280, kv_dtype=kv_dtype,
                 sampling=SamplingParams(greedy=True))
    chunk = (ca.chunk_attention_contiguous_q8 if kv_dtype == torch.int8
             else ca.chunk_attention_contiguous)
    decode = ([da.decode_attention_contiguous_q8, ka.kv_append_uniform_q8]
              if kv_dtype == torch.int8 else
              [da.decode_attention_contiguous, da.decode_attention_appending])
    wrappers = [fa.flash_attention, chunk, *decode]
    before = [w.launches for w in wrappers]
    def prompt(n, first):
        return [(first + i) % (cfg.vocab_size - 2) + 2 for i in range(n)]

    ragged = eng.generate([prompt(598, 0), prompt(897, 1)], max_new_tokens=6)
    aligned = eng.generate([prompt(698, 0), prompt(698, 1)], max_new_tokens=6)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    for res in (ragged, aligned):
        assert all(0 <= t < cfg.vocab_size for row in res.token_ids for t in row)


# ---------------------------------------------------------------------------
# the paged kernels (continuous-batching serving)
# ---------------------------------------------------------------------------

def _paged_pool(gen, L, P, Hk, page, D, tables, valid):
    """bf16 pools with NaN in every page no table row holds and in every
    row at or past ``valid[b]`` of row b's pages (stale pages and rows)."""
    k, v = _bf16(gen, L, P, Hk, page, D), _bf16(gen, L, P, Hk, page, D)
    unused = torch.ones(P, dtype=torch.bool, device="cuda")
    unused[tables.reshape(-1).long()] = False
    k[:, unused] = float("nan")
    v[:, unused] = float("nan")
    j = torch.arange(tables.shape[1] * page, device="cuda")
    for b, n in enumerate(valid):
        jj = j[n:]
        pg = tables[b].long()[jj // page]
        k[:, pg, :, jj % page] = float("nan")
        v[:, pg, :, jj % page] = float("nan")
    return k, v


def _tables(gen, B, max_pages, P):
    perm = torch.randperm(P - 1, generator=gen, device="cuda")[:B * max_pages]
    return (perm + 1).reshape(B, max_pages).to(torch.int32)


@pytest.mark.parametrize("page", [8, 16, 48, 512])
@pytest.mark.parametrize("G,D", [(7, 128), (8, 64), (1, 128)])
def test_paged_decode_attention_matches_plain(gen, page, G, D):
    """Lengths 1, one page, a page and one, three pages, and an idle row
    (length 0, zeroed table row, as the scheduler's idle slots); 64-key
    tiles cross pages of 8, 16 and 48; NaN past each row's length."""
    L, Hk, max_pages = 2, 2, 4
    lens_list = [1, page, page + 1, 3 * page, 0]
    B = len(lens_list)
    P = B * max_pages + 3
    tables = _tables(gen, B, max_pages, P)
    tables[-1] = 0
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, lens_list)
    q = _bf16(gen, B, 1, G * Hk, D)
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    before = pa.paged_decode_attention_stacked.launches
    got = pa.paged_decode_attention_stacked(q, k, v, tables, lens, page, 1)
    ref = pa.paged_decode_attention_plain(q, k, v, tables, lens, page, 1)
    assert pa.paged_decode_attention_stacked.launches == before + 1
    assert bool(got.isfinite().all())
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("page", [8, 16, 48, 512])
@pytest.mark.parametrize("T,start", [(1, 0), (1, 37), (7, 13), (256, 0),
                                     (256, 700), (512, 512), (512, 300)])
def test_paged_chunk_attention_matches_plain(gen, page, T, start):
    """Pieces of 1..512 tokens at page-aligned and mid-page starts, two rows
    with their own tables, G = 7; NaN in the pages no table holds and past
    the piece's end."""
    L, B, Hk, G, D = 2, 2, 2, 7, 128
    max_pages = -(-(start + T) // page) + 1
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, [start + T] * B)
    q = _bf16(gen, B, T, G * Hk, D)
    before = ca.paged_chunk_attention.launches
    got = ca.paged_chunk_attention(q, k, v, tables, 1, start, page)
    ref = ca.paged_chunk_attention_plain(q, k, v, tables, 1, start, page)
    assert ca.paged_chunk_attention.launches == before + 1
    assert bool(got.isfinite().all())
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("page,start,T", [(8, 27, 16), (16, 60, 7),
                                          (48, 150, 256), (512, 2039, 16)])
def test_paged_chunk_attention_past_the_table_end(gen, page, start, T):
    """A bucket-padded last piece that starts inside the table's last page
    and ends past it (the scheduler's piece after a near-full prefix hit):
    the rows past the table attend the whole table, as in the plain
    version and the TPU kernel."""
    L, B, Hk, G, D = 2, 2, 2, 7, 128
    max_pages = -(-(start + 1) // page)
    assert start + T > max_pages * page
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, [start + T] * B)
    q = _bf16(gen, B, T, G * Hk, D)
    got = ca.paged_chunk_attention(q, k, v, tables, 1, start, page)
    ref = ca.paged_chunk_attention_plain(q, k, v, tables, 1, start, page)
    assert bool(got.isfinite().all())
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("page", [8, 16, 48, 512])
def test_paged_append_ragged_bit_exact(gen, page):
    """Rows at the first row of a page, the last row of a page, the next
    page, a skipped row (-1) and two idle rows whose zeroed tables lead to
    scratch page 0; everything but the scratch row is bit-exact, and the
    scratch row holds the idle rows' value."""
    L, Hk, D, max_pages = 2, 2, 128, 4
    pos_list = [0, page - 1, page, 3 * page + 5, -1, 0, 0]
    B = len(pos_list)
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    tables[-2:] = 0
    k, v = _bf16(gen, L, P, Hk, page, D), _bf16(gen, L, P, Hk, page, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    # the idle rows race on the scratch row: give them one value
    kn[-1], vn[-1] = kn[-2], vn[-2]
    pos = torch.tensor(pos_list, device="cuda", dtype=torch.int32)
    mine, theirs = (k.clone(), v.clone()), (k.clone(), v.clone())
    before = ka.paged_append_ragged.launches
    got = ka.paged_append_ragged(*mine, kn, vn, pos, tables, 1, page_size=page)
    ka.paged_append_ragged_plain(*theirs, kn, vn, pos, tables, 1, page)
    assert ka.paged_append_ragged.launches == before + 1
    assert got[0] is mine[0] and got[1] is mine[1]
    for g, r in zip(mine, theirs):
        assert torch.equal(g[:, 1:], r[:, 1:])
        assert torch.equal(g[0], r[0])           # other layers untouched
    changed = (mine[0] != k).any(dim=-1)
    assert int(changed[:, 1:].sum()) == 4 * Hk  # the four real rows
    assert torch.equal(mine[0][1, 0, :, 0], kn[-1, 0])


@pytest.mark.parametrize("page", [8, 16, 48, 512])
@pytest.mark.parametrize("T,start", [(1, 0), (7, 13), (256, 384), (512, 0),
                                     (512, 250)])
def test_paged_append_prefill_bit_exact(gen, page, T, start):
    """A piece of T rows at ``start`` through one table row, crossing pages;
    the table's last entry is 0, so bucket padding past the allocated pages
    lands on scratch page 0 (compared too: each scratch row is written
    once)."""
    L, Hk, D = 2, 2, 128
    max_pages = -(-(start + T) // page)
    P = max_pages + 4
    tables = _tables(gen, 1, max_pages, P)
    if max_pages > 1:
        tables[0, -1] = 0
    k, v = _bf16(gen, L, P, Hk, page, D), _bf16(gen, L, P, Hk, page, D)
    kn, vn = _bf16(gen, 1, T, Hk, D), _bf16(gen, 1, T, Hk, D)
    mine, theirs = (k.clone(), v.clone()), (k.clone(), v.clone())
    before = ka.paged_append_prefill.launches
    got = ka.paged_append_prefill(*mine, kn, vn, start, tables, 1,
                                  page_size=page)
    ka.paged_append_prefill_plain(*theirs, kn, vn, start, tables, 1, page)
    assert ka.paged_append_prefill.launches == before + 1
    assert got[0] is mine[0] and got[1] is mine[1]
    for g, r in zip(mine, theirs):
        assert torch.equal(g, r)
    assert int((mine[0] != k).any(dim=-1).sum()) == T * Hk


def _q8_pool(k, v):
    """The int8 pool of a bf16 pool: NaN rows get NaN scales."""
    out = []
    for x in (k, v):
        q, sc = quantize_kv(x.nan_to_num())
        sc[x.isnan().any(-1)] = float("nan")
        out += [q, sc]
    return out[0], out[2], out[1], out[3]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("page", [8, 512])
@pytest.mark.parametrize("T", [1, 2, 16, 17])
def test_paged_q8_and_verify_attention_match_plain(gen, T, page, quant):
    """_paged_bhgd_q8 (decode and verify) and the verify shape of
    _paged_bhgd: a window at the sequence start, one straddling pages 0 and
    1, one starting page 2, long rows, and for the decode an idle row
    (length 0, zeroed table: zeros out); G = 7; NaN (NaN scales) in the
    pages no table holds and past each row's length.  T = 17 is a window
    wider than 16 rows (and than a page of 8)."""
    L, Hk, G, D = 2, 2, 7, 128
    lens_list = [T, page + T // 2 + 1, 2 * page + T, 3 * page, 4 * page]
    max_pages = max(4, -(-max(lens_list) // page))
    if T == 1:
        lens_list.append(0)
    B = len(lens_list)
    P = B * max_pages + 3
    tables = _tables(gen, B, max_pages, P)
    if T == 1:
        tables[-1] = 0
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, lens_list)
    pools, scales = (k, v), ()
    if quant:
        k8, v8, ks, vs = _q8_pool(k, v)
        pools, scales = (k8, v8), (ks, vs)
    q = _bf16(gen, B, T, G * Hk, D)
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    name = ("paged_decode_attention_stacked" if T == 1
            else "paged_verify_attention_stacked") + ("_q8" if quant else "")
    fn = getattr(pa, name)
    plain = (pa.paged_decode_attention_q8_plain if quant
             else pa.paged_decode_attention_plain)
    args = (q, *pools, *scales, tables, lens, page, 1)
    before = fn.launches
    got = fn(*args)
    ref = plain(*args)
    assert fn.launches == before + 1
    assert bool(got.isfinite().all())
    if T == 1:
        assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("page", [8, 512])
@pytest.mark.parametrize("T,start", [(1, 0), (7, 13), (256, 700), (512, 300)])
def test_paged_chunk_attention_q8_matches_plain(gen, page, T, start):
    """Pieces over the int8 pool at page-aligned and mid-page starts, two
    rows with their own tables, G = 7; NaN scales past the piece's end."""
    L, B, Hk, G, D = 2, 2, 2, 7, 128
    max_pages = -(-(start + T) // page) + 1
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, [start + T] * B)
    k8, v8, ks, vs = _q8_pool(k, v)
    q = _bf16(gen, B, T, G * Hk, D)
    args = (q, k8, v8, ks, vs, tables, 1, start, page)
    before = ca.paged_chunk_attention_q8.launches
    got = ca.paged_chunk_attention_q8(*args)
    ref = ca.paged_chunk_attention_q8_plain(*args)
    assert ca.paged_chunk_attention_q8.launches == before + 1
    assert bool(got.isfinite().all())
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


def _append_state(gen, L, P, Hk, page, D, quant):
    k, v = _bf16(gen, L, P, Hk, page, D), _bf16(gen, L, P, Hk, page, D)
    return list(_q8_pool(k, v)) if quant else [k, v]


def _new_rows(gen, shape, quant):
    """(k, v) rows, and for int8 their scales as keywords."""
    kn, vn = _bf16(gen, *shape), _bf16(gen, *shape)
    if not quant:
        return kn, vn, {}
    (kq, ks), (vq, vs) = quantize_kv(kn), quantize_kv(vn)
    return kq, vq, dict(ks_new=ks, vs_new=vs)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("page,T", [(8, 2), (8, 8), (8, 9), (8, 17),
                                    (512, 2), (512, 16)])
def test_paged_append_ragged_t_bit_exact(gen, page, T, quant):
    """T rows per batch row from a per-row start: at position 0, straddling
    pages 0 and 1 (page - 1), at row 0 of page 1, deep in page 3, and a
    skipped row (-1); bytes and scales bit-exact, nothing else written.
    T = 9 and 17 are windows wider than their page of 8 (two and three
    pages)."""
    L, Hk, D = 2, 2, 128
    max_pages = max(4, -(-(3 * page + T) // page))
    starts_list = [0, page - 1, page, 3 * page, -1]
    B = len(starts_list)
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    base = _append_state(gen, L, P, Hk, page, D, quant)
    kn, vn, extra = _new_rows(gen, (B, T, Hk, D), quant)
    starts = torch.tensor(starts_list, device="cuda", dtype=torch.int32)
    mine, theirs = [t.clone() for t in base], [t.clone() for t in base]

    def kw(st):
        return dict(extra, k_scale=st[2], v_scale=st[3]) if quant else {}

    before = ka.paged_append_ragged_t.launches
    got = ka.paged_append_ragged_t(mine[0], mine[1], kn, vn, starts, tables,
                                   1, page_size=page, **kw(mine))
    ka.paged_append_ragged_t_plain(theirs[0], theirs[1], kn, vn, starts,
                                   tables, 1, page, **kw(theirs))
    assert ka.paged_append_ragged_t.launches == before + 1
    assert got[0] is mine[0] and got[1] is mine[1]
    for g, r in zip(mine, theirs):
        assert torch.equal(g.nan_to_num(), r.nan_to_num())
    assert int((mine[0] != base[0]).any(dim=-1).sum()) == (B - 1) * T * Hk


@pytest.mark.parametrize("page", [8, 512])
def test_int8_paged_appends_write_their_scales(gen, page):
    """The int8 instantiations of the ragged decode append and the prefill
    append: bytes and scales bit-exact against the plain writes."""
    L, Hk, D, max_pages = 2, 2, 128, 4
    pos = torch.tensor([0, page - 1, page, 3 * page + 2], device="cuda",
                       dtype=torch.int32)
    B = pos.numel()
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    for name, n in (("paged_append_ragged", 1),
                    ("paged_append_prefill", min(3 * page, 300))):
        base = _append_state(gen, L, P, Hk, page, D, True)
        rows = (B, 1) if n == 1 else (1, n)
        kn, vn, extra = _new_rows(gen, (*rows, Hk, D), True)
        at, tab = (pos, tables) if n == 1 else (page // 2, tables[:1])
        mine, theirs = [t.clone() for t in base], [t.clone() for t in base]
        getattr(ka, name)(mine[0], mine[1], kn, vn, at, tab, 1,
                          page_size=page, k_scale=mine[2], v_scale=mine[3],
                          **extra)
        getattr(ka, name + "_plain")(theirs[0], theirs[1], kn, vn, at, tab,
                                     1, page, k_scale=theirs[2],
                                     v_scale=theirs[3], **extra)
        for g, r in zip(mine, theirs):
            assert torch.equal(g.nan_to_num(), r.nan_to_num())
        assert int((mine[2] != base[2]).sum()) > 0


def test_new_paged_wrappers_refuse_on_the_card(gen):
    """T < 2 for the verify, G > 8, a bf16 pool given to a q8 wrapper, new
    rows of the wrong head count."""
    pool = _bf16(gen, 1, 4, 2, 16, 128)
    p8 = torch.zeros((1, 4, 2, 16, 128), dtype=torch.int8, device="cuda")
    sc = torch.ones((1, 4, 2, 16), device="cuda")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    lens = torch.full((1,), 20, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="T >= 2"):
        pa.paged_verify_attention_stacked(_bf16(gen, 1, 1, 4, 128), pool,
                                          pool, tables, lens, 16, 0)
    with pytest.raises(ValueError, match="G <= 8"):
        pa.paged_verify_attention_stacked_q8(_bf16(gen, 1, 5, 18, 128), p8,
                                             p8, sc, sc, tables, lens, 16, 0)
    with pytest.raises(TypeError, match="f32 scales"):
        pa.paged_decode_attention_stacked_q8(_bf16(gen, 1, 1, 4, 128), pool,
                                             pool, sc, sc, tables, lens, 16, 0)
    with pytest.raises(ValueError, match="new rows"):
        ka.paged_append_ragged_t(pool, pool, _bf16(gen, 1, 17, 3, 128),
                                 _bf16(gen, 1, 17, 3, 128), lens, tables, 0,
                                 page_size=16)


def test_paged_wrappers_refuse_on_the_card(gen):
    pool = _bf16(gen, 1, 4, 2, 16, 128)
    tables = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        pa.paged_decode_attention_stacked(
            _bf16(gen, 1, 1, 4, 128).float(), pool, pool, tables,
            torch.ones(1, device="cuda"), 16, 0)
    with pytest.raises(IndexError, match="outside the"):
        ca.paged_chunk_attention(_bf16(gen, 1, 8, 4, 128), pool, pool, tables,
                                 0, 32, 16)
    with pytest.raises(TypeError, match="bf16"):
        ka.paged_append_prefill(pool.float(), pool.float(),
                                _bf16(gen, 1, 8, 2, 128),
                                _bf16(gen, 1, 8, 2, 128), 0, tables, 0,
                                page_size=16)


def test_serving_engine_runs_on_the_card_through_the_paged_kernels(gen):
    """ContinuousBatchingEngine on a tiny W4A8 model on the card: more
    requests than slots, prompts of several pieces and pages, a prefix hit
    with a partial page; the four paged kernels, flash and the matmul
    launch, and no contiguous-cache kernel does."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )

    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    cb = ContinuousBatchingEngine(cfg, params, max_slots=2, page_size=16,
                                  num_pages=48, max_pages_per_seq=8,
                                  prefill_chunk=32,
                                  sampling=SamplingParams(greedy=True))
    cb._eos = set()
    used = [qm.quant_matmul4_a8, fa.flash_attention,
            pa.paged_decode_attention_stacked, ca.paged_chunk_attention,
            ka.paged_append_ragged, ka.paged_append_prefill]
    unused = [da.decode_attention_contiguous, da.decode_attention_appending,
              ca.chunk_attention_contiguous, ca.chunk_attention_contiguous_q8,
              ka.kv_append_uniform_q8, da.decode_attention_contiguous_q8]
    before = [w.launches for w in used + unused]
    first = [[(7 * i + j) % 500 + 2 for j in range(n)]
             for i, n in enumerate((5, 40, 77, 100))]
    # the second wave shares 4 pages and 6 rows of a fifth with prompt 3
    second = [first[3][:70] + [3, 4, 5]]
    done = []
    for rid0, wave in ((0, first), (len(first), second)):
        for i, p in enumerate(wave):
            cb.submit(Request(request_id=rid0 + i, prompt=p, max_new_tokens=6))
        done += cb.run_to_completion()
    cb.check_page_invariants()
    assert sorted(f.request_id for f in done) == list(range(5))
    assert all(f.finish_reason == "length" and len(f.token_ids) == 6
               for f in done)
    assert cb.metrics.snapshot()["prefix_hit_tokens"] > 0
    after = [w.launches for w in used + unused]
    n = len(used)
    assert all(a > b for a, b in zip(after[:n], before[:n]))
    assert after[n:] == before[n:]


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_speculative_serving_on_the_card(gen, kv_dtype):
    """Prompt lookup (echo prompts, through step_batch) and a draft model
    equal to the target over a bf16 and an INT8 pool on a tiny W4A8 model:
    every request finishes by length, the verify kernel of the pool's type
    and the windowed append launch, and the drafter nearly always agrees."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )

    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    verify = (pa.paged_verify_attention_stacked_q8 if kv_dtype == torch.int8
              else pa.paged_verify_attention_stacked)
    for draft in (False, True):
        extra = dict(draft_params=params, draft_cfg=cfg) if draft else {}
        cb = ContinuousBatchingEngine(
            cfg, params, max_slots=2, page_size=16, num_pages=64,
            max_pages_per_seq=8, prefill_chunk=32, kv_dtype=kv_dtype,
            sampling=SamplingParams(greedy=True), speculative=True,
            spec_k=4, **extra)
        cb._eos = set()
        before = (verify.launches, ka.paged_append_ragged_t.launches)
        passage = [(11 * j) % 300 + 5 for j in range(30)]
        for i in range(3):
            cb.submit(Request(request_id=i, prompt=passage[i:] + passage[:15],
                              max_new_tokens=12))
        done = cb.run_to_completion()
        cb.check_page_invariants()
        assert sorted(f.request_id for f in done) == [0, 1, 2]
        assert all(f.finish_reason == "length" and len(f.token_ids) == 12
                   for f in done)
        assert verify.launches > before[0]
        assert ka.paged_append_ragged_t.launches > before[1]
        if draft:
            assert cb.metrics.snapshot()["spec_tokens_per_forward"] > 3.0


def test_serving_engine_on_the_card_resends_a_near_max_seq_prompt(gen):
    """A 60-token prompt on a 4-page table of 16 (64 tokens), sent twice
    with the prefix cache on: the second request's last piece starts at 59
    and, padded to 16 tokens, runs past the table.  Both finish with their
    tokens, and the engine serves on."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )

    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    cb = ContinuousBatchingEngine(cfg, params, max_slots=1, page_size=16,
                                  num_pages=12, max_pages_per_seq=4,
                                  prefill_chunk=32,
                                  sampling=SamplingParams(greedy=True))
    cb._eos = set()
    prompt = [(11 * j) % 500 + 2 for j in range(60)]
    done = []
    for rid in range(3):
        cb.submit(Request(request_id=rid, prompt=prompt, max_new_tokens=4))
        done += cb.run_to_completion()
        cb.check_page_invariants()
    assert [f.request_id for f in done] == [0, 1, 2]
    assert all(f.finish_reason == "length" and len(f.token_ids) == 4
               for f in done)
    assert cb.metrics.snapshot()["prefix_hit_tokens"] == 2 * 59


def test_checkpoints_load_on_the_card(gen, tmp_path):
    """load_checkpoint and load_quantized put every tensor on the card by
    default, bit for bit; the checkpoint is written by chip_smoke.py's
    writer (this machine may have no safetensors or transformers)."""
    import os
    import sys

    from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
        load_quantized,
        save_quantized,
    )
    from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
        load_checkpoint,
    )

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from chip_smoke import hf_state_dict, write_hf_checkpoint

    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    sd = hf_state_dict(cfg, params)
    write_hf_checkpoint(str(tmp_path / "hf"), cfg.to_hf_config(), sd, shards=3)
    lcfg, loaded = load_checkpoint(str(tmp_path / "hf"))
    got = hf_state_dict(lcfg, loaded)
    assert set(got) == set(sd)
    assert all(got[n].is_cuda and torch.equal(got[n], t) for n, t in sd.items())
    qp = quantize_params(loaded, QuantConfig(bits=8, group_size=128,
                                             quantize_lm_head=True))
    save_quantized(str(tmp_path / "q"), lcfg, qp)
    qcfg, back = load_quantized(str(tmp_path / "q"))
    for name in ("q", "down"):
        assert back["layers"][name].q.is_cuda
        assert torch.equal(back["layers"][name].q, qp["layers"][name].q)
        assert torch.equal(back["layers"][name].scales,
                           qp["layers"][name].scales)
    assert torch.equal(back["lm_head"].q, qp["lm_head"].q)
    eng = Engine(qcfg, back, max_batch=2, max_seq=128,
                 sampling=SamplingParams(greedy=True))
    before = qm.quant_matmul8.launches
    res = eng.generate([[5, 9, 17], [7]], max_new_tokens=4)
    assert qm.quant_matmul8.launches - before == res.steps * (7 * 2 + 1)


# ---------------------------------------------------------------------------
# the double-pumped decode's kernels
# ---------------------------------------------------------------------------

# K, F of a tiny model and of Qwen2.5-7B
MLP_SHAPES = {"tiny": (512, 512), "7b": (3584, 18944)}


def _mlp_weights(gen, L, K, F, gs_gate, gs_down):
    def q(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def s(*shape):
        return torch.rand(shape, generator=gen, device="cuda") * 0.01 + 0.005

    return (q(L, K // 2, F), s(L, K // gs_gate, F), q(L, K // 2, F),
            s(L, K // gs_gate, F), q(L, F // 2, K), s(L, F // gs_down, K))


@pytest.mark.parametrize("gs_gate,gs_down", [(128, 128), (256, 128)])
@pytest.mark.parametrize("M", [1, 4, 8, 40, 192, 256])
@pytest.mark.parametrize("shape", sorted(MLP_SHAPES))
def test_fused_mlp_matches_plain(gen, shape, M, gs_gate, gs_down):
    K, F = MLP_SHAPES[shape]
    w = _mlp_weights(gen, 2, K, F, gs_gate, gs_down)
    x = _bf16(gen, M, K)
    kw = dict(gs_gate=gs_gate, gs_down=gs_down)
    before = fs.fused_mlp.launches
    got = fs.fused_mlp(x, *w, 1, **kw)
    again = fs.fused_mlp(x, *w, 1, **kw)
    ref = fs.fused_mlp_plain(x, *w, 1, **kw)
    assert fs.fused_mlp.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    # no atomics: two calls are bit-identical
    assert torch.equal(got, again)
    # both round h to bf16 and the output; the tensor cores' f32 sums of g
    # and u differ from the plain version's in order, which can move an h
    # across a bf16 boundary: 2^-6 of the largest output, the matmuls' rule
    tol = 2 ** -6 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("gs_gate,gs_down", [(128, 128), (256, 128)])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 40, 64, 65, 192, 256])
@pytest.mark.parametrize("shape", sorted(MLP_SHAPES))
def test_fused_mlp_split_and_tensor_core_paths(gen, shape, M, gs_gate,
                                               gs_down):
    """Both passes on the tensor-core body at every tile and split: the
    decode stream's one and four m16 tiles a warp (M 1..16, 17..64) with K
    split in both passes, the 64-row tiles over several row tiles above
    (the down pass split into slices of whole pairs); within 2^-6 of the
    largest output of the plain version (test_fused_mlp_matches_plain's
    rule), two calls bit for bit."""
    K, F = MLP_SHAPES[shape]
    (mt1, s1, _), (mt2, s2, _) = fs.plan_fused_mlp(M, K, F, gs_gate, gs_down)
    assert mt1 == mt2 == (1 if M <= 16 else 4)
    # the tiny MLP's 256 packed rows are one slice
    assert (s1 > 1) == (M <= 64 and shape == "7b")
    assert (s2 > 1) == (shape == "7b")
    w = _mlp_weights(gen, 2, K, F, gs_gate, gs_down)
    x = _bf16(gen, M, K)
    kw = dict(gs_gate=gs_gate, gs_down=gs_down)
    before = fs.fused_mlp.launches
    got = fs.fused_mlp(x, *w, 1, **kw)
    again = fs.fused_mlp(x, *w, 1, **kw)
    ref = fs.fused_mlp_plain(x, *w, 1, **kw)
    assert fs.fused_mlp.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (M, K)
    assert torch.equal(got, again)
    tol = 2 ** -6 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


def _nan_past(cache, rows, lens):
    """A copy of ``cache`` with NaN at every key position at or past
    ``lens[b]`` of row ``rows[b]`` (every layer) and in every row outside
    ``rows``."""
    bad = cache.clone()
    keep = torch.zeros(bad.shape[1], dtype=torch.bool, device="cuda")
    keep[rows] = True
    bad[:, ~keep] = float("nan")
    for r, n in zip(rows, lens):
        bad[:, r, :, n:] = float("nan")
    return bad


# Ba (= Mb), Hk, G, S, cache rows
ATTN_MLP_SHAPES = {"tiny": (4, 2, 8, 256, 8), "7b": (96, 4, 7, 512, 192)}


@pytest.mark.parametrize("second_half", [False, True], ids=["row0 0",
                                                             "row0 Ba"])
@pytest.mark.parametrize("shape", sorted(ATTN_MLP_SHAPES))
def test_fused_attn_mlp_matches_plain(gen, shape, second_half):
    Ba, Hk, G, S, Bc = ATTN_MLP_SHAPES[shape]
    K, F = MLP_SHAPES[shape]
    D, L, layer_a, layer_m = 128, 2, 1, 0
    row0 = Ba if second_half else 0
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    lens_list = torch.randint(1, S + 1, (Ba,), generator=gen,
                              device="cuda").tolist()
    lens_list[0], lens_list[-1] = 1, S
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    rows = list(range(row0, row0 + Ba))
    kbad, vbad = _nan_past(kc, rows, lens_list), _nan_past(vc, rows,
                                                           lens_list)
    q = _bf16(gen, Ba, 1, Hk * G, D)
    x = _bf16(gen, Ba, K)
    w = _mlp_weights(gen, L, K, F, 128, 128)
    kw = dict(gs_gate=128, gs_down=128, row0=row0)
    before = fs.fused_attn_mlp.launches
    attn, y = fs.fused_attn_mlp(lens, layer_a, layer_m, q, kbad, vbad, x,
                                *w, **kw)
    attn2, y2 = fs.fused_attn_mlp(lens, layer_a, layer_m, q, kbad, vbad, x,
                                  *w, **kw)
    ref_attn, ref_y = fs.fused_attn_mlp_plain(lens, layer_a, layer_m, q, kc,
                                              vc, x, *w, **kw)
    assert fs.fused_attn_mlp.launches == before + 2
    assert torch.equal(attn, attn2) and torch.equal(y, y2)
    assert attn.shape == (Ba, 1, Hk * G, D) and bool(attn.isfinite().all())
    # the decode kernels' rule: bf16 output, the plain version rounds the
    # probabilities to bf16
    assert (attn.float() - ref_attn.float()).abs().max().item() <= 2e-2
    tol = 2 ** -6 * ref_y.float().abs().max().item()
    assert (y.float() - ref_y.float()).abs().max().item() <= tol


# Bn, Hk, cache rows
APPEND_SHAPES = {"tiny": (3, 2, 6), "7b": (96, 4, 192)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", [0, 255])
@pytest.mark.parametrize("second_half", [False, True], ids=["row0 0",
                                                             "row0 Bn"])
@pytest.mark.parametrize("shape", sorted(APPEND_SHAPES))
def test_kv_append_uniform_bit_exact(gen, shape, second_half, pos, dtype):
    Bn, Hk, Bc = APPEND_SHAPES[shape]
    L, S, D, layer = 2, 256, 128, 1
    row0 = Bn if second_half else 0
    kc = torch.randn((L, Bc, Hk, S, D), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((L, Bc, Hk, S, D), generator=gen, device="cuda").to(dtype)
    kn, vn = _bf16(gen, Bn, 1, Hk, D), _bf16(gen, Bn, 1, Hk, D)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = ka.kv_append_uniform.launches
    gk, gv = ka.kv_append_uniform(k1, v1, kn, vn, pos, layer, row0=row0)
    rk, rv = ka.kv_append_uniform_plain(k2, v2, kn, vn, pos, layer, row0)
    assert ka.kv_append_uniform.launches == before + 1
    assert gk is k1 and gv is v1
    assert torch.equal(gk, rk) and torch.equal(gv, rv)
    changed = ((gk != kc).any(-1) | (gv != vc).any(-1)).nonzero().tolist()
    assert all(l == layer and row0 <= b < row0 + Bn and p == pos
               for l, b, _, p in changed)
    # the position as a tensor on the card (read on the device)
    k3, v3 = kc.clone(), vc.clone()
    ka.kv_append_uniform(k3, v3, kn, vn,
                         torch.tensor([pos], device="cuda"), layer, row0=row0)
    assert torch.equal(k3, rk) and torch.equal(v3, rv)


PUMP = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=3, num_heads=2, num_kv_heads=1, head_dim=128)


def test_decode_step_pumped_matches_decode_step_on_the_card(gen):
    """Three pumped decode steps of a tiny pad-free INT4 model (bf16) beside
    three decode_step(uniform_decode=True) steps from the same cache: each
    pumped step launches fused_attn_mlp and kv_append_uniform twice a
    layer and quant_matmul4 8 times a layer + 3 (the drain), and no
    decode attention or fused_mlp; the logits agree to bf16 noise."""
    cfg = tiny_config(**PUMP)
    params = qwen.init_quantized_params(cfg, gen, bits=4, group_size=64,
                                        pad_free=True, device="cuda")
    B, T, L = 4, 8, cfg.num_layers
    cache = KVCache.create(L, B, 256, 1, 128, device="cuda")
    prompts = torch.randint(2, 512, (B, T), generator=gen, device="cuda")
    lens = torch.full((B,), T, device="cuda")
    logits, cache = qwen.prefill(params, cfg, prompts, lens, cache)
    other = KVCache(k=cache.k.clone(), v=cache.v.clone())
    assert qwen.pumped_supported(cfg, params, cache, 192)
    tok = logits.argmax(-1)
    wrappers = {"fused_attn_mlp": fs.fused_attn_mlp,
                "kv_append_uniform": ka.kv_append_uniform,
                "quant_matmul4": qm.quant_matmul4, "fused_mlp": fs.fused_mlp,
                "decode_attention_appending": da.decode_attention_appending}
    for s in range(3):
        pos = lens + s
        for w in wrappers.values():
            w.launches = 0
        got, cache = qwen.decode_step_pumped(params, cfg, tok, pos, cache)
        assert {n: w.launches for n, w in wrappers.items()} == {
            "fused_attn_mlp": 2 * L, "kv_append_uniform": 2 * L,
            "quant_matmul4": 8 * L + 3, "fused_mlp": 0,
            "decode_attention_appending": 0}
        ref, other = qwen.decode_step(params, cfg, tok, pos, other,
                                      uniform_decode=True)
        assert bool(got.isfinite().all())
        # bf16 paths that round at different places (the drain's three
        # matmuls, the wmma tile's bf16 weights at the halves' MLP):
        # within 2^-4 of the largest logit
        tol = 2 ** -4 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol
        tok = ref.argmax(-1)
    # layer 0's fresh rows depend on the embeddings only
    written = slice(T, T + 3)
    assert torch.equal(cache.k[0, :, :, written], other.k[0, :, :, written])
    assert torch.equal(cache.v[0, :, :, written], other.v[0, :, :, written])


def test_fused_wrappers_refuse_on_the_card(gen):
    w = _mlp_weights(gen, 2, 512, 512, 128, 128)
    x = _bf16(gen, 4, 512)
    with pytest.raises(ValueError, match="M <= 256"):
        fs.fused_mlp(_bf16(gen, 257, 512), *w, 0, gs_gate=128, gs_down=128)
    with pytest.raises(ValueError, match="gs % 32"):
        fs.fused_mlp(x, *_mlp_weights(gen, 2, 512, 512, 16, 128), 0,
                     gs_gate=16, gs_down=128)
    with pytest.raises(ValueError, match="one device"):
        fs.fused_mlp(x, w[0].cpu(), *w[1:], 0, gs_gate=128, gs_down=128)
    kc = torch.zeros((2, 8, 2, 256, 128), device="cuda")
    q = _bf16(gen, 4, 1, 8, 128)
    lens = torch.ones(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="bf16 caches"):
        fs.fused_attn_mlp(lens, 0, 0, q, kc, kc, x, *w, gs_gate=128,
                          gs_down=128)
    with pytest.raises(ValueError, match="rows inside"):
        fs.fused_attn_mlp(lens, 0, 0, q, kc.bfloat16(), kc.bfloat16(), x, *w,
                          gs_gate=128, gs_down=128, row0=5)
    k8 = torch.zeros((2, 8, 2, 256, 128), dtype=torch.int8, device="cuda")
    new = _bf16(gen, 4, 1, 2, 128)
    with pytest.raises(TypeError, match="bf16 or f32"):
        ka.kv_append_uniform(k8, k8, new, new, 3, 0)
    with pytest.raises(IndexError, match="outside the cache"):
        ka.kv_append_uniform(kc, kc, new, new, 256, 0)


# ---------------------------------------------------------------------------
# the last four sites: the ragged window append, the fresh-merge decode
# attention, the all-layer append, the fused attention + matmul
# ---------------------------------------------------------------------------

def _kv_cache(gen, shape, dtype):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("T", [1, 5, 17])
@pytest.mark.parametrize("D", [64, 128])
def test_kv_append_ragged_t_bit_exact(gen, dtype, T, D):
    """Rows 0..7 of a 9-row cache at starts -1 (skipped), 0, the band edges
    7, 8, 31 and 32, S - T and S - 2 (a window past the cache's end: the
    tokens at S and beyond are dropped); the starts on the card."""
    L, Bc, Hk, S, layer = 2, 9, 2, 256, 1
    starts_l = [-1, 0, 7, 8, 31, 32, S - T, S - 2]
    B = len(starts_l)
    kc, vc = _kv_cache(gen, (L, Bc, Hk, S, D), dtype), _kv_cache(
        gen, (L, Bc, Hk, S, D), dtype)
    kw = kw2 = {}
    if dtype == torch.int8:
        (kn, ksn), (vn, vsn) = (quantize_kv(torch.randn(
            (B, T, Hk, D), generator=gen, device="cuda")) for _ in range(2))
        ks = torch.rand((L, Bc, Hk, S), generator=gen, device="cuda")
        vs = torch.rand((L, Bc, Hk, S), generator=gen, device="cuda")
        kw = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                  vs_new=vsn)
        kw2 = dict(k_scale=ks.clone(), v_scale=vs.clone(), ks_new=ksn,
                   vs_new=vsn)
    else:
        kn, vn = _bf16(gen, B, T, Hk, D), _bf16(gen, B, T, Hk, D)
    starts = torch.tensor(starts_l, device="cuda", dtype=torch.int32)
    mine = [kc.clone(), vc.clone()]
    theirs = [kc.clone(), vc.clone()]
    before = ka.kv_append_ragged_t.launches
    got = ka.kv_append_ragged_t(*mine, kn, vn, starts, layer, **kw)
    ref = ka.kv_append_ragged_t_plain(*theirs, kn, vn, starts, layer, **kw2)
    assert ka.kv_append_ragged_t.launches == before + 1
    assert got[0] is mine[0] and got[1] is mine[1]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if dtype == torch.int8:
        assert torch.equal(kw["k_scale"], kw2["k_scale"])
        assert torch.equal(kw["v_scale"], kw2["v_scale"])
    # nothing outside the windows (and nothing of row 8) changed
    written = torch.zeros((L, Bc, Hk, S), dtype=torch.bool, device="cuda")
    for b, p in enumerate(starts_l):
        if p >= 0:
            written[layer, b, :, p:min(p + T, S)] = True
    assert not bool(((mine[0] != kc).any(-1) & ~written).any())


def _nan_from(cache, lens):
    """A copy with NaN at every key position at or past lens[b] of row b
    (every layer)."""
    bad = cache.clone()
    for b, n in enumerate(lens):
        bad[:, b, :, n:] = float("nan")
    return bad


@pytest.mark.parametrize("B,Bc,Hk,G,D,S,lens", [
    (3, 3, 2, 7, 128, 256, [0, 100, 255]),
    (2, 4, 1, 5, 64, 512, [511, 7]),
    (4, 4, 4, 8, 128, 256, [256, 64, 63, 1]),
    (4, 4, 4, 7, 128, 1024, [0, 1023, 300, 999]),
])
def test_fresh_decode_attention_matches_plain(gen, B, Bc, Hk, G, D, S, lens):
    """Per-row old lengths (0, S - 1 and S among them) with NaN at and past
    each one in the kernel's cache: the kernel never reads the position
    the deferred append has not written.  Within 2e-2 of the plain version
    (bf16 output; the plain version rounds the probabilities to bf16)."""
    L, layer = 2, 1
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    old = torch.tensor(lens, device="cuda", dtype=torch.int32)
    kbad, vbad = _nan_from(kc, lens), _nan_from(vc, lens)
    before = da.decode_attention_contiguous_fresh.launches
    got = da.decode_attention_contiguous_fresh(q, kbad, vbad, kn, vn, layer,
                                               old)
    ref = da.decode_attention_contiguous_fresh_plain(q, kc, vc, kn, vn, layer,
                                                     old)
    assert da.decode_attention_contiguous_fresh.launches == before + 1
    assert got.shape == (B, 1, G * Hk, D) and bool(got.isfinite().all())
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    # the caches are only read
    assert torch.equal(kbad.isnan(), _nan_from(kc, lens).isnan())


@pytest.mark.parametrize("pos", [0, 100, 255])
def test_fresh_decode_attention_equals_the_appending_kernel(gen, pos):
    """At one shared position the fresh merge is the appending kernel's
    call of the same core, less the cache write: bit-identical outputs."""
    L, B, Hk, G, D, S = 2, 3, 2, 7, 128, 256
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    fresh = da.decode_attention_contiguous_fresh(
        q, kc, vc, kn, vn, 1, torch.full((B,), pos, device="cuda"))
    appended, _, _ = da.decode_attention_appending(q, kc.clone(), vc.clone(),
                                                   kn, vn, 1, pos)
    assert torch.equal(fresh, appended)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", [0, 37, 255])
@pytest.mark.parametrize("L,B,Bc", [(3, 2, 2), (28, 5, 8)])
def test_kv_append_all_uniform_bit_exact(gen, L, B, Bc, pos, dtype):
    Hk, S, D = 4, 256, 128
    kc, vc = _kv_cache(gen, (L, Bc, Hk, S, D), dtype), _kv_cache(
        gen, (L, Bc, Hk, S, D), dtype)
    kn, vn = _bf16(gen, L, B, 1, Hk, D), _bf16(gen, L, B, 1, Hk, D)
    mine, theirs = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
    before = ka.kv_append_all_uniform.launches
    got = ka.kv_append_all_uniform(*mine, kn, vn,
                                   torch.tensor([pos], device="cuda"))
    ref = ka.kv_append_all_uniform_plain(*theirs, kn, vn, pos)
    assert ka.kv_append_all_uniform.launches == before + 1
    assert got[0] is mine[0] and all(torch.equal(a, b)
                                     for a, b in zip(got, ref))
    changed = ((mine[0] != kc).any(-1) | (mine[1] != vc).any(-1)).nonzero()
    assert bool((changed[:, 3] == pos).all()) and bool((changed[:, 1] < B).all())
    # [L, B, Hk, D] rows and a host int position write the same
    again = [kc.clone(), vc.clone()]
    ka.kv_append_all_uniform(*again, kn[:, :, 0], vn[:, :, 0], pos)
    assert torch.equal(again[0], mine[0]) and torch.equal(again[1], mine[1])


# Ba, Bc, Hk, G, S, Mb, K, N, gs
ATTN_MM_SHAPES = {"tiny": (4, 8, 2, 8, 256, 8, 256, 512, 64),
                  "odd": (3, 5, 1, 5, 512, 70, 512, 192, 128),
                  "probe": (56, 112, 4, 7, 1024, 56, 3584, 18944, 256)}


@pytest.mark.parametrize("second", [False, True], ids=["row0 0", "row0 Ba"])
@pytest.mark.parametrize("shape", sorted(ATTN_MM_SHAPES))
def test_fused_attn_matmul_matches_plain(gen, shape, second):
    Ba, Bc, Hk, G, S, Mb, K, N, gs = ATTN_MM_SHAPES[shape]
    L, D, layer = 2, 128, 1
    row0 = Bc - Ba if second else 0
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    lens_l = torch.randint(1, S + 1, (Ba,), generator=gen,
                           device="cuda").tolist()
    lens_l[0], lens_l[-1] = 1, S
    lens = torch.tensor(lens_l, device="cuda", dtype=torch.int32)
    rows = list(range(row0, row0 + Ba))
    kbad, vbad = _nan_past(kc, rows, lens_l), _nan_past(vc, rows, lens_l)
    q, x = _bf16(gen, Ba, 1, Hk * G, D), _bf16(gen, Mb, K)
    wq = torch.randint(-128, 128, (L, K // 2, N), generator=gen,
                       device="cuda", dtype=torch.int8)
    ws = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01
    before = fs.fused_attn_matmul.launches
    attn, y = fs.fused_attn_matmul(lens, layer, q, kbad, vbad, x, wq, ws,
                                   group_size=gs, row0=row0)
    attn2, y2 = fs.fused_attn_matmul(lens, layer, q, kbad, vbad, x, wq, ws,
                                     group_size=gs, row0=row0)
    ref_a, ref_y = fs.fused_attn_matmul_plain(lens, layer, q, kc, vc, x, wq,
                                              ws, group_size=gs, row0=row0)
    assert fs.fused_attn_matmul.launches == before + 2
    assert torch.equal(attn, attn2) and torch.equal(y, y2)
    assert attn.shape == (Ba, 1, Hk * G, D) and y.shape == (Mb, N)
    assert bool(attn.isfinite().all())
    assert (attn.float() - ref_a.float()).abs().max().item() <= 2e-2
    # the W4A16 matmul's rule: 2^-6 of the largest output
    tol = 2 ** -6 * ref_y.float().abs().max().item()
    assert (y.float() - ref_y.float()).abs().max().item() <= tol
    # the dense W4A16 kernel runs another body (the tensor cores), so it
    # agrees with this wmma tile by the same rule
    dense = qm.quant_matmul4(x, wq, ws, layer, gs)
    assert (y.float() - dense.float()).abs().max().item() <= tol


def test_deferred_decode_step_matches_the_appending_step_on_the_card(gen):
    """Three deferred-append decode steps of a tiny bf16 model beside three
    decode_step(uniform_decode=True) steps from the same cache: each
    launches the fresh attention once a layer, the all-layer append once,
    and no appending attention; logits and caches are bit-identical (the
    same core call, the same rows written)."""
    cfg = tiny_config(head_dim=128)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    B, T, L = 4, 8, cfg.num_layers
    cache = KVCache.create(L, B, 256, cfg.num_kv_heads, 128, device="cuda")
    prompts = torch.randint(2, 512, (B, T), generator=gen, device="cuda")
    lens = torch.full((B,), T, device="cuda")
    logits, cache = qwen.prefill(params, cfg, prompts, lens, cache)
    other = KVCache(k=cache.k.clone(), v=cache.v.clone())
    tok = logits.argmax(-1)
    wrappers = {"decode_attention_contiguous_fresh":
                da.decode_attention_contiguous_fresh,
                "kv_append_all_uniform": ka.kv_append_all_uniform,
                "decode_attention_appending": da.decode_attention_appending}
    for s in range(3):
        for w in wrappers.values():
            w.launches = 0
        got, cache = qwen.decode_step(params, cfg, tok, lens + s, cache,
                                      uniform_decode=True,
                                      deferred_append=True)
        assert {n: w.launches for n, w in wrappers.items()} == {
            "decode_attention_contiguous_fresh": L,
            "kv_append_all_uniform": 1, "decode_attention_appending": 0}
        ref, other = qwen.decode_step(params, cfg, tok, lens + s, other,
                                      uniform_decode=True)
        assert torch.equal(got, ref)
        assert torch.equal(cache.k, other.k) and torch.equal(cache.v, other.v)
        tok = ref.argmax(-1)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_ragged_generate_writes_through_kv_append_ragged_t(gen, monkeypatch,
                                                           kv_dtype):
    """A ragged Engine.generate batch launches kv_append_ragged_t once a
    layer a decode step, and generate_speculative once a layer a verify
    forward; an aligned batch never."""
    from qwen_inference_engine_tpu_torch.engine import speculative as spec

    cfg = tiny_config(head_dim=128)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    eng = Engine(cfg, params, max_batch=3, max_seq=256, kv_dtype=kv_dtype,
                 sampling=SamplingParams(greedy=True), device="cuda")
    eng.cfg = cfg.replace(eos_token_ids=())
    w = ka.kv_append_ragged_t
    w.launches = 0
    res = eng.generate([[5, 9, 17], [100, 200, 300, 400, 7], [3] * 11],
                       max_new_tokens=6)
    assert w.launches == cfg.num_layers * (res.steps - 1) > 0
    w.launches = 0
    eng.generate([[5, 9, 17], [1, 2, 3], [7, 8, 9]], max_new_tokens=4)
    assert w.launches == 0
    forwards = []
    orig = spec.forward_hidden

    def count(*a, **k):
        forwards.append(a[2].shape)
        return orig(*a, **k)

    monkeypatch.setattr(spec, "forward_hidden", count)
    out = eng.generate_speculative([[5, 9, 17, 5, 9, 17, 5, 9], [4] * 9,
                                    [1, 2, 3, 4, 1, 2, 3, 4]],
                                   max_new_tokens=8, k=4)
    assert len(out) == 3 and forwards
    assert w.launches == cfg.num_layers * len(forwards)


def test_last_kernels_refuse_on_the_card(gen):
    k8 = torch.zeros((2, 4, 2, 256, 128), dtype=torch.int8, device="cuda")
    kb = torch.zeros((2, 4, 2, 256, 128), dtype=torch.bfloat16, device="cuda")
    q = _bf16(gen, 4, 1, 8, 128)
    new = _bf16(gen, 4, 1, 2, 128)
    lens = torch.ones(4, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="no int8 form"):
        da.decode_attention_contiguous_fresh(q, k8, k8, new, new, 0, lens)
    with pytest.raises(TypeError, match="writes no scales"):
        ka.kv_append_all_uniform(k8, k8, _bf16(gen, 2, 4, 2, 128),
                                 _bf16(gen, 2, 4, 2, 128), 3)
    with pytest.raises(TypeError, match="int8 K/V"):
        s = torch.zeros((2, 4, 2, 256), device="cuda")
        ka.kv_append_ragged_t(k8, k8, new, new, lens, 0, k_scale=s,
                              v_scale=s, ks_new=lens[:, None, None].float(),
                              vs_new=lens[:, None, None].float())
    with pytest.raises(ValueError, match="starts"):
        ka.kv_append_ragged_t(kb, kb, new, new, lens.cpu(), 0)
    wq = torch.zeros((2, 128, 96), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="N % 64"):
        fs.fused_attn_matmul(lens, 0, q, kb, kb, _bf16(gen, 4, 256), wq,
                             torch.zeros((2, 4, 96), device="cuda"),
                             group_size=64)
