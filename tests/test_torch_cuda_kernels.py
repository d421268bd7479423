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
scratch-page writes), the one row append kernel at both vector widths
(16 bytes, and 4 where k_new starts 4 bytes past a 16-byte boundary; D 64
and 128, bf16 and int8, T 1, 5 and 17 and a 40-token piece; page ids
outside the pool and positions past the table writing nothing; a
captured decode append replayed at new positions; the C launcher's plan
checks), its contiguous layout the same way (kv_append_ragged_t in bf16,
f32 and int8 and kv_append_uniform_q8, an int8 k_new 1 byte off copied
first, B = Bc and B < Bc, the INT8 append at positions -1 and S writing
nothing; both replayed in a CUDA graph after their starts or position
change; the C launchers' plan checks), the INT8 pool's kernels and the
speculative verify
(T = 2, 5, 9, 10, 16 and 17 at G 1, 4, 7 and 8, D 64 and 128: one and two
64-row groups, windows straddling pages and windows wider than their page,
the int8 scale writes), the paged decode and verify split S on the tensor
cores (one split, several, most of them empty, splits starting inside a
page; two calls bit for bit; the same bits through pages of 512, 256, 16
and 8, in order and shuffled; a verify row bit-equal to the decode of its
token; one CUDA graph replayed at new device lengths and tables), the
paged chunks on the tensor cores (G 1, 4, 7 and 8, D 64 and 128, pieces
past the table's end, the bits of the contiguous chunk kernels through
pages of 8, 16, 48 and 512, in order and shuffled; one CUDA graph
replayed after the tables and pools change), the grouped MoE matmuls (one row, one
expert taking every row, 127 empty experts of 128, decode- and
prefill-like expert sizes, odd column tiles, a padded K; the three on
the tensor-core body at 16- and 64-row tiles, a layer past 2^31 weight
bytes, an INT4 call over one expert bit-equal to the dense kernel), the
four dense matmuls at the 7B's offline-fused widths (qkv N 4608, gateup N
37888; M 4, 40 and 300; fused columns bit-equal to the split calls past
64 rows), ``fuse_projections`` through Engine.generate (4 matmuls a layer,
no ``fused_mlp``), a debug hook raising under graph capture, the fused
single-pass MLP, the fused attention + MLP and the uniform bf16 append of
the double-pumped decode (tiny and Qwen2.5-7B shapes, NaN past each row's
length, two calls bit for bit), ``decode_step_pumped`` against
``decode_step``, the last four sites' kernels (the ragged window append at
starts -1, band edges and past the cache's end in bf16, f32 and int8; the
fresh-merge decode attention with NaN at and past each old length and
bit-identical to the appending kernel; the all-layer append at 28 layers;
the fused attention + matmul at the probe's shapes, its y bit-equal to
``quant_matmul4``'s at Mb <= 64 and its attention to ``fused_attn_mlp``'s,
replayed in a CUDA graph), both uniform appends at both vector widths (16
bytes, and 4 where k_new starts 4 bytes past a 16-byte boundary; D 64 and
128, bf16 and f32, positions 0, S - 1 and S) and replayed in a CUDA graph
at a new device position, the deferred-append
decode step against ``decode_step`` bit for bit, the appending and fresh
decodes split S on the tensor cores (B 1, 4, 8 and 192, G 1, 4, 7 and 8,
D 64 and 128, S 256 and 2304, positions and old lengths on each side of
the 64-key tile and of the split edges, S - 1 and S, NaN past each, the
written cache row bit for bit and nothing else written, a position past
the cache, one CUDA graph replayed at a new device position), flash
attention on the tensor cores (T 1 to 512, G 1, 4, 7 and 8, D 64 and 128, two calls bit for
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
# 16-row tensor-core tiles); prefill-like experts of 7..200 rows (the
# 64-row tiles) with every tile straddling; N of an odd number of column
# tiles
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


# (E, group sizes, M): W8A16's tensor-core tiles, 16 rows (mt 1) where
# the mean rows per expert is at most 16, else 64 (mt 4): an expert of one
# row; an expert of 300 rows alone (5 tiles of 64) and among 127 small ones
# (19 tiles of 16); empty experts among straddling ones; group sizes
# summing past M (the rows past M dropped) under either tile
GROUPED8_CASES = {
    "one row": (8, [0, 0, 0, 1, 0, 0, 0, 0], None, 1),
    "300 rows": (8, [0, 300, 0, 0, 0, 0, 0, 0], None, 4),
    "300 rows among 127": (128, [300] + [13] * 127, None, 1),
    "empties": (5, [37, 0, 61, 0, 132], None, 4),
    "past M, 64-row tiles": (5, [100, 0, 150, 80, 20], 300, 4),
    "past M, 16-row tiles": (32, [50, 0, 100, 90] + [3] * 28, 200, 1),
}


@pytest.mark.parametrize("N", [192, 256], ids=["N 192", "N 256"])
@pytest.mark.parametrize("gs", [32, 128, None], ids=["gs 32", "gs 128",
                                                      "per column"])
@pytest.mark.parametrize("case", sorted(GROUPED8_CASES))
def test_grouped_matmul8_tensor_core_tiles_match_plain(gen, case, gs, N):
    """grouped_matmul8 on qmm_mma_body<kW8A16>, one block a (128-column
    tile, expert) walking its expert's row tiles, at layer 1 of a stacked
    [2, E, K, N] tensor: gs 32, 128 and per column, N 192 (a last column
    tile of 64) and 256, the plan's tile height as stated, against the
    plain version (2^-6 of the largest output), finite, two calls bit for
    bit, and every row past the experts' rows written by none (the group
    sizes summing past M)."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    E, sizes, M, mt = GROUPED8_CASES[case]
    gsz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    M = M or sum(sizes)
    K = 512
    assert gm.plan_grouped_matmul8(M, E) == mt
    G = 1 if gs is None else K // gs
    q = torch.randint(-127, 128, (2, E, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((2, E, G, N), generator=gen, device="cuda") * 0.01
    x = _bf16(gen, M, K)
    before = gm.grouped_matmul8.launches
    got = gm.grouped_matmul8(x, q, s, gsz, 1)
    again = gm.grouped_matmul8(x, q, s, gsz, 1)
    assert gm.grouped_matmul8.launches == before + 2
    assert torch.equal(got, again)
    assert bool(got.isfinite().all())
    _check_matmul(got, gm.grouped_matmul8_plain(x, q, s, gsz, 1), 2 ** -6)


def test_grouped_matmul8_takes_a_layer_past_2_31_weight_bytes(gen):
    """Layer 11 of a 12-layer stack of Qwen3-30B-A3B's gate experts (128 x
    2048 x 768 int8: the slab starts 2.2e9 bytes in, past a 32-bit offset)
    at the decode shape (M 256), against the plain version."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    L, E, K, N, layer = 12, 128, 2048, 768, 11
    q = torch.randint(-127, 128, (L, E, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    assert layer * E * K * N > 2 ** 31
    s = torch.rand((L, E, K // 128, N), generator=gen, device="cuda") * 1e-3
    gsz = _group_sizes(gen, E, None)
    x = _bf16(gen, int(gsz.sum()), K)
    got = gm.grouped_matmul8(x, q, s, gsz, layer)
    _check_matmul(got, gm.grouped_matmul8_plain(x, q, s, gsz, layer), 2 ** -6)


def _grouped4_call(gm, kind, x, q, s, gsz, layer, gs):
    """(kernel, plain, args) of an INT4 grouped kernel; W4A8 quantizes x
    per token first."""
    if kind == "w4a8":
        xq, sx = qm.quantize_activations(x)
        return (gm.grouped_matmul4_a8, gm.grouped_matmul4_a8_plain,
                (xq, sx.reshape(-1).contiguous(), q, s, gsz, layer, gs))
    return gm.grouped_matmul4, gm.grouped_matmul4_plain, (x, q, s, gsz, layer,
                                                          gs)


# (kind, N): W4A8 takes N a multiple of 128, W4A16 of 64 (N 192: a last
# column tile of 64)
GROUPED4_KINDS = [("w4a8", 256), ("w4", 192), ("w4", 256)]


@pytest.mark.parametrize("kind,N", GROUPED4_KINDS,
                         ids=[f"{k} N {n}" for k, n in GROUPED4_KINDS])
@pytest.mark.parametrize("gs", [128, 256], ids=["gs 128", "gs 256"])
@pytest.mark.parametrize("case", sorted(GROUPED8_CASES))
def test_grouped_matmul4_tensor_core_tiles_match_plain(gen, case, gs, kind,
                                                       N):
    """grouped_matmul4_a8 / grouped_matmul4 on qmm_mma_body<kW4A8> /
    <kW4A16>, one block a (128-column tile, expert) walking its expert's
    row tiles, at layer 1 of a stacked [2, E, Kp/2, N] tensor (Kp 1024: 4
    plane pairs at gs 128, 2 at gs 256): GROUPED8_CASES's experts (one row,
    300 rows alone and among 127, empty experts among straddling ones,
    group sizes summing past M) under the plan's tile height (16 or 64
    rows), against the plain version (2^-6 of the largest output), finite,
    two calls bit for bit, one launch a call."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    E, sizes, M, mt = GROUPED8_CASES[case]
    gsz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    M = M or sum(sizes)
    K = 1024
    assert gm.plan_grouped_matmul(M, E) == mt
    q = torch.randint(-128, 128, (2, E, K // 2, N), generator=gen,
                      device="cuda", dtype=torch.int8)
    s = torch.rand((2, E, K // gs, N), generator=gen, device="cuda") * 0.01
    fn, plain, args = _grouped4_call(gm, kind, _bf16(gen, M, K), q, s, gsz, 1,
                                     gs)
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    assert bool(got.isfinite().all())
    _check_matmul(got, plain(*args), 2 ** -6)


@pytest.mark.parametrize("kind", ["w4a8", "w4"])
def test_grouped_matmul4_takes_a_layer_past_2_31_weight_bytes(gen, kind):
    """Layer 23 of a 24-layer stack of Qwen3-30B-A3B's gate experts (128 x
    1024 packed rows x 768, INT4 gs 256: the slab starts 2.3e9 bytes in,
    past a 32-bit offset) at the decode shape (M 256), against the plain
    version."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    L, E, K, N, layer, gs = 24, 128, 2048, 768, 23, 256
    q = torch.randint(-128, 128, (L, E, K // 2, N), generator=gen,
                      device="cuda", dtype=torch.int8)
    assert layer * E * (K // 2) * N > 2 ** 31
    s = torch.rand((L, E, K // gs, N), generator=gen, device="cuda") * 1e-2
    gsz = _group_sizes(gen, E, None)
    fn, plain, args = _grouped4_call(gm, kind, _bf16(gen, int(gsz.sum()), K),
                                     q, s, gsz, layer, gs)
    _check_matmul(fn(*args), plain(*args), 2 ** -6)


@pytest.mark.parametrize("E", [8, 128], ids=["64-row tiles", "16-row tiles"])
@pytest.mark.parametrize("gs", [128, 256], ids=["gs 128", "gs 256"])
@pytest.mark.parametrize("kind", ["w4a8", "w4"])
def test_grouped_matmul4_one_expert_equals_the_dense_kernel(gen, kind, gs, E):
    """A grouped INT4 call whose rows (300 > 64: the dense kernel's one K
    slice) all go to expert 3 equals the dense quant_matmul4_a8 /
    quant_matmul4 over that expert's slab bit for bit: both run
    qmm_mma_body of the same kind, in the same K order and fold, with one
    slice (E 8: the grouped 64-row tiles, E 128: the 16-row ones)."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    M, K, N, layer = 300, 1024, 256, 1
    sizes = [0] * E
    sizes[3] = M
    gsz = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    q = torch.randint(-128, 128, (2, E, K // 2, N), generator=gen,
                      device="cuda", dtype=torch.int8)
    s = torch.rand((2, E, K // gs, N), generator=gen, device="cuda") * 0.01
    fn, _, args = _grouped4_call(gm, kind, _bf16(gen, M, K), q, s, gsz, layer,
                                 gs)
    got = fn(*args)
    slab = (q[layer, 3][None], s[layer, 3][None])
    if kind == "w4a8":
        want = qm.quant_matmul4_a8(args[0], args[1], *slab, 0, gs)
    else:
        want = qm.quant_matmul4(args[0], *slab, 0, gs)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


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


# Qwen2.5-7B's offline-fused widths at K 3584: qkv 3584 + 2 x 512, gateup
# 2 x 18944; the split projections' widths beside them
FUSED_N = {"qkv": (4608, (3584, 512, 512)), "gateup": (37888, (18944, 18944))}
FUSED_KERNELS = {"w4a8": (4, 8, 256), "w4a16": (4, 0, 128),
                 "w8a16": (8, 0, 128), "w8a8": (8, 8, None)}


def _fused_operands(gen, kind, M, N):
    """(kernel, plain, args without the weight, the weight q / scales)."""
    bits, act_bits, gs = FUSED_KERNELS[kind]
    K = 3584
    rows = K // 2 if bits == 4 else K
    lo = -128 if bits == 4 else -127
    q = torch.randint(lo, 128, (1, rows, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((1, 1 if gs is None else K // gs, N), generator=gen,
                   device="cuda") * (K ** -0.5 / 7)
    x = _bf16(gen, M, K)
    name = {(4, 8): "quant_matmul4_a8", (4, 0): "quant_matmul4",
            (8, 0): "quant_matmul8", (8, 8): "quant_matmul8_a8"}[
                (bits, act_bits)]
    if act_bits:
        xq, sx = qm.quantize_activations(x)
        head = (xq, sx.reshape(-1).contiguous())
    else:
        head = (x,)
    tail = (gs,) if bits == 4 else ()
    return getattr(qm, name), getattr(qm, name + "_plain"), head, tail, q, s


@pytest.mark.parametrize("M", [4, 40, 300])
@pytest.mark.parametrize("proj", sorted(FUSED_N))
@pytest.mark.parametrize("kind", sorted(FUSED_KERNELS))
def test_quant_matmuls_at_the_fused_widths(gen, kind, proj, M):
    """The four dense kernels at the 7B's fused widths against their plain
    versions (2^-6 of the largest output, 2^-7 for W8A8: the rules of
    chip_smoke.check_matmul), two calls bit for bit.  Past 64 rows (the
    prefill tiles, one K slice whatever N is) the fused output's columns
    are bit-equal to each split projection's own call; at M <= 64 the K
    split follows N, so they may round apart (within the same rule)."""
    N, parts = FUSED_N[proj]
    kern, plain, head, tail, q, s = _fused_operands(gen, kind, M, N)
    got = kern(*head, q, s, 0, *tail)
    again = kern(*head, q, s, 0, *tail)
    ref = plain(*head, q, s, 0, *tail)
    _check_matmul(got, ref, 2 ** -7 if kind == "w8a8" else 2 ** -6)
    assert torch.equal(got, again)
    lo = 0
    for n in parts:
        one = kern(*head, q[..., lo:lo + n].contiguous(),
                   s[..., lo:lo + n].contiguous(), 0, *tail)
        if M > 64:
            assert torch.equal(got[:, lo:lo + n], one)
        else:
            _check_matmul(got[:, lo:lo + n], ref[:, lo:lo + n],
                          2 ** -7 if kind == "w8a8" else 2 ** -6)
        lo += n


@pytest.mark.parametrize("act_bits", [0, 8], ids=["w4a16", "w4a8"])
def test_fused_params_run_four_matmuls_a_layer(gen, act_bits):
    """``fuse_projections`` on the card: Engine.generate (its decode steps
    captured) launches 4 matmuls a layer a forward, never ``fused_mlp``
    (pad-free W4A16 at M <= 256 takes it when split), and a prefill of
    2 x 160 rows (M > 256: the split W4A16 MLP is three matmuls, not
    fused_mlp; M > 64: one K slice at every width) gives the split
    parameters' logits bit for bit."""
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        fuse_projections,
    )

    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64, act_bits=act_bits)
    params = quantize_params(
        qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda"),
        QuantConfig(bits=4, group_size=128))
    fused = fuse_projections(params)
    kern = qm.quant_matmul4_a8 if act_bits else qm.quant_matmul4
    for k in (kern, fs.fused_mlp):
        k.launches = 0
    eng = Engine(cfg, fused, max_batch=2, max_seq=128,
                 sampling=SamplingParams(greedy=True))
    res = eng.generate([[5, 9, 17], [100, 200, 300, 400, 500]],
                       max_new_tokens=6)
    assert kern.launches == res.steps * 4 * cfg.num_layers
    assert fs.fused_mlp.launches == 0
    toks = torch.randint(0, cfg.vocab_size, (2, 160), generator=gen,
                         device="cuda")
    lens = torch.tensor([160, 141], device="cuda")
    out = []
    for p in (params, fused):
        cache = KVCache.create(cfg.num_layers, 2, 256, cfg.num_kv_heads,
                               cfg.head_dim, device="cuda")
        out.append(qwen.prefill(p, cfg, toks, lens, cache)[0])
    assert torch.equal(out[0], out[1])


def test_debug_hook_raises_under_a_cuda_graph_capture(gen):
    """An enabled dump hook inside ``torch.cuda.graph`` raises (a host print
    cannot replay) and names eager_steps(); in an eager step it prints; a
    disabled hook captures as an identity."""
    from qwen_inference_engine_tpu_torch.utils import debug

    x = _bf16(gen, 4, 8)
    debug.enable(True)
    try:
        assert debug.dump_activation("eager", x) is x
        g = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match=r"eager_steps\(\)"):
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                y = x * 2
                debug.dump_activation("captured", y)
    finally:
        debug.enable(False)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = debug.dump_activation("off", x * 2)
    g.replay()
    assert torch.equal(y, x * 2)


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


def _ragged_case(gen, B, Hk, G, D, S, lens, layer=1, L=2):
    """One ragged decode of B rows at ``lens`` over a cache of B + 2 rows
    with NaN at and past each length and in the rows past B (never read):
    within 2e-2 of the plain version over the clean cache, a row of length
    0 gives 0, finite, two calls bit for bit with one launch counted each,
    the cache untouched."""
    Bc = B + 2
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    rows = [min(n, S) for n in lens] + [0, 0]
    kbad, vbad = _nan_from(kc, rows), _nan_from(vc, rows)
    k0, v0 = kbad.clone(), vbad.clone()
    lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
    before = da.decode_attention_contiguous.launches
    got = da.decode_attention_contiguous(q, kbad, vbad, layer, lengths)
    again = da.decode_attention_contiguous(q, kbad, vbad, layer, lengths)
    assert da.decode_attention_contiguous.launches == before + 2
    assert torch.equal(got, again), lens
    assert torch.equal(_bits(kbad), _bits(k0)), lens
    assert torch.equal(_bits(vbad), _bits(v0)), lens
    assert got.shape == q.shape and bool(got.isfinite().all()), lens
    ref = da.decode_attention_contiguous_plain(q, kc, vc, layer, lengths)
    live = lengths > 0
    assert bool((got[~live] == 0).all()), lens
    err = (got[live].float() - ref[live].float()).abs().amax().item()
    assert err <= 2e-2, (lens, err)


# the ragged decode's plans: B x Hk = 12 blocks a split (16 splits of 64
# keys at S 1024), or 264 (one split, no merge launch)
RAGGED_PLANS = {"split": (6, 2, 1024), "one split": (132, 2, 256)}


@pytest.mark.parametrize("plan", sorted(RAGGED_PLANS))
@pytest.mark.parametrize("G", [1, 7, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_ragged_decode_split_matches_plain(gen, D, G, plan):
    """decode_attention_contiguous on the split-S tensor-core kernel at
    lengths 0, 1, 64, 65, S and S + 7 (attending all S keys), each row
    cycling through them, on a plan of several splits (merged) and of one
    (written directly): as _ragged_case holds it."""
    B, Hk, S = RAGGED_PLANS[plan]
    splits = da.plan_decode_split(B, Hk, S)[1]
    assert (splits == 1) == (plan == "one split")
    edges = [0, 1, 64, 65, S, S + 7]
    _ragged_case(gen, B, Hk, G, D, S, [edges[i % 6] for i in range(B)])


@pytest.mark.parametrize("B,S,positions", [
    (4, 1024, [0, 63, 64, 65, 500, 999, 1023]),
    (192, 512, [0, 64, 272, 511]),
])
def test_ragged_decode_equals_the_appending_decode(gen, B, S, positions):
    """After decode_attention_appending has written position f, the ragged
    decode at lengths f + 1 over that cache stages the same bits into the
    same blocks: outputs bit-equal, at check_decode's B 4 of S 1024 (16
    splits and a merge) and at the batch-192 default dispatch's S 512 (one
    split), Qwen2.5-7B's heads."""
    L, Hk, G, D, layer = 2, 4, 7, 128, 1
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    for pos in positions:
        appended, _, _ = da.decode_attention_appending(q, kc, vc, kn, vn,
                                                       layer, pos)
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device="cuda")
        ragged = da.decode_attention_contiguous(q, kc, vc, layer, lengths)
        assert torch.equal(ragged, appended), pos


@pytest.mark.parametrize("B,S", [(4, 1024), (192, 512)])
def test_ragged_decode_replays_in_a_cuda_graph_with_new_lengths(gen, B, S):
    """One ragged call captured in a CUDA graph with its lengths a device
    tensor (the plan reads nothing from the device), replayed after the
    lengths are changed in place, equals the eager call at the new lengths
    bit for bit, at check_decode's shape (16 splits) and at B 192 (one
    split)."""
    L, Hk, G, D, layer = 2, 4, 7, 128, 1
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    lengths = torch.randint(0, S + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention_contiguous(q, kc, vc, layer, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = da.decode_attention_contiguous(q, kc, vc, layer, lengths)
    for new in ([69, 152, 332, 1000], [0, S, 1, S + 7]):
        lengths.copy_(torch.tensor([new[i % 4] for i in range(B)],
                                   dtype=torch.int32))
        captured.zero_()
        graph.replay()
        eager = da.decode_attention_contiguous(q, kc, vc, layer, lengths)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager), new


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


def _q8_split_lengths(S, span, B):
    """Batches of B lengths that together hold 1, 63, 64, 65, each side of
    the first two split edges, S - 1, S and 0 (each batch's rows cycle
    through them)."""
    edges = sorted({n for n in (1, 63, 64, 65, span - 1, span, span + 1,
                                2 * span - 1, 2 * span, 2 * span + 1, S - 1,
                                S, 0) if 0 <= n <= S})
    return [[edges[(i + j) % len(edges)] for j in range(B)]
            for i in range(0, len(edges), B)]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("S", [256, 2304])
def test_decode_attention_q8_split_matches_plain(gen, S, B, G, D):
    """The split-S tensor-core kernel against its plain version (2e-2) at
    lengths on each side of the 64-key tile and of the split edges, S and
    0 (a row of length 0 gives 0, as the one-block kernel did), B smaller
    than the cache batch, NaN in the scales past each length and in the
    rows past B (never read), two calls bit for bit, one launch counted a
    call."""
    L, Bc, Hk, layer = 2, B + 2, 2, 1
    kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    span, splits = da.plan_decode_split(B, Hk, S)
    assert span % 64 == 0 and (splits - 1) * span < S <= splits * span
    for lens in _q8_split_lengths(S, span, B):
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        past = torch.arange(S, device="cuda")[None, :] >= lengths[:, None]
        ksn, vsn = ks.clone(), vs.clone()
        for t in (ksn, vsn):
            t[layer, :B].masked_fill_(past[:, None, :], float("nan"))
            t[layer, B:] = float("nan")
        q = _bf16(gen, B, 1, G * Hk, D)
        before = da.decode_attention_contiguous_q8.launches
        got = da.decode_attention_contiguous_q8(q, kc, vc, ksn, vsn, layer,
                                                lengths)
        again = da.decode_attention_contiguous_q8(q, kc, vc, ksn, vsn, layer,
                                                  lengths)
        assert da.decode_attention_contiguous_q8.launches == before + 2
        assert torch.equal(got, again), lens
        assert got.shape == q.shape and bool(got.isfinite().all()), lens
        ref = da.decode_attention_contiguous_q8_plain(q, kc, vc, ks, vs,
                                                      layer, lengths)
        live = lengths > 0
        assert (got[~live] == 0).all(), lens
        err = (got[live].float() - ref[live].float()).abs().amax().item() \
            if live.any() else 0.0
        assert err <= 2e-2, (lens, err)


def test_decode_attention_q8_split_replays_in_a_cuda_graph(gen):
    """One call captured in a CUDA graph (the plan reads nothing from the
    device) and replayed equals the eager call, bit for bit, at
    check_decode_q8's shape (B 4 of S 2304, Qwen2.5-7B's heads)."""
    L, B, Hk, G, D, S, layer = 2, 4, 4, 7, 128, 2304, 1
    kc, ks = _int8_cache(gen, L, B, Hk, S, D)
    vc, vs = _int8_cache(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    lengths = torch.tensor([69, 700, 1408, 2000], device="cuda",
                           dtype=torch.int32)
    args = (q, kc, vc, ks, vs, layer, lengths)
    eager = da.decode_attention_contiguous_q8(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention_contiguous_q8(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = da.decode_attention_contiguous_q8(*args)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


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
@pytest.mark.parametrize("G,D", [(7, 128), (8, 64), (1, 128), (4, 64)])
def test_paged_decode_attention_matches_plain(gen, page, G, D):
    """Lengths 1, one page, a page and one, three pages, and an idle row
    (length 0, zeroed table row, as the scheduler's idle slots); 64-key
    tiles cross pages of 8, 16 and 48; NaN past each row's length and in
    every page no table holds.  The plan splits S = 4 pages into one split
    (pages of 8 and 16), three (48: splits start inside pages) and 32 (512:
    most splits of the short rows empty, merged); two calls bit for bit."""
    L, Hk, max_pages = 2, 2, 4
    lens_list = [1, page, page + 1, 3 * page, 0]
    B = len(lens_list)
    P = B * max_pages + 3
    tables = _tables(gen, B, max_pages, P)
    tables[-1] = 0
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, lens_list)
    q = _bf16(gen, B, 1, G * Hk, D)
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    splits = pa.plan_paged_split(B, Hk, 1, max_pages * page)[1]
    assert splits == {8: 1, 16: 1, 48: 3, 512: 32}[page]
    before = pa.paged_decode_attention_stacked.launches
    got = pa.paged_decode_attention_stacked(q, k, v, tables, lens, page, 1)
    again = pa.paged_decode_attention_stacked(q, k, v, tables, lens, page, 1)
    ref = pa.paged_decode_attention_plain(q, k, v, tables, lens, page, 1)
    assert pa.paged_decode_attention_stacked.launches == before + 2
    assert bool(got.isfinite().all())
    assert torch.equal(got, again)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("B,S", [(4, 1024), (1, 2304), (8, 512)])
@pytest.mark.parametrize("G,D", [(7, 128), (8, 64), (1, 128)])
def test_paged_decode_is_the_same_bits_through_any_pages(gen, B, S, G, D):
    """One cache of S keys a row, stored as pages of 512, 256, 16 and 8
    (as many as divide S), in order (identity tables) and shuffled: the
    plan is the contiguous decode's (it depends on S alone) and so is the
    arithmetic a row, so every layout gives the bits of
    decode_attention_contiguous over the cache itself; lengths 0, 1, 64,
    65, 69, 1000, S - 1 and S, NaN past each row's length."""
    L, Hk, layer = 2, 4, 1
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    edges = [69, 0, 1, 64, 65, min(1000, S), S, S - 1]
    lens_list = [edges[i % len(edges)] for i in range(B)]
    for b, m in enumerate(lens_list):
        kc[:, b, :, m:] = float("nan")
        vc[:, b, :, m:] = float("nan")
    q = _bf16(gen, B, 1, G * Hk, D)
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    assert pa.plan_paged_split(B, Hk, 1, S) == da.plan_decode_split(B, Hk, S)
    outs = []
    for page in (p for p in (512, 256, 16, 8) if S % p == 0):
        n = S // page
        for shuffle in (False, True):
            order = (torch.randperm(B * n, generator=gen, device="cuda")
                     if shuffle else torch.arange(B * n, device="cuda"))

            def pool(c):
                rows = c.reshape(L, B, Hk, n, page, D).permute(
                    0, 1, 3, 2, 4, 5).reshape(L, B * n, Hk, page, D)
                out = torch.empty_like(
                    rows, memory_format=torch.contiguous_format)
                out[:, order] = rows
                return out

            tables = order.to(torch.int32).reshape(B, n)
            outs.append(pa.paged_decode_attention_stacked(
                q, pool(kc), pool(vc), tables, lens, page, layer))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert bool(outs[0].isfinite().all())
    want = da.decode_attention_contiguous(q, kc, vc, layer, lens)
    assert torch.equal(outs[0], want)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T,G", [(2, 7), (5, 7), (9, 7), (5, 8), (16, 4)])
def test_paged_verify_rows_are_the_decode_bits(gen, T, G, quant):
    """While a verify's T * G rows fit one row group, its row for token t
    is, bit for bit, the decode of that token at length len - T + t + 1
    over the same pool: the same plan, blocks and arithmetic a row.  So a
    drafter equal to the target attends as the target's verify does."""
    L, Hk, D, page, max_pages = 2, 4, 128, 16, 8
    lens_list = [T, 37, 70, 100, max_pages * page]
    B = len(lens_list)
    P = B * max_pages + 3
    tables = _tables(gen, B, max_pages, P)
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, lens_list)
    pools, scales = (k, v), ()
    if quant:
        k8, v8, ks, vs = _q8_pool(k, v)
        pools, scales = (k8, v8), (ks, vs)
    sfx = "_q8" if quant else ""
    verify = getattr(pa, "paged_verify_attention_stacked" + sfx)
    decode = getattr(pa, "paged_decode_attention_stacked" + sfx)
    q = _bf16(gen, B, T, G * Hk, D)
    lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
    assert pa.paged_row_groups(T, G) == 1
    rows = verify(q, *pools, *scales, tables, lens, page, 1)
    for t in range(T):
        one = decode(q[:, t:t + 1].contiguous(), *pools, *scales, tables,
                     lens - T + t + 1, page, 1)
        assert torch.equal(one[:, 0], rows[:, t]), t


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
def test_paged_decode_row_bits_across_table_widths(gen, quant):
    """A row's decode output does not depend on the rows beside it: the
    serving engine hands the paged attention tables of its full
    max_pages_per_seq width, zero past each row's pages, and the plan
    follows that width alone.  Four rows (all within one page of 512)
    beside four neighbours that hold 1, 2, 4 and then 8 pages (the widths
    a trimmed table would have taken): the four rows give the same bits
    each time; NaN past each row's length and in every page no table
    holds."""
    L, Hk, G, D, page, wide = 2, 4, 7, 128, 512, 8
    rows = [400, 37, 300, 1]
    B = len(rows) + 4
    P = B * wide + 3
    tables = _tables(gen, B, wide, P)
    full = rows + [wide * page - 5] * 4
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, full)
    pools, scales = (k, v), ()
    if quant:
        k8, v8, ks, vs = _q8_pool(k, v)
        pools, scales = (k8, v8), (ks, vs)
    attend = getattr(pa, "paged_decode_attention_stacked"
                     + ("_q8" if quant else ""))
    q = _bf16(gen, B, 1, G * Hk, D)
    outs = []
    for w in (1, 2, 4, 8):
        lens_list = rows + [w * page - 5] * 4
        held = torch.zeros_like(tables)
        for b, n in enumerate(lens_list):
            n_pages = -(-n // page)
            held[b, :n_pages] = tables[b, :n_pages]
        lens = torch.tensor(lens_list, device="cuda", dtype=torch.int32)
        out = attend(q, *pools, *scales, held, lens, page, 1)
        assert bool(out.isfinite().all()), w
        outs.append(out[:len(rows)])
    for w, got in zip((2, 4, 8), outs[1:]):
        assert torch.equal(got, outs[0]), w


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T", [1, 5])
def test_paged_attention_replays_in_a_cuda_graph_with_new_lengths(gen, T,
                                                                  quant):
    """One paged decode / verify call captured in a CUDA graph with its
    lengths and tables on the device (the plan comes from the shapes
    alone), replayed after the lengths and tables change in place, equals
    the eager call at the new values bit for bit."""
    L, Hk, G, D, page, max_pages, B = 2, 4, 7, 128, 16, 8, 4
    P = 2 * B * max_pages + 1
    tables = _tables(gen, B, max_pages, P)
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    k, v = _paged_pool(gen, L, P, Hk, page, D, torch.arange(
        P, device="cuda", dtype=torch.int32)[None], [P * page])
    pools, scales = (k, v), ()
    if quant:
        k8, v8, ks, vs = _q8_pool(k, v)
        pools, scales = (k8, v8), (ks, vs)
    name = ("paged_decode_attention_stacked" if T == 1
            else "paged_verify_attention_stacked") + ("_q8" if quant else "")
    fn = getattr(pa, name)
    q = _bf16(gen, B, T, G * Hk, D)
    args = (q, *pools, *scales, tables, lens, page, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args)
    for new in ([T, 37, 100, max_pages * page], [128, T + 1, 77, 64]):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        tables.copy_(_tables(gen, B, max_pages, P))
        captured.zero_()
        graph.replay()
        eager = fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager), new


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


def _as_pages(c, page, order):
    """The cache ``c [L, B, Hk, S, ...]`` stored as a pool of pages of
    ``page`` tokens, row b's page i at pool page ``order[b * n + i]``."""
    L, B, Hk, S = c.shape[:4]
    n = S // page
    rows = c.reshape(L, B, Hk, n, page, *c.shape[4:]).transpose(2, 3)
    rows = rows.reshape(L, B * n, Hk, page, *c.shape[4:])
    out = torch.empty_like(rows, memory_format=torch.contiguous_format)
    out[:, order] = rows
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("G,D", [(7, 128), (8, 64)])
@pytest.mark.parametrize("T,start", [(1, 0), (7, 13), (256, 700),
                                     (256, 1280), (512, 1024)])
def test_paged_chunk_is_the_contiguous_bits_through_any_pages(gen, T, start,
                                                              G, D, quant):
    """One cache of S = 1536 keys a row stored as pages of 8, 16, 48 and
    512, in order (identity tables) and shuffled: the paged chunk kernel
    runs the contiguous chunk kernel's blocks (one block a 64-row tile, no
    key split) with the same arithmetic, so every layout gives the bits of
    chunk_attention_contiguous(_q8) at the same start; NaN past the
    piece's end in every row (NaN scales for int8)."""
    L, B, Hk, S, layer = 2, 2, 2, 1536, 1
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    kc[:, :, :, start + T:] = float("nan")
    vc[:, :, :, start + T:] = float("nan")
    caches, scales = (kc, vc), ()
    if quant:
        k8, ks = quantize_kv(kc.nan_to_num())
        v8, vs = quantize_kv(vc.nan_to_num())
        ks[:, :, :, start + T:] = float("nan")
        vs[:, :, :, start + T:] = float("nan")
        caches, scales = (k8, v8), (ks, vs)
    sfx = "_q8" if quant else ""
    q = _bf16(gen, B, T, G * Hk, D)
    want = getattr(ca, "chunk_attention_contiguous" + sfx)(
        q, *caches, *scales, layer, start)
    assert bool(want.isfinite().all())
    paged = getattr(ca, "paged_chunk_attention" + sfx)
    for page in (8, 16, 48, 512):
        n = S // page
        for shuffle in (False, True):
            order = (torch.randperm(B * n, generator=gen, device="cuda")
                     if shuffle else torch.arange(B * n, device="cuda"))
            tables = order.to(torch.int32).reshape(B, n)
            pools = [_as_pages(c, page, order) for c in caches + scales]
            before = paged.launches
            got = paged(q, *pools, tables, layer, start, page)
            assert paged.launches == before + 1
            assert torch.equal(got, want), (page, shuffle)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("page", [16, 512])
@pytest.mark.parametrize("G,D", [(8, 128), (8, 64), (1, 64), (4, 128)])
@pytest.mark.parametrize("T,start", [(5, 13), (256, 700), (100, 1000)])
def test_paged_chunk_attention_head_layouts_match_plain(gen, T, start, G, D,
                                                        page, quant):
    """G 1, 4 and 8 (Qwen3-30B-A3B's layout), D 64 and 128, packed row
    tiles that T * G does not fill, mid-page starts, three rows with their
    own tables; NaN in the pages no table holds and past the piece's end
    (NaN scales for int8); two calls bit for bit."""
    L, B, Hk = 2, 3, 2
    max_pages = -(-(start + T) // page) + 1
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, [start + T] * B)
    pools, scales = (k, v), ()
    if quant:
        k8, v8, ks, vs = _q8_pool(k, v)
        pools, scales = (k8, v8), (ks, vs)
    name = "paged_chunk_attention" + ("_q8" if quant else "")
    q = _bf16(gen, B, T, G * Hk, D)
    args = (q, *pools, *scales, tables, 1, start, page)
    got = getattr(ca, name)(*args)
    again = getattr(ca, name)(*args)
    ref = getattr(ca, name + "_plain")(*args)
    assert bool(got.isfinite().all())
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("page,start,T", [(8, 27, 16), (48, 150, 256),
                                          (512, 2039, 16)])
def test_paged_chunk_attention_q8_past_the_table_end(gen, page, start, T):
    """The INT8 pool's bucket-padded last piece past the table's end: its
    rows there attend the whole table, as in the plain version."""
    L, B, Hk, G, D = 2, 2, 2, 7, 128
    max_pages = -(-(start + 1) // page)
    assert start + T > max_pages * page
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    k, v = _paged_pool(gen, L, P, Hk, page, D, tables, [start + T] * B)
    k8, v8, ks, vs = _q8_pool(k, v)
    q = _bf16(gen, B, T, G * Hk, D)
    args = (q, k8, v8, ks, vs, tables, 1, start, page)
    got = ca.paged_chunk_attention_q8(*args)
    ref = ca.paged_chunk_attention_q8_plain(*args)
    assert bool(got.isfinite().all())
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
def test_paged_chunk_replays_in_a_cuda_graph(gen, quant):
    """One paged chunk call captured in a CUDA graph (the launch reads
    nothing back from the device), replayed after the tables and the pool
    change in place, equals the eager call at the new values bit for
    bit."""
    L, B, Hk, G, D, page, max_pages, T, start = 2, 2, 4, 7, 128, 16, 8, 64, 37
    P = 2 * B * max_pages + 1
    tables = _tables(gen, B, max_pages, P)
    k, v = _bf16(gen, L, P, Hk, page, D), _bf16(gen, L, P, Hk, page, D)
    pools, scales = [k, v], []
    if quant:
        k8, v8, ks, vs = _q8_pool(k, v)
        pools, scales = [k8, v8], [ks, vs]
    fn = ca.paged_chunk_attention_q8 if quant else ca.paged_chunk_attention
    q = _bf16(gen, B, T, G * Hk, D)
    args = (q, *pools, *scales, tables, 1, start, page)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(*args)
    for _ in range(2):
        tables.copy_(_tables(gen, B, max_pages, P))
        fresh = [_bf16(gen, L, P, Hk, page, D) for _ in range(2)]
        if quant:
            fresh = list(_q8_pool(*fresh))
        for t, new in zip(pools + scales, fresh):
            t.copy_(new)
        captured.zero_()
        graph.replay()
        eager = fn(*args)
        torch.cuda.synchronize()
        assert bool(eager.isfinite().all())
        assert torch.equal(captured, eager)


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
@pytest.mark.parametrize("page", [8, 16, 512])
@pytest.mark.parametrize("T", [1, 2, 5, 9, 10, 16, 17])
@pytest.mark.parametrize("G,D", [(7, 128), (4, 64), (8, 128), (1, 64)])
def test_paged_q8_and_verify_attention_match_plain(gen, G, D, T, page,
                                                   quant):
    """_paged_bhgd_q8 (decode and verify) and the verify shape of
    _paged_bhgd: a window at the sequence start, one straddling pages 0 and
    1, one starting page 2, long rows, and for the decode an idle row
    (length 0, zeroed table: zeros out); NaN (NaN scales) in the pages no
    table holds and past each row's length; two calls bit for bit.  T * G
    crosses the 64-row group (T = 10 at G = 7, T = 9 at G = 8, T = 17 at
    G = 4); T = 17 is a window wider than a page of 8 and 16; pages of
    512 plan several splits, most of them empty for the short rows."""
    L, Hk = 2, 2
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
    again = fn(*args)
    ref = plain(*args)
    assert fn.launches == before + 2
    assert bool(got.isfinite().all())
    assert torch.equal(got, again)
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


def _rows_at(gen, shape, quant, offset):
    """New K/V rows (and for int8 their scales as keywords) whose k_new
    starts ``offset`` bytes into its storage: a contiguous view."""
    kn, vn, extra = _new_rows(gen, shape, quant)
    el = offset // kn.element_size()
    flat = torch.empty(kn.numel() + el, dtype=kn.dtype, device="cuda")
    view = flat[el:].view(kn.shape)
    view.copy_(kn)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    return view, vn, extra


@pytest.mark.parametrize("offset", [0, 4], ids=["16 bytes", "4 bytes"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T", [1, 5, 17, 40])
def test_paged_appends_at_both_vector_widths(gen, T, D, quant, offset):
    """The one paged append kernel at both widths: 16-byte vectors where the
    pools and the new rows are 16-byte aligned, 4-byte words where k_new
    starts 4 bytes past a 16-byte boundary (the plan says which); D 64 and
    128, bf16 and int8 (scales too).  T = 1 is paged_append_ragged, 5 and
    17 paged_append_ragged_t (17 wider than the page of 16: three pages),
    40 a prefill piece over four pages from a mid-page start; per-row
    starts at 0, mid-page, the page's last row, a skipped row (-1) and
    deep in the table.  Bit-exact, nothing else of the pools written."""
    L, Hk, page = 2, 4, 16
    prefill = T == 40
    starts_list = [5] if prefill else [0, 7, page - 1, -1, 2 * page + 3]
    B = len(starts_list)
    max_pages = -(-(max(starts_list) + T) // page)
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    base = _append_state(gen, L, P, Hk, page, D, quant)
    kn, vn, extra = _rows_at(gen, (B, T, Hk, D), quant, offset)
    elem = 1 if quant else 2
    vec, _, _ = ka.plan_paged_append(B, T, Hk, D, elem, offset == 0)
    assert vec == (16 if offset == 0 else 4)
    mine, theirs = [t.clone() for t in base], [t.clone() for t in base]

    def kw(st):
        return dict(extra, k_scale=st[2], v_scale=st[3]) if quant else {}

    if prefill:
        name, at = "paged_append_prefill", starts_list[0]
    else:
        name = "paged_append_ragged" if T == 1 else "paged_append_ragged_t"
        at = torch.tensor(starts_list, device="cuda", dtype=torch.int32)
    fn, plain = getattr(ka, name), getattr(ka, name + "_plain")
    before = fn.launches
    got = fn(mine[0], mine[1], kn, vn, at, tables, 1, page_size=page,
             **kw(mine))
    plain(theirs[0], theirs[1], kn, vn, at, tables, 1, page, **kw(theirs))
    assert fn.launches == before + 1
    assert got[0] is mine[0] and got[1] is mine[1]
    for g, r in zip(mine, theirs):
        assert torch.equal(g, r)
    rows = sum(T for s in starts_list if s >= 0)
    assert int((mine[0] != base[0]).any(dim=-1).sum()) == rows * Hk


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["paged_append_ragged",
                                  "paged_append_ragged_t",
                                  "paged_append_prefill"])
def test_paged_appends_write_nothing_outside_the_pool_or_the_table(
        gen, name, quant):
    """Page ids outside [0, P) (P + 5 and -2) and positions whose logical
    page is at or past the table's width write nothing; every other token
    lands as the plain write puts it.  The plain write runs on a pool of
    one more page, with the bad ids sent there, and is compared on the
    first P pages."""
    L, Hk, D, page, max_pages = 2, 4, 128, 16, 4
    if name == "paged_append_prefill":
        # 5..64: pages 1 and 2 bad, 3 good, 64 past the width
        B, T, at_list = 1, 60, [5]
    else:
        # 14: a window into the bad page P + 5; 18 and 40: bad pages (-2);
        # 62: a window past the width; 64: at the width
        T = 1 if name == "paged_append_ragged" else 5
        at_list = [14, 18, 46, 62, 3, 40, 64]
        B = len(at_list)
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    tables[0, 1] = P + 5
    tables[0, 2] = -2
    if B > 1:
        tables[1, 1] = -2
        tables[5, 2] = -2
    base = _append_state(gen, L, P + 1, Hk, page, D, quant)
    kn, vn, extra = _new_rows(gen, (B, T, Hk, D), quant)
    mine = [t[:, :P].clone() for t in base]
    theirs = [t.clone() for t in base]
    sink = torch.where((tables < 0) | (tables >= P), P, tables)

    def kw(st):
        return dict(extra, k_scale=st[2], v_scale=st[3]) if quant else {}

    at = at_list[0] if B == 1 else torch.tensor(at_list, device="cuda",
                                                dtype=torch.int32)
    getattr(ka, name)(mine[0], mine[1], kn, vn, at, tables, 1,
                      page_size=page, **kw(mine))
    getattr(ka, name + "_plain")(theirs[0], theirs[1], kn, vn, at, sink, 1,
                                 page, **kw(theirs))
    for g, r in zip(mine, theirs):
        assert torch.equal(g, r[:, :P])
    pos = torch.tensor(at_list, device="cuda")[:, None] + torch.arange(
        T, device="cuda")
    logical = pos // page
    inside = logical < max_pages
    ids = torch.gather(sink.long(), 1, logical.clamp(max=max_pages - 1))
    good = int((inside & (ids < P)).sum())
    assert good < B * T
    assert int((mine[0] != base[0][:, :P]).any(dim=-1).sum()) == good * Hk


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_append_ragged_replays_in_a_cuda_graph_at_new_positions(
        gen, quant):
    """paged_append_ragged captured in a CUDA graph (it reads the positions
    and tables on the device), replayed after the positions tensor and the
    new rows change in place, writes at the new positions: the same pools
    as the eager call there."""
    L, Hk, D, page, max_pages = 2, 4, 128, 16, 4
    B = 6
    P = B * max_pages + 2
    tables = _tables(gen, B, max_pages, P)
    base = _append_state(gen, L, P, Hk, page, D, quant)
    kn, vn, extra = _new_rows(gen, (B, 1, Hk, D), quant)
    pos = torch.tensor([0, 5, 15, 16, -1, 63], device="cuda",
                       dtype=torch.int32)
    state = [t.clone() for t in base]

    def append(st, p):
        kw = dict(extra, k_scale=st[2], v_scale=st[3]) if quant else {}
        return ka.paged_append_ragged(st[0], st[1], kn, vn, p, tables, 1,
                                      page_size=page, **kw)

    append(state, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        append(state, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        append(state, pos)
    for new_pos in ([1, 6, 16, 17, 40, -1], [63, -1, 0, 31, 32, 2]):
        pos.copy_(torch.tensor(new_pos, device="cuda", dtype=torch.int32))
        fresh = _new_rows(gen, (B, 1, Hk, D), quant)
        kn.copy_(fresh[0])
        vn.copy_(fresh[1])
        for key, t in fresh[2].items():
            extra[key].copy_(t)
        for t, b in zip(state, base):
            t.copy_(b)
        graph.replay()
        eager = [t.clone() for t in base]
        append(eager, pos)
        torch.cuda.synchronize()
        for g, e in zip(state, eager):
            assert torch.equal(g, e)
        n = sum(p >= 0 for p in new_pos)
        assert int((state[0] != base[0]).any(dim=-1).sum()) == n * Hk


def test_paged_append_c_guard_refuses_bad_plans(gen):
    """The C launcher checks the plan it is given against the shapes and
    returns cudaErrorInvalidValue (1) for a vector of 8 bytes, 16-byte
    vectors over a k_new 4 bytes off, blocks of 256 threads, too few or too
    many blocks, and for the old refusals (no starts, an int8 call missing
    a scale); the planned call returns 0."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    L, P, Hk, page, D, B, T, max_pages = 2, 8, 2, 16, 128, 2, 5, 3
    k, v = _bf16(gen, L, P, Hk, page, D), _bf16(gen, L, P, Hk, page, D)
    kn, vn, _ = _rows_at(gen, (B, T, Hk, D), False, 0)
    off, _, _ = _rows_at(gen, (B, T, Hk, D), False, 4)
    starts = torch.tensor([0, 20], device="cuda", dtype=torch.int32)
    tables = _tables(gen, B, max_pages, P)
    sc = torch.ones((L, P, Hk, page), device="cuda")
    st = cuda_lib.stream_handle(k.device)

    def call(plan, new=kn, starts_ptr=starts.data_ptr(), scales=(None,) * 4):
        return lib.qie_paged_append_ragged_t(
            k.data_ptr(), v.data_ptr(), scales[0], scales[1], new.data_ptr(),
            vn.data_ptr(), scales[2], scales[3], starts_ptr,
            tables.data_ptr(), L, P, B, T, Hk, page, D, max_pages, 1, *plan,
            st)

    good = ka.plan_paged_append(B, T, Hk, D, 2, True)
    assert good == (16, 128, 3)    # 2 x 5 x 2 head rows of 16 vectors
    for bad in [(8, 128, 5), (16, 256, 2), (16, 128, 2), (16, 128, 4),
                (4, 128, 9), (4, 128, 11)]:
        assert call(bad) == 1, bad
    assert call(good, new=off) == 1
    assert call(good, starts_ptr=None) == 1
    assert call(good, scales=(sc.data_ptr(), sc.data_ptr(), None,
                              sc.data_ptr())) == 1
    assert call((4, 128, 10), new=off) == 0
    assert call(good) == 0
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("second_half", [False, True], ids=["row0 0",
                                                             "row0 Ba"])
@pytest.mark.parametrize("gs_gate,gs_down", [(128, 128), (256, 128)])
@pytest.mark.parametrize("Mb", [1, 4, 40, 64, 96, 192])
def test_fused_attn_mlp_plans_match_plain(gen, Mb, gs_gate, gs_down,
                                          second_half):
    """The attention blocks (the pumped half batch: 96 rows of a 192-row
    cache, Hk 4, G 7, S 512, NaN past each length) beside the gate / up
    pass at every plan fused_mlp takes for Mb rows of the 7B MLP: the split
    decode stream's one and four m16 tiles a warp (Mb 1, 4, 40, 64) and
    the unsplit 64-row tiles (96, 192); attention within 2e-2, the MLP
    within 2^-6 of its largest output, two calls bit for bit."""
    Ba, Hk, G, S, Bc = ATTN_MLP_SHAPES["7b"]
    K, F = MLP_SHAPES["7b"]
    (mt1, s1, _), _ = fs.plan_fused_mlp(Mb, K, F, gs_gate, gs_down)
    assert mt1 == (1 if Mb <= 16 else 4) and (s1 > 1) == (Mb <= 64)
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
    x = _bf16(gen, Mb, K)
    w = _mlp_weights(gen, L, K, F, gs_gate, gs_down)
    kw = dict(gs_gate=gs_gate, gs_down=gs_down, row0=row0)
    before = fs.fused_attn_mlp.launches
    attn, y = fs.fused_attn_mlp(lens, layer_a, layer_m, q, kbad, vbad, x,
                                *w, **kw)
    attn2, y2 = fs.fused_attn_mlp(lens, layer_a, layer_m, q, kbad, vbad, x,
                                  *w, **kw)
    ref_attn, ref_y = fs.fused_attn_mlp_plain(lens, layer_a, layer_m, q, kc,
                                              vc, x, *w, **kw)
    assert fs.fused_attn_mlp.launches == before + 2
    assert torch.equal(attn, attn2) and torch.equal(y, y2)
    assert y.shape == (Mb, K) and bool(attn.isfinite().all())
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


@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "4 bytes past"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("pos", [0, 255, 256], ids=["0", "S-1", "S"])
@pytest.mark.parametrize("D", [64, 128])
def test_kv_append_uniform_vector_widths(gen, D, pos, dtype, offset):
    """Both widths of the uniform append: 16-byte vectors where the row and
    every operand are 16-byte aligned, 4-byte words where k_new starts 4
    bytes past a 16-byte boundary; D 64 and 128, bf16 and f32, positions
    0, S - 1 and S (nothing written).  The rows bit for bit, nothing else
    of the cache touched, for kv_append_uniform (7 rows from row 2 of 12)
    and kv_append_all_uniform (3 layers, 7 of 12 rows)."""
    L, Bc, Bn, Hk, S, row0, layer = 3, 12, 7, 4, 256, 2, 1
    kc = _kv_cache(gen, (L, Bc, Hk, S, D), dtype)
    vc = _kv_cache(gen, (L, Bc, Hk, S, D), dtype)
    el = offset // torch.empty((), dtype=dtype).element_size()

    def rows(*shape):
        n = 1
        for d in shape:
            n *= d
        flat = torch.randn(n + el, generator=gen, device="cuda").to(dtype)
        return flat[el:].view(shape)

    kn, vn = rows(Bn, 1, Hk, D), rows(Bn, 1, Hk, D)
    assert (kn.data_ptr() % 16 == 4) == (offset == 4) and kn.is_contiguous()
    mine, theirs = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
    before = ka.kv_append_uniform.launches
    ka.kv_append_uniform(*mine, kn, vn, torch.tensor([pos], device="cuda"),
                         layer, row0=row0)
    assert ka.kv_append_uniform.launches == before + 1
    if pos < S:
        ka.kv_append_uniform_plain(*theirs, kn, vn, pos, layer, row0)
    assert torch.equal(mine[0], theirs[0]) and torch.equal(mine[1], theirs[1])
    kn, vn = rows(L, Bn, 1, Hk, D), rows(L, Bn, 1, Hk, D)
    mine, theirs = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
    before = ka.kv_append_all_uniform.launches
    ka.kv_append_all_uniform(*mine, kn, vn, torch.tensor([pos], device="cuda"))
    assert ka.kv_append_all_uniform.launches == before + 1
    if pos < S:
        ka.kv_append_all_uniform_plain(*theirs, kn, vn, pos)
    assert torch.equal(mine[0], theirs[0]) and torch.equal(mine[1], theirs[1])


@pytest.mark.parametrize("kind", ["uniform", "all layers"])
def test_kv_append_uniform_replays_in_a_cuda_graph_at_a_new_position(gen,
                                                                     kind):
    """A uniform append captured in a CUDA graph writes, when replayed after
    its position tensor changed, at the new position: the same cache as
    the eager call there."""
    L, Bc, Hk, S, D = 3, 8, 4, 256, 128
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    pos = torch.tensor([5], device="cuda", dtype=torch.int32)
    if kind == "uniform":
        kn, vn = _bf16(gen, 4, 1, Hk, D), _bf16(gen, 4, 1, Hk, D)

        def append(k, v, p):
            return ka.kv_append_uniform(k, v, kn, vn, p, 1, row0=4)
    else:
        kn, vn = _bf16(gen, L, Bc, 1, Hk, D), _bf16(gen, L, Bc, 1, Hk, D)

        def append(k, v, p):
            return ka.kv_append_all_uniform(k, v, kn, vn, p)

    kg, vg = kc.clone(), vc.clone()
    append(kg, vg, pos)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        append(kg, vg, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        append(kg, vg, pos)
    for p in (200, 0, 255):
        kg.copy_(kc)
        vg.copy_(vc)
        pos.fill_(p)
        graph.replay()
        ke, ve = kc.clone(), vc.clone()
        append(ke, ve, p)
        torch.cuda.synchronize()
        assert torch.equal(kg, ke) and torch.equal(vg, ve), p
        assert not torch.equal(kg, kc), p


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
        # matmuls, the halves' MLP): within 2^-4 of the largest logit
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


def _at_offset(t, offset):
    """A contiguous copy of ``t`` starting ``offset`` bytes past a 16-byte
    boundary of its storage."""
    el = offset // t.element_size()
    flat = torch.empty(t.numel() + el, dtype=t.dtype, device=t.device)
    view = flat[el:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    return view


# (cache type, bytes k_new starts past a 16-byte boundary): 0 takes
# 16-byte vectors, 4 the 4-byte words, 1 (int8) is copied by the wrapper
# and then takes 16-byte vectors
CONTIGUOUS_ROWS = [(torch.bfloat16, 0), (torch.bfloat16, 4),
                   (torch.float32, 0), (torch.float32, 4), (torch.int8, 0),
                   (torch.int8, 4), (torch.int8, 1)]


@pytest.mark.parametrize("Bc", [6, 9], ids=["B = Bc", "B < Bc"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize(
    "dtype,offset", CONTIGUOUS_ROWS,
    ids=[f"{str(d).split('.')[-1]} {o} off" for d, o in CONTIGUOUS_ROWS])
def test_kv_append_ragged_t_at_both_vector_widths(gen, dtype, offset, D, T,
                                                  Bc):
    """The row kernel's contiguous layout at both widths: 16-byte vectors
    where the caches and the new rows are 16-byte aligned, 4-byte words
    where k_new starts 4 bytes past a 16-byte boundary, and an int8 k_new
    1 byte off copied first; bf16, f32 and int8 (scales too), D 64 and
    128, 6 rows of a cache of 6 or 9.  Starts -1 (skipped), 0, 7, S - T
    and S - 2 (a window past the cache's end) and 40.  Bit-exact against
    the plain version, nothing else of the caches written."""
    L, Hk, S, layer = 2, 4, 64, 1
    starts_l = [-1, 0, 7, S - T, S - 2, 40]
    B = len(starts_l)
    kc = _kv_cache(gen, (L, Bc, Hk, S, D), dtype)
    vc = _kv_cache(gen, (L, Bc, Hk, S, D), dtype)
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
        kn = _kv_cache(gen, (B, T, Hk, D), dtype)
        vn = _kv_cache(gen, (B, T, Hk, D), dtype)
    kn = _at_offset(kn, offset)
    elem = kn.element_size()
    vec = ka.plan_paged_append(B, T, Hk, D, elem, offset != 4)[0]
    assert vec == (4 if offset == 4 else 16)
    starts = torch.tensor(starts_l, device="cuda", dtype=torch.int32)
    mine, theirs = [kc.clone(), vc.clone()], [kc.clone(), vc.clone()]
    before = ka.kv_append_ragged_t.launches
    got = ka.kv_append_ragged_t(*mine, kn, vn, starts, layer, **kw)
    ka.kv_append_ragged_t_plain(*theirs, kn, vn, starts, layer, **kw2)
    assert ka.kv_append_ragged_t.launches == before + 1
    assert got[0] is mine[0] and got[1] is mine[1]
    assert torch.equal(mine[0], theirs[0]) and torch.equal(mine[1], theirs[1])
    if dtype == torch.int8:
        assert torch.equal(kw["k_scale"], kw2["k_scale"])
        assert torch.equal(kw["v_scale"], kw2["v_scale"])
    rows = sum(min(T, S - p) for p in starts_l if p >= 0)
    assert int((mine[0] != kc).any(-1).sum()) == rows * Hk


@pytest.mark.parametrize("pos", [0, 63, -1, 64], ids=["0", "S-1", "-1", "S"])
@pytest.mark.parametrize("offset", [0, 4, 1])
@pytest.mark.parametrize("Bc", [4, 6], ids=["B = Bc", "B < Bc"])
@pytest.mark.parametrize("D", [64, 128])
def test_kv_append_uniform_q8_at_both_vector_widths(gen, D, Bc, offset, pos):
    """kv_append_uniform_q8 through the row kernel at both widths (k_new
    0 or 4 bytes past a 16-byte boundary; 1 byte off is copied first), D
    64 and 128, 4 rows of a cache of 4 or 6, at positions 0 and S - 1 and
    at -1 and S on the device, which write nothing.  Bytes and scales
    bit-exact against the plain version, nothing else written."""
    L, B, Hk, S, layer = 2, 4, 4, 64, 1
    kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    kn, ksn = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen,
                                      device="cuda"))
    vn, vsn = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen,
                                      device="cuda"))
    kn = _at_offset(kn, offset)
    base = (kc, vc, ks, vs)
    mine, theirs = [t.clone() for t in base], [t.clone() for t in base]
    before = ka.kv_append_uniform_q8.launches
    got = ka.kv_append_uniform_q8(*mine, kn, vn, ksn, vsn, torch.tensor(
        [pos], device="cuda", dtype=torch.int32), layer)
    assert ka.kv_append_uniform_q8.launches == before + 1
    assert all(g is m for g, m in zip(got, mine))
    inside = 0 <= pos < S
    if inside:
        ka.kv_append_uniform_q8_plain(*theirs, kn, vn, ksn, vsn, pos, layer)
    for g, r in zip(mine, theirs):
        assert torch.equal(g, r)
    assert int((mine[0] != kc).any(-1).sum()) == (B * Hk if inside else 0)


@pytest.mark.parametrize("site", ["ragged_t bf16", "ragged_t int8",
                                  "uniform_q8"])
def test_contiguous_row_appends_replay_in_a_cuda_graph(gen, site):
    """kv_append_ragged_t (a window of 5) and kv_append_uniform_q8 captured
    in a CUDA graph (they read the starts / the position on the device),
    replayed after the starts or position tensor and the new rows change
    in place, write at the new places: the same caches as the eager call
    there."""
    L, Bc, Hk, S, D, layer = 2, 6, 4, 64, 128, 1
    quant = site != "ragged_t bf16"
    ragged = site.startswith("ragged_t")
    B, T = (6, 5) if ragged else (4, 1)
    if quant:
        (kc, ks), (vc, vs) = (_int8_cache(gen, L, Bc, Hk, S, D)
                              for _ in range(2))
        base = [kc, vc, ks, vs]
    else:
        base = [_bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)]

    def rows():
        kn, vn = _bf16(gen, B, T, Hk, D), _bf16(gen, B, T, Hk, D)
        if not quant:
            return [kn, vn]
        (kq, ks), (vq, vs) = quantize_kv(kn), quantize_kv(vn)
        return [kq, vq, ks, vs]

    new = rows()
    if ragged:
        plans = ([0, 7, 63, -1, 30, 59], [5, -1, 0, 60, 12, 40])
        at = torch.tensor([3, 3, 3, 3, 3, 3], device="cuda",
                          dtype=torch.int32)
    else:
        plans = ([17], [63], [0])
        at = torch.tensor([5], device="cuda", dtype=torch.int32)

    def append(st, where):
        if not ragged:
            return ka.kv_append_uniform_q8(*st, *new, where, layer)
        kw = dict(k_scale=st[2], v_scale=st[3], ks_new=new[2],
                  vs_new=new[3]) if quant else {}
        return ka.kv_append_ragged_t(st[0], st[1], new[0], new[1], where,
                                     layer, **kw)

    state = [t.clone() for t in base]
    append(state, at)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        append(state, at)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        append(state, at)
    for where in plans:
        at.copy_(torch.tensor(where, device="cuda", dtype=torch.int32))
        for t, f in zip(new, rows()):
            t.copy_(f)
        for t, b in zip(state, base):
            t.copy_(b)
        graph.replay()
        eager = [t.clone() for t in base]
        append(eager, at)
        torch.cuda.synchronize()
        for g, e in zip(state, eager):
            assert torch.equal(g, e), where
        written = sum(min(T, S - p) for p in where if p >= 0) * (
            1 if ragged else B)
        assert int((state[0] != base[0]).any(dim=-1).sum()) == written * Hk


def test_contiguous_row_append_c_guard_refuses_bad_plans(gen):
    """The C launchers of kv_append_ragged_t and kv_append_uniform_q8 check
    the plan they are given against the shapes and return
    cudaErrorInvalidValue (1) for a vector of 8 bytes, 16-byte vectors over
    a k_new 4 bytes off, blocks of 256 threads, too few or too many
    blocks, no starts or position, a scale missing (and, for the INT8
    append, all of them); the planned calls return 0."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    L, Bc, B, T, Hk, S, D = 2, 4, 2, 5, 2, 64, 128
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    kn, vn = _bf16(gen, B, T, Hk, D), _bf16(gen, B, T, Hk, D)
    off = _at_offset(kn, 4)
    starts = torch.tensor([0, 20], device="cuda", dtype=torch.int32)
    sc = torch.ones((L, Bc, Hk, S), device="cuda")
    st = cuda_lib.stream_handle(kc.device)

    def ragged(plan, new=kn, starts_ptr=starts.data_ptr(),
               scales=(None,) * 4):
        return lib.qie_kv_append_ragged_t(
            kc.data_ptr(), vc.data_ptr(), scales[0], scales[1],
            new.data_ptr(), vn.data_ptr(), scales[2], scales[3], starts_ptr,
            L, Bc, B, T, Hk, S, D, 2, 1, *plan, st)

    good = ka.plan_paged_append(B, T, Hk, D, 2, True)
    assert good == (16, 128, 3)    # 2 x 5 x 2 head rows of 16 vectors
    for bad in [(8, 128, 5), (16, 256, 2), (16, 128, 2), (16, 128, 4),
                (4, 128, 9), (4, 128, 11)]:
        assert ragged(bad) == 1, bad
    assert ragged(good, new=off) == 1
    assert ragged(good, starts_ptr=None) == 1
    assert ragged(good, scales=(sc.data_ptr(), sc.data_ptr(), None,
                                sc.data_ptr())) == 1
    assert ragged((4, 128, 10), new=off) == 0
    assert ragged(good) == 0
    k8, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    q, qs = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen,
                                    device="cuda"))
    pos = torch.tensor([9], device="cuda", dtype=torch.int32)
    scales = (ks.data_ptr(), ks.data_ptr(), qs.data_ptr(), qs.data_ptr())

    def q8(plan, pos_ptr=pos.data_ptr(), scales=scales):
        return lib.qie_kv_append_q8(
            k8.data_ptr(), k8.data_ptr(), scales[0], scales[1], q.data_ptr(),
            q.data_ptr(), scales[2], scales[3], pos_ptr, L, Bc, B, Hk, S, D,
            1, *plan, st)

    good = ka.plan_paged_append(B, 1, Hk, D, 1, True)
    assert good == (16, 128, 1)    # 2 x 2 head rows of 8 vectors
    for bad in [(8, 128, 1), (16, 256, 1), (16, 128, 2), (4, 128, 2)]:
        assert q8(bad) == 1, bad
    assert q8(good, pos_ptr=None) == 1
    assert q8(good, scales=(None,) * 4) == 1
    assert q8(good, scales=scales[:3] + (None,)) == 1
    assert q8((4, 128, 1)) == 0
    assert q8(good) == 0
    torch.cuda.synchronize()


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


def _bf16_split_edges(S, span):
    """Key positions 0, on each side of the 64-key tile and of the first
    two split edges, and S - 1."""
    return sorted({n for n in (0, 63, 64, 65, span - 1, span, span + 1,
                               2 * span - 1, 2 * span, 2 * span + 1, S - 1)
                   if 0 <= n < S})


def _bits(t):
    """bf16 as int16, so NaN compares equal to itself."""
    return t.view(torch.int16)


def _appending_case(gen, L, B, Bc, Hk, G, D, S, layer, pos):
    """One appending call at ``pos`` against its plain version, with NaN at
    and past the position in every row of the kernel's cache and in the
    rows past B: within 2e-2, finite, the row at ``pos`` equal to k_new /
    v_new bit for bit and every other cache byte untouched, two calls bit
    for bit with one launch counted each, and the fresh kernel over the
    written cache at old lengths ``pos`` bit-identical.  Returns the
    output."""
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    lens = [pos] * B + [0] * (Bc - B)
    kbad, vbad = _nan_from(kc, lens), _nan_from(vc, lens)
    want_k, want_v = kbad.clone(), vbad.clone()
    want_k[layer, :B, :, pos] = kn[:, 0]
    want_v[layer, :B, :, pos] = vn[:, 0]
    before = da.decode_attention_appending.launches
    got, gk, gv = da.decode_attention_appending(q, kbad, vbad, kn, vn, layer,
                                                pos)
    again, _, _ = da.decode_attention_appending(q, kbad, vbad, kn, vn, layer,
                                                pos)
    assert da.decode_attention_appending.launches == before + 2
    assert gk is kbad and gv is vbad
    assert torch.equal(_bits(kbad), _bits(want_k)), pos
    assert torch.equal(_bits(vbad), _bits(want_v)), pos
    assert torch.equal(got, again), pos
    assert got.shape == q.shape and bool(got.isfinite().all()), pos
    ref, _, _ = da.decode_attention_appending_plain(q, kc.clone(), vc.clone(),
                                                    kn, vn, layer, pos)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, (pos, err)
    fresh = da.decode_attention_contiguous_fresh(
        q, kbad, vbad, kn, vn, layer,
        torch.full((B,), pos, dtype=torch.int32, device="cuda"))
    assert torch.equal(fresh, got), pos
    return got


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("S", [256, 2304])
def test_decode_attention_appending_split_matches_plain(gen, S, B, G, D):
    """The split-S tensor-core appending decode (plan_decode_split's span)
    at positions 0, on each side of the 64-key tile and of the split edges,
    and S - 1, B smaller than the cache batch: as _appending_case holds
    it."""
    L, Hk, layer = 2, 2, 1
    span, splits = da.plan_decode_split(B, Hk, S)
    assert splits > 1 and (splits - 1) * span < S <= splits * span
    for pos in _bf16_split_edges(S, span):
        _appending_case(gen, L, B, B + 2, Hk, G, D, S, layer, pos)


def _fresh_split_lengths(S, span, B):
    """Batches of B old lengths that together hold every
    _bf16_split_edges position and S (a fresh key past every split where
    splits * span == S)."""
    edges = _bf16_split_edges(S, span) + [S]
    return [[edges[(i + j) % len(edges)] for j in range(B)]
            for i in range(0, len(edges), B)]


def _fresh_case(gen, L, B, Bc, Hk, G, D, S, layer, lens):
    """One fresh call at old lengths ``lens`` against its plain version,
    with NaN at and past each old length and in the rows past B: within
    2e-2, finite, the caches untouched, two calls bit for bit with one
    launch counted each."""
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    kbad = _nan_from(kc, list(lens) + [0] * (Bc - B))
    vbad = _nan_from(vc, list(lens) + [0] * (Bc - B))
    k0, v0 = kbad.clone(), vbad.clone()
    old = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = da.decode_attention_contiguous_fresh.launches
    got = da.decode_attention_contiguous_fresh(q, kbad, vbad, kn, vn, layer,
                                               old)
    again = da.decode_attention_contiguous_fresh(q, kbad, vbad, kn, vn, layer,
                                                 old)
    assert da.decode_attention_contiguous_fresh.launches == before + 2
    assert torch.equal(got, again), lens
    assert torch.equal(_bits(kbad), _bits(k0)), lens
    assert torch.equal(_bits(vbad), _bits(v0)), lens
    assert got.shape == q.shape and bool(got.isfinite().all()), lens
    ref = da.decode_attention_contiguous_fresh_plain(q, kc, vc, kn, vn, layer,
                                                     old)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2, (lens, err)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("S", [256, 2304])
def test_fresh_decode_attention_split_matches_plain(gen, S, B, G, D):
    """The split-S tensor-core fresh decode at old lengths 0, on each side
    of the 64-key tile and of the split edges, S - 1 and S (at S 256 and
    2304 the plan's splits end at S, so the last split takes that fresh
    key), B smaller than the cache batch: as _fresh_case holds it."""
    L, Hk, layer = 2, 2, 1
    span, splits = da.plan_decode_split(B, Hk, S)
    assert splits > 1
    for lens in _fresh_split_lengths(S, span, B):
        _fresh_case(gen, L, B, B + 2, Hk, G, D, S, layer, lens)


@pytest.mark.parametrize("kind", ["appending", "fresh"])
def test_bf16_decodes_at_the_default_dispatch_batch(gen, kind):
    """B 192 of Qwen2.5-7B's heads (Hk 4, G 7, D 128) at S 512, the
    batch-192 default dispatch: the plan has one split, so the kernel
    writes its output directly (no merge launch); positions 0, 63, 64, 65,
    257 and S - 1, and old lengths cycling through them and S."""
    L, B, Hk, G, D, S, layer = 2, 192, 4, 7, 128, 512, 1
    assert da.plan_decode_split(B, Hk, S)[1] == 1
    edges = [0, 63, 64, 65, 257, S - 1]
    if kind == "appending":
        for pos in edges:
            _appending_case(gen, L, B, B, Hk, G, D, S, layer, pos)
    else:
        lens = [(edges + [S])[i % 7] for i in range(B)]
        _fresh_case(gen, L, B, B, Hk, G, D, S, layer, lens)


@pytest.mark.parametrize("S,B", [(256, 4), (512, 192)])
def test_decode_attention_appending_past_the_cache_writes_nothing(gen, S, B):
    """A device position at or past S (or below 0) attends nothing and
    writes nothing: output 0, every cache byte untouched, on the split path
    (B 4) and the one-split path (B 192)."""
    L, Hk, G, D, layer = 2, 4, 7, 128, 1
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    k0, v0 = kc.clone(), vc.clone()
    for p in (S, S + 100, -1):
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        got, _, _ = da.decode_attention_appending(q, kc, vc, kn, vn, layer,
                                                  pos)
        torch.cuda.synchronize()
        assert bool((got == 0).all()), p
        assert torch.equal(kc, k0) and torch.equal(vc, v0), p


def test_decode_attention_appending_replays_in_a_cuda_graph(gen):
    """One appending call captured in a CUDA graph with its position a
    device tensor (the plan reads nothing from the device), replayed after
    the position is changed in place, equals the eager call at the new
    position bit for bit, output and caches, at check_decode's shape (B 4,
    S 1024, Qwen2.5-7B's heads)."""
    L, B, Hk, G, D, S, layer = 2, 4, 4, 7, 128, 1024, 1
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    kg, vg, ke, ve = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    pos = torch.tensor([999], dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention_appending(q, kg, vg, kn, vn, layer, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _, _ = da.decode_attention_appending(q, kg, vg, kn, vn,
                                                       layer, pos)
    da.decode_attention_appending(q, ke, ve, kn, vn, layer, 999)
    for p in (500, 64):
        pos.fill_(p)
        captured.zero_()
        graph.replay()
        eager, _, _ = da.decode_attention_appending(q, ke, ve, kn, vn, layer,
                                                    p)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager), p
        assert torch.equal(kg, ke) and torch.equal(vg, ve), p


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
    # at Mb <= 64 the matmul blocks are quant_matmul4's body on its plan
    # and its reduce: its bits; above 64 rows the dense kernel takes 128-row
    # tiles, and the two agree by the W4A16 rule
    dense = qm.quant_matmul4(x, wq, ws, layer, gs)
    if Mb <= 64:
        assert torch.equal(y, dense)
    else:
        assert (y.float() - dense.float()).abs().max().item() <= tol
    # the attention blocks are fused_attn_mlp's, bit for bit, beside any MLP
    Kf, Ff = MLP_SHAPES["tiny"]
    w = _mlp_weights(gen, L, Kf, Ff, 128, 128)
    attn_mlp, _ = fs.fused_attn_mlp(lens, layer, 0, q, kbad, vbad,
                                    _bf16(gen, 8, Kf), *w, gs_gate=128,
                                    gs_down=128, row0=row0)
    assert torch.equal(attn, attn_mlp)


def test_fused_attn_matmul_replays_in_a_cuda_graph(gen):
    """fused_attn_matmul at the probe's shapes (its split plan: the matmul
    blocks, then the reduce) captured in a CUDA graph and replayed equals
    the eager call, after q, x and the lengths change in place."""
    Ba, Bc, Hk, G, S, Mb, K, N, gs = ATTN_MM_SHAPES["probe"]
    L, D, layer = 2, 128, 1
    assert fs.plan_fused_attn_matmul(Mb, K, N, gs)[1] > 1
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    lens = torch.full((Ba,), S - 7, device="cuda", dtype=torch.int32)
    q, x = _bf16(gen, Ba, 1, Hk * G, D), _bf16(gen, Mb, K)
    wq = torch.randint(-128, 128, (L, K // 2, N), generator=gen,
                       device="cuda", dtype=torch.int8)
    ws = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01

    def call():
        return fs.fused_attn_matmul(lens, layer, q, kc, vc, x, wq, ws,
                                    group_size=gs, row0=Bc - Ba)

    call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for n in (S, 1, 333):
        lens.fill_(n)
        q.copy_(_bf16(gen, Ba, 1, Hk * G, D))
        x.copy_(_bf16(gen, Mb, K))
        graph.replay()
        eager = call()
        torch.cuda.synchronize()
        assert torch.equal(captured[0], eager[0]), n
        assert torch.equal(captured[1], eager[1]), n


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
