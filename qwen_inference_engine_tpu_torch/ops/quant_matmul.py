"""Quantized matmuls: INT4 / INT8 weights with bf16 or per-token int8
activations.

Four CUDA kernels of ``csrc/quant_matmul.cu``, each the port of one Pallas
kernel of the JAX package's ``ops/quant_matmul.py``, and each with a plain
PyTorch version beside it:

* ``quant_matmul4_a8``: int8 activations x INT4 plane-pair weights (W4A8,
  ``_quant_matmul4_a8``);
* ``quant_matmul4``: bf16 activations x INT4 plane-pair weights (W4A16,
  ``_quant_matmul4``);
* ``quant_matmul8``: bf16 activations x INT8 weights, a scale per group of
  rows or one per column (W8A16, ``_quant_matmul8``);
* ``quant_matmul8_a8``: int8 activations x INT8 weights (W8A8,
  ``_quant_matmul8_a8``).

All four run on one tensor-core kernel; at M <= 64 it splits K across
blocks as ``plan_split_k`` plans it, with the partial sums in a workspace
the wrapper allocates.  ``quant_matmul_stacked`` is the
dispatcher the model calls: it pads the reduction axis, quantizes the
activations per token outside the kernel for the a8 variants (as the JAX
package does), and routes each ``(bits, act_bits)`` pair to its kernel.  A wrapper runs its plain version only for
a CPU tensor; for any other it checks types and shapes, then launches its
kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, quant_matmul


def quantize_activations(x: torch.Tensor):
    """Per-row (= per-token) symmetric int8 quantization of ``x [..., K]``.

    Returns ``(q int8 [..., K], scale f32 [..., 1])`` with ``x ~= q * scale``.
    """
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(ax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return q, sx


def _plain(x, q, scales, layer: int, bits: int, group_size: int,
           sx=None) -> torch.Tensor:
    """``bf16(sum_g (x_g @ q_g[layer]) * s_g [* sx])`` in f32 (int products
    of the a8 variants are exact in f32 while |sum| < 2^24)."""
    one = QuantLinear(q=q[layer], scales=scales[layer], b=None, bits=bits,
                      group_size=group_size)
    y = quant_matmul(x.float(), one)
    if sx is not None:
        y = y * sx.reshape(-1, 1).float()
    return y.to(torch.bfloat16)


def _group_size8(q, scales) -> int:
    """The INT8 group size from the scales: K / G (G = 1: one per column)."""
    return q.shape[1] // scales.shape[1]


def quant_matmul4_a8_plain(xq, sx, q, scales, layer: int,
                           group_size: int) -> torch.Tensor:
    """Plain version of the W4A8 kernel: ``bf16((xq @ W4[layer]) * sx)``.

    xq int8 [M, Kp]; sx f32 [M]; q int8 [L, Kp/2, N]; scales f32
    [L, Kp/gs, N]."""
    return _plain(xq, q, scales, layer, 4, group_size, sx)


def quant_matmul4_plain(x, q, scales, layer: int,
                        group_size: int) -> torch.Tensor:
    """Plain version of the W4A16 kernel: ``bf16(x @ W4[layer])``.

    x bf16 [M, Kp]; q int8 [L, Kp/2, N]; scales f32 [L, Kp/gs, N]."""
    return _plain(x, q, scales, layer, 4, group_size)


def quant_matmul8_plain(x, q, scales, layer: int) -> torch.Tensor:
    """Plain version of the W8A16 kernel: ``bf16(x @ W8[layer])``.

    x bf16 [M, K]; q int8 [L, K, N]; scales f32 [L, G, N] (G = K / gs, or
    1 for one scale per column)."""
    return _plain(x, q, scales, layer, 8, _group_size8(q, scales))


def quant_matmul8_a8_plain(xq, sx, q, scales, layer: int) -> torch.Tensor:
    """Plain version of the W8A8 kernel: ``bf16((xq @ W8[layer]) * sx)``."""
    return _plain(xq, q, scales, layer, 8, _group_size8(q, scales), sx)


def _check(name: str, x, sx, q, scales, layer: int, *, x_dtype, k_per_row,
           gs: int, gs_rule: str, gs_ok: bool, n_mult: int) -> None:
    """The checks every wrapper makes on a non-CPU tensor before it builds
    or launches anything."""
    M, K = x.shape
    L, Kq, N = q.shape
    if x.dtype != x_dtype or q.dtype != torch.int8:
        raise TypeError(f"{name} takes {x_dtype} activations and int8 weights")
    if scales.dtype != torch.float32 or (
            sx is not None and sx.dtype != torch.float32):
        raise TypeError(f"{name} takes f32 scales")
    G = scales.shape[1] if scales.dim() == 3 else -1
    if (Kq * k_per_row != K or scales.shape != (L, G, N) or G <= 0
            or (sx is not None and sx.numel() != M)):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scales {tuple(scales.shape)}"
                         + (f", sx {tuple(sx.shape)}" if sx is not None else ""))
    if not gs_ok or K % 32 or N % n_mult:
        raise ValueError(f"{name} kernel needs {gs_rule}, K % 32 == 0 and "
                         f"N % {n_mult} == 0 (gs={gs}, K={K}, N={N})")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    for t in (x, q, scales) + ((sx,) if sx is not None else ()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")


# The tensor-core matmuls' decode stream: K split so
# that about 4 blocks run on each of the H100's 132 SMs (a block streams 128
# columns of its slice), slices of at least 256 weight rows (4 of the
# kernel's 64-row stages)
SPLIT_TARGET_BLOCKS = 4 * 132
SPLIT_MIN_ROWS = 256


@functools.lru_cache(maxsize=None)
def plan_split_k(M: int, rows: int, N: int, unit: int):
    """``(mt, splits, slice)`` of a tensor-core matmul of ``x [M, .]`` over
    a weight of ``rows`` rows and N columns, whose sums fold every ``unit``
    weight rows (a scale group, an INT4 plane pair, or a 64-row stage).

    M <= 64: the decode stream, ``mt`` m16 tiles a warp (1 or 4), the rows
    cut into ``splits`` slices of ``slice`` rows (the last may be shorter),
    each a multiple of ``unit``, as many as fill ``SPLIT_TARGET_BLOCKS``
    blocks of 128 columns but none under ``SPLIT_MIN_ROWS`` rows.  M > 64:
    the prefill tiles, ``(0, 1, rows)``."""
    if M > 64:
        return 0, 1, rows
    mt = 1 if M <= 16 else 4
    units = -(-rows // unit)
    tiles = -(-N // 128) * -(-M // (16 * mt))
    want = -(-SPLIT_TARGET_BLOCKS // tiles)
    per = max(-(-units // want), -(-SPLIT_MIN_ROWS // unit))
    slice_rows = min(per, units) * unit
    return mt, -(-rows // slice_rows), slice_rows


def plan_quant_matmul8_a8(M: int, K: int, N: int, G: int):
    """The INT8 kernels' plan (W8A8, and W8A16 as ``plan_quant_matmul8``)
    for ``x [M, K] @ W [K, N]`` with G scale groups (1: one scale per
    column): slices end on group boundaries (per column, on 64-row
    stages)."""
    return plan_split_k(M, K, N, 64 if G == 1 else K // G)


plan_quant_matmul8 = plan_quant_matmul8_a8


def plan_quant_matmul4_a8(M: int, Kp: int, N: int, gs: int):
    """The INT4 kernels' plan (W4A8, and W4A16 as ``plan_quant_matmul4``)
    for ``x [M, Kp] @ W4 [Kp/2, N]`` (plane pairs of gs packed rows):
    slices of whole pairs, in packed rows."""
    return plan_split_k(M, Kp // 2, N, gs)


plan_quant_matmul4 = plan_quant_matmul4_a8


def _workspace(splits: int, M: int, N: int, device, dtype):
    """The split-K partials ``[splits, M, N]``, or None for one slice."""
    if splits == 1:
        return None
    return torch.empty((splits, M, N), device=device, dtype=dtype)


def quant_matmul4_a8(xq, sx, q, scales, layer: int,
                     group_size: int) -> torch.Tensor:
    """``bf16 [M, N] = (xq [M,Kp] int8 @ W4[layer]) * sx[M]`` on the card.

    W4 is the stacked plane-pair INT4 weight ``q [L, Kp/2, N]`` with group
    scales ``[L, Kp/gs, N]``; ``layer`` selects the slab without a copy.
    At M <= 64 the split-K partials go to a workspace allocated here
    (``plan_quant_matmul4_a8``).
    """
    if xq.device.type == "cpu":
        return quant_matmul4_a8_plain(xq, sx, q, scales, layer, group_size)
    gs = group_size
    Kp = xq.shape[1]
    _check("quant_matmul4_a8", xq, sx, q, scales, layer, x_dtype=torch.int8,
           k_per_row=2, gs=gs, gs_rule="gs % 32 == 0, K % (2*gs) == 0",
           gs_ok=gs > 0 and gs % 32 == 0 and Kp % (2 * gs) == 0
           and scales.shape[1] == Kp // gs, n_mult=128)
    M, N = xq.shape[0], q.shape[2]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return out
    mt, splits, slice_rows = plan_quant_matmul4_a8(M, Kp, N, gs)
    ws = _workspace(splits, M, N, xq.device, torch.float32)
    rc = cuda_lib.library().qie_quant_matmul4_a8(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), scales.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(), M, Kp, N, gs,
        mt, splits, slice_rows, int(layer), q.shape[0],
        cuda_lib.stream_handle(xq.device))
    cuda_lib.check(rc, "quant_matmul4_a8")
    quant_matmul4_a8.launches += 1
    return out


def quant_matmul4(x, q, scales, layer: int, group_size: int) -> torch.Tensor:
    """``bf16 [M, N] = x [M,Kp] bf16 @ W4[layer]`` on the card (W4A16).

    The same stacked plane-pair INT4 layout as ``quant_matmul4_a8``; N a
    multiple of 64.  At M <= 64 the split-K partials go to a workspace
    allocated here (``plan_quant_matmul4``)."""
    if x.device.type == "cpu":
        return quant_matmul4_plain(x, q, scales, layer, group_size)
    gs = group_size
    Kp = x.shape[1]
    _check("quant_matmul4", x, None, q, scales, layer, x_dtype=torch.bfloat16,
           k_per_row=2, gs=gs, gs_rule="gs % 32 == 0, K % (2*gs) == 0",
           gs_ok=gs > 0 and gs % 32 == 0 and Kp % (2 * gs) == 0
           and scales.shape[1] == Kp // gs, n_mult=64)
    M, N = x.shape[0], q.shape[2]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    mt, splits, slice_rows = plan_quant_matmul4(M, Kp, N, gs)
    ws = _workspace(splits, M, N, x.device, torch.float32)
    rc = cuda_lib.library().qie_quant_matmul4(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(), M, Kp, N, gs,
        mt, splits, slice_rows, int(layer), q.shape[0],
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, "quant_matmul4")
    quant_matmul4.launches += 1
    return out


def _gs8_ok(K: int, G: int) -> bool:
    """INT8 scale layouts the kernels take: one per column, or groups of a
    multiple of 32 rows."""
    return G == 1 or (G > 0 and K % G == 0 and (K // G) % 32 == 0)


def quant_matmul8(x, q, scales, layer: int) -> torch.Tensor:
    """``bf16 [M, N] = x [M,K] bf16 @ W8[layer]`` on the card (W8A16).

    ``q [L, K, N]`` int8, ``scales [L, G, N]``: a scale per group of K/G
    rows, or one per column (G = 1, applied in the epilogue).  At M <= 64
    the split-K partials go to a workspace allocated here
    (``plan_quant_matmul8``)."""
    if x.device.type == "cpu":
        return quant_matmul8_plain(x, q, scales, layer)
    K = x.shape[1]
    G = scales.shape[1] if scales.dim() == 3 else 0
    _check("quant_matmul8", x, None, q, scales, layer, x_dtype=torch.bfloat16,
           k_per_row=1, gs=K // max(G, 1),
           gs_rule="G == 1 or K/G % 32 == 0", gs_ok=_gs8_ok(K, G), n_mult=64)
    M, N = x.shape[0], q.shape[2]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out
    mt, splits, slice_rows = plan_quant_matmul8(M, K, N, G)
    ws = _workspace(splits, M, N, x.device, torch.float32)
    rc = cuda_lib.library().qie_quant_matmul8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(), M, K, N, G,
        mt, splits, slice_rows, int(layer), q.shape[0],
        cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, "quant_matmul8")
    quant_matmul8.launches += 1
    return out


def quant_matmul8_a8(xq, sx, q, scales, layer: int) -> torch.Tensor:
    """``bf16 [M, N] = (xq [M,K] int8 @ W8[layer]) * sx[M]`` on the card
    (W8A8), with the scale layouts of ``quant_matmul8``.  At M <= 64 the
    split-K partials go to a workspace allocated here
    (``plan_quant_matmul8_a8``)."""
    if xq.device.type == "cpu":
        return quant_matmul8_a8_plain(xq, sx, q, scales, layer)
    K = xq.shape[1]
    G = scales.shape[1] if scales.dim() == 3 else 0
    _check("quant_matmul8_a8", xq, sx, q, scales, layer, x_dtype=torch.int8,
           k_per_row=1, gs=K // max(G, 1),
           gs_rule="G == 1 or K/G % 32 == 0", gs_ok=_gs8_ok(K, G), n_mult=128)
    M, N = xq.shape[0], q.shape[2]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return out
    mt, splits, slice_rows = plan_quant_matmul8_a8(M, K, N, G)
    ws = _workspace(splits, M, N, xq.device,
                    torch.int32 if G == 1 else torch.float32)
    rc = cuda_lib.library().qie_quant_matmul8_a8(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), scales.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(), M, K, N, G,
        mt, splits, slice_rows, int(layer), q.shape[0],
        cuda_lib.stream_handle(xq.device))
    cuda_lib.check(rc, "quant_matmul8_a8")
    quant_matmul8_a8.launches += 1
    return out


for _w in (quant_matmul4_a8, quant_matmul4, quant_matmul8, quant_matmul8_a8):
    _w.launches = 0
del _w


def quant_matmul_stacked(x: torch.Tensor, lin: QuantLinear, layer: int,
                         act_bits: int = 0) -> torch.Tensor:
    """``x [..., K] @ lin[layer] -> [..., N]`` for a layer-stacked QuantLinear.

    CPU: the plain dequant matmul (``ops/linear.quant_matmul``).  Otherwise
    each ``(bits, act_bits)`` pair goes to its kernel: (4, 8) W4A8, (4, 0)
    W4A16, (8, 0) W8A16, (8, 8) W8A8; activations in bf16, quantized per
    token for the a8 kernels."""
    if x.device.type == "cpu":
        return quant_matmul(x, lin.layer_slice(layer), act_bits=act_bits)
    if lin.bits not in (4, 8) or act_bits not in (0, 8):
        raise ValueError(f"no kernel for bits={lin.bits}, "
                         f"act_bits={act_bits}")
    k_x = x.shape[-1]
    kp = lin.in_features
    if k_x > kp:
        raise ValueError(f"x has K={k_x} > the weight's {kp}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_x).to(torch.bfloat16)
    if kp != k_x:  # quantizer-padded reduction axis
        x2 = torch.nn.functional.pad(x2, (0, kp - k_x))
    x2 = x2.contiguous()
    if act_bits == 8:
        xq, sx = quantize_activations(x2)
        sx = sx.reshape(-1).contiguous()
        if lin.bits == 4:
            y = quant_matmul4_a8(xq, sx, lin.q, lin.scales, layer,
                                 lin.group_size)
        else:
            y = quant_matmul8_a8(xq, sx, lin.q, lin.scales, layer)
    elif lin.bits == 4:
        y = quant_matmul4(x2, lin.q, lin.scales, layer, lin.group_size)
    else:
        y = quant_matmul8(x2, lin.q, lin.scales, layer)
    return y.reshape(*lead, lin.out_features).to(x.dtype)
