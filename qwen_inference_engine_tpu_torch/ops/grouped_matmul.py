"""Grouped (MoE expert) quantized matmuls: INT4 / INT8 expert stacks.

``y[M, N] = xs[M, K] @ dequant(Wq[layer, e])`` where the rows of ``xs`` are
(token, expert) pairs sorted by expert id and ``group_sizes[e]`` rows
belong to expert ``e`` (the layout ``models/qwen.moe_mlp`` builds).  Three
CUDA kernels of ``csrc/grouped_matmul.cu``, each the port of one Pallas
kernel of the JAX package's ``ops/grouped_matmul.py``, each with its plain
PyTorch version beside it, all three on the dense matmuls' tensor-core
body with the row tile ``plan_grouped_matmul`` picks:

* ``grouped_matmul4``: bf16 activations x INT4 plane-pair experts
  (W4A16, ``_grouped_matmul4``);
* ``grouped_matmul4_a8``: per-token int8 activations x INT4 experts
  (W4A8, ``_grouped_matmul4_a8``);
* ``grouped_matmul8``: bf16 activations x INT8 experts, a scale per group
  of rows or one per column (``_grouped_matmul8``; INT8 experts never take
  int8 activations, as in the JAX package).

The stacks are ``q [L, E, K/pack, N]`` with scales ``[L, E, K/gs, N]``;
``layer`` selects the slab without a copy.  ``group_sizes [E]`` int32
stays on the device: the kernels read the expert offsets themselves, so a
card run never waits for the routing.  The plain versions (dequantize the
layer's slab, one matmul per expert over its rows) read the sizes on the
host.  A wrapper runs its plain version only for a CPU tensor; for any
other it checks types and shapes, then launches its kernel or raises.

``grouped_quant_matmul`` is the dispatcher ``moe_mlp`` calls, the
counterpart of the JAX entry point: it pads the reduction axis, quantizes
the activations per token for ``act_bits=8`` (INT4 experts only) and
routes to the kernel.  ``grouped_quant_matmul_supported`` is a copy of the
JAX package's shape gate, which decides (there and here) whether W4A8
experts quantize their activations.
"""

from __future__ import annotations

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, dequantize
from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
    quantize_activations,
)

# The JAX package's VMEM footprint model (ops/grouped_matmul.py:447-486):
# it decides which shapes its kernels take, and so which function W4A8
# experts compute; it says nothing about this card.
_VMEM_BUDGET = 14 * 1024 * 1024
_TM = 128


def _pick_bn(n: int, tm: int, weight_rows: int, *, int4: bool,
             gs: int = 0) -> int:
    """Largest 128-multiple divisor of n that fits the JAX kernels' VMEM."""
    best = 0
    temp_rows = gs if gs else weight_rows
    for d in range(1, n // 128 + 1):
        bn = 128 * d
        if n % bn:
            continue
        vmem = (weight_rows * bn * 2
                + (temp_rows * bn * 6 if int4 else 0)
                + (4 * tm * weight_rows * 2 if int4 else 0)
                + 16 * bn
                + tm * bn * 4
                + tm * bn * 2 * 2)
        if vmem <= _VMEM_BUDGET and bn > best:
            best = bn
    return best


def grouped_quant_matmul_supported(qe: QuantLinear, n_rows: int) -> bool:
    """The JAX package's shape gate for its grouped kernels (qe: an expert
    stack).  W4A8 experts quantize their activations only where it holds."""
    k = qe.in_features
    n = qe.out_features
    gs = qe.group_size
    if n % 128 != 0:
        return False
    if qe.bits == 4:
        if k % (2 * gs) or gs % 128:
            return False
        return _pick_bn(n, _TM, gs, int4=True, gs=gs) > 0
    groups = qe.scales.shape[-2]
    if groups > 1 and (k % groups or (k // groups) % 128):
        return False
    return _pick_bn(n, _TM, min(k, 2048), int4=False) > 0


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def grouped_matmul_dense(xs: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """``xs [M, K]`` sorted by expert @ ``w [E, K', N]`` (K' >= K: the
    first K rows) per expert, in xs's dtype: one matmul per expert over its
    rows (the sizes are read on the host).  The bf16 expert stacks' path
    (the JAX package's ``jax.lax.ragged_dot``) and the plain versions'."""
    k = xs.shape[-1]
    out = xs.new_zeros((xs.shape[0], w.shape[-1]))
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n > 0:
            out[start:start + n] = xs[start:start + n] @ w[e, :k].to(xs.dtype)
        start += n
    return out


def _layer_weight(q, scales, layer: int, bits: int,
                  group_size: int) -> torch.Tensor:
    """The layer's expert slab ``[E, K, N]`` dequantized
    (``ops/linear.dequantize``: q x scale rounded to bf16)."""
    return dequantize(QuantLinear(q=q[layer], scales=scales[layer], b=None,
                                  bits=bits, group_size=group_size))


def _plain(x, q, scales, group_sizes, layer: int, bits: int, group_size: int,
           sx=None) -> torch.Tensor:
    """The dequantized slab, one f32 matmul per expert, times the row
    scale; rounded to bf16 as the kernels' output is."""
    w = _layer_weight(q, scales, layer, bits, group_size)
    y = grouped_matmul_dense(x.float(), w, group_sizes)
    if sx is not None:
        y = y * sx.reshape(-1, 1).float()
    return y.to(torch.bfloat16)


def _group_size8(q, scales) -> int:
    """The INT8 group size from the scales: K / G (G = 1: one per column)."""
    return q.shape[-2] // scales.shape[-2]


def grouped_matmul4_plain(x, q, scales, group_sizes, layer: int,
                          group_size: int) -> torch.Tensor:
    """Plain version of the W4A16 kernel: x bf16 [M, Kp]; q int8
    [L, E, Kp/2, N]; scales f32 [L, E, Kp/gs, N]; bf16 [M, N]."""
    return _plain(x, q, scales, group_sizes, layer, 4, group_size)


def grouped_matmul4_a8_plain(xq, sx, q, scales, group_sizes, layer: int,
                             group_size: int) -> torch.Tensor:
    """Plain version of the W4A8 kernel: ``bf16((xq @ W4[layer, e]) * sx)``
    per expert; xq int8 [M, Kp], sx f32 [M]."""
    return _plain(xq, q, scales, group_sizes, layer, 4, group_size, sx)


def grouped_matmul8_plain(x, q, scales, group_sizes,
                          layer: int) -> torch.Tensor:
    """Plain version of the W8A16 kernel: x bf16 [M, K]; q int8
    [L, E, K, N]; scales f32 [L, E, G, N] (G = 1: one per column)."""
    return _plain(x, q, scales, group_sizes, layer, 8, _group_size8(q, scales))


# the tensor-core body's row tiles: 16 rows (mt 1) up to this mean of rows
# per expert, 64 (mt 4) above
GROUPED_SMALL_ROWS = 16


def plan_grouped_matmul(M: int, E: int) -> int:
    """``mt`` of the three grouped kernels over ``M`` rows and ``E``
    experts: the tensor-core body's m16 tiles a warp, as ``plan_split_k``
    picks them for the dense matmuls.  1 (16-row tiles) where the mean rows
    per expert, ``ceil(M / E)``, is at most 16 (every decode step), else 4
    (64-row tiles).  The host never reads the routing: the mean is all it
    knows."""
    return 1 if -(-M // E) <= GROUPED_SMALL_ROWS else 4


plan_grouped_matmul8 = plan_grouped_matmul


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check(name: str, x, sx, q, scales, group_sizes, layer: int, *, x_dtype,
           k_per_row: int, gs_ok: bool, gs_rule: str, n_mult: int) -> None:
    """The checks every wrapper makes on a non-CPU tensor before it builds
    or launches anything."""
    if x.dim() != 2 or q.dim() != 4 or scales.dim() != 4:
        raise ValueError(f"{name} takes x [M, K], q [L, E, K/pack, N] and "
                         f"scales [L, E, G, N]")
    M, K = x.shape
    L, E, Kq, N = q.shape
    if x.dtype != x_dtype or q.dtype != torch.int8:
        raise TypeError(f"{name} takes {x_dtype} activations and int8 weights")
    if scales.dtype != torch.float32 or (
            sx is not None and sx.dtype != torch.float32):
        raise TypeError(f"{name} takes f32 scales")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 group sizes")
    G = scales.shape[2]
    if (Kq * k_per_row != K or scales.shape != (L, E, G, N) or G <= 0
            or group_sizes.shape != (E,)
            or (sx is not None and sx.shape != (M,))):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scales {tuple(scales.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}"
                         + (f", sx {tuple(sx.shape)}" if sx is not None else ""))
    if not gs_ok or K % 32 or N % n_mult:
        raise ValueError(f"{name} kernel needs {gs_rule}, K % 32 == 0 and "
                         f"N % {n_mult} == 0 (K={K}, N={N}, G={G})")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    for t in (x, q, scales, group_sizes) + ((sx,) if sx is not None else ()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")


def _out_buffer(name: str, out, M: int, N: int, device) -> torch.Tensor:
    """A wrapper's output: ``out`` checked, or a new bf16 [M, N]."""
    if out is None:
        return torch.empty((M, N), dtype=torch.bfloat16, device=device)
    if (out.shape != (M, N) or out.dtype != torch.bfloat16
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous bf16 [{M}, {N}] "
                         f"on {device}, not {out.dtype} {tuple(out.shape)}")
    return out


def _int4_gs_ok(K: int, gs: int, G: int) -> bool:
    return gs > 0 and gs % 32 == 0 and K % (2 * gs) == 0 and G == K // gs


def grouped_matmul4_a8(xq, sx, q, scales, group_sizes, layer: int,
                       group_size: int, out=None) -> torch.Tensor:
    """``bf16 [M, N]``: rows of expert e ``(xq @ W4[layer, e]) * sx`` on the
    card (W4A8); xq int8 [M, Kp] sorted by expert, sx f32 [M].  ``out``
    (a launch on the card): a bf16 [M, N] buffer to write, whose rows past
    the last group the kernel leaves as they were."""
    if xq.device.type == "cpu":
        return grouped_matmul4_a8_plain(xq, sx, q, scales, group_sizes, layer,
                                        group_size)
    name = "grouped_matmul4_a8"
    _check(name, xq, sx, q, scales, group_sizes, layer, x_dtype=torch.int8,
           k_per_row=2, n_mult=128, gs_rule="gs % 32 == 0, K % (2*gs) == 0",
           gs_ok=_int4_gs_ok(xq.shape[-1], group_size, scales.shape[2]))
    M, Kp = xq.shape
    L, E, _, N = q.shape
    out = _out_buffer(name, out, M, N, xq.device)
    if M == 0:
        return out
    rc = cuda_lib.library().qie_grouped_matmul4_a8(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), scales.data_ptr(),
        group_sizes.data_ptr(), out.data_ptr(), M, Kp, N, group_size, E,
        plan_grouped_matmul(M, E), int(layer), L,
        cuda_lib.stream_handle(xq.device))
    cuda_lib.check(rc, name)
    grouped_matmul4_a8.launches += 1
    return out


def grouped_matmul4(x, q, scales, group_sizes, layer: int,
                    group_size: int, out=None) -> torch.Tensor:
    """``bf16 [M, N]``: rows of expert e ``x @ W4[layer, e]`` on the card
    (W4A16); x bf16 [M, Kp] sorted by expert; ``out`` as
    ``grouped_matmul4_a8``'s."""
    if x.device.type == "cpu":
        return grouped_matmul4_plain(x, q, scales, group_sizes, layer,
                                     group_size)
    name = "grouped_matmul4"
    _check(name, x, None, q, scales, group_sizes, layer,
           x_dtype=torch.bfloat16, k_per_row=2, n_mult=64,
           gs_rule="gs % 32 == 0, K % (2*gs) == 0",
           gs_ok=_int4_gs_ok(x.shape[-1], group_size, scales.shape[2]))
    M, Kp = x.shape
    L, E, _, N = q.shape
    out = _out_buffer(name, out, M, N, x.device)
    if M == 0:
        return out
    rc = cuda_lib.library().qie_grouped_matmul4(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), M, Kp, N, group_size, E, plan_grouped_matmul(M, E),
        int(layer), L, cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, name)
    grouped_matmul4.launches += 1
    return out


def grouped_matmul8(x, q, scales, group_sizes, layer: int,
                    out=None) -> torch.Tensor:
    """``bf16 [M, N]``: rows of expert e ``x @ W8[layer, e]`` on the card
    (W8A16); q int8 [L, E, K, N], scales [L, E, G, N]: a scale per group of
    K/G rows, or one per column (G = 1, applied in the epilogue); ``out``
    as ``grouped_matmul4_a8``'s."""
    if x.device.type == "cpu":
        return grouped_matmul8_plain(x, q, scales, group_sizes, layer)
    name = "grouped_matmul8"
    K = x.shape[-1]
    G = scales.shape[2] if scales.dim() == 4 else 0
    _check(name, x, None, q, scales, group_sizes, layer,
           x_dtype=torch.bfloat16, k_per_row=1, n_mult=64,
           gs_rule="G == 1 or K/G % 32 == 0",
           gs_ok=G == 1 or (G > 0 and K % G == 0 and (K // G) % 32 == 0))
    M = x.shape[0]
    L, E, _, N = q.shape
    out = _out_buffer(name, out, M, N, x.device)
    if M == 0:
        return out
    rc = cuda_lib.library().qie_grouped_matmul8(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), group_sizes.data_ptr(),
        out.data_ptr(), M, K, N, G, E, plan_grouped_matmul(M, E), int(layer),
        L, cuda_lib.stream_handle(x.device))
    cuda_lib.check(rc, name)
    grouped_matmul8.launches += 1
    return out


for _w in (grouped_matmul4_a8, grouped_matmul4, grouped_matmul8):
    _w.launches = 0
del _w


# ----------------------------------------------------------------------
# Entry point
# ----------------------------------------------------------------------

def grouped_quant_matmul(xs: torch.Tensor, qe: QuantLinear,
                         group_sizes: torch.Tensor, layer=None,
                         act_bits: int = 0) -> torch.Tensor:
    """``xs [M, K]`` (rows sorted by expert) @ an expert stack -> [M, N].

    ``qe.q`` is single-layer ``[E, K/pack, N]`` or stacked
    ``[L, E, K/pack, N]`` with ``layer`` an int.  ``act_bits=8`` (INT4
    experts only; the caller applies the shape gate) quantizes xs per token
    first.  CPU: weight-only experts run the plain version in xs's dtype
    (the JAX package's dequantize + ``ragged_dot``), W4A8 the plain version
    of its kernel; otherwise the kernel of the pair, on bf16 activations.
    """
    stacked = qe.q.dim() == 4
    q = qe.q if stacked else qe.q[None]
    scales = qe.scales if stacked else qe.scales[None]
    layer = int(layer) if stacked else 0
    gsz = group_sizes.to(torch.int32).contiguous()
    k_x = xs.shape[-1]
    kp = qe.in_features
    if k_x > kp:
        raise ValueError(f"xs has K={k_x} > the experts' {kp}")
    a8 = act_bits == 8 and qe.bits == 4
    if xs.device.type == "cpu" and not a8:
        w = _layer_weight(q, scales, layer, qe.bits, qe.group_size)
        return grouped_matmul_dense(xs, w, gsz)
    x2 = xs.to(torch.bfloat16)
    if kp != k_x:  # quantizer-padded reduction axis
        x2 = torch.nn.functional.pad(x2, (0, kp - k_x))
    x2 = x2.contiguous()
    if a8:
        xq, sx = quantize_activations(x2)
        y = grouped_matmul4_a8(xq, sx.reshape(-1).contiguous(), q, scales,
                               gsz, layer, qe.group_size)
    elif qe.bits == 4:
        y = grouped_matmul4(x2, q, scales, gsz, layer, qe.group_size)
    else:
        y = grouped_matmul8(x2, q, scales, gsz, layer)
    return y.to(xs.dtype)
