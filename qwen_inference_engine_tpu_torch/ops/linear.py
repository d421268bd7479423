"""Linear layers: bf16 and INT4-quantized, and the plain quantized matmul.

Weights are stored pre-transposed ``[in, out]`` (``[L, in, out]`` when
stacked over layers), as in the JAX package, so one packer's output feeds
both packages byte for byte.

INT4 packing layout (plane packing): scale groups along the reduction
axis are packed in adjacent pairs — packed byte row ``p*G + r`` holds
logical row ``p*2G + r`` (group ``2p``, LOW nibble) and ``p*2G + G + r``
(group ``2p+1``, HIGH nibble), with byte encoding ``byte = 16*hi + (lo+8)``
(hi two's-complement, lo excess-8; byte range exactly [-128, 127]).
Unpack is 3 int ops: ``lo+8 = byte & 0xF`` and
``hi = (byte - (byte & 0xF)) >> 4`` (arithmetic shift).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Linear:
    """Dense weight ``[in, out]`` (or ``[L, in, out]``) plus optional bias."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


@dataclasses.dataclass
class QuantLinear:
    """Quantized dense layer.

    q: int8. For bits=8: ``[.., in, out]`` values in [-127,127].
       For bits=4: ``[.., in//2, out]`` packed nibbles (module docstring).
    scales: ``[.., in//group_size, out]`` float32 dequant scales.
    ``in`` may exceed the model's width: the quantizer pads the reduction
    axis (quant/quantize.py), and the matmul zero-pads x to match.
    """

    q: torch.Tensor
    scales: torch.Tensor
    b: Optional[torch.Tensor]
    bits: int
    group_size: int

    @property
    def in_features(self) -> int:
        k = self.q.shape[-2]
        return k * 2 if self.bits == 4 else k

    @property
    def out_features(self) -> int:
        return self.q.shape[-1]

    def layer_slice(self, layer: int) -> "QuantLinear":
        """Layer ``layer`` of a stacked weight, without its bias (views)."""
        return QuantLinear(q=self.q[layer], scales=self.scales[layer], b=None,
                           bits=self.bits, group_size=self.group_size)


def unpack_nibbles(packed: torch.Tensor):
    """(low, high) signed int4 planes of ``byte = 16*hi + (lo+8)``."""
    p32 = packed.to(torch.int32)
    l8 = p32 & 0xF
    lo = l8 - 8
    hi = (p32 - l8) >> 4
    return lo.to(torch.int8), hi.to(torch.int8)


def unpack_int4(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Unpack ``[.., K//2, N]`` int8 nibbles to ``[.., K, N]`` int8 in [-8, 7].

    Inverse of quant.quantize.pack_int4 (group-pair layout).
    """
    kh, n = packed.shape[-2], packed.shape[-1]
    g = group_size
    lo, hi = unpack_nibbles(packed)
    lead = packed.shape[:-2]
    lo = lo.reshape(*lead, kh // g, 1, g, n)
    hi = hi.reshape(*lead, kh // g, 1, g, n)
    out = torch.cat([lo, hi], dim=-3)  # [..., pairs, 2, g, n]
    return out.reshape(*lead, kh * 2, n)


def dequantize(lin: QuantLinear) -> torch.Tensor:
    """Materialize the bf16 weight ``[.., in, out]``."""
    if lin.bits == 8:
        q = lin.q
    elif lin.bits == 4:
        q = unpack_int4(lin.q, lin.group_size)
    else:
        raise ValueError(f"bits={lin.bits}")
    k, n = q.shape[-2], q.shape[-1]
    groups = lin.scales.shape[-2]
    lead = q.shape[:-2]
    qg = q.reshape(*lead, groups, k // groups, n).float()
    w = qg * lin.scales[..., :, None, :]
    return w.reshape(*lead, k, n).to(torch.bfloat16)


def quant_matmul(x: torch.Tensor, lin: QuantLinear,
                 act_bits: int = 0, amax_group=None) -> torch.Tensor:
    """Plain dequant matmul of one layer's ``lin`` (the counterpart of the
    JAX package's ``_quant_matmul_xla``).

    ``y = sum_g (x_g @ q_g) * s_g`` in fp32; ``act_bits=8`` first applies
    the per-token int8 activation quantization of the W4A8/W8A8 kernels
    (``ops/quant_matmul.quantize_activations``) and multiplies the row
    scale back at the end (each token's scale over ``amax_group``'s whole
    row where one is given).
    """
    q = lin.q if lin.bits == 8 else unpack_int4(lin.q, lin.group_size)
    k, n = q.shape
    groups = lin.scales.shape[0]
    gs = k // groups
    lead = x.shape[:-1]
    if x.shape[-1] < k:  # quantizer-padded reduction axis
        x = torch.nn.functional.pad(x, (0, k - x.shape[-1]))
    out_dtype = x.dtype
    sx = None
    if act_bits == 8:
        from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
            quantize_activations,
        )

        x, sx = quantize_activations(x, amax_group)
    xg = x.reshape(-1, groups, gs).float()
    wg = q.reshape(groups, gs, n).float() * lin.scales[:, None, :]
    y = torch.einsum("mgk,gkn->mn", xg, wg)
    if sx is not None:
        y = y * sx.reshape(-1, 1)
    return y.reshape(*lead, n).to(out_dtype)


def apply_linear(x: torch.Tensor, lin, layer: Optional[int] = None,
                 act_bits: int = 0, amax_group=None) -> torch.Tensor:
    """``x [..., in] @ lin -> [..., out]`` for Linear or QuantLinear.

    For a layer-stacked weight pass ``layer``: a QuantLinear is handed to
    ``ops/quant_matmul.quant_matmul_stacked``, which indexes the stacked
    weights without copying them (the CUDA kernel takes the layer index).
    ``act_bits=8`` (QuantLinear only) quantizes activations per token;
    ``amax_group``: ``x`` is this rank's K shard of a row-parallel
    projection and each token's scale is taken over the whole row.
    """
    stacked = layer is not None
    if isinstance(lin, Linear):
        w = lin.w[layer] if stacked else lin.w
        y = torch.matmul(x, w.to(x.dtype))
    elif isinstance(lin, QuantLinear):
        from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
            quant_matmul_stacked,
        )

        if stacked:
            y = quant_matmul_stacked(x, lin, layer, act_bits=act_bits,
                                     amax_group=amax_group)
        else:
            y = quant_matmul_stacked(
                x, dataclasses.replace(lin, q=lin.q[None],
                                       scales=lin.scales[None]),
                0, act_bits=act_bits, amax_group=amax_group)
    else:
        raise TypeError(f"not a linear: {type(lin)}")
    if lin.b is not None:
        b = lin.b[layer] if stacked else lin.b
        y = y + b.to(y.dtype)
    return y
