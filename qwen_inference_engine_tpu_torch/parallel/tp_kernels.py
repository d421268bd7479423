"""Per-projection tensor-parallel quantized matmuls.

The port's counterpart of the JAX package's ``parallel/tp_kernels.py``.
As there, no engine calls them: the engines run the whole step per rank
(``parallel/tp_step.py``'s makers), and these two stay as the separately
tested building blocks of its sharding algebra, with the guards a naive
row split needs:

* column parallel (``q / k / v / gate / up``): the weight split on its
  output axis, the activations whole on every rank, this rank's columns
  out; no collective;
* row parallel (``o / down``): the weight split on its reduction axis, the
  activations this rank's shard of K (a column-parallel output), the
  partial products summed over the model group, then the bias.

Both take the global ``QuantLinear`` (as the JAX functions do) and cut this
rank's slice; the product is the port's own dispatch
(``ops/quant_matmul.quant_matmul_stacked``: the kernels on the card, the
plain version on the CPU), at the local shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear
from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
    quant_matmul_stacked,
)
from qwen_inference_engine_tpu_torch.parallel.mesh import Mesh, all_reduce


def _stacked(lin: QuantLinear, layer: Optional[int]):
    """(stacked lin, layer index) of a stacked or single weight."""
    if layer is not None:
        return lin, layer
    return dataclasses.replace(lin, q=lin.q[None], scales=lin.scales[None],
                               b=None if lin.b is None else lin.b[None]), 0


def _cut(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    w = t.shape[dim] // parts
    return t.narrow(dim, index * w, w)


def quant_matmul_tp_column(x: torch.Tensor, lin: QuantLinear, mesh: Mesh,
                           layer: Optional[int] = None,
                           act_bits: int = 0) -> torch.Tensor:
    """``x [..., K]`` (whole on every rank) times this rank's output
    columns of ``lin``: ``[..., N / tp]``, its bias slice added."""
    tp, m = mesh.tp, mesh.coords[1]
    if lin.out_features % tp:
        raise ValueError(f"N={lin.out_features} does not split over "
                         f"tp={tp}")
    full, l = _stacked(lin, layer)
    local = dataclasses.replace(full, q=_cut(full.q, -1, m, tp).contiguous(),
                                scales=_cut(full.scales, -1, m, tp)
                                .contiguous(), b=None)
    y = quant_matmul_stacked(x, local, l, act_bits=act_bits)
    if full.b is not None:
        y = y + _cut(full.b[l], -1, m, tp).to(y.dtype)
    return y


def quant_matmul_tp_row(x: torch.Tensor, lin: QuantLinear, mesh: Mesh,
                        layer: Optional[int] = None,
                        act_bits: int = 0) -> torch.Tensor:
    """``x [..., K / tp]`` (this rank's shard of the reduction axis) times
    this rank's rows of ``lin``, summed over the model group: ``[..., N]``
    on every rank, the bias added after the sum.

    Needs an unpadded, shard-aligned quantization: the quantizer may pad
    K (``quantize_linear``'s odd-tile rule), and padded weight rows cut
    against logical-K activations misalign every shard's scale groups.
    Quantize with ``QuantConfig(pad_free=True)`` and a group size from
    ``parallel.tp_step.tp_aligned_group_size``."""
    tp, m = mesh.tp, mesh.coords[1]
    k_logical = x.shape[-1] * tp
    unit = 2 if lin.bits == 4 else 1
    if lin.in_features != k_logical:
        raise ValueError(
            f"padded-K quantization (K={lin.in_features} vs logical "
            f"{k_logical}) cannot be row-sharded; requantize pad_free")
    if (k_logical // tp) % (unit * lin.group_size):
        raise ValueError(
            f"row shards of K={k_logical} at tp={tp} straddle "
            f"group_size={lin.group_size} boundaries; use "
            f"tp_aligned_group_size")
    full, l = _stacked(lin, layer)
    local = dataclasses.replace(full, q=_cut(full.q, -2, m, tp).contiguous(),
                                scales=_cut(full.scales, -2, m, tp)
                                .contiguous(), b=None)
    y = quant_matmul_stacked(x, local, l, act_bits=act_bits)
    y = all_reduce(y, mesh.model_group)
    if full.b is not None:
        y = y + full.b[l].to(y.dtype)
    return y
