"""INT8 KV-cache quantization (per-token, per-head absmax scales).

The port's own copy of the JAX package's ``quant/kv_quant.py`` scheme:
``scale = max|x| / 127`` over each written key / value head vector, and
``q = clip(round(x / scale), -127, 127)`` with a zero scale read as 1.  The
division (not a multiplication by the reciprocal) and round-half-to-even
make the int8 bytes and the scales bit-identical to the JAX function's on
the same f32 input.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] float -> (int8 [..., D], f32 scale [...])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """(int8 [..., D], f32 [...]) -> float [..., D]."""
    return (q.float() * scale[..., None]).to(dtype)
