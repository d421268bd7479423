"""Rotary position embeddings (rotate-half / NeoX convention, as HF Qwen)."""

from __future__ import annotations

from typing import Tuple

import torch


def precompute_rope(max_position: int, head_dim: int, theta: float,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape [max_position, head_dim] (fp32).

    Frequencies ``theta^(-2i/d)`` duplicated across both halves, matching HF
    ``emb = cat(freqs, freqs)``.
    """
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) * 2.0 / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    pos = torch.arange(max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)  # [S, half]
    emb = torch.cat([freqs, freqs], dim=-1)  # [S, d]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos_table: torch.Tensor,
               sin_table: torch.Tensor) -> torch.Tensor:
    """Rotate q or k by absolute position.

    x: [B, T, heads, head_dim]; positions: [B, T] integer.
    Rotation in fp32, result cast back to x.dtype.
    """
    cos = cos_table[positions][:, :, None, :]  # [B, T, 1, d]
    sin = sin_table[positions][:, :, None, :]
    xf = x.float()
    out = xf * cos + _rotate_half(xf) * sin
    return out.to(x.dtype)
