"""RMSNorm and per-head QK-norm (plain PyTorch; bandwidth-trivial)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Row-wise RMS normalization with learned scale.

    HF Qwen2RMSNorm semantics: variance in fp32, the normalized value is
    cast back to the input dtype *before* the weight multiply.
    """
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(dtype)
    return normed * weight.to(dtype)


def qk_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMSNorm over head_dim (Qwen3's q_norm/k_norm).

    x: [..., heads, head_dim]; weight: [head_dim].
    """
    return rms_norm(x, weight, eps)
