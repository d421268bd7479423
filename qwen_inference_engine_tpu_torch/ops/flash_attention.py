"""Causal GQA flash attention for fresh prefill (positions 0..T-1).

``flash_attention`` wraps the CUDA kernel ``csrc/flash_attention.cu`` (the
port of the JAX package's ``flash_attention`` / ``_flash_kernel``);
``flash_attention_plain`` beside it computes the same function with the
plain oracle.  Layout ``[B, T, H, D]`` as the projections produce it.
"""

from __future__ import annotations

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q [B, T, Hq, D], k/v [B, T, Hk, D] -> [B, T, Hq, D], causal."""
    B, T = q.shape[:2]
    positions = torch.arange(T, device=q.device)[None, :].expand(B, T)
    return gqa_attention(q, k, v, positions)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention over fresh q/k/v; returns [B, T, Hq, D].

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (bf16, D in {64, 128}) or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    B, T, Hq, D = q.shape
    Hk = k.shape[2]
    if k.shape != (B, T, Hk, D) or v.shape != k.shape or Hq % Hk:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes D in (64, 128), not {D}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError("flash_attention takes bf16 tensors on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, T, Hq, Hk, D, D ** -0.5, cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
