"""Contiguous KV cache ``[L, B, Hk, S, D]`` and its plain stacked writes.

Head-major, as in the JAX package, so the attention kernels read one
(row, KV head) slab of ``S x D`` contiguously.  ``S`` is rounded up to 256.
The cache is updated in place (the JAX package's donated scan carry).

An int8 cache (INT8 KV) also holds per-token-per-head f32 scales
``[L, B, Hk, S]``; ``KVCache.write`` quantizes the fresh rows with
``quantize_kv`` and stores the bytes and the scales through the same plain
write, as the JAX package's ``_write_cache_stacked`` does.  The paged cache
comes in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv


@dataclasses.dataclass
class KVCache:
    """Contiguous cache: k/v ``[L, B, Hk, S, D]``; k_scale/v_scale
    ``[L, B, Hk, S]`` f32 when the dtype is int8, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        max_seq = -(-max_seq // 256) * 256
        shape = (num_layers, batch, num_kv_heads, max_seq, head_dim)
        quant = dtype == torch.int8

        def scales():
            return torch.zeros(shape[:-1], dtype=torch.float32, device=device)

        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       k_scale=scales() if quant else None,
                       v_scale=scales() if quant else None)

    def write(self, layer: int, k: torch.Tensor, v: torch.Tensor,
              writer: Callable[[torch.Tensor, int, torch.Tensor], None]
              ) -> None:
        """Store this layer's fresh ``k / v [B, T, Hk, D]`` with ``writer
        (cache_tensor, layer, new)`` (one of the ``write_*_stacked`` below,
        its positions bound).  An int8 cache stores the quantized bytes, and
        the scales through the same writer on a trailing unit axis."""
        if not self.quantized:
            writer(self.k, layer, k)
            writer(self.v, layer, v)
            return
        for cache, scales, new in ((self.k, self.k_scale, k),
                                   (self.v, self.v_scale, v)):
            q, s = quantize_kv(new)
            writer(cache, layer, q)
            writer(scales[..., None], layer, s[..., None])


def kv_dtype_from_bits(bits: int) -> torch.dtype:
    """KV cache dtype for a ``--kv-bits`` flag: 8 -> int8 (with scales),
    32 -> float32 (CPU runs and tests), anything else -> bfloat16."""
    return {8: torch.int8, 32: torch.float32}.get(bits, torch.bfloat16)


def write_stacked(cache: torch.Tensor, layer: int, new: torch.Tensor,
                  positions: torch.Tensor) -> None:
    """Scatter ``new [B, T, Hk, ...]`` at ``positions [B, T]`` into
    ``cache[layer]`` (in place): the ragged decode's KV write."""
    B, T = positions.shape
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    # advanced indices (rows, positions) around the head slice broadcast to
    # [B, T] and land in front: the indexed view is [B, T, Hk, ...]
    cache[layer, rows, :, positions] = new.to(cache.dtype)


def write_prefill_stacked(cache: torch.Tensor, layer: int,
                          new: torch.Tensor) -> None:
    """Write a fresh prefill ``new [B, T, Hk, ...]`` at positions ``0..T-1``
    of ``cache[layer]`` (in place)."""
    write_window_stacked(cache, layer, new, 0)


def write_window_stacked(cache: torch.Tensor, layer: int, new: torch.Tensor,
                         start: int) -> None:
    """Write ``new [B, T, Hk, ...]`` at positions ``start..start+T-1`` of
    every row of ``cache[layer]`` (in place): a prefill continuation
    chunk's uniform window write (the JAX ``dynamic_update_slice``)."""
    B, T = new.shape[:2]
    if not 0 <= start <= cache.shape[3] - T:
        raise IndexError(f"window [{start}, {start + T}) outside the cache "
                         f"({cache.shape[3]})")
    cache[layer, :B, :, start:start + T] = new.transpose(1, 2).to(cache.dtype)
