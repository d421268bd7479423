"""Contiguous KV cache ``[L, B, Hk, S, D]`` and its plain stacked writes.

Head-major, as in the JAX package, so the decode kernel reads one
(row, KV head) slab of ``S x D`` contiguously.  ``S`` is rounded up to 256.
The cache is updated in place (the JAX package's donated scan carry).
The paged cache and INT8 KV come in later slices.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    """Contiguous cache: k/v ``[L, B, Hk, S, D]``."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(num_layers: int, batch: int, max_seq: int, num_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        if dtype == torch.int8:
            raise NotImplementedError(
                "INT8 KV needs the ports of kv_append_uniform_q8, "
                "decode_attention_contiguous_q8 and "
                "chunk_attention_contiguous_q8")
        max_seq = -(-max_seq // 256) * 256
        shape = (num_layers, batch, num_kv_heads, max_seq, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))


def write_stacked(cache: torch.Tensor, layer: int, new: torch.Tensor,
                  positions: torch.Tensor) -> None:
    """Scatter ``new [B, T, Hk, D]`` at ``positions [B, T]`` into
    ``cache[layer]`` (in place): the ragged decode's KV write."""
    B, T = positions.shape
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, T)
    # advanced indices (rows, positions) around the head slice broadcast to
    # [B, T] and land in front: the indexed view is [B, T, Hk, D]
    cache[layer, rows, :, positions] = new.to(cache.dtype)


def write_prefill_stacked(cache: torch.Tensor, layer: int,
                          new: torch.Tensor) -> None:
    """Write a fresh prefill ``new [B, T, Hk, D]`` at positions ``0..T-1``
    of ``cache[layer]`` (in place)."""
    B, T = new.shape[:2]
    cache[layer, :B, :, :T] = new.transpose(1, 2).to(cache.dtype)
