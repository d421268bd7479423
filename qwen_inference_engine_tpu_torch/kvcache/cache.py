"""KV caches: contiguous ``[L, B, Hk, S, D]`` and paged, with plain writes.

Head-major, as in the JAX package, so the attention kernels read one
(row, KV head) slab of ``S x D`` contiguously.  ``S`` is rounded up to 256.
The cache is updated in place (the JAX package's donated scan carry).

The paged cache (continuous-batching serving) is a pool of pages
``[L, P, Hk, page, D]`` shared by all sequences (the JAX package's code
layout, ``cache.py:127``; its module docstring's ``[L, P, page, Hk, D]`` is
wrong).  Block tables ``[slots, max_pages]`` of int32 page ids are
scheduler state, not stored here; page 0 is the scratch page that idle
slots and table entries past a sequence's pages point at.

An int8 cache (INT8 KV) also holds per-token-per-head f32 scales
``[L, B, Hk, S]``; ``KVCache.write`` quantizes the fresh rows with
``quantize_kv`` and stores the bytes and the scales through the same plain
write, as the JAX package's ``_write_cache_stacked`` does.  The paged
cache holds bf16, f32 or int8 pages; an int8 pool carries its scales
``[L, P, Hk, page]`` through every paged append (written in the same
launch), ``copy_page`` and the plain writes (``paged_write_stacked`` on a
trailing unit axis).
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

    def clear(self) -> None:
        """Zero the cache in place, as ``create`` made it."""
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                t.zero_()

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


@dataclasses.dataclass
class PagedKVCache:
    """Paged cache: k/v pages ``[L, P, Hk, page, D]``; k_scale/v_scale
    ``[L, P, Hk, page]`` f32 when the dtype is int8, else None."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_size: int

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    @staticmethod
    def create(num_layers: int, num_pages: int, page_size: int,
               num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device=None) -> "PagedKVCache":
        shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
        quant = dtype == torch.int8

        def scales():
            return torch.zeros(shape[:-1], dtype=torch.float32, device=device)

        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            k_scale=scales() if quant else None,
            v_scale=scales() if quant else None, page_size=page_size)

    def copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` over page ``dst`` in every layer (K, V and the
        scales), in place: the prefix cache's partial-page reuse."""
        for t in (self.k_pages, self.v_pages, self.k_scale, self.v_scale):
            if t is not None:
                t[:, dst] = t[:, src]


def pages_required(seq_len: int, page_size: int) -> int:
    """ceil(seq / page): pages a sequence of ``seq_len`` tokens needs."""
    return -(-seq_len // page_size)


def _page_ids(positions: torch.Tensor, block_tables: torch.Tensor,
              page_size: int):
    """(page ids, rows in the page, in-table mask) of ``positions [B, T]``
    through ``block_tables [B, max_pages]``; a position whose logical page
    is past the table's width is outside it (the JAX scatter drops it)."""
    logical = torch.div(positions, page_size, rounding_mode="floor").long()
    inside = logical < block_tables.shape[1]
    ids = torch.gather(block_tables.long(), 1,
                       logical.clamp(max=block_tables.shape[1] - 1))
    return ids, positions.long() % page_size, inside


def paged_write(pages_l: torch.Tensor, new: torch.Tensor,
                positions: torch.Tensor, block_tables: torch.Tensor,
                page_size: int) -> None:
    """Scatter ``new [B, T, Hk, ...]`` at absolute ``positions [B, T]``
    through ``block_tables`` into one layer's pool ``[P, Hk, page, ...]``,
    in place."""
    ids, rows, inside = _page_ids(positions, block_tables, page_size)
    # advanced indices (ids, rows) around the head slice land in front: the
    # indexed view is [n, Hk, ...]
    pages_l[ids[inside], :, rows[inside]] = new[inside].to(pages_l.dtype)


def paged_write_stacked(pages: torch.Tensor, layer: int, new: torch.Tensor,
                        positions: torch.Tensor, block_tables: torch.Tensor,
                        page_size: int) -> None:
    """``paged_write`` into ``pages[layer]`` of the stacked pool
    ``[L, P, Hk, page, ...]``, in place."""
    paged_write(pages[layer], new, positions, block_tables, page_size)


def paged_read(pages_l: torch.Tensor,
               block_tables: torch.Tensor) -> torch.Tensor:
    """Gather one layer's pages of each row: ``[B, Hk, max_pages * page,
    ...]`` (head-major), the plain attention's view of the pool."""
    gathered = pages_l[block_tables.long()]   # [B, max_pages, Hk, page, ...]
    B, NP, Hk, PS = gathered.shape[:4]
    return gathered.transpose(1, 2).reshape(B, Hk, NP * PS,
                                            *gathered.shape[4:])


def kv_dtype_from_bits(bits: int) -> torch.dtype:
    """KV cache dtype for a ``--kv-bits`` flag: 8 -> int8 (with scales),
    32 -> float32 (CPU runs and tests), anything else -> bfloat16."""
    return {8: torch.int8, 32: torch.float32}.get(bits, torch.bfloat16)


def write_stacked(cache: torch.Tensor, layer: int, new: torch.Tensor,
                  positions: torch.Tensor) -> None:
    """Scatter ``new [B, T, Hk, ...]`` at ``positions [B, T]`` into
    ``cache[layer]`` (in place): the JAX package's
    ``contiguous_write_stacked`` (the forward's per-row writes go through
    ``ops/kv_append.kv_append_ragged_t``)."""
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
