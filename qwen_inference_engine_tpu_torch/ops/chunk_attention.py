"""Flash attention for prefill continuation chunks over the stacked cache.

Chunk i >= 1 of a chunked prefill attends its T queries (absolute
positions ``[start, start + T)``) over ``cache[layer, b, :, 0:start + T]``;
the chunk's own keys are already written.  Causal by absolute position.

The wrappers launch the CUDA kernel ``csrc/chunk_attention.cu``:

* ``chunk_attention_contiguous`` (the port of the JAX package's
  ``chunk_attention_contiguous`` / ``_chunk_kernel``): bf16 cache;
* ``chunk_attention_contiguous_q8`` (the port of
  ``chunk_attention_contiguous_q8`` / ``_chunk_kernel_q8``): int8 cache with
  per-token-per-head f32 scales ``[L, Bc, Hk, S]``;
* ``paged_chunk_attention`` (the port of ``paged_chunk_attention`` /
  ``_paged_chunk`` / ``_paged_chunk_kernel``): the serving scheduler's
  continuation piece over the bf16 page pool ``[L, P, Hk, page, D]``
  through its block table, ``start`` a host int (need not be
  page-aligned);
* ``paged_chunk_attention_q8`` (the port of ``paged_chunk_attention_q8`` /
  ``_paged_chunk_q8`` / ``_paged_chunk_kernel_q8``): the same over the int8
  pool with its f32 scales ``[L, P, Hk, page]``.

All four run on the tensor cores, one block body (``attend_gqa_block`` of
``csrc/attention_mma.cuh``: mma.sync with the G query heads of one KV head
packed into each block's rows, K/V tiles staged by cp.async in two
stages); the paged ones address their keys through the block table
(``PagedKeys``), so through identity tables they give the contiguous
kernels' bits at the same start.

The contiguous wrappers take ``start`` as a host int shared by every row
or, as the JAX wrapper does, a ``[B]`` int32 device tensor of per-row
starts (the fixed-batch speculative verify, each row at its own length),
which the kernel reads; a row's window must lie inside the cache.

``*_plain`` beside each computes the same function with the plain oracle
(the q8 ones over the dequantized prefix, in q's dtype), as the JAX
package's XLA path does.  Unlike the JAX package, which declines chunks
above a TPU VMEM ceiling and falls back to XLA, the kernel takes every
chunk the engine gives it: T in 1..512, any start, G <= 8, D in {64, 128};
anything else raises.  The paged kernel likewise takes any T in 1..512
(the JAX kernel wants ``T % 8 == 0`` and a VMEM ceiling) and any page size
that is a multiple of 8.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention_kmajor
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    check_cache,
    check_scales,
)
from qwen_inference_engine_tpu_torch.ops.paged_attention import (
    check_paged,
    paged_kv_plain,
)
from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

MAX_CHUNK = 512


Start = Union[int, torch.Tensor]


def _positions(q: torch.Tensor, start: Start) -> torch.Tensor:
    """[B, T] absolute positions of the chunk's queries."""
    B, T = q.shape[:2]
    if isinstance(start, torch.Tensor):
        return start.to(q.device).long()[:, None] + torch.arange(
            T, device=q.device)
    return (start + torch.arange(T, device=q.device))[None, :].expand(B, T)


def _end(q: torch.Tensor, start: Start) -> int:
    """The last key any row reads, plus one (a host int)."""
    if isinstance(start, torch.Tensor):
        return int(start.max()) + q.shape[1]
    return int(start) + q.shape[1]


def chunk_attention_contiguous_plain(q, k_cache, v_cache, layer: int,
                                     start: Start) -> torch.Tensor:
    """q [B, T, Hq, D] at positions ``start..start+T-1`` (per row for a
    tensor ``start``) over ``cache[layer, :B]``, causal."""
    B = q.shape[0]
    end = _end(q, start)
    return gqa_attention_kmajor(q, k_cache[layer, :B, :, :end],
                                v_cache[layer, :B, :, :end],
                                _positions(q, start))


def chunk_attention_contiguous_q8_plain(q, k_cache, v_cache, k_scale, v_scale,
                                        layer: int,
                                        start: Start) -> torch.Tensor:
    """The same over the int8 cache, dequantized to q's dtype first."""
    B = q.shape[0]
    end = _end(q, start)
    k = dequantize_kv(k_cache[layer, :B, :, :end],
                      k_scale[layer, :B, :, :end], q.dtype)
    v = dequantize_kv(v_cache[layer, :B, :, :end],
                      v_scale[layer, :B, :, :end], q.dtype)
    return gqa_attention_kmajor(q, k, v, _positions(q, start))


def _launch(name: str, q, k_cache, v_cache, k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor], layer: int, start: Start):
    B, T, Hq, D = q.shape
    L, Bc, Hk, S, Dc = k_cache.shape
    if Dc != D or v_cache.shape != k_cache.shape or B > Bc or Hq % Hk \
            or Hq // Hk > 8:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} (G <= 8)")
    if not 1 <= T <= MAX_CHUNK:
        raise ValueError(f"{name} takes chunks of 1..{MAX_CHUNK} tokens, "
                         f"not {T}")
    if D not in (64, 128):
        raise ValueError(f"{name} kernel takes D in (64, 128), not {D}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    starts = None
    if isinstance(start, torch.Tensor):
        if start.shape != (B,) or start.device != q.device:
            raise ValueError(f"{name}: per-row starts must be [{B}] on the "
                             f"device of q")
        starts, start = start.to(torch.int32).contiguous(), 0
    else:
        start = int(start)
        if not 0 <= start <= S - T:
            raise IndexError(f"chunk [{start}, {start + T}) outside the "
                             f"cache ({S})")
    check_cache(name, q, k_cache, v_cache,
                torch.bfloat16 if k_scale is None else torch.int8)
    if k_scale is not None:
        check_scales(name, k_cache, k_scale, v_scale)
    q = q.contiguous()
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_chunk_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        None if starts is None else starts.data_ptr(), out.data_ptr(),
        L, Bc, B, T, Hq, Hk, S, D, int(layer), start, D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    return out


def chunk_attention_contiguous(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, layer: int,
                               start: Start) -> torch.Tensor:
    """Attention of the chunk ``q [B, T, Hq, D]`` (positions
    ``start..start+T-1``; ``start`` a host int, or per-row starts ``[B]``
    on the device) over the bf16 ``cache[layer, b, :, :start + T]``;
    returns [B, T, Hq, D].  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return chunk_attention_contiguous_plain(q, k_cache, v_cache, layer,
                                                start)
    out = _launch("chunk_attention_contiguous", q, k_cache, v_cache, None,
                  None, layer, start)
    chunk_attention_contiguous.launches += 1
    return out


chunk_attention_contiguous.launches = 0


def chunk_attention_contiguous_q8(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  k_scale: torch.Tensor,
                                  v_scale: torch.Tensor, layer: int,
                                  start: Start) -> torch.Tensor:
    """The same over an int8 cache with f32 scales ``[L, Bc, Hk, S]``."""
    if q.device.type == "cpu":
        return chunk_attention_contiguous_q8_plain(q, k_cache, v_cache,
                                                   k_scale, v_scale, layer,
                                                   start)
    out = _launch("chunk_attention_contiguous_q8", q, k_cache, v_cache,
                  k_scale, v_scale, layer, start)
    chunk_attention_contiguous_q8.launches += 1
    return out


chunk_attention_contiguous_q8.launches = 0


def paged_chunk_attention_plain(q, k_pages, v_pages, block_tables,
                                layer: int, start: int, page_size: int,
                                k_scale=None, v_scale=None) -> torch.Tensor:
    """q [B, T, Hq, D] at positions ``start..start+T-1`` over each row's
    pages of ``pages[layer]`` (keys past ``start + T`` zeroed; an int8 pool
    dequantized to q's dtype)."""
    B, T = q.shape[:2]
    end = torch.full((B,), int(start) + T, device=q.device)
    k, v = paged_kv_plain(k_pages, v_pages, k_scale, v_scale, block_tables,
                          end, layer, q.dtype)
    return gqa_attention_kmajor(q, k, v, _positions(q, int(start)))


def paged_chunk_attention_q8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                   block_tables, layer: int, start: int,
                                   page_size: int) -> torch.Tensor:
    """``paged_chunk_attention_plain`` over the int8 pool."""
    return paged_chunk_attention_plain(q, k_pages, v_pages, block_tables,
                                       layer, start, page_size, k_scale,
                                       v_scale)


def _launch_paged(name, q, k_pages, v_pages, scales, block_tables,
                  layer: int, start: int, page_size: int) -> torch.Tensor:
    B, T, Hq, D = q.shape
    L, P, Hk, PS, _ = k_pages.shape
    tables = check_paged(name, (q,), (k_pages, v_pages), block_tables,
                         page_size, layer, scales=scales,
                         input_dtype=torch.bfloat16)
    if not 1 <= T <= MAX_CHUNK:
        raise ValueError(f"{name} takes pieces of 1..{MAX_CHUNK} tokens, "
                         f"not {T}")
    start = int(start)
    if not 0 <= start < tables.shape[1] * PS:
        raise IndexError(f"piece start {start} outside the "
                         f"{tables.shape[1]} pages of the table")
    q = q.contiguous()
    out = torch.empty_like(q)
    ks, vs = scales if scales is not None else (None, None)
    rc = cuda_lib.library().qie_paged_chunk_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), tables.data_ptr(),
        out.data_ptr(), L, P, B, T, Hq, Hk, PS, tables.shape[1], D,
        int(layer), start, D ** -0.5, cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    return out


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          layer: int, start: int,
                          page_size: int) -> torch.Tensor:
    """Attention of the piece ``q [B, T, Hq, D]`` (positions
    ``start..start+T-1``, ``start`` a host int) over the paged prefix
    ``[0, start + T)`` of each row of ``block_tables [B, max_pages]`` in the
    stacked bf16 pool ``[L, P, Hk, page, D]``; the piece's own K/V are
    already appended.  The piece must start inside the table and may end
    past it (a bucket-padded last piece): its rows there attend the whole
    table.  Returns [B, T, Hq, D].  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(q, k_pages, v_pages, block_tables,
                                           layer, start, page_size)
    out = _launch_paged("paged_chunk_attention", q, k_pages, v_pages, None,
                        block_tables, layer, start, page_size)
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


def paged_chunk_attention_q8(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor,
                             block_tables: torch.Tensor, layer: int,
                             start: int, page_size: int) -> torch.Tensor:
    """The same over the int8 pool with its f32 scales ``[L, P, Hk,
    page]``."""
    if q.device.type == "cpu":
        return paged_chunk_attention_q8_plain(q, k_pages, v_pages, k_scale,
                                              v_scale, block_tables, layer,
                                              start, page_size)
    out = _launch_paged("paged_chunk_attention_q8", q, k_pages, v_pages,
                        (k_scale, v_scale), block_tables, layer, start,
                        page_size)
    paged_chunk_attention_q8.launches += 1
    return out


paged_chunk_attention_q8.launches = 0
