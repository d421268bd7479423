"""In-place KV appends: INT8 decode into the contiguous cache, bf16 into
the page pool.

Each wrapper launches a kernel of ``csrc/kv_append.cu``:

* ``kv_append_uniform_q8`` (the port of the JAX package's
  ``kv_append_uniform_q8`` / ``_uniform_append_q8_kernel``): every row of
  an aligned batch writes its quantized K/V row and the two scales at one
  shared position.  The quantization itself (``quant/kv_quant.py``) stays
  outside the kernel, as in the JAX package;
* ``paged_append_ragged`` (the port of ``paged_append_ragged`` /
  ``_paged_ragged_kernel``): the decode step's one K/V row per batch row,
  each at its own position, through its block table; a negative position
  skips the row;
* ``paged_append_prefill`` (the port of ``paged_append_prefill`` /
  ``_paged_prefill_kernel``): a prefill piece's T K/V rows of one sequence
  at ``start .. start+T-1`` through ``tables[0]``.

``*_plain`` beside each is the plain indexed write.  Both paged appends
follow the table as it is (zero entries lead to scratch page 0, as bucket
padding does in the JAX package); a position past the table's width writes
nothing, as the JAX scatter drops it.
"""

from __future__ import annotations

from typing import Union

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import paged_write_stacked
from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    check_row0,
    check_scales,
    device_position,
)
from qwen_inference_engine_tpu_torch.ops.paged_attention import (
    check_paged,
    refuse_int8_pool,
)


def kv_append_uniform_q8_plain(k_cache, v_cache, k_scale, v_scale, k_new,
                               v_new, ks_new, vs_new, position, layer: int):
    """Write ``k/v_new [B, 1, Hk, D]`` and ``ks/vs_new [B, 1, Hk]`` at
    ``position`` of ``cache[layer, :B]`` (in place); returns the caches."""
    B = k_new.shape[0]
    p = int(position)
    k_cache[layer, :B, :, p] = k_new[:, 0].to(k_cache.dtype)
    v_cache[layer, :B, :, p] = v_new[:, 0].to(v_cache.dtype)
    k_scale[layer, :B, :, p] = ks_new[:, 0].float()
    v_scale[layer, :B, :, p] = vs_new[:, 0].float()
    return k_cache, v_cache, k_scale, v_scale


def kv_append_uniform_q8(k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         ks_new: torch.Tensor, vs_new: torch.Tensor,
                         position: Union[int, torch.Tensor], layer: int,
                         row0=0):
    """INT8-KV uniform append: int8 ``k/v_new [B, 1, Hk, D]`` and f32
    ``ks/vs_new [B, 1, Hk]`` at the one ``position`` (an int, or a 1-element
    tensor read on the device) of the int8 caches ``[L, Bc, Hk, S, D]`` and
    scales ``[L, Bc, Hk, S]``, in place.  Returns the same four tensors.  A
    CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    check_row0(row0)
    if k_cache.device.type == "cpu":
        return kv_append_uniform_q8_plain(k_cache, v_cache, k_scale, v_scale,
                                          k_new, v_new, ks_new, vs_new,
                                          position, layer)
    name = "kv_append_uniform_q8"
    L, Bc, Hk, S, D = k_cache.shape
    B = k_new.shape[0]
    dev = k_cache.device
    if B > Bc or k_new.shape != (B, 1, Hk, D) or v_new.shape != k_new.shape \
            or ks_new.shape != (B, 1, Hk) or vs_new.shape != ks_new.shape \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name} shapes: cache {tuple(k_cache.shape)}, new "
                         f"{tuple(k_new.shape)}, scales {tuple(ks_new.shape)}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    for t in (k_cache, v_cache, k_new, v_new):
        if t.dtype != torch.int8 or t.device != dev:
            raise TypeError(f"{name} takes int8 K/V on the cache's device, "
                            f"not {t.dtype} on {t.device}")
    for t in (ks_new, vs_new):
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"{name} takes f32 new scales on the cache's "
                            f"device, not {t.dtype} on {t.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs contiguous caches")
    check_scales(name, k_cache, k_scale, v_scale)
    pos = device_position(position, S, dev)
    kn, vn = k_new.contiguous(), v_new.contiguous()
    ksn, vsn = ks_new.contiguous(), vs_new.contiguous()
    rc = cuda_lib.library().qie_kv_append_q8(
        k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kn.data_ptr(), vn.data_ptr(), ksn.data_ptr(),
        vsn.data_ptr(), pos.data_ptr(), L, Bc, B, Hk, S, D, int(layer),
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    kv_append_uniform_q8.launches += 1
    return k_cache, v_cache, k_scale, v_scale


kv_append_uniform_q8.launches = 0


def paged_append_ragged_plain(k_pages, v_pages, k_new, v_new, positions,
                              block_tables, layer: int, page_size: int):
    """Write ``k/v_new [B, 1, Hk, D]`` at ``positions [B]`` (negative: skip
    the row) through ``block_tables [B, max_pages]`` into
    ``pages[layer]`` (in place); returns the pools."""
    keep = positions >= 0
    pos = positions.long().clamp(min=0)[keep][:, None]
    tables = block_tables[keep]
    paged_write_stacked(k_pages, layer, k_new[keep], pos, tables, page_size)
    paged_write_stacked(v_pages, layer, v_new[keep], pos, tables, page_size)
    return k_pages, v_pages


def paged_append_ragged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, block_tables: torch.Tensor,
                        layer: int, *, page_size: int):
    """Decode append into the stacked pools ``[L, P, Hk, page, D]``, in
    place: row b's ``k/v_new [B, 1, Hk, D]`` at ``positions[b]`` through
    ``block_tables[b]``; ``positions [B]`` and the tables stay on the
    device (read by the kernel).  Returns the two pools.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel or raises."""
    refuse_int8_pool(k_pages, "paged_append_ragged")
    if k_pages.device.type == "cpu":
        return paged_append_ragged_plain(k_pages, v_pages, k_new, v_new,
                                         positions, block_tables, layer,
                                         page_size)
    name = "paged_append_ragged"
    L, P, Hk, PS, D = k_pages.shape
    B = k_new.shape[0]
    if k_new.shape != (B, 1, Hk, D):
        raise ValueError(f"{name}: new rows must be {(B, 1, Hk, D)}, not "
                         f"{tuple(k_new.shape)}")
    tables = check_paged(name, (k_new, v_new), (k_pages, v_pages),
                         block_tables, page_size, layer)
    if positions.shape != (B,) or positions.device != k_pages.device:
        raise ValueError(f"{name}: positions must be [{B}] on the pools' "
                         f"device")
    pos = positions.to(torch.int32).contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    rc = cuda_lib.library().qie_paged_append_ragged(
        k_pages.data_ptr(), v_pages.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        pos.data_ptr(), tables.data_ptr(), L, P, B, Hk, PS, D,
        tables.shape[1], int(layer), cuda_lib.stream_handle(k_pages.device))
    cuda_lib.check(rc, name)
    paged_append_ragged.launches += 1
    return k_pages, v_pages


paged_append_ragged.launches = 0


def paged_append_prefill_plain(k_pages, v_pages, k_new, v_new, start: int,
                               block_tables, layer: int, page_size: int):
    """Write ``k/v_new [1, T, Hk, D]`` at ``start .. start+T-1`` through
    ``block_tables [1, max_pages]`` into ``pages[layer]`` (in place);
    returns the pools."""
    T = k_new.shape[1]
    pos = (int(start) + torch.arange(T, device=k_new.device))[None, :]
    paged_write_stacked(k_pages, layer, k_new, pos, block_tables, page_size)
    paged_write_stacked(v_pages, layer, v_new, pos, block_tables, page_size)
    return k_pages, v_pages


def paged_append_prefill(k_pages: torch.Tensor, v_pages: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         start: int, block_tables: torch.Tensor, layer: int,
                         *, page_size: int):
    """Prefill-piece append of one sequence into the stacked pools, in
    place: ``k/v_new [1, T, Hk, D]`` at ``start .. start+T-1`` (``start`` a
    host int) through ``block_tables [1, max_pages]``, across page
    boundaries.  Returns the two pools.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    refuse_int8_pool(k_pages, "paged_append_prefill")
    if k_pages.device.type == "cpu":
        return paged_append_prefill_plain(k_pages, v_pages, k_new, v_new,
                                          start, block_tables, layer,
                                          page_size)
    name = "paged_append_prefill"
    L, P, Hk, PS, D = k_pages.shape
    T = k_new.shape[1]
    if k_new.shape != (1, T, Hk, D) or not 1 <= T <= 65535:
        raise ValueError(f"{name}: new rows must be [1, T, {Hk}, {D}], not "
                         f"{tuple(k_new.shape)}")
    tables = check_paged(name, (k_new, v_new), (k_pages, v_pages),
                         block_tables, page_size, layer)
    start = int(start)
    if start < 0:
        raise IndexError(f"{name}: start {start} < 0")
    kn, vn = k_new.contiguous(), v_new.contiguous()
    rc = cuda_lib.library().qie_paged_append_prefill(
        k_pages.data_ptr(), v_pages.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        tables.data_ptr(), L, P, T, Hk, PS, D, tables.shape[1], int(layer),
        start, cuda_lib.stream_handle(k_pages.device))
    cuda_lib.check(rc, name)
    paged_append_prefill.launches += 1
    return k_pages, v_pages


paged_append_prefill.launches = 0
