"""In-place KV appends: bf16 and INT8 rows into the contiguous cache,
bf16 or int8 rows into the page pool.

Each wrapper launches a kernel of ``csrc/kv_append.cu``:

* ``kv_append_uniform`` (the port of the JAX package's ``kv_append_uniform``
  / ``_uniform_append_kernel``): the K/V rows of an aligned batch's rows
  ``[row0, row0 + Bn)`` at one shared position read on the device (the
  double-pumped decode appends each half this way); the rows are copied
  bit for bit and nothing else of the cache is touched (the TPU kernel
  rewrites the 8-row band around the position, for its tiling);
* ``kv_append_all_uniform`` (the port of ``kv_append_all_uniform`` /
  ``_append_all_kernel``): every layer's fresh K/V row ``[L, B, Hk, D]``
  at one shared position in one launch, the deferred-append decode step's
  write after its layer loop (``models/qwen.forward_hidden(...,
  deferred_append=True)``, an ablation no entry point dispatches);
* ``kv_append_ragged_t`` (the port of ``kv_append_ragged_t`` /
  ``_ragged_t_kernel``): T consecutive K/V rows per batch row at a per-row
  start on the device into one layer of the contiguous cache, bf16 (f32)
  or int8 with the scales in the same launch: the ragged decode's write
  (T = 1) and the contiguous verify's window (T = k + 1).  A negative
  start skips the row; a token at or past S is dropped, as the JAX
  kernel (its band clamped to the cache's end) never selects it;
* ``kv_append_uniform_q8`` (the port of the JAX package's
  ``kv_append_uniform_q8`` / ``_uniform_append_q8_kernel``): every row of
  an aligned batch writes its quantized K/V row and the two scales at one
  shared position, into cache rows ``[row0, row0 + B)`` (the pipeline's
  1F1B microbatch window, ``parallel/pp_step.py``).  The quantization itself (``quant/kv_quant.py``) stays
  outside the kernel, as in the JAX package;
* ``paged_append_ragged`` (the port of ``paged_append_ragged`` /
  ``_paged_ragged_kernel``): the decode step's one K/V row per batch row,
  each at its own position, through its block table; a negative position
  skips the row;
* ``paged_append_ragged_t`` (the port of ``paged_append_ragged_t`` /
  ``_paged_ragged_t_kernel``): the speculative verify's T consecutive K/V
  rows per batch row at a per-row start (any T: each token finds its own
  page, so a window may span several); a negative start skips the row;
* ``paged_append_prefill`` (the port of ``paged_append_prefill`` /
  ``_paged_prefill_kernel``): a prefill piece's T K/V rows of one sequence
  at ``start .. start+T-1`` through ``tables[0]``.

``csrc/kv_append.cu`` holds two kernels.  The two uniform appends share
a grid-stride copy of 16-byte vectors (4-byte words where an operand is
not 16-byte aligned).  The other five share the row copy,
``append_rows_kernel``: one thread a vector of one (row, token, KV head)
head row, every token of a window in parallel; 16-byte vectors where the
destination's and the new rows' data pointers are 16-byte aligned, else
4-byte words, as ``plan_paged_append`` plans it from the shapes and the
pointers (the C launcher checks the plan, as ``check_paged_append_plan``
does first).  Its layout says where token t of row b lands from the
row's start: the three paged appends resolve a page through the row's
block table; ``kv_append_ragged_t`` and ``kv_append_uniform_q8`` take the
contiguous cache's row ``((layer * Bc + b) * Hk + hk) * S + start + t``,
dropping a token at or past S, the start read from ``starts[b]`` (per-row
starts) or from the one shared position.  A thread loads its source
vectors before the row's start (and the page id), so one dependent load
stands between the launch and its stores (two for the paged decode and
verify, whose page id follows the start; the prefill's start comes from
the host): on the H100 the launch bounds these appends, and that chain
comes next.  They take bf16 rows (also f32 for the contiguous cache), or
int8 rows with their f32 scales (``quantize_kv``): the kernel writes the
bytes and the scales (``[L, P, Hk, page]`` or ``[L, Bc, Hk, S]``) in one
launch, where the JAX package runs its paged kernels on the bytes and
scatters the scales with XLA.  ``*_plain`` beside each is the plain
indexed write.  The paged appends follow the table as it is (zero
entries lead to scratch page 0, as bucket padding does in the JAX
package); a position past the table's width writes nothing, as the JAX
scatter drops it, and so does a page id outside ``[0, P)``.
"""

from __future__ import annotations

import functools
from typing import Union

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import paged_write_stacked
from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    row_window,
    check_scales,
    device_position,
)
from qwen_inference_engine_tpu_torch.ops.paged_attention import check_paged


def kv_append_uniform_plain(k_cache, v_cache, k_new, v_new, position,
                            layer: int, row0: int = 0):
    """Write ``k/v_new [Bn, 1, Hk, D]`` at ``position`` of
    ``cache[layer, row0:row0 + Bn]`` (in place); returns the caches."""
    Bn = k_new.shape[0]
    p = int(position)
    k_cache[layer, row0:row0 + Bn, :, p] = k_new[:, 0].to(k_cache.dtype)
    v_cache[layer, row0:row0 + Bn, :, p] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def kv_append_uniform(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      position: Union[int, torch.Tensor], layer: int,
                      row0: int = 0):
    """Uniform decode append: ``k/v_new [Bn, 1, Hk, D]`` (cast to the
    cache's type) at the one ``position`` (an int, or a 1-element tensor
    read on the device) of the rows ``[row0, row0 + Bn)`` of the bf16 or
    f32 caches ``[L, Bc, Hk, S, D]``, in place.  Returns the same two
    tensors.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises."""
    if k_cache.device.type == "cpu":
        return kv_append_uniform_plain(k_cache, v_cache, k_new, v_new,
                                       position, layer, row0)
    name = "kv_append_uniform"
    L, Bc, Hk, S, D = k_cache.shape
    Bn = k_new.shape[0]
    dev = k_cache.device
    if k_new.shape != (Bn, 1, Hk, D) or v_new.shape != k_new.shape \
            or v_cache.shape != k_cache.shape or not 0 <= row0 \
            or row0 + Bn > Bc:
        raise ValueError(f"{name} shapes: cache {tuple(k_cache.shape)}, new "
                         f"{tuple(k_new.shape)}, rows from {row0}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    _check_float_cache(name, k_cache, v_cache, (k_new, v_new),
                       "int8: kv_append_uniform_q8")
    pos = device_position(position, S, dev)
    kn = k_new.to(k_cache.dtype).contiguous()
    vn = v_new.to(v_cache.dtype).contiguous()
    rc = cuda_lib.library().qie_kv_append_uniform(
        k_cache.data_ptr(), v_cache.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        pos.data_ptr(), L, Bc, Bn, Hk, S, D, k_cache.element_size(),
        int(layer), int(row0), cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    kv_append_uniform.launches += 1
    return k_cache, v_cache


kv_append_uniform.launches = 0


def kv_append_all_uniform_plain(k_cache, v_cache, k_new, v_new, position):
    """Write every layer's ``k/v_new [L, B, (1,) Hk, D]`` at ``position`` of
    ``cache[:, :B]`` (in place); returns the caches."""
    L, _, Hk, _, D = k_cache.shape
    p = int(position)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        new = new.reshape(L, -1, Hk, D)
        cache[:, :new.shape[1], :, p] = new.to(cache.dtype)
    return k_cache, v_cache


def kv_append_all_uniform(k_cache: torch.Tensor, v_cache: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          position: Union[int, torch.Tensor]):
    """Deferred all-layer append: every layer's fresh ``k/v_new [L, B, Hk,
    D]`` (or ``[L, B, 1, Hk, D]``; cast to the cache's type) at the one
    ``position`` (an int, or a 1-element tensor read on the device) of the
    rows ``[0, B)`` of the bf16 or f32 caches ``[L, Bc, Hk, S, D]``, in
    place, in one launch.  An int8 cache is refused: the JAX kernel writes
    no scales.  Returns the same two tensors.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    if k_cache.device.type == "cpu":
        return kv_append_all_uniform_plain(k_cache, v_cache, k_new, v_new,
                                           position)
    name = "kv_append_all_uniform"
    L, Bc, Hk, S, D = k_cache.shape
    B = k_new.shape[1] if k_new.dim() >= 2 else 0
    if k_new.shape not in ((L, B, Hk, D), (L, B, 1, Hk, D)) \
            or v_new.shape != k_new.shape or v_cache.shape != k_cache.shape \
            or not 1 <= B <= Bc:
        raise ValueError(f"{name} shapes: cache {tuple(k_cache.shape)}, new "
                         f"{tuple(k_new.shape)} (want [L, B <= Bc, (1,) Hk, "
                         f"D])")
    _check_float_cache(name, k_cache, v_cache, (k_new, v_new),
                       "int8 caches: the kernel writes no scales")
    pos = device_position(position, S, k_cache.device)
    kn = k_new.reshape(L, B, Hk, D).to(k_cache.dtype).contiguous()
    vn = v_new.reshape(L, B, Hk, D).to(v_cache.dtype).contiguous()
    rc = cuda_lib.library().qie_kv_append_all_uniform(
        k_cache.data_ptr(), v_cache.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        pos.data_ptr(), L, Bc, B, Hk, S, D, k_cache.element_size(),
        cuda_lib.stream_handle(k_cache.device))
    cuda_lib.check(rc, name)
    kv_append_all_uniform.launches += 1
    return k_cache, v_cache


kv_append_all_uniform.launches = 0


def _check_float_cache(name, k_cache, v_cache, news, int8_note) -> None:
    """bf16 or f32 contiguous caches, rows of 32-bit words, and the new
    rows on the caches' device."""
    if k_cache.dtype not in (torch.bfloat16, torch.float32) \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{name} takes bf16 or f32 caches, not "
                        f"{k_cache.dtype} ({int8_note})")
    for t in (v_cache, *news):
        if t.device != k_cache.device:
            raise TypeError(f"{name} takes K/V on the cache's device, not "
                            f"{t.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs contiguous caches")
    if (k_cache.shape[-1] * k_cache.element_size()) % 4:
        raise ValueError(f"{name} copies 32-bit words: D * element size "
                         f"must be a multiple of 4")


def kv_append_ragged_t_plain(k_cache, v_cache, k_new, v_new, starts,
                             layer: int, k_scale=None, v_scale=None,
                             ks_new=None, vs_new=None):
    """Write row b's ``k/v_new [B, T, Hk, D]`` (and for an int8 cache the
    scales ``ks/vs_new [B, T, Hk]``) at ``starts[b] .. starts[b] + T - 1``
    of ``cache[layer, b]`` (in place): a negative start skips the row, a
    token at or past S is dropped.  Returns the caches."""
    S = k_cache.shape[3]
    pairs = [(k_cache, k_new), (v_cache, v_new)]
    if k_scale is not None:
        pairs += [(k_scale[..., None], ks_new[..., None]),
                  (v_scale[..., None], vs_new[..., None])]
    for b, p in enumerate(starts.tolist()):
        if not 0 <= p < S:
            continue
        n = min(k_new.shape[1], S - p)
        for cache, new in pairs:
            cache[layer, b, :, p:p + n] = new[b, :n].transpose(0, 1).to(
                cache.dtype)
    return k_cache, v_cache


def kv_append_ragged_t(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       starts: torch.Tensor, layer: int, k_scale=None,
                       v_scale=None, ks_new=None, vs_new=None):
    """Ragged window append into the stacked contiguous caches ``[L, Bc, Hk,
    S, D]``, in place: row b's ``k/v_new [B, T, Hk, D]`` at ``starts[b] ..
    starts[b] + T - 1`` of ``cache[layer, b]`` for rows ``b < B``;
    ``starts [B]`` stays on the device (read by the kernel).  A negative
    start skips the row; tokens at or past S are dropped.  A bf16 or f32
    cache takes rows cast to its type; an int8 cache takes int8 rows with
    their f32 scales ``ks/vs_new [B, T, Hk]`` and its own ``k/v_scale
    [L, Bc, Hk, S]``.  Returns the two caches.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    if k_cache.device.type == "cpu":
        return kv_append_ragged_t_plain(k_cache, v_cache, k_new, v_new,
                                        starts, layer, k_scale, v_scale,
                                        ks_new, vs_new)
    name = "kv_append_ragged_t"
    L, Bc, Hk, S, D = k_cache.shape
    B, T = k_new.shape[:2] if k_new.dim() == 4 else (0, 0)
    if k_new.shape != (B, T, Hk, D) or v_new.shape != k_new.shape \
            or v_cache.shape != k_cache.shape or not 1 <= B <= min(Bc, 65535) \
            or not 1 <= T <= 65535:
        raise ValueError(f"{name} shapes: cache {tuple(k_cache.shape)}, new "
                         f"{tuple(k_new.shape)} (want [B <= Bc, T, Hk, D])")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    dev = k_cache.device
    if k_cache.dtype == torch.int8:
        for t in (v_cache, k_new, v_new):
            if t.dtype != torch.int8 or t.device != dev:
                raise TypeError(f"{name} into an int8 cache takes int8 K/V "
                                f"rows (quantize_kv) on its device, not "
                                f"{t.dtype} on {t.device}")
        if k_scale is None or v_scale is None:
            raise ValueError(f"{name}: an int8 cache needs its f32 scales")
        check_scales(name, k_cache, k_scale, v_scale)
        ksn, vsn = _check_new_scales(name, k_new, (k_scale, v_scale), ks_new,
                                     vs_new)
        kn, vn = k_new, v_new
        if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
            raise ValueError(f"{name} needs contiguous caches")
    else:
        if any(t is not None for t in (k_scale, v_scale, ks_new, vs_new)):
            raise ValueError(f"{name}: scales go with an int8 cache only")
        _check_float_cache(name, k_cache, v_cache, (k_new, v_new),
                           "or int8 with its scales")
        kn, vn = _cast(k_new, k_cache.dtype), _cast(v_new, v_cache.dtype)
        ksn = vsn = None
    if starts.shape != (B,) or starts.device != dev:
        raise ValueError(f"{name}: starts must be [{B}] on the cache's "
                         f"device")
    st = _cast(starts, torch.int32).contiguous()
    ptrs, plan = _row_operands(name, k_cache, v_cache, kn, vn)
    rc = cuda_lib.library().qie_kv_append_ragged_t(
        *ptrs[:2], _ptr(k_scale), _ptr(v_scale), *ptrs[2:], _ptr(ksn),
        _ptr(vsn), st.data_ptr(), L, Bc, B, T, Hk, S, D,
        k_cache.element_size(), int(layer), *plan,
        cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    kv_append_ragged_t.launches += 1
    return k_cache, v_cache


kv_append_ragged_t.launches = 0


def kv_append_uniform_q8_plain(k_cache, v_cache, k_scale, v_scale, k_new,
                               v_new, ks_new, vs_new, position, layer: int,
                               row0: int = 0):
    """Write ``k/v_new [B, 1, Hk, D]`` and ``ks/vs_new [B, 1, Hk]`` at
    ``position`` of ``cache[layer, row0:row0 + B]`` (in place); returns the
    caches."""
    rows = slice(row0, row0 + k_new.shape[0])
    p = int(position)
    k_cache[layer, rows, :, p] = k_new[:, 0].to(k_cache.dtype)
    v_cache[layer, rows, :, p] = v_new[:, 0].to(v_cache.dtype)
    k_scale[layer, rows, :, p] = ks_new[:, 0].float()
    v_scale[layer, rows, :, p] = vs_new[:, 0].float()
    return k_cache, v_cache, k_scale, v_scale


def kv_append_uniform_q8(k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         ks_new: torch.Tensor, vs_new: torch.Tensor,
                         position: Union[int, torch.Tensor], layer: int,
                         row0=0):
    """INT8-KV uniform append: int8 ``k/v_new [B, 1, Hk, D]`` and f32
    ``ks/vs_new [B, 1, Hk]`` at the one ``position`` (an int, or a 1-element
    tensor read on the device) of rows ``[row0, row0 + B)`` of the int8
    caches ``[L, Bc, Hk, S, D]`` and scales ``[L, Bc, Hk, S]``, in place.
    Returns the same four tensors.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises."""
    name = "kv_append_uniform_q8"
    row0 = row_window(name, row0, k_new.shape[0], k_cache.shape[1])
    if k_cache.device.type == "cpu":
        return kv_append_uniform_q8_plain(k_cache, v_cache, k_scale, v_scale,
                                          k_new, v_new, ks_new, vs_new,
                                          position, layer, row0)
    L, Bc, Hk, S, D = k_cache.shape
    B = k_new.shape[0]
    dev = k_cache.device
    if k_new.shape != (B, 1, Hk, D) or v_new.shape != k_new.shape \
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
    ksn, vsn = ks_new.contiguous(), vs_new.contiguous()
    ptrs, plan = _row_operands(name, k_cache, v_cache, k_new, v_new)
    rc = cuda_lib.library().qie_kv_append_q8(
        *ptrs[:2], k_scale.data_ptr(), v_scale.data_ptr(), *ptrs[2:],
        ksn.data_ptr(), vsn.data_ptr(), pos.data_ptr(), L, Bc, B, Hk, S, D,
        int(layer), row0, *plan, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    kv_append_uniform_q8.launches += 1
    return k_cache, v_cache, k_scale, v_scale


kv_append_uniform_q8.launches = 0


def _paged_rows_plain(k_pages, v_pages, k_new, v_new, positions,
                      block_tables, layer: int, page_size: int, k_scale,
                      v_scale, ks_new, vs_new):
    """Write ``k/v_new [B, T, Hk, D]`` (and ``ks/vs_new [B, T, Hk]`` into
    the scales of an int8 pool) at ``positions [B, T]`` through
    ``block_tables`` into ``pages[layer]``, in place."""
    paged_write_stacked(k_pages, layer, k_new, positions, block_tables,
                        page_size)
    paged_write_stacked(v_pages, layer, v_new, positions, block_tables,
                        page_size)
    if k_scale is not None:
        paged_write_stacked(k_scale[..., None], layer, ks_new[..., None],
                            positions, block_tables, page_size)
        paged_write_stacked(v_scale[..., None], layer, vs_new[..., None],
                            positions, block_tables, page_size)
    return k_pages, v_pages


def paged_append_ragged_t_plain(k_pages, v_pages, k_new, v_new, positions,
                                block_tables, layer: int, page_size: int,
                                k_scale=None, v_scale=None, ks_new=None,
                                vs_new=None):
    """Write row b's ``k/v_new [B, T, Hk, D]`` at ``positions[b] ..
    positions[b] + T - 1`` (a negative start skips the row) through
    ``block_tables [B, max_pages]`` into ``pages[layer]`` (in place);
    returns the pools."""
    keep = positions >= 0
    T = k_new.shape[1]
    pos = positions.long()[keep][:, None] + torch.arange(
        T, device=positions.device)
    scales = ((ks_new[keep], vs_new[keep]) if k_scale is not None
              else (None, None))
    return _paged_rows_plain(k_pages, v_pages, k_new[keep], v_new[keep], pos,
                             block_tables[keep], layer, page_size, k_scale,
                             v_scale, *scales)


def paged_append_ragged_plain(k_pages, v_pages, k_new, v_new, positions,
                              block_tables, layer: int, page_size: int,
                              k_scale=None, v_scale=None, ks_new=None,
                              vs_new=None):
    """Write ``k/v_new [B, 1, Hk, D]`` at ``positions [B]`` (negative: skip
    the row) through ``block_tables [B, max_pages]`` into ``pages[layer]``
    (in place); returns the pools."""
    return paged_append_ragged_t_plain(k_pages, v_pages, k_new, v_new,
                                       positions, block_tables, layer,
                                       page_size, k_scale, v_scale, ks_new,
                                       vs_new)


def _check_new_scales(name, k_new, scales, ks_new, vs_new):
    """An int8 pool's new rows come with f32 scales ``[B, T, Hk]``."""
    if scales is None:
        return None, None
    for t in (ks_new, vs_new):
        if t is None or t.shape != k_new.shape[:-1] \
                or t.dtype != torch.float32 or t.device != k_new.device:
            raise ValueError(f"{name}: int8 rows come with f32 scales "
                             f"{tuple(k_new.shape[:-1])} on their device")
    return ks_new.contiguous(), vs_new.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cast(t, dtype):
    """``t`` as ``dtype``, without the cost of ``to`` when it already is."""
    return t if t.dtype == dtype else t.to(dtype)


PAGED_APPEND_THREADS = 128   # a block of the paged append kernel


@functools.lru_cache(maxsize=None)
def plan_paged_append(B: int, T: int, Hk: int, D: int, elem_bytes: int,
                      aligned: bool):
    """The row append kernel's plan ``(vec, threads, blocks)`` for ``B``
    rows of ``T`` tokens of ``Hk`` head rows of ``D`` elements of
    ``elem_bytes`` bytes (1, 2 or 4): one thread a ``vec``-byte vector of a
    head row, 16 where ``aligned`` (the destination's and the new rows'
    data pointers all 16-byte aligned) and the row's bytes allow it, else
    4; blocks of ``threads`` covering the ``B * T * Hk * D * elem_bytes /
    vec`` vectors once.  The same plan serves both layouts: the three paged
    appends (pools ``[L, P, Hk, page, D]``) and the contiguous
    ``kv_append_ragged_t`` and ``kv_append_uniform_q8`` (caches ``[L, Bc,
    Hk, S, D]``, T = 1 for the latter): it depends only on the shapes and
    the alignment."""
    row = D * elem_bytes
    vec = 16 if aligned and row % 16 == 0 else 4
    total = B * T * Hk * (row // vec)
    return vec, PAGED_APPEND_THREADS, -(-total // PAGED_APPEND_THREADS)


def check_paged_append_plan(name: str, plan, rows: int, row_bytes: int,
                            ptrs: int) -> None:
    """The C guard's rule for the paged append's plan, before any launch:
    ``vec`` 4 or 16 dividing the head row's ``row_bytes`` and every data
    pointer (``ptrs``, their bitwise or), ``PAGED_APPEND_THREADS``-thread
    blocks covering the ``rows`` head rows' vectors once, fewer than
    2^31."""
    vec, threads, blocks = plan
    total = rows * (row_bytes // vec) if vec in (4, 16) \
        and row_bytes % vec == 0 else 0
    if threads != PAGED_APPEND_THREADS or not 0 < total < 2 ** 31 \
            or not (blocks - 1) * threads < total <= blocks * threads:
        raise ValueError(f"{name}: plan (vec {vec}, threads {threads}, "
                         f"blocks {blocks}) does not cover {rows} head rows "
                         f"of {row_bytes} bytes once in 4- or 16-byte "
                         f"vectors, {PAGED_APPEND_THREADS} threads a block")
    if ptrs % vec:
        raise ValueError(f"{name}: {vec}-byte vectors need the destination "
                         f"and the new rows {vec}-byte aligned")


def _row_operands(name, k_dst, v_dst, k_new, v_new):
    """The destination's (pools or contiguous caches) and the new rows'
    ``[B, T, Hk, D]`` data pointers and the row kernel's plan, checked.
    New rows that are not 4-byte aligned (a view a few bytes into its
    storage) are copied: the kernel moves 32-bit words at least."""
    kn, vn = k_new.contiguous(), v_new.contiguous()
    ptrs = [k_dst.data_ptr(), v_dst.data_ptr(), kn.data_ptr(),
            vn.data_ptr()]
    if (ptrs[2] | ptrs[3]) % 4:
        kn, vn = kn.clone(), vn.clone()
        ptrs[2:] = kn.data_ptr(), vn.data_ptr()
    B, T, Hk, D = kn.shape
    every = ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]
    elem = k_dst.element_size()
    plan = plan_paged_append(B, T, Hk, D, elem, every % 16 == 0)
    check_paged_append_plan(name, plan, B * T * Hk, D * elem, every)
    return ptrs, plan


def _launch_rows(name, k_pages, v_pages, k_new, v_new, positions,
                 block_tables, layer, page_size, k_scale, v_scale, ks_new,
                 vs_new):
    """The ragged (T = 1) and windowed appends: one entry point for both."""
    L, P, Hk, PS, D = k_pages.shape
    B, T = k_new.shape[:2]
    if k_new.shape != (B, T, Hk, D) or T < 1:
        raise ValueError(f"{name}: new rows must be [B, T, {Hk}, {D}], not "
                         f"{tuple(k_new.shape)}")
    scales = None if k_scale is None else (k_scale, v_scale)
    tables = check_paged(name, (k_new, v_new), (k_pages, v_pages),
                         block_tables, page_size, layer, scales=scales)
    ksn, vsn = _check_new_scales(name, k_new, scales, ks_new, vs_new)
    if positions.shape != (B,) or positions.device != k_pages.device:
        raise ValueError(f"{name}: positions must be [{B}] on the pools' "
                         f"device")
    pos = positions.to(torch.int32).contiguous()
    ptrs, plan = _row_operands(name, k_pages, v_pages, k_new, v_new)
    rc = cuda_lib.library().qie_paged_append_ragged_t(
        *ptrs[:2], _ptr(k_scale), _ptr(v_scale), *ptrs[2:], _ptr(ksn),
        _ptr(vsn), pos.data_ptr(), tables.data_ptr(), L, P, B, T, Hk, PS, D,
        tables.shape[1], int(layer), *plan,
        cuda_lib.stream_handle(k_pages.device))
    cuda_lib.check(rc, name)


def paged_append_ragged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, block_tables: torch.Tensor,
                        layer: int, *, page_size: int, k_scale=None,
                        v_scale=None, ks_new=None, vs_new=None):
    """Decode append into the stacked pools ``[L, P, Hk, page, D]``, in
    place: row b's ``k/v_new [B, 1, Hk, D]`` at ``positions[b]`` through
    ``block_tables[b]``; ``positions [B]`` and the tables stay on the
    device (read by the kernel).  An int8 pool takes int8 rows, their
    scales ``ks/vs_new [B, 1, Hk]`` and its own ``k/v_scale``.  Returns the
    two pools.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises."""
    if k_pages.device.type == "cpu":
        return paged_append_ragged_plain(k_pages, v_pages, k_new, v_new,
                                         positions, block_tables, layer,
                                         page_size, k_scale, v_scale, ks_new,
                                         vs_new)
    if k_new.shape[1] != 1:
        raise ValueError(f"paged_append_ragged: new rows must be [B, 1, Hk, "
                         f"D], not {tuple(k_new.shape)}")
    _launch_rows("paged_append_ragged", k_pages, v_pages, k_new, v_new,
                 positions, block_tables, layer, page_size, k_scale, v_scale,
                 ks_new, vs_new)
    paged_append_ragged.launches += 1
    return k_pages, v_pages


paged_append_ragged.launches = 0


def paged_append_ragged_t(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          positions: torch.Tensor, block_tables: torch.Tensor,
                          layer: int, *, page_size: int, k_scale=None,
                          v_scale=None, ks_new=None, vs_new=None):
    """Verify-window append into the stacked pools, in place: row b's ``k/
    v_new [B, T, Hk, D]`` at ``positions[b] .. positions[b] + T - 1``
    through ``block_tables[b]`` (any T: each token finds its own page, the
    caller allocates them); a negative start skips the row.
    An int8 pool takes int8 rows with their scales ``[B, T, Hk]``.
    Returns the two pools.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises."""
    if k_pages.device.type == "cpu":
        return paged_append_ragged_t_plain(k_pages, v_pages, k_new, v_new,
                                           positions, block_tables, layer,
                                           page_size, k_scale, v_scale,
                                           ks_new, vs_new)
    _launch_rows("paged_append_ragged_t", k_pages, v_pages, k_new, v_new,
                 positions, block_tables, layer, page_size, k_scale, v_scale,
                 ks_new, vs_new)
    paged_append_ragged_t.launches += 1
    return k_pages, v_pages


paged_append_ragged_t.launches = 0


def paged_append_prefill_plain(k_pages, v_pages, k_new, v_new, start: int,
                               block_tables, layer: int, page_size: int,
                               k_scale=None, v_scale=None, ks_new=None,
                               vs_new=None):
    """Write ``k/v_new [1, T, Hk, D]`` at ``start .. start+T-1`` through
    ``block_tables [1, max_pages]`` into ``pages[layer]`` (in place);
    returns the pools."""
    T = k_new.shape[1]
    pos = (int(start) + torch.arange(T, device=k_new.device))[None, :]
    return _paged_rows_plain(k_pages, v_pages, k_new, v_new, pos,
                             block_tables, layer, page_size, k_scale,
                             v_scale, ks_new, vs_new)


def paged_append_prefill(k_pages: torch.Tensor, v_pages: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         start: int, block_tables: torch.Tensor, layer: int,
                         *, page_size: int, k_scale=None, v_scale=None,
                         ks_new=None, vs_new=None):
    """Prefill-piece append of one sequence into the stacked pools, in
    place: ``k/v_new [1, T, Hk, D]`` at ``start .. start+T-1`` (``start`` a
    host int) through ``block_tables [1, max_pages]``, across page
    boundaries; an int8 pool takes int8 rows with their scales ``[1, T,
    Hk]``.  Returns the two pools.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises."""
    if k_pages.device.type == "cpu":
        return paged_append_prefill_plain(k_pages, v_pages, k_new, v_new,
                                          start, block_tables, layer,
                                          page_size, k_scale, v_scale,
                                          ks_new, vs_new)
    name = "paged_append_prefill"
    L, P, Hk, PS, D = k_pages.shape
    T = k_new.shape[1]
    if k_new.shape != (1, T, Hk, D) or not 1 <= T <= 65535:
        raise ValueError(f"{name}: new rows must be [1, T, {Hk}, {D}], not "
                         f"{tuple(k_new.shape)}")
    scales = None if k_scale is None else (k_scale, v_scale)
    tables = check_paged(name, (k_new, v_new), (k_pages, v_pages),
                         block_tables, page_size, layer, scales=scales)
    ksn, vsn = _check_new_scales(name, k_new, scales, ks_new, vs_new)
    start = int(start)
    if start < 0:
        raise IndexError(f"{name}: start {start} < 0")
    ptrs, plan = _row_operands(name, k_pages, v_pages, k_new, v_new)
    rc = cuda_lib.library().qie_paged_append_prefill(
        *ptrs[:2], _ptr(k_scale), _ptr(v_scale), *ptrs[2:], _ptr(ksn),
        _ptr(vsn), tables.data_ptr(), L, P, T, Hk, PS, D, tables.shape[1],
        int(layer), start, *plan, cuda_lib.stream_handle(k_pages.device))
    cuda_lib.check(rc, name)
    paged_append_prefill.launches += 1
    return k_pages, v_pages


paged_append_prefill.launches = 0
