"""T=1 GQA flash decode over the stacked contiguous KV cache.

The four wrappers launch the CUDA kernels of ``csrc/decode_attention.cu``:

* ``decode_attention_contiguous`` (the port of the JAX package's
  ``decode_attention_contiguous`` / ``_decode_kernel``): per-row lengths,
  used by the ragged batch after its K/V write;
* ``decode_attention_appending`` (the port of ``decode_attention_appending``
  / ``_decode_append_kernel``): every row at one position; the kernel
  writes the fresh K/V row into the cache in place and attends over it;
* ``decode_attention_contiguous_fresh`` (the port of
  ``decode_attention_contiguous_fresh`` / ``_decode_kernel_fresh``): per-row
  old lengths (the current token excluded) over a bf16 cache, with the
  current token's K/V merged into the softmax from the inputs, never read
  from the cache: the deferred-append decode step's attention.  There is no
  int8 form (the JAX kernel has none);
* ``decode_attention_contiguous_q8`` (the port of
  ``decode_attention_contiguous_q8`` / ``_decode_kernel_q8``): per-row
  lengths over an int8 cache with f32 scales (INT8 KV, every decode step).

All four share one kernel: S split across blocks on the tensor cores as
``plan_decode_split`` plans from the shapes alone (a call reads nothing
back and is capturable in a CUDA graph), then a merge launch.  In the
appending and fresh decodes the fresh key is staged from ``k_new`` /
``v_new`` by the split that holds it, so at one shared position their
outputs are bit-identical, and bit-identical to the ragged decode's at
lengths = position + 1 over the cache the appending decode wrote; where
the plan has one split (a batch that fills the card alone) the three bf16
decodes write the output directly and launch no merge.

``*_plain`` beside each computes the same function with the plain oracle.
The cache is ``[L, Bc, Hk, S, D]``.  The contiguous, appending and INT8-KV
decodes take ``row0``: the B rows of q are cache rows ``[row0, row0 + B)``
(the pipeline's 1F1B decode works on one microbatch's row window of the
whole cache, ``parallel/pp_step.py``), which the kernel reads (and the
appending one writes) in place; ``row0 < 0`` or ``row0 + B > Bc`` raises
``ValueError``.
"""

from __future__ import annotations

from typing import Union

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention_kmajor
from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv


def row_window(name, row0, B: int, Bc: int) -> int:
    """The row window ``[row0, row0 + B)`` inside the cache's ``Bc`` rows;
    returns row0 as an int."""
    row0 = int(row0)
    if row0 < 0 or row0 + B > Bc:
        raise ValueError(f"{name} shapes: rows [{row0}, {row0 + B}) "
                         f"outside the cache's {Bc}")
    return row0


def decode_attention_contiguous_plain(q, k_cache, v_cache, layer: int,
                                      lengths, row0: int = 0) -> torch.Tensor:
    """q [B, 1, Hq, D] over ``cache[layer, row0:row0 + B]`` with ``lengths
    [B]``."""
    B = q.shape[0]
    lengths = lengths.to(q.device).long()
    rows = slice(row0, row0 + B)
    return gqa_attention_kmajor(q, k_cache[layer, rows], v_cache[layer, rows],
                                (lengths - 1)[:, None], kv_valid_len=lengths)


def _check_decode_args(name, q, k_cache, v_cache, layer,
                       kv_dtype=torch.bfloat16):
    B, T, Hq, D = q.shape
    L, Bc, Hk, S, Dc = k_cache.shape
    if T != 1 or Dc != D or v_cache.shape != k_cache.shape or B > Bc \
            or Hq % Hk or Hq // Hk > 8:
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} (T == 1, G <= 8)")
    if D not in (64, 128):
        raise ValueError(f"{name} kernel takes D in (64, 128), not {D}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    check_cache(name, q, k_cache, v_cache, kv_dtype)


def check_cache(name, q, k_cache, v_cache, kv_dtype) -> None:
    """bf16 queries and contiguous caches of ``kv_dtype`` on q's device."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bf16 queries, not {q.dtype}")
    kind = "bf16" if kv_dtype == torch.bfloat16 else "int8"
    for t in (k_cache, v_cache):
        if t.dtype != kv_dtype or t.device != q.device:
            raise TypeError(f"{name} takes {kind} caches on the device of q, "
                            f"not {t.dtype} on {t.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs contiguous caches")


def device_position(position: Union[int, torch.Tensor], S: int,
                    device) -> torch.Tensor:
    """A shared decode position as a 1-element int32 tensor on ``device``
    (a tensor stays on the device: the kernel reads it, the host never
    waits for it)."""
    if isinstance(position, torch.Tensor):
        if position.numel() != 1 or position.device != device:
            raise ValueError("position must be one element on the device of "
                             "the cache")
        position = position.reshape(1)
        return position if position.dtype == torch.int32 \
            else position.to(torch.int32)
    if not 0 <= int(position) < S:
        raise IndexError(f"position {position} outside the cache ({S})")
    return torch.full((1,), int(position), dtype=torch.int32, device=device)


def check_aligned(name, *tensors) -> None:
    """The split kernels copy 16-byte chunks: every operand (None skipped)
    starts on a 16-byte boundary, as the C guards require."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned operands")


def decode_workspace(splits: int, B: int, Hq: int, D: int,
                     device) -> torch.Tensor:
    """The split kernels' f32 partials ``[splits, B, Hq, D]`` and
    log-sum-exps ``[splits, B, Hq]``, in one buffer."""
    return torch.empty(splits * B * Hq * (D + 1), dtype=torch.float32,
                       device=device)


def _split_operands(name, B, Hq, Hk, S, D, device, direct: bool):
    """``(span, splits, ws)`` of a split decode call: the plan, checked as
    the C guard checks it, and its workspace (None where ``direct``, a bf16
    call that writes its one split's output itself)."""
    span, splits = plan_decode_split(B, Hk, S)
    check_split_plan(name, span, splits, S)
    if direct and splits == 1:
        return span, splits, None
    ws = decode_workspace(splits, B, Hq, D, device)
    if ws.dtype != torch.float32 or ws.numel() < splits * B * Hq * (D + 1) \
            or ws.device != device:
        raise ValueError(f"{name}: the workspace must hold "
                         f"{splits * B * Hq * (D + 1)} f32 on the device")
    return span, splits, ws


def _check_new_rows(name, k_new, v_new, q, Hk):
    B, _, _, D = q.shape
    for t in (k_new, v_new):
        if t.shape != (B, 1, Hk, D) or t.device != q.device:
            raise ValueError(f"{name}: k_new/v_new must be {(B, 1, Hk, D)} "
                             f"on the device of q")
    return (k_new.to(torch.bfloat16).contiguous(),
            v_new.to(torch.bfloat16).contiguous())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_lengths(lengths, q):
    if lengths.shape != (q.shape[0],) or lengths.device != q.device:
        raise ValueError("lengths must be [B] on the device of q")
    return lengths.to(torch.int32).contiguous()


def decode_attention_contiguous(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, layer: int,
                                lengths: torch.Tensor,
                                row0=0) -> torch.Tensor:
    """Attention of ``q [B, 1, Hq, D]`` over the first ``lengths[b]`` keys of
    ``cache[layer, row0 + b]``; returns [B, 1, Hq, D].  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel or raises."""
    name = "decode_attention_contiguous"
    row0 = row_window(name, row0, q.shape[0], k_cache.shape[1])
    if q.device.type == "cpu":
        return decode_attention_contiguous_plain(q, k_cache, v_cache, layer,
                                                 lengths, row0)
    _check_decode_args(name, q, k_cache, v_cache, layer)
    B, _, Hq, D = q.shape
    L, Bc, Hk, S, _ = k_cache.shape
    lens = _check_lengths(lengths, q)
    q = q.contiguous()
    span, splits, ws = _split_operands(name, B, Hq, Hk, S, D, q.device,
                                       direct=True)
    check_aligned(name, q, k_cache, v_cache, ws)
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        _ptr(ws), out.data_ptr(), L, Bc, B, Hq, Hk, S, D, int(layer), row0,
        span, splits, D ** -0.5, cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    decode_attention_contiguous.launches += 1
    return out


decode_attention_contiguous.launches = 0


def decode_attention_appending_plain(q, k_cache, v_cache, k_new, v_new,
                                     layer: int, position: int,
                                     row0: int = 0):
    """Write ``k_new/v_new [B, 1, Hk, D]`` at ``position`` of
    ``cache[layer, row0:row0 + B]`` (in place), then attend over
    ``position + 1`` keys."""
    B = q.shape[0]
    position = int(position)
    rows = slice(row0, row0 + B)
    k_cache[layer, rows, :, position] = k_new[:, 0].to(k_cache.dtype)
    v_cache[layer, rows, :, position] = v_new[:, 0].to(v_cache.dtype)
    lengths = torch.full((B,), position + 1, dtype=torch.long, device=q.device)
    attn = decode_attention_contiguous_plain(q, k_cache, v_cache, layer,
                                             lengths, row0)
    return attn, k_cache, v_cache


def decode_attention_appending(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, layer: int,
                               position: Union[int, torch.Tensor], row0=0):
    """Append-fused decode: every row's fresh K/V at the one ``position``
    (an int, or a 1-element tensor read on the device) of cache rows
    ``[row0, row0 + B)``.  Returns ``(attn [B, 1, Hq, D], k_cache,
    v_cache)``; the caches are the same tensors, written in place.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    name = "decode_attention_appending"
    row0 = row_window(name, row0, q.shape[0], k_cache.shape[1])
    if q.device.type == "cpu":
        return decode_attention_appending_plain(q, k_cache, v_cache, k_new,
                                                v_new, layer, position, row0)
    _check_decode_args(name, q, k_cache, v_cache, layer)
    B, _, Hq, D = q.shape
    L, Bc, Hk, S, _ = k_cache.shape
    kn, vn = _check_new_rows(name, k_new, v_new, q, Hk)
    pos = device_position(position, S, q.device)
    q = q.contiguous()
    span, splits, ws = _split_operands(name, B, Hq, Hk, S, D, q.device,
                                       direct=True)
    check_aligned(name, q, k_cache, v_cache, kn, vn, ws)
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_decode_attention_appending(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), pos.data_ptr(), _ptr(ws), out.data_ptr(), L, Bc, B, Hq,
        Hk, S, D, int(layer), row0, span, splits, D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    decode_attention_appending.launches += 1
    return out, k_cache, v_cache


decode_attention_appending.launches = 0


def decode_attention_contiguous_fresh_plain(q, k_cache, v_cache, k_new,
                                            v_new, layer: int, old_lengths):
    """q [B, 1, Hq, D] (rounded to the cache's type, as ``k/v_new [B, 1, Hk,
    D]``) over the first ``old_lengths[b]`` keys of ``cache[layer, b]`` and
    the fresh key and value: a copy of the layer's rows with the fresh row
    written at ``old_lengths[b]`` (one slot longer where a row's old tokens
    fill the cache), attended as ``decode_attention_appending_plain`` does.
    The cache is not written.  Returns [B, 1, Hq, D] in q's dtype."""
    B = q.shape[0]
    S = k_cache.shape[3]
    dt = k_cache.dtype
    lens = old_lengths.to(q.device).long()
    rows = torch.arange(B, device=q.device)
    pad = int(bool((lens >= S).any()))
    layers = []
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        part = torch.nn.functional.pad(cache[layer:layer + 1, :B],
                                       (0, 0, 0, pad))
        part[0, rows, :, lens] = new[:, 0].to(dt)
        layers.append(part)
    return decode_attention_contiguous_plain(q.to(dt), *layers, 0,
                                             lens + 1).to(q.dtype)


def decode_attention_contiguous_fresh(q: torch.Tensor, k_cache: torch.Tensor,
                                      v_cache: torch.Tensor,
                                      k_new: torch.Tensor,
                                      v_new: torch.Tensor, layer: int,
                                      old_lengths: torch.Tensor
                                      ) -> torch.Tensor:
    """Attention of ``q [B, 1, Hq, D]`` over the first ``old_lengths[b]``
    keys of the bf16 ``cache[layer, b]`` (the current token not yet
    written) and the current token's ``k/v_new [B, 1, Hk, D]``; the cache
    is only read.  Returns [B, 1, Hq, D].  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return decode_attention_contiguous_fresh_plain(
            q, k_cache, v_cache, k_new, v_new, layer, old_lengths)
    name = "decode_attention_contiguous_fresh"
    if k_cache.dtype == torch.int8:
        raise TypeError(f"{name} has no int8 form (the JAX kernel has none): "
                        f"bf16 caches only")
    _check_decode_args(name, q, k_cache, v_cache, layer)
    B, _, Hq, D = q.shape
    L, Bc, Hk, S, _ = k_cache.shape
    kn, vn = _check_new_rows(name, k_new, v_new, q, Hk)
    lens = _check_lengths(old_lengths, q)
    q = q.contiguous()
    span, splits, ws = _split_operands(name, B, Hq, Hk, S, D, q.device,
                                       direct=True)
    check_aligned(name, q, k_cache, v_cache, kn, vn, ws)
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_decode_attention_fresh(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        kn.data_ptr(), vn.data_ptr(), _ptr(ws), out.data_ptr(), L, Bc, B, Hq,
        Hk, S, D, int(layer), span, splits, D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    decode_attention_contiguous_fresh.launches += 1
    return out


decode_attention_contiguous_fresh.launches = 0


SPLIT_KEYS = 64                 # the tensor-core core's key tile
SPLIT_TARGET_BLOCKS = 2 * 132    # two blocks on each of the H100's SMs


def plan_decode_split(B: int, Hk: int, S: int):
    """The split decodes' plan ``(span, splits)`` from the shapes alone
    (never the lengths or the position, so a call reads nothing back from
    the device and stays capturable in a CUDA graph): block (hk, b, s)
    attends keys ``[s * span, (s + 1) * span)`` of row b's first
    ``lengths[b]`` (the appending and fresh decodes: of its ``f + 1``, the
    last split also taking a fresh key ``f`` at S).
    The span is a whole number of 64-key tiles, the fewest that give
    ``B * Hk * splits >= SPLIT_TARGET_BLOCKS`` (or one tile a split where
    S has too few); ``splits * span`` covers S once.  A batch that fills
    the card alone gets one split."""
    tiles = -(-S // SPLIT_KEYS)
    want = -(-SPLIT_TARGET_BLOCKS // (B * Hk))
    span = max(1, tiles // want) * SPLIT_KEYS
    return span, -(-S // span)


def check_split_plan(name, span: int, splits: int, S: int) -> None:
    """The C guard's rule for a split plan: spans of whole 64-key tiles,
    splits covering S exactly once."""
    if (span <= 0 or span % SPLIT_KEYS or splits < 1
            or (splits - 1) * span >= S or splits * span < S):
        raise ValueError(f"{name}: split plan span {span} x {splits} must be "
                         f"a multiple of {SPLIT_KEYS} keys covering S = {S} "
                         f"once")


def decode_attention_contiguous_q8_plain(q, k_cache, v_cache, k_scale,
                                         v_scale, layer: int, lengths,
                                         row0: int = 0) -> torch.Tensor:
    """q [B, 1, Hq, D] over the dequantized ``cache[layer, row0:row0 + B]``
    (in q's dtype) with ``lengths [B]``."""
    rows = slice(row0, row0 + q.shape[0])
    k = dequantize_kv(k_cache[layer, rows], k_scale[layer, rows], q.dtype)
    v = dequantize_kv(v_cache[layer, rows], v_scale[layer, rows], q.dtype)
    return decode_attention_contiguous_plain(q, k[None], v[None], 0, lengths)


def decode_attention_contiguous_q8(q: torch.Tensor, k_cache: torch.Tensor,
                                   v_cache: torch.Tensor,
                                   k_scale: torch.Tensor,
                                   v_scale: torch.Tensor, layer: int,
                                   lengths: torch.Tensor,
                                   row0=0) -> torch.Tensor:
    """Attention of ``q [B, 1, Hq, D]`` over the first ``lengths[b]`` keys of
    the int8 ``cache[layer, row0 + b]`` with its f32 scales ``[L, Bc, Hk,
    S]``; returns [B, 1, Hq, D].  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel or raises."""
    row0 = row_window("decode_attention_contiguous_q8", row0, q.shape[0],
                      k_cache.shape[1])
    if q.device.type == "cpu":
        return decode_attention_contiguous_q8_plain(q, k_cache, v_cache,
                                                    k_scale, v_scale, layer,
                                                    lengths, row0)
    _check_decode_args("decode_attention_contiguous_q8", q, k_cache, v_cache,
                       layer, kv_dtype=torch.int8)
    B, _, Hq, D = q.shape
    L, Bc, Hk, S, _ = k_cache.shape
    check_scales("decode_attention_contiguous_q8", k_cache, k_scale, v_scale)
    lens = _check_lengths(lengths, q)
    q = q.contiguous()
    span, splits, ws = _split_operands("decode_attention_contiguous_q8", B,
                                       Hq, Hk, S, D, q.device, direct=False)
    check_aligned("decode_attention_contiguous_q8", q, k_cache, v_cache, ws)
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_decode_attention_q8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
        ws.data_ptr(), out.data_ptr(), L, Bc, B, Hq, Hk, S, D, int(layer),
        row0, span, splits, D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "decode_attention_contiguous_q8")
    decode_attention_contiguous_q8.launches += 1
    return out


decode_attention_contiguous_q8.launches = 0


def check_scales(name, k_cache, k_scale, v_scale) -> None:
    """The f32 scales ``[L, Bc, Hk, S]`` of an int8 cache, contiguous and on
    its device."""
    for t in (k_scale, v_scale):
        if t.shape != k_cache.shape[:-1] or t.dtype != torch.float32 \
                or t.device != k_cache.device or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous f32 scales "
                             f"{tuple(k_cache.shape[:-1])} on the cache's "
                             f"device, not {t.dtype} {tuple(t.shape)}")
