"""T=1 GQA flash decode over the stacked contiguous KV cache.

Both wrappers launch the CUDA kernel ``csrc/decode_attention.cu``:

* ``decode_attention_contiguous`` (the port of the JAX package's
  ``decode_attention_contiguous`` / ``_decode_kernel``): per-row lengths,
  used by the ragged batch after the plain stacked KV write;
* ``decode_attention_appending`` (the port of ``decode_attention_appending``
  / ``_decode_append_kernel``): every row at one position; the kernel
  writes the fresh K/V row into the cache in place and attends over it.

``*_plain`` beside each computes the same function with the plain oracle.
The cache is ``[L, Bc, Hk, S, D]``; ``row0`` (the pipeline-parallel batch
window of the JAX package) is accepted only as 0.
"""

from __future__ import annotations

from typing import Union

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention_kmajor


def _check_row0(row0) -> None:
    if row0 != 0:
        raise NotImplementedError("row0 != 0 (pipeline-parallel decode) is "
                                  "not ported")


def decode_attention_contiguous_plain(q, k_cache, v_cache, layer: int,
                                      lengths) -> torch.Tensor:
    """q [B, 1, Hq, D] over ``cache[layer, :B]`` with ``lengths [B]``."""
    B = q.shape[0]
    lengths = lengths.to(q.device).long()
    return gqa_attention_kmajor(q, k_cache[layer, :B], v_cache[layer, :B],
                                (lengths - 1)[:, None], kv_valid_len=lengths)


def _check_decode_args(name, q, k_cache, v_cache, layer):
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
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"{name} takes bf16 tensors on one device "
                            "(INT8 KV needs the port of the _q8 kernels)")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs contiguous caches")


def decode_attention_contiguous(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, layer: int,
                                lengths: torch.Tensor,
                                row0=0) -> torch.Tensor:
    """Attention of ``q [B, 1, Hq, D]`` over the first ``lengths[b]`` keys of
    ``cache[layer, b]``; returns [B, 1, Hq, D].  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    _check_row0(row0)
    if q.device.type == "cpu":
        return decode_attention_contiguous_plain(q, k_cache, v_cache, layer,
                                                 lengths)
    _check_decode_args("decode_attention_contiguous", q, k_cache, v_cache,
                       layer)
    B, _, Hq, D = q.shape
    L, Bc, Hk, S, _ = k_cache.shape
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("lengths must be [B] on the device of q")
    lens = lengths.to(torch.int32).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        None, None, None, out.data_ptr(), L, Bc, B, Hq, Hk, S, D, int(layer),
        D ** -0.5, cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "decode_attention_contiguous")
    decode_attention_contiguous.launches += 1
    return out


decode_attention_contiguous.launches = 0


def decode_attention_appending_plain(q, k_cache, v_cache, k_new, v_new,
                                     layer: int, position: int):
    """Write ``k_new/v_new [B, 1, Hk, D]`` at ``position`` of
    ``cache[layer, :B]`` (in place), then attend over ``position + 1`` keys."""
    B = q.shape[0]
    position = int(position)
    k_cache[layer, :B, :, position] = k_new[:, 0].to(k_cache.dtype)
    v_cache[layer, :B, :, position] = v_new[:, 0].to(v_cache.dtype)
    lengths = torch.full((B,), position + 1, dtype=torch.long, device=q.device)
    attn = decode_attention_contiguous_plain(q, k_cache, v_cache, layer,
                                             lengths)
    return attn, k_cache, v_cache


def decode_attention_appending(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, layer: int,
                               position: Union[int, torch.Tensor], row0=0):
    """Append-fused decode: every row's fresh K/V at the one ``position``
    (an int, or a 1-element tensor read on the device).  Returns
    ``(attn [B, 1, Hq, D], k_cache, v_cache)``; the caches are the same
    tensors, written in place.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises."""
    _check_row0(row0)
    if q.device.type == "cpu":
        return decode_attention_appending_plain(q, k_cache, v_cache, k_new,
                                                v_new, layer, position)
    _check_decode_args("decode_attention_appending", q, k_cache, v_cache,
                       layer)
    B, _, Hq, D = q.shape
    L, Bc, Hk, S, _ = k_cache.shape
    if k_new.shape != (B, 1, Hk, D) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be {(B, 1, Hk, D)}")
    if isinstance(position, torch.Tensor):
        if position.numel() != 1 or position.device != q.device:
            raise ValueError("position must be one element on q's device")
        pos = position.reshape(1).to(torch.int32)
    else:
        if not 0 <= int(position) < S:
            raise IndexError(f"position {position} outside the cache ({S})")
        pos = torch.full((1,), int(position), dtype=torch.int32,
                         device=q.device)
    kn = k_new.to(torch.bfloat16).contiguous()
    vn = v_new.to(torch.bfloat16).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), None,
        kn.data_ptr(), vn.data_ptr(), pos.data_ptr(), out.data_ptr(),
        L, Bc, B, Hq, Hk, S, D, int(layer), D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, "decode_attention_appending")
    decode_attention_appending.launches += 1
    return out, k_cache, v_cache


decode_attention_appending.launches = 0
