"""In-place INT8-KV decode append into the stacked contiguous cache.

``kv_append_uniform_q8`` wraps the CUDA kernel ``csrc/kv_append.cu`` (the
port of the JAX package's ``kv_append_uniform_q8`` /
``_uniform_append_q8_kernel``): every row of an aligned batch writes its
quantized K/V row and the two scales at one shared position.
``kv_append_uniform_q8_plain`` beside it is the plain indexed write.  The
quantization itself (``quant/kv_quant.py``) stays outside the kernel, as
in the JAX package.
"""

from __future__ import annotations

from typing import Union

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    check_row0,
    check_scales,
    device_position,
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
