"""W4A8 quantized matmul: per-token int8 activations x INT4 plane-pair weights.

``quant_matmul4_a8`` is the wrapper of the CUDA kernel
``csrc/quant_matmul.cu`` (the port of the JAX package's
``_quant_matmul4_a8``); ``quant_matmul4_a8_plain`` beside it computes the
same function in plain PyTorch.  ``quant_matmul_stacked`` is the dispatcher
the model calls: it quantizes the activations per token outside the kernel
(as the JAX package does), pads the reduction axis, and raises on CUDA for
every variant whose kernel is not ported yet.
"""

from __future__ import annotations

import torch

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, quant_matmul


def quantize_activations(x: torch.Tensor):
    """Per-row (= per-token) symmetric int8 quantization of ``x [..., K]``.

    Returns ``(q int8 [..., K], scale f32 [..., 1])`` with ``x ~= q * scale``.
    """
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(ax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return q, sx


def quant_matmul4_a8_plain(xq, sx, q, scales, layer: int,
                           group_size: int) -> torch.Tensor:
    """Plain version of the kernel: ``bf16((xq @ dequant(q[layer])) * sx)``.

    xq int8 [M, Kp]; sx f32 [M]; q int8 [L, Kp/2, N]; scales f32
    [L, Kp/gs, N].  The int products are exact in f32 (|sum| < 2^24)."""
    one = QuantLinear(q=q[layer], scales=scales[layer], b=None, bits=4,
                      group_size=group_size)
    y = quant_matmul(xq.float(), one) * sx.reshape(-1, 1).float()
    return y.to(torch.bfloat16)


def quant_matmul4_a8(xq, sx, q, scales, layer: int,
                     group_size: int) -> torch.Tensor:
    """``bf16 [M, N] = (xq [M,Kp] int8 @ W4[layer]) * sx[M]`` on the card.

    W4 is the stacked plane-pair INT4 weight ``q [L, Kp/2, N]`` with group
    scales ``[L, Kp/gs, N]``; ``layer`` selects the slab without a copy.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if xq.device.type == "cpu":
        return quant_matmul4_a8_plain(xq, sx, q, scales, layer, group_size)
    M, Kp = xq.shape
    L, Kh, N = q.shape
    gs = group_size
    if xq.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError("quant_matmul4_a8 takes int8 activations and weights")
    if sx.dtype != torch.float32 or scales.dtype != torch.float32:
        raise TypeError("quant_matmul4_a8 takes f32 row and group scales")
    if Kh * 2 != Kp or sx.numel() != M or scales.shape != (L, Kp // gs, N):
        raise ValueError(f"quant_matmul4_a8 shapes: x {tuple(xq.shape)}, "
                         f"sx {tuple(sx.shape)}, q {tuple(q.shape)}, "
                         f"scales {tuple(scales.shape)}, gs {gs}")
    if gs % 32 or Kp % (2 * gs) or N % 128:
        raise ValueError(f"quant_matmul4_a8 kernel needs gs % 32 == 0, "
                         f"K % (2*gs) == 0 and N % 128 == 0 "
                         f"(gs={gs}, K={Kp}, N={N})")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    for t in (xq, sx, q, scales):
        if t.device != xq.device or not t.is_contiguous():
            raise ValueError("quant_matmul4_a8 needs contiguous tensors on "
                             "one device")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return out
    rc = cuda_lib.library().qie_quant_matmul4_a8(
        xq.data_ptr(), sx.data_ptr(), q.data_ptr(), scales.data_ptr(),
        out.data_ptr(), M, Kp, N, gs, int(layer), L,
        cuda_lib.stream_handle(xq.device))
    cuda_lib.check(rc, "quant_matmul4_a8")
    quant_matmul4_a8.launches += 1
    return out


quant_matmul4_a8.launches = 0


def quant_matmul_stacked(x: torch.Tensor, lin: QuantLinear, layer: int,
                         act_bits: int = 0) -> torch.Tensor:
    """``x [..., K] @ lin[layer] -> [..., N]`` for a layer-stacked QuantLinear.

    CPU: the plain dequant matmul (``ops/linear.quant_matmul``).  CUDA: the
    W4A8 kernel; the variants whose kernels are still to port raise."""
    if x.device.type == "cpu":
        return quant_matmul(x, lin.layer_slice(layer), act_bits=act_bits)
    if lin.bits != 4:
        raise NotImplementedError(
            "INT8 weights on CUDA need the ports of _quant_matmul8 and "
            "_quant_matmul8_a8 (ops/quant_matmul.py of the JAX package)")
    if act_bits != 8:
        raise NotImplementedError(
            "INT4 weights with bf16 activations on CUDA need the port of "
            "_quant_matmul4 (ops/quant_matmul.py of the JAX package); "
            "use act_bits=8")
    k_x = x.shape[-1]
    kp = lin.in_features
    if k_x > kp:
        raise ValueError(f"x has K={k_x} > the weight's {kp}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k_x).to(torch.bfloat16)
    if kp != k_x:  # quantizer-padded reduction axis
        x2 = torch.nn.functional.pad(x2, (0, kp - k_x))
    xq, sx = quantize_activations(x2)
    y = quant_matmul4_a8(xq, sx.reshape(-1).contiguous(), lin.q, lin.scales,
                         layer, lin.group_size)
    return y.reshape(*lead, lin.out_features).to(x.dtype)
