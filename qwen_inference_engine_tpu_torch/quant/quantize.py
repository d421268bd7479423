"""Weight quantization: INT4 group-wise plane-pair packing (and INT8).

The port of the JAX package's ``quant/quantize.py``: the same schemes, the
same K-padding rule and the same packed bytes, so a weight quantized by
either package gives bit-identical ``q`` and ``scales``.

* INT8: symmetric per-output-channel absmax (one group over the reduction
  axis by default).
* INT4: symmetric absmax per ``group_size`` slice of the reduction axis,
  values in [-7, 7], packed two logical rows per byte (ops/linear.py).

Layer-stacked weights (and expert stacks) are quantized one ``[K, N]``
slab at a time, so the f32 temporaries of a whole stack are never live at
once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8               # 4 or 8
    group_size: int = 128       # reduction-axis group
    quantize_lm_head: bool = False
    pad_free: bool = False      # prefer a smaller group size over padding

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits={self.bits}")


def pad_free_group_size(k: int, group_size: int) -> int:
    """Largest gs <= group_size for which INT4 packing needs no K padding."""
    gs = group_size
    while gs > 2:
        if k % (2 * gs) == 0:
            kt = k // (2 * gs)
            if kt <= 20 or kt % 2 == 0:
                return gs
        gs //= 2
    return gs


def pack_int4(q: torch.Tensor, group_size: int) -> torch.Tensor:
    """Pack ``[.., K, N]`` int8 values in [-8,7] to ``[.., K//2, N]`` bytes.

    Groups 2p (low nibbles) and 2p+1 (high nibbles) share packed rows
    ``p*G..(p+1)*G``; byte ``16*hi + (lo+8)``.  Requires K % (2*G) == 0.
    """
    k, n = q.shape[-2], q.shape[-1]
    if k % (2 * group_size):
        raise ValueError(f"K={k} is not a multiple of 2*group_size")
    lead = q.shape[:-2]
    g = group_size
    qg = q.reshape(*lead, k // (2 * g), 2, g, n)
    lo = qg[..., 0, :, :].to(torch.int32)
    hi = qg[..., 1, :, :].to(torch.int32)
    packed = (hi * 16 + lo + 8).to(torch.int8)
    return packed.reshape(*lead, k // 2, n)


def _padded_k(k: int, bits: int, group_size: Optional[int]) -> int:
    """The quantizer's K-padding rule: pad so a long, odd k-tile chain can be
    halved (Qwen 7B down-proj: K=18944=512*37 -> 19456=1024*19)."""
    if bits != 4:
        return k
    gs0 = group_size or 128
    kt = -(-k // (2 * gs0))
    if kt > 20 and kt % 2 == 1:
        kt += 1
    return kt * 2 * gs0


def _final_group_size(k: int, bits: int, group_size: Optional[int]) -> int:
    if bits == 8:
        return group_size or k
    gs = group_size or 128
    while gs > 2 and (k % gs or (k // gs) % 2):
        gs //= 2
    return gs


def _quantize_2d(w: torch.Tensor, bits: int, gs: int):
    """One [K, N] weight (already padded) -> (q int8, scales f32)."""
    k, n = w.shape
    qmax = 127.0 if bits == 8 else 7.0
    wg = w.float().reshape(k // gs, gs, n)
    absmax = wg.abs().amax(dim=-2)                       # [groups, n]
    scales = absmax / qmax
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(wg / safe[:, None, :]), -qmax, qmax)
    q = q.reshape(k, n).to(torch.int8)
    if bits == 4:
        q = pack_int4(q, gs)
    return q, scales


def quantize_linear(lin: Linear, bits: int, group_size: Optional[int] = None,
                    pad_free: bool = False) -> QuantLinear:
    """Quantize a Linear: weights ``[in, out]`` or stacked with any lead
    dimensions (``[L, in, out]``, an expert stack ``[L, E, in, out]``), one
    ``[in, out]`` slab at a time."""
    w = lin.w
    k = w.shape[-2]
    if bits == 4 and pad_free:
        group_size = pad_free_group_size(k, group_size or 128)
    k_pad = _padded_k(k, bits, group_size)
    gs = _final_group_size(k_pad, bits, group_size)
    if k_pad % gs:
        raise ValueError(f"K={k_pad} is not a multiple of group size {gs}")
    lead, n = tuple(w.shape[:-2]), w.shape[-1]
    pack = 2 if bits == 4 else 1
    q = torch.empty(lead + (k_pad // pack, n), dtype=torch.int8,
                    device=w.device)
    scales = torch.empty(lead + (k_pad // gs, n), dtype=torch.float32,
                         device=w.device)
    ws, qs, ss = (t.reshape(-1, *t.shape[-2:]) for t in (w, q, scales))
    for i in range(ws.shape[0]):
        wl = ws[i].float()
        if k_pad != k:
            wl = torch.nn.functional.pad(wl, (0, 0, 0, k_pad - k))
        qs[i], ss[i] = _quantize_2d(wl, bits, gs)
        del wl
    return QuantLinear(q=q, scales=scales, b=lin.b, bits=bits, group_size=gs)


def quantize_params(params: dict, qcfg: QuantConfig) -> dict:
    """Quantize every projection Linear of a model's params, and a
    Qwen3-MoE model's expert stacks ``moe_gate`` / ``moe_up`` /
    ``moe_down`` ``[L, E, K, N]`` group-wise like a dense projection.

    The MoE ``router`` stays a bf16 Linear (small, and top-k selection is
    sensitive to it), as do norm weights, embeddings and rope tables;
    lm_head is quantized only if ``qcfg.quantize_lm_head``."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in list(layers):
        if name in ("moe_gate", "moe_up", "moe_down"):
            layers[name] = quantize_linear(Linear(w=layers[name]), qcfg.bits,
                                           qcfg.group_size,
                                           pad_free=qcfg.pad_free)
        elif name != "router" and isinstance(layers[name], Linear):
            layers[name] = quantize_linear(layers[name], qcfg.bits,
                                           qcfg.group_size,
                                           pad_free=qcfg.pad_free)
    out["layers"] = layers
    if qcfg.quantize_lm_head and isinstance(out.get("lm_head"), Linear):
        out["lm_head"] = quantize_linear(out["lm_head"], qcfg.bits,
                                         qcfg.group_size,
                                         pad_free=qcfg.pad_free)
    return out


def fuse_projections(params: dict) -> dict:
    """Concatenate q / k / v into one ``qkv`` projection and gate / up into
    one ``gateup`` (the output axis of the packed weights, the scales and,
    where every part has one, the biases), as the JAX package's function
    does, byte for byte.

    A layer then runs 4 projection matmuls where it ran 7 (and quantizes
    its activations for 4 where it did for 7 under W4A8 / W8A8).  A pair
    stays split unless every part is a ``QuantLinear`` of one bit width,
    one group size and one packed K, with a bias on all parts or none.
    Fused parameters turn off the fused MLP and the pumped decode
    (``use_mlp_kernel`` and ``pumped_supported`` ask for ``gate``), as in
    the JAX package."""
    layers = dict(params["layers"])

    def cat(names, out_name):
        lins = [layers.get(n) for n in names]
        if not all(isinstance(lin, QuantLinear) for lin in lins):
            return
        if len({lin.group_size for lin in lins}) > 1 \
                or len({lin.bits for lin in lins}) > 1 \
                or len({lin.q.shape[-2] for lin in lins}) > 1:
            return
        b = None
        if any(lin.b is not None for lin in lins):
            if not all(lin.b is not None for lin in lins):
                return
            b = torch.cat([lin.b for lin in lins], dim=-1)
        fused = QuantLinear(q=torch.cat([lin.q for lin in lins], dim=-1),
                            scales=torch.cat([lin.scales for lin in lins],
                                             dim=-1),
                            b=b, bits=lins[0].bits,
                            group_size=lins[0].group_size)
        for n in names:
            del layers[n]
        layers[out_name] = fused

    cat(("q", "k", "v"), "qkv")
    cat(("gate", "up"), "gateup")
    return dict(params, layers=layers)
