"""Fused decode kernels: the single-pass INT4 SwiGLU MLP, one batch half's
decode attention beside the other half's MLP in one launch, and decode
attention beside one INT4 matmul.

Three CUDA kernels of ``csrc/fused_step.cu``, each the port of one Pallas
kernel of the JAX package's ``ops/fused_step.py``, each with a plain
PyTorch version beside it:

* ``fused_mlp`` (``fused_mlp`` / ``_fused_mlp_kernel``): a layer's whole
  SwiGLU ``down(silu(x Wg) * (x Wu))`` over pad-free INT4 weights.  x is
  rounded to bf16; g and u stay in f32; h = silu(g) * u is rounded to bf16
  once, as the TPU kernel does; the output is in x's dtype.  The main
  forward takes it for W4A16 weights at M = B * T <= 256
  (``fused_mlp_supported``, the JAX package's gate, copied);
* ``fused_attn_mlp`` (``fused_attn_mlp`` / ``_fused_attn_mlp_kernel``):
  decode attention of the cache rows ``[row0, row0 + Ba)`` at layer
  ``layer_a`` (the port's decode attention numerics: f32 online softmax
  over the first ``lens[b]`` keys), and ``fused_mlp`` of layer ``layer_m``
  on an independent x; ``decode_step_pumped`` runs it twice a layer;
* ``fused_attn_matmul`` (``fused_attn_matmul`` /
  ``_fused_attn_matmul_kernel``, the JAX package's first fused prototype):
  the same decode attention beside ``y = x @ W4[layer]`` (W4A16, the
  output rounded to bf16) at the same layer, in one launch.  No entry
  point dispatches it: ``chip_smoke.py``'s ``[probe fused]``, the port of
  ``scripts/probe_fused.py``, measures how much of the two it overlaps.

The TPU kernels carry the down projection's sum from one grid step to the
next; on the card blocks run in no order, so both MLP kernels run in two
passes: gate / up / h into a workspace, then the down projection.
``fused_mlp`` runs both on the W4A16 matmul's tensor-core kernel, K split
as ``plan_fused_mlp`` plans it, and a reduce after each pass;
``fused_attn_matmul`` carries no sum across blocks and is one launch.  The
query heads are the G real ones: the JAX package pads them to G8 = 8 for
the TPU's layout.  A wrapper runs its plain
version only for a CPU tensor; for any other it checks types, shapes and
the device, then launches its kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    decode_attention_contiguous_plain,
)
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear, quant_matmul
from qwen_inference_engine_tpu_torch.ops.quant_matmul import (
    SPLIT_MIN_ROWS,
    SPLIT_TARGET_BLOCKS,
    _check as check_matmul,
    plan_split_k,
    quant_matmul4_plain,
)


def fused_mlp_supported(gate, up, down, m: int) -> bool:
    """Pad-free INT4 triple with matching shapes (the JAX package's gate):
    stacked INT4 gate / up / down without bias, gate / up out == down in
    (no K padding), F % 512, 512 % (2 * gs_down), equal gate and up group
    sizes, K % (2 * gs_gate), and m <= 256 rows."""
    for lin in (gate, up, down):
        if not isinstance(lin, QuantLinear) or lin.bits != 4 \
                or lin.b is not None or lin.q.dim() != 3:
            return False
    F_ = gate.out_features
    if up.out_features != F_ or down.in_features != F_:
        return False
    if F_ % 512 or 512 % (2 * down.group_size):
        return False
    if gate.group_size != up.group_size:
        return False
    if down.out_features % (2 * gate.group_size):
        return False
    return m <= 256


def _int4_matmul(x, q, scales, gs: int) -> torch.Tensor:
    """f32 ``x @ W4`` of one layer's slab ``q [K/2, N]``, ``scales [K/gs, N]``."""
    return quant_matmul(x.float(), QuantLinear(q=q, scales=scales, b=None,
                                               bits=4, group_size=gs))


def fused_mlp_plain(x, wg, sg, wu, su, wd, sd, layer: int, *, gs_gate: int,
                    gs_down: int) -> torch.Tensor:
    """Plain version of ``fused_mlp``, with the kernel's rounding: x to
    bf16, g and u in f32, h = bf16(silu(g) * u), the down sum in f32, the
    output in x's dtype."""
    xb = x.to(torch.bfloat16)
    g = _int4_matmul(xb, wg[layer], sg[layer], gs_gate)
    u = _int4_matmul(xb, wu[layer], su[layer], gs_gate)
    h = (F.silu(g) * u).to(torch.bfloat16)
    return _int4_matmul(h, wd[layer], sd[layer], gs_down).to(x.dtype)


def fused_attn_mlp_plain(lens, layer_a: int, layer_m: int, q, k_cache,
                         v_cache, x, wg, sg, wu, su, wd, sd, *, gs_gate: int,
                         gs_down: int, row0: int = 0):
    """Plain version of ``fused_attn_mlp``: ``decode_attention_contiguous``
    of ``q [Ba, 1, Hq, D]`` (rounded to bf16) over the cache rows
    ``[row0, row0 + Ba)`` of layer ``layer_a``, and ``fused_mlp`` of layer
    ``layer_m`` on ``x``.  Returns ``(attn [Ba, 1, Hq, D] bf16, y)``."""
    Ba = q.shape[0]
    rows = slice(row0, row0 + Ba)
    attn = decode_attention_contiguous_plain(
        q.to(torch.bfloat16), k_cache[layer_a:layer_a + 1, rows],
        v_cache[layer_a:layer_a + 1, rows], 0, lens)
    y = fused_mlp_plain(x, wg, sg, wu, su, wd, sd, layer_m, gs_gate=gs_gate,
                        gs_down=gs_down)
    return attn, y


def _check_mlp(name, x, wg, sg, wu, su, wd, sd, layer, gs_gate, gs_down):
    """The checks of the MLP operands on a non-CPU tensor, before anything
    is built or launched; returns (M, K, F, L)."""
    if x.dim() != 2:
        raise ValueError(f"{name} takes x [M, K], not {tuple(x.shape)}")
    M, K = x.shape
    L, Kh, F_ = wg.shape
    shapes_ok = (
        Kh * 2 == K and wu.shape == wg.shape and wd.shape == (L, F_ // 2, K)
        and sg.shape == (L, K // max(gs_gate, 1), F_) and su.shape == sg.shape
        and sd.shape == (L, F_ // max(gs_down, 1), K))
    if not shapes_ok:
        raise ValueError(
            f"{name} shapes: x {tuple(x.shape)}, wg {tuple(wg.shape)}, wu "
            f"{tuple(wu.shape)}, wd {tuple(wd.shape)}, sg {tuple(sg.shape)}, "
            f"su {tuple(su.shape)}, sd {tuple(sd.shape)}")
    for w in (wg, wu, wd):
        if w.dtype != torch.int8:
            raise TypeError(f"{name} takes int8 plane-pair weights, not "
                            f"{w.dtype}")
    for s in (sg, su, sd):
        if s.dtype != torch.float32:
            raise TypeError(f"{name} takes f32 scales, not {s.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"{name} takes floating-point x, not {x.dtype}")
    if (gs_gate <= 0 or gs_gate % 32 or K % (2 * gs_gate) or gs_down <= 0
            or gs_down % 32 or F_ % (2 * gs_down) or K % 64 or F_ % 64):
        raise ValueError(f"{name} kernel needs gs % 32 == 0 for gate/up and "
                         f"down, K % (2*gs_gate) == 0, F % (2*gs_down) == 0 "
                         f"and K, F multiples of 64 (K={K}, F={F_}, "
                         f"gs_gate={gs_gate}, gs_down={gs_down})")
    if M > 256:
        raise ValueError(f"{name} takes M <= 256 rows, not {M}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    for t in (wg, sg, wu, su, wd, sd):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")
    return M, K, F_, L


def _check_attn(name, lens, layer, q, k_cache, v_cache, x, row0):
    """The checks of the attention operands of the fused launches on a
    non-CPU tensor; returns (q in bf16, lens in int32), contiguous."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{name} takes q [Ba, 1, Hq, D], not "
                         f"{tuple(q.shape)}")
    Ba, _, Hq, D = q.shape
    Lc, Bc, Hk, S, Dc = k_cache.shape
    if (Dc != D or v_cache.shape != k_cache.shape or Hq % Hk
            or Hq // Hk > 8 or not 0 <= row0 or row0 + Ba > Bc):
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, row0 {row0} (G <= 8, rows "
                         f"inside the cache)")
    if D != 128:
        raise ValueError(f"{name} kernel takes D == 128, not {D}")
    if not 0 <= layer < Lc:
        raise IndexError(f"layer {layer} out of range for {Lc} layers")
    for t in (k_cache, v_cache):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"{name} takes bf16 caches on the device of q, "
                            f"not {t.dtype} on {t.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs contiguous caches")
    if lens.shape != (Ba,) or lens.device != q.device:
        raise ValueError("lens must be [Ba] on the device of q")
    if x.device != q.device:
        raise ValueError(f"{name} needs x on the device of q")
    return (q.to(torch.bfloat16).contiguous(),
            lens.to(torch.int32).contiguous())


def plan_fused_mlp(M: int, K: int, F: int, gs_gate: int, gs_down: int):
    """``fused_mlp``'s two plans, each ``(mt, splits, slice)`` as
    ``plan_split_k`` gives it: gate / up over K / 2 packed rows of both
    weights' 2 F columns (pairs of gs_gate), the down pass over F / 2
    packed rows of K columns (pairs of gs_down).  M <= 64: both as the
    matmuls plan them.  M > 64 (up to 256 rows): the decode stream's
    64-row tiles (mt 4, two blocks an SM) in both passes, which leave no
    128-row tile half empty at M = 192; gate / up over all of K (2 F / 128
    column tiles fill the card), the down pass's few tiles (7B: K / 128 x
    M / 64 = 84 at M = 192) split into about twice the decode stream's
    blocks, slices of whole pairs."""
    rows = F // 2
    if M <= 64:
        return (plan_split_k(M, K // 2, 2 * F, gs_gate),
                plan_split_k(M, rows, K, gs_down))
    tiles = -(-K // 128) * -(-M // 64)
    want = -(-2 * SPLIT_TARGET_BLOCKS // tiles)
    units = rows // gs_down
    per = max(-(-units // want), -(-SPLIT_MIN_ROWS // gs_down))
    slice_rows = min(per, units) * gs_down
    return (4, 1, K // 2), (4, -(-rows // slice_rows), slice_rows)


def _fused_mlp_workspace(M, K, F, plans, device):
    """One workspace for both passes: the f32 partials, M x max(splits1 *
    2 F, splits2 * K) values (the down pass reuses the gate / up partials'
    room), then h bf16 [M, F]."""
    (_, s1, _), (_, s2, _) = plans
    n_bytes = 4 * M * max(s1 * 2 * F, s2 * K) + 2 * M * F
    return torch.empty(n_bytes, dtype=torch.uint8, device=device)


def fused_mlp(x: torch.Tensor, wg: torch.Tensor, sg: torch.Tensor,
              wu: torch.Tensor, su: torch.Tensor, wd: torch.Tensor,
              sd: torch.Tensor, layer: int, *, gs_gate: int,
              gs_down: int) -> torch.Tensor:
    """``x [M, K] -> [M, K]``: the SwiGLU MLP of layer ``layer`` over the
    stacked pad-free INT4 weights (gate / up ``[L, K/2, F]`` with scales
    ``[L, K/gs_gate, F]``, down ``[L, F/2, K]`` with ``[L, F/gs_down, K]``).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernels
    (gate / up, SwiGLU, down and its reduce, in one C call; the workspace
    allocated here) or raises."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, wg, sg, wu, su, wd, sd, layer,
                               gs_gate=gs_gate, gs_down=gs_down)
    M, K, F_, L = _check_mlp("fused_mlp", x, wg, sg, wu, su, wd, sd, layer,
                             gs_gate, gs_down)
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    plans = plan_fused_mlp(M, K, F_, gs_gate, gs_down)
    ws = _fused_mlp_workspace(M, K, F_, plans, dev)
    y = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    rc = cuda_lib.library().qie_fused_mlp(
        xb.data_ptr(), wg.data_ptr(), sg.data_ptr(), wu.data_ptr(),
        su.data_ptr(), wd.data_ptr(), sd.data_ptr(), ws.data_ptr(),
        y.data_ptr(), M, K, F_, gs_gate, gs_down, *plans[0], *plans[1],
        int(layer), L, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, "fused_mlp")
    fused_mlp.launches += 1
    return y.to(x.dtype)


fused_mlp.launches = 0


def fused_attn_mlp(lens: torch.Tensor, layer_a: int, layer_m: int,
                   q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, x: torch.Tensor, wg, sg, wu, su,
                   wd, sd, *, gs_gate: int, gs_down: int, row0: int = 0):
    """Decode attention of ``q [Ba, 1, Hq, D]`` over the first ``lens[b]``
    keys of the cache rows ``row0 + b`` of layer ``layer_a`` (caches
    ``[L, Bc, Hk, S, D]``), and ``fused_mlp`` of layer ``layer_m`` on
    ``x [Mb, K]``, in one launch (and the MLP's down pass).  Returns
    ``(attn [Ba, 1, Hq, D] bf16, y [Mb, K] in x's dtype)``.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return fused_attn_mlp_plain(lens, layer_a, layer_m, q, k_cache,
                                    v_cache, x, wg, sg, wu, su, wd, sd,
                                    gs_gate=gs_gate, gs_down=gs_down,
                                    row0=row0)
    name = "fused_attn_mlp"
    qb, lens32 = _check_attn(name, lens, layer_a, q, k_cache, v_cache, x,
                             row0)
    M, K, F_, L = _check_mlp(name, x, wg, sg, wu, su, wd, sd, layer_m,
                             gs_gate, gs_down)
    Ba, _, Hq, D = q.shape
    Lc, Bc, Hk, S, _ = k_cache.shape
    dev = q.device
    xb = x.to(torch.bfloat16).contiguous()
    attn = torch.empty_like(qb)
    g_ws = torch.empty((M, F_), dtype=torch.float32, device=dev)
    h_ws = torch.empty((M, F_), dtype=torch.bfloat16, device=dev)
    y = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    rc = cuda_lib.library().qie_fused_attn_mlp(
        qb.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens32.data_ptr(), attn.data_ptr(), xb.data_ptr(), wg.data_ptr(),
        sg.data_ptr(), wu.data_ptr(), su.data_ptr(), wd.data_ptr(),
        sd.data_ptr(), g_ws.data_ptr(), h_ws.data_ptr(), y.data_ptr(),
        Lc, Bc, Ba, Hq, Hk, S, int(layer_a), int(row0), M, K, F_, gs_gate,
        gs_down, int(layer_m), L, D ** -0.5, cuda_lib.stream_handle(dev))
    cuda_lib.check(rc, name)
    fused_attn_mlp.launches += 1
    return attn, y.to(x.dtype)


fused_attn_mlp.launches = 0


def fused_attn_matmul_plain(lens, layer: int, q, k_cache, v_cache, x, wq,
                            wscales, *, group_size: int, row0: int = 0):
    """Plain version of ``fused_attn_matmul``: ``decode_attention_contiguous``
    of ``q [Ba, 1, Hq, D]`` (rounded to bf16) over the cache rows
    ``[row0, row0 + Ba)`` of ``layer``, and ``bf16(x @ W4[layer])`` (x
    rounded to bf16; the W4A16 matmul's plain version) in x's dtype.
    Returns ``(attn [Ba, 1, Hq, D] bf16, y [Mb, N])``."""
    Ba = q.shape[0]
    rows = slice(row0, row0 + Ba)
    attn = decode_attention_contiguous_plain(
        q.to(torch.bfloat16), k_cache[layer:layer + 1, rows],
        v_cache[layer:layer + 1, rows], 0, lens)
    y = quant_matmul4_plain(x.to(torch.bfloat16), wq, wscales, layer,
                            group_size)
    return attn, y.to(x.dtype)


def fused_attn_matmul(lens: torch.Tensor, layer: int, q: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      x: torch.Tensor, wq: torch.Tensor,
                      wscales: torch.Tensor, *, group_size: int,
                      row0: int = 0):
    """Decode attention of ``q [Ba, 1, Hq, D]`` over the first ``lens[b]``
    keys of the cache rows ``row0 + b`` of ``layer`` (caches ``[L, Bc, Hk,
    S, D]``), and ``y = x [Mb, K] @ W4[layer]`` over the stacked INT4
    plane-pair weight ``wq [L, K/2, N]`` with scales ``wscales [L, K/gs,
    N]``, in one launch.  Returns ``(attn [Ba, 1, Hq, D] bf16, y [Mb, N] in
    x's dtype)``.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises."""
    if q.device.type == "cpu":
        return fused_attn_matmul_plain(lens, layer, q, k_cache, v_cache, x,
                                       wq, wscales, group_size=group_size,
                                       row0=row0)
    name = "fused_attn_matmul"
    qb, lens32 = _check_attn(name, lens, layer, q, k_cache, v_cache, x, row0)
    if x.dim() != 2 or not x.is_floating_point():
        raise ValueError(f"{name} takes floating-point x [Mb, K], not "
                         f"{x.dtype} {tuple(x.shape)}")
    xb = x.to(torch.bfloat16).contiguous()
    gs = group_size
    K = xb.shape[1]
    check_matmul(name, xb, None, wq, wscales, layer, x_dtype=torch.bfloat16,
                 k_per_row=2, gs=gs, gs_rule="gs % 32 == 0, K % (2*gs) == 0",
                 gs_ok=gs > 0 and gs % 32 == 0 and K % (2 * gs) == 0
                 and wscales.shape[1] == K // gs, n_mult=64)
    Ba, _, Hq, D = q.shape
    Lc, Bc, Hk, S, _ = k_cache.shape
    M, N = xb.shape[0], wq.shape[2]
    attn = torch.empty_like(qb)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=q.device)
    rc = cuda_lib.library().qie_fused_attn_matmul(
        qb.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens32.data_ptr(), attn.data_ptr(), xb.data_ptr(), wq.data_ptr(),
        wscales.data_ptr(), y.data_ptr(), Lc, Bc, Ba, Hq, Hk, S, int(row0), M,
        K, N, gs, int(layer), wq.shape[0], D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    fused_attn_matmul.launches += 1
    return attn, y.to(x.dtype)


fused_attn_matmul.launches = 0
