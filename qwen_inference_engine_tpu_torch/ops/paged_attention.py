"""GQA attention of T fresh query tokens per row over the stacked page pool.

The wrappers launch the CUDA kernel ``csrc/paged_attention.cu``, the port
of the JAX package's ``_paged_bhgd`` / ``_paged_kernel`` (bf16 pool) and
``_paged_bhgd_q8`` / ``_paged_kernel_q8`` (int8 pool with per-token f32
scales ``[L, P, Hk, page]``):

* ``paged_decode_attention_stacked`` / ``_q8``: plain decode, ``q [B, 1,
  Hq, D]``; row b's query attends the first ``seq_lens[b]`` keys of its
  sequence, key j at row ``j % page`` of page ``block_tables[b, j //
  page]`` of the pool ``[L, P, Hk, page, D]`` at the layer index;
* ``paged_verify_attention_stacked`` / ``_q8``: the speculative verify,
  ``q [B, T, Hq, D]`` with T >= 2 (any window the scheduler sends,
  ``spec_k + 1``): row b's token t sits at
  ``seq_lens[b] - T + t`` (the lengths count the T fresh tokens, already
  appended) and attends keys ``[0, that]``.

``paged_decode_attention`` is the single-layer form.  The lengths and
tables stay on the device: the kernel reads them, the host never waits for
them.  The kernel takes G = Hq / Hk <= 8 (the JAX package's
``paged_verify_attention_supported``; anything else raises on the card)
and any T, where the JAX package sends T > 16 or T > page to XLA.  It is
flash-decoding on the tensor cores: each block takes up to 64 of a row's
T * G query rows of one KV head (``paged_row_groups``) over one split of
the row's keys, as ``plan_paged_split`` plans from the shapes alone (the
tables' width gives S = max_pages * page; a call reads nothing back and
is capturable in a CUDA graph), then a merge launch, none for a bf16 plan
of one split.  Since the plan follows the tables' width, a row's bits
follow it too: the serving engine passes every decode tick and verify
tables of its full ``max_pages_per_seq`` width, so a row's output does
not depend on the rows beside it (splits past a row's keys are empty).

``paged_attention_plain`` gathers the pages (``paged_read``; an int8 pool
is dequantized to q's dtype), puts zeros where keys lie at or past a row's
length (stale pages may hold anything, NaN included), and runs the plain
oracle.
"""

from __future__ import annotations

from typing import Optional

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import paged_read
from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention_kmajor
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    check_aligned,
    check_split_plan,
    decode_workspace,
    plan_decode_split,
)
from qwen_inference_engine_tpu_torch.quant.kv_quant import dequantize_kv

GROUP_ROWS = 64   # packed query rows of a block (four m16 tiles)


def check_paged(name: str, inputs, pools, block_tables: torch.Tensor,
                page_size: int, layer: int, scales=None,
                input_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The checks every paged kernel needs before it launches: ``inputs``
    (the queries ``(q [B, T, Hq, D],)`` with G = Hq / Hk <= 8, or the new
    rows ``(k_new, v_new)``, each ``[B, T, Hk, D]``) and the contiguous
    pools ``[L, P, Hk, page, D]``, bf16 or int8 with ``scales`` (their
    ``(k_scale, v_scale)``, f32 ``[L, P, Hk, page]``), on one device, D in
    {64, 128}, pages of a multiple of 8 tokens, a layer in range,
    ``block_tables [B, max_pages]`` on that device.  The inputs are of
    ``input_dtype`` (default: the pools').  Returns the tables as
    contiguous int32, as the kernels read them."""
    k_pages, v_pages = pools
    x = inputs[0]
    L, P, Hk, PS, D = k_pages.shape
    B, _, H, Dx = x.shape
    if Dx != D or v_pages.shape != k_pages.shape or H % Hk or H // Hk > 8 \
            or PS != page_size or any(t.shape != x.shape for t in inputs):
        raise ValueError(f"{name} shapes: {tuple(x.shape)}, pools "
                         f"{tuple(k_pages.shape)}, page_size {page_size} "
                         f"(G <= 8)")
    if D not in (64, 128):
        raise ValueError(f"{name} kernel takes D in (64, 128), not {D}")
    if page_size % 8:
        raise ValueError(f"{name} takes pages of a multiple of 8 tokens, "
                         f"not {page_size}")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range for {L} layers")
    kv = k_pages.dtype
    kind = {torch.bfloat16: "bf16", torch.int8: "int8"}.get(kv)
    if kind is None:
        raise TypeError(f"{name} takes bf16 or int8 pools, not {kv}")
    want_in = kv if input_dtype is None else input_dtype
    for t, want in [(t, want_in) for t in inputs] + [(k_pages, kv),
                                                     (v_pages, kv)]:
        if t.dtype != want or t.device != k_pages.device:
            raise TypeError(f"{name} takes {kind} pools and {want} inputs on "
                            f"one device, not {t.dtype} on {t.device}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name} needs contiguous pools")
    if (kv == torch.int8) != (scales is not None):
        raise TypeError(f"{name}: an int8 pool comes with its f32 scales, a "
                        f"bf16 pool without")
    for s in scales or ():
        if s.shape != k_pages.shape[:-1] or s.dtype != torch.float32 \
                or s.device != k_pages.device or not s.is_contiguous():
            raise ValueError(f"{name} takes contiguous f32 scales "
                             f"{tuple(k_pages.shape[:-1])} on the pools' "
                             f"device, not {s.dtype} {tuple(s.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.device != k_pages.device:
        raise ValueError(f"{name}: block tables must be [{B}, max_pages] on "
                         f"the pools' device, not {tuple(block_tables.shape)}")
    return block_tables.to(torch.int32).contiguous()


def masked_pages(pages_l: torch.Tensor, block_tables: torch.Tensor,
                 n_valid: torch.Tensor) -> torch.Tensor:
    """``paged_read`` of one layer (pages ``[P, Hk, page, ...]``) with every
    key at or past ``n_valid[b]`` replaced by zeros: ``[B, Hk, max_pages *
    page, ...]``."""
    view = paged_read(pages_l, block_tables)
    keep = torch.arange(view.shape[2], device=view.device)[None, :] \
        < n_valid.to(view.device).long()[:, None]
    keep = keep.reshape(*keep.shape[:1], 1, keep.shape[1],
                        *([1] * (view.dim() - 3)))
    return torch.where(keep, view, torch.zeros_like(view))


def paged_kv_plain(k_pages, v_pages, k_scale, v_scale, block_tables,
                   n_valid, layer: int, dtype):
    """One layer's K and V of each row ``[B, Hk, max_pages * page, D]``,
    zeros at or past ``n_valid``, an int8 pool dequantized to ``dtype``."""
    k = masked_pages(k_pages[layer], block_tables, n_valid)
    v = masked_pages(v_pages[layer], block_tables, n_valid)
    if k_scale is None:
        return k, v
    ks = masked_pages(k_scale[layer], block_tables, n_valid)
    vs = masked_pages(v_scale[layer], block_tables, n_valid)
    return dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype)


def paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                          page_size: int, layer: int, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """q [B, T, Hq, D]: token t of row b at ``seq_lens[b] - T + t`` over the
    first ``seq_lens[b]`` keys of row b's pages of ``pages[layer]``."""
    T = q.shape[1]
    lens = seq_lens.to(q.device).long()
    k, v = paged_kv_plain(k_pages, v_pages, k_scale, v_scale, block_tables,
                          lens, layer, q.dtype)
    positions = (lens - T)[:, None] + torch.arange(T, device=q.device)
    return gqa_attention_kmajor(q, k, v, positions, kv_valid_len=lens)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                 page_size: int, layer: int) -> torch.Tensor:
    """``paged_attention_plain`` over a bf16 or f32 pool: the plain version
    of the decode (q [B, 1, Hq, D]) and of the verify (q [B, T, Hq, D])."""
    return paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                 page_size, layer)


def paged_decode_attention_q8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                    block_tables, seq_lens, page_size: int,
                                    layer: int) -> torch.Tensor:
    """The same over the int8 pool, dequantized to q's dtype (the decode's
    and the verify's plain version)."""
    return paged_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                 page_size, layer, k_scale, v_scale)


def paged_row_groups(T: int, G: int) -> int:
    """Blocks of ``GROUP_ROWS`` packed query rows (r = t * G + h) that a
    row's T tokens of G heads need: one for the decode and for a verify of
    T * G <= 64 rows, which then reads each K/V tile once a split."""
    return -(-T * G // GROUP_ROWS)


def plan_paged_split(B: int, Hk: int, row_groups: int, S: int):
    """The paged kernel's plan ``(span, splits)`` from the shapes alone
    (never the lengths, so a call reads nothing back from the device and
    stays capturable in a CUDA graph): block (hk, b, g, s) attends keys
    ``[s * span, (s + 1) * span)`` of row b's first ``min(lens[b], S)``,
    ``S = max_pages * page`` from the tables' width.  The contiguous
    decodes' rule (``plan_decode_split``) over ``B * row_groups`` block
    rows: whole 64-key tiles, the fewest that give ``B * Hk * row_groups *
    splits >= SPLIT_TARGET_BLOCKS``, splits covering S once; at one row
    group it is that plan."""
    return plan_decode_split(B * row_groups, Hk, S)


def _launch(name, q, k_pages, v_pages, scales, block_tables, seq_lens,
            page_size: int, layer: int) -> torch.Tensor:
    B, T, Hq, D = q.shape
    L, P, Hk, PS, _ = k_pages.shape
    tables = check_paged(name, (q,), (k_pages, v_pages), block_tables,
                         page_size, layer, scales=scales,
                         input_dtype=torch.bfloat16)
    if seq_lens.shape != (B,) or seq_lens.device != q.device:
        raise ValueError(f"{name}: seq_lens must be [{B}] on the device of q")
    lens = seq_lens.to(torch.int32).contiguous()
    q = q.contiguous()
    max_pages = tables.shape[1]
    S = max_pages * PS
    span, splits = plan_paged_split(B, Hk, paged_row_groups(T, Hq // Hk), S)
    check_split_plan(name, span, splits, S)
    ws = (None if scales is None and splits == 1
          else decode_workspace(splits, B * T, Hq, D, q.device))
    ks, vs = scales if scales is not None else (None, None)
    check_aligned(name, q, k_pages, v_pages, ws)
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), None if ws is None else ws.data_ptr(),
        out.data_ptr(), L, P, B, T, Hq, Hk, PS, max_pages, D, int(layer),
        span, splits, D ** -0.5, cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    return out


def _check_tokens(name: str, q: torch.Tensor, verify: bool) -> None:
    T = q.shape[1]
    if verify and T < 2:
        raise ValueError(f"{name} takes T >= 2 tokens per row, not {T}")
    if not verify and T != 1:
        raise ValueError(f"{name} is the T == 1 decode, not T = {T}: the "
                         f"multi-query shape is paged_verify_attention_stacked")


def paged_decode_attention_stacked(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   seq_lens: torch.Tensor, page_size: int,
                                   layer: int) -> torch.Tensor:
    """Decode attention of ``q [B, 1, Hq, D]`` straight off the stacked bf16
    pool ``[L, P, Hk, page, D]`` through ``block_tables [B, max_pages]``
    with ``seq_lens [B]`` valid keys per row; returns [B, 1, Hq, D].  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    name = "paged_decode_attention_stacked"
    _check_tokens(name, q, False)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                            seq_lens, page_size, layer)
    out = _launch(name, q, k_pages, v_pages, None, block_tables, seq_lens,
                  page_size, layer)
    paged_decode_attention_stacked.launches += 1
    return out


paged_decode_attention_stacked.launches = 0


def paged_decode_attention_stacked_q8(q: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      block_tables: torch.Tensor,
                                      seq_lens: torch.Tensor, page_size: int,
                                      layer: int) -> torch.Tensor:
    """The same over the int8 pool with its f32 scales ``[L, P, Hk,
    page]``."""
    name = "paged_decode_attention_stacked_q8"
    _check_tokens(name, q, False)
    if q.device.type == "cpu":
        return paged_decode_attention_q8_plain(q, k_pages, v_pages, k_scale,
                                               v_scale, block_tables,
                                               seq_lens, page_size, layer)
    out = _launch(name, q, k_pages, v_pages, (k_scale, v_scale), block_tables,
                  seq_lens, page_size, layer)
    paged_decode_attention_stacked_q8.launches += 1
    return out


paged_decode_attention_stacked_q8.launches = 0


def paged_verify_attention_stacked(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   seq_lens: torch.Tensor, page_size: int,
                                   layer: int) -> torch.Tensor:
    """Causal attention of ``q [B, T, Hq, D]`` (T >= 2 consecutive fresh
    tokens per row, already appended) over the stacked bf16 pool:
    row b's token t sits at ``seq_lens[b] - T + t`` and attends keys
    ``[0, that]``.  Returns [B, T, Hq, D].  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel or raises."""
    name = "paged_verify_attention_stacked"
    _check_tokens(name, q, True)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                            seq_lens, page_size, layer)
    out = _launch(name, q, k_pages, v_pages, None, block_tables, seq_lens,
                  page_size, layer)
    paged_verify_attention_stacked.launches += 1
    return out


paged_verify_attention_stacked.launches = 0


def paged_verify_attention_stacked_q8(q: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      block_tables: torch.Tensor,
                                      seq_lens: torch.Tensor, page_size: int,
                                      layer: int) -> torch.Tensor:
    """The verify over the int8 pool with its f32 scales."""
    name = "paged_verify_attention_stacked_q8"
    _check_tokens(name, q, True)
    if q.device.type == "cpu":
        return paged_decode_attention_q8_plain(q, k_pages, v_pages, k_scale,
                                               v_scale, block_tables,
                                               seq_lens, page_size, layer)
    out = _launch(name, q, k_pages, v_pages, (k_scale, v_scale), block_tables,
                  seq_lens, page_size, layer)
    paged_verify_attention_stacked_q8.launches += 1
    return out


paged_verify_attention_stacked_q8.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           page_size: int) -> torch.Tensor:
    """The single-layer form: one layer's pool ``[P, Hk, page, D]``."""
    return paged_decode_attention_stacked(q, k_pages[None], v_pages[None],
                                          block_tables, seq_lens, page_size, 0)
