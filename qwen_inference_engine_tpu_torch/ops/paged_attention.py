"""T=1 GQA decode attention over the stacked page pool.

``paged_decode_attention_stacked`` launches the CUDA kernel
``csrc/paged_attention.cu`` (the port of the JAX package's
``paged_decode_attention_stacked`` / ``_paged_bhgd`` / ``_paged_kernel``
for plain decode, ``n_t == 1``): row b's query attends the first
``seq_lens[b]`` keys of its sequence, key j at row ``j % page`` of page
``block_tables[b, j // page]`` of the pool ``[L, P, Hk, page, D]`` at the
layer index.  ``paged_decode_attention`` is the single-layer form.  The
lengths and tables stay on the device: the kernel reads them, the host
never waits for them.

``paged_decode_attention_plain`` gathers the pages (``paged_read``), puts
zeros where keys lie at or past a row's length (stale pages may hold
anything, NaN included), and runs the plain oracle.

Not ported yet, and raising ``NotImplementedError``: the multi-query
verify shape (``paged_verify_attention_stacked``, slice 4, speculation)
and the INT8 pool (``_paged_bhgd_q8``, the INT8 paged slice).
"""

from __future__ import annotations

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import paged_read
from qwen_inference_engine_tpu_torch.ops import cuda_lib
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention_kmajor


def refuse_int8_pool(pool: torch.Tensor, kernel: str) -> None:
    """The INT8 page pool's kernels are not ported: raise naming ``kernel``,
    on the CPU as on the card."""
    if pool.dtype == torch.int8:
        raise NotImplementedError(
            f"{kernel} over the INT8 page pool is not ported yet: it comes "
            f"with the INT8 paged slice (_paged_bhgd_q8, _paged_chunk_q8 and "
            f"the scale scatters)")


def check_paged(name: str, inputs, pools, block_tables: torch.Tensor,
                page_size: int, layer: int) -> torch.Tensor:
    """The checks every paged kernel needs before it launches: ``inputs``
    (the queries ``(q [B, T, Hq, D],)`` with G = Hq / Hk <= 8, or the new
    rows ``(k_new, v_new)``, each ``[B, T, Hk, D]``) and the contiguous
    pools ``[L, P, Hk, page, D]`` bf16 on one device, D in {64, 128}, pages
    of a multiple of 8 tokens, a layer in range, ``block_tables
    [B, max_pages]`` on that device.  Returns the tables as contiguous
    int32, as the kernels read them."""
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
    for t in (*inputs, k_pages, v_pages):
        if t.dtype != torch.bfloat16 or t.device != k_pages.device:
            raise TypeError(f"{name} takes bf16 pools and inputs on one "
                            f"device, not {t.dtype} on {t.device}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name} needs contiguous pools")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.device != k_pages.device:
        raise ValueError(f"{name}: block tables must be [{B}, max_pages] on "
                         f"the pools' device, not {tuple(block_tables.shape)}")
    return block_tables.to(torch.int32).contiguous()


def masked_pages(pages_l: torch.Tensor, block_tables: torch.Tensor,
                 n_valid: torch.Tensor) -> torch.Tensor:
    """``paged_read`` of one layer with every key at or past ``n_valid[b]``
    replaced by zeros: ``[B, Hk, max_pages * page, D]``."""
    view = paged_read(pages_l, block_tables)
    keep = torch.arange(view.shape[2], device=view.device)[None, :] \
        < n_valid.to(view.device).long()[:, None]
    return torch.where(keep[:, None, :, None], view, torch.zeros_like(view))


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, seq_lens,
                                 page_size: int, layer: int) -> torch.Tensor:
    """q [B, 1, Hq, D] over the first ``seq_lens[b]`` keys of row b's pages
    of ``pages[layer]``."""
    lens = seq_lens.to(q.device).long()
    k = masked_pages(k_pages[layer], block_tables, lens)
    v = masked_pages(v_pages[layer], block_tables, lens)
    return gqa_attention_kmajor(q, k, v, (lens - 1)[:, None],
                                kv_valid_len=lens)


def paged_decode_attention_stacked(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   seq_lens: torch.Tensor, page_size: int,
                                   layer: int) -> torch.Tensor:
    """Decode attention of ``q [B, 1, Hq, D]`` straight off the stacked pool
    ``[L, P, Hk, page, D]`` through ``block_tables [B, max_pages]`` with
    ``seq_lens [B]`` valid keys per row; returns [B, 1, Hq, D].  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if q.shape[1] != 1:
        raise NotImplementedError(
            "paged_verify_attention_stacked (the multi-query verify shape "
            "of _paged_bhgd, n_t > 1) is not ported yet: it comes with the "
            "speculation slice (4)")
    refuse_int8_pool(k_pages,
                     "paged_decode_attention_stacked_q8 (_paged_bhgd_q8)")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                            seq_lens, page_size, layer)
    name = "paged_decode_attention_stacked"
    B, _, Hq, D = q.shape
    L, P, Hk, PS, _ = k_pages.shape
    tables = check_paged(name, (q,), (k_pages, v_pages), block_tables,
                         page_size, layer)
    if seq_lens.shape != (B,) or seq_lens.device != q.device:
        raise ValueError(f"{name}: seq_lens must be [{B}] on the device of q")
    lens = seq_lens.to(torch.int32).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    rc = cuda_lib.library().qie_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(), L, P, B, Hq, Hk,
        PS, tables.shape[1], D, int(layer), D ** -0.5,
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(rc, name)
    paged_decode_attention_stacked.launches += 1
    return out


paged_decode_attention_stacked.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           page_size: int) -> torch.Tensor:
    """The single-layer form: one layer's pool ``[P, Hk, page, D]``."""
    return paged_decode_attention_stacked(q, k_pages[None], v_pages[None],
                                          block_tables, seq_lens, page_size, 0)
