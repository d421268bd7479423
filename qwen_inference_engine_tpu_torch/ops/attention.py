"""GQA attention over a KV cache: the plain oracle.

The port of ``ops/attention.py`` of the JAX package: a pair of einsums with
an fp32 softmax.  The attention kernels (``ops/flash_attention.py``,
``ops/decode_attention.py``) run this function as their plain version on
CPU tensors and are held against it on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_positions: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-major wrapper: k/v ``[B, S, Hk, D]``."""
    return gqa_attention_kmajor(q, k.transpose(1, 2), v.transpose(1, 2),
                                q_positions, kv_valid_len)


def gqa_attention_kmajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor,
                         kv_valid_len: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Causal GQA attention of queries against a head-major cache.

    q: [B, T, Hq, D] queries (already RoPE'd / qk-normed)
    k, v: [B, Hk, S, D] keys/values at absolute slots 0..S-1
    q_positions: [B, T] absolute position of each query token
    kv_valid_len: [B] optional number of valid KV slots.

    Returns [B, T, Hq, D] in q.dtype.
    """
    B, T, Hq, D = q.shape
    Hk, S = k.shape[1], k.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, T, Hk, G, D).float()
    scores = torch.einsum("btkgd,bksd->bkgts", qg, k.float()) * D ** -0.5

    key_pos = torch.arange(S, device=q.device)
    mask = key_pos[None, None, :] <= q_positions[:, :, None]  # [B, T, S]
    if kv_valid_len is not None:
        mask = mask & (key_pos[None, None, :] < kv_valid_len[:, None, None])
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, _NEG_INF))
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = probs.to(v.dtype).float()
    out = torch.einsum("bkgts,bksd->btkgd", probs, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)
