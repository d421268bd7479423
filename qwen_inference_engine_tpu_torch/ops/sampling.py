"""Token sampling: greedy / temperature / top-k / top-p + repetition penalty.

Plain PyTorch on the logits row.  Greedy takes the argmax of the raw
(penalized) logits, exactly as the JAX package does; the stochastic paths
draw from an explicit ``torch.Generator``, so the same seed gives the same
tokens on one device (not the JAX package's tokens: the generators differ).
Top-k is exact (``torch.topk``); the JAX package's ``approx_max_k`` option
has no counterpart.

``sample_rows`` is the serving form: every parameter is a ``[B]`` tensor,
so one decode step serves requests with different temperature / top-p /
top-k / greedy / penalties; ``k_cap`` is the top-k selection width.

``stream_generator`` is the serving engines' stream rule: one sampling
call draws from a generator seeded by (seed, stream) and, for position
j >= 1 of a speculation chain, j; a speculation round's positions are
thus independent streams, and a chained window draws exactly as the same
rounds run one by one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class SamplingParams:
    """Per-call sampling configuration (defaults as the JAX package)."""

    temperature: float = 0.7
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    # additive presence penalty on already-seen tokens (0 = off)
    presence_penalty: float = 0.0
    top_k: int = 50
    greedy: bool = False


def stream_generator(device, seed: int, stream: int,
                     position: int = 0) -> torch.Generator:
    """The generator of one sampling call: seeded by ``(seed, stream)`` and
    the chain ``position`` (0 for a plain decode tick or a prefill piece;
    position j of a speculation round's chain is stream j of that round)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream + position * 2 ** 40)
                    % (2 ** 63))
    return gen


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF-style repetition penalty: seen tokens' logits are divided by
    ``penalty`` when positive, multiplied when negative.

    logits: [B, V] fp32; seen_mask: [B, V] bool; penalty: scalar or [B].
    """
    penalty = torch.as_tensor(penalty, dtype=logits.dtype, device=logits.device)
    penalty = penalty.expand(logits.shape[:1])[:, None]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def _mask_top_p(sorted_logits: torch.Tensor, top_p) -> torch.Tensor:
    """Mask (to -inf) the tail of descending-sorted logits beyond cumulative
    probability ``top_p`` (a float or per-row ``[B]``); the top-1 is always
    kept."""
    if isinstance(top_p, torch.Tensor):
        top_p = top_p.to(sorted_logits.dtype)[:, None]
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[..., 0] = True
    return torch.where(keep, sorted_logits,
                       torch.full_like(sorted_logits, float("-inf")))


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]):
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample(logits: torch.Tensor, params: SamplingParams,
           seen_mask: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Draw one token per row. logits: [B, V] -> [B] int64."""
    logits = logits.float()
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask,
                                          params.repetition_penalty)
        logits = logits - torch.where(
            seen_mask, torch.tensor(float(params.presence_penalty),
                                    device=logits.device), 0.0)
    if params.greedy:
        return torch.argmax(logits, dim=-1)

    logits = logits / max(float(params.temperature), 1e-6)
    if params.top_k and params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])
        top_vals, top_idx = torch.topk(logits, k, dim=-1)  # descending
        top_vals = _mask_top_p(top_vals, params.top_p)
        choice = _categorical(top_vals, generator)
        return torch.gather(top_idx, 1, choice[:, None])[:, 0]
    if params.top_p < 1.0:
        top_vals, top_idx = torch.sort(logits, dim=-1, descending=True)
        top_vals = _mask_top_p(top_vals, params.top_p)
        choice = _categorical(top_vals, generator)
        return torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return _categorical(logits, generator)


def sample_rows(logits: torch.Tensor, generator: Optional[torch.Generator],
                *, k_cap: int, temperature: torch.Tensor,
                top_p: torch.Tensor, top_k: torch.Tensor,
                greedy: torch.Tensor, repetition_penalty: torch.Tensor,
                presence_penalty: Optional[torch.Tensor] = None,
                seen_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sampling, every parameter a ``[B]`` tensor on the logits'
    device: greedy rows take the exact argmax of the penalized logits; the
    others draw from their own top-k (``top_k`` 0 or above ``k_cap`` means
    ``k_cap``) and top-p after their temperature.  logits [B, V] -> [B]
    int64."""
    logits = logits.float()
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask,
                                          repetition_penalty)
        if presence_penalty is not None:
            logits = logits - torch.where(seen_mask,
                                          presence_penalty[:, None].float(),
                                          0.0)
    arg = torch.argmax(logits, dim=-1)
    scaled = logits / temperature.float().clamp(min=1e-6)[:, None]
    k_cap = min(k_cap, logits.shape[-1])
    top_vals, top_idx = torch.topk(scaled, k_cap, dim=-1)
    k_row = torch.where((top_k <= 0) | (top_k > k_cap),
                        torch.full_like(top_k, k_cap), top_k)
    lane = torch.arange(k_cap, device=logits.device)[None, :]
    top_vals = torch.where(lane < k_row[:, None], top_vals,
                           torch.full_like(top_vals, float("-inf")))
    top_vals = _mask_top_p(top_vals, top_p)
    choice = _categorical(top_vals, generator)
    drawn = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(greedy, arg, drawn)


def update_seen_mask(seen_mask: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mark ``tokens`` [B] as seen in the [B, V] presence mask (in place)."""
    seen_mask[torch.arange(seen_mask.shape[0], device=seen_mask.device),
              tokens.long()] = True
    return seen_mask


def seen_mask_from_prompts(prompt_ids: torch.Tensor, prompt_lens: torch.Tensor,
                           vocab_size: int) -> torch.Tensor:
    """Presence mask [B, V] of prompt tokens (padded positions excluded)."""
    B, T = prompt_ids.shape
    valid = torch.arange(T, device=prompt_ids.device)[None, :] < prompt_lens[:, None]
    seen = torch.zeros((B, vocab_size), dtype=torch.bool, device=prompt_ids.device)
    rows = torch.arange(B, device=prompt_ids.device)[:, None].expand(B, T)
    seen[rows[valid], prompt_ids.long()[valid]] = True
    return seen
