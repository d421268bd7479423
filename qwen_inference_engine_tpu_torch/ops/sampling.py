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

``sample`` takes the call's temperature, top-p and penalties as
``SamplingTensors`` on the device (the JAX engine's ``sp_dyn``), made once
per call; top-k, greedy and whether top-p cuts the whole vocabulary stay
host values, fixed per captured step.  Nothing in ``sample`` or
``sample_rows`` copies host data to the device or reads back from it, so
both run inside a CUDA graph: the draw is ``torch.multinomial``'s own
exponential race without its host-side check of the probabilities.

Under the TP step the logits are vocab-sharded: each model rank holds
its ``[B, V / tp]`` columns.  Both samplers then take ``vocab`` (a
``parallel/tp_step.ShardedVocab``) and run on the same candidates as on one
device: greedy rows take the sharded argmax (ties to the lowest global
id); top-k gathers each rank's top-k candidates with their global ids over
the model group and keeps the global top-k of them; top-p over the whole
vocabulary and plain temperature sampling gather the full row.  The
penalties apply to each rank's own columns of the (whole) seen mask first.
Every model rank draws from a generator seeded alike, on identical
gathered candidates, so every rank samples the same token.

``stream_generator`` is the serving engines' stream rule: one sampling
call draws from a generator seeded by (seed, stream) and, for position
j >= 1 of a speculation chain, j; a speculation round's positions are
thus independent streams, and a chained window draws exactly as the same
rounds run one by one.  ``stream_seed`` is that seed, for a generator
reseeded in place (a captured decode tick's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
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


@dataclasses.dataclass
class SamplingTensors:
    """The data fields of one call's ``SamplingParams`` as f32 scalars on
    the device, views of one buffer that ``load`` fills with a single copy:
    the temperature (at least 1e-6) and its f32 reciprocal, top-p and both
    penalties.  A captured step binds the buffer; each call loads its
    values before the step runs."""

    buf: torch.Tensor

    FIELDS = ("temperature", "inv_temperature", "top_p",
              "repetition_penalty", "presence_penalty")

    @staticmethod
    def create(device) -> "SamplingTensors":
        return SamplingTensors(torch.zeros(len(SamplingTensors.FIELDS),
                                           dtype=torch.float32, device=device))

    @staticmethod
    def of(params: SamplingParams, device) -> "SamplingTensors":
        return SamplingTensors.create(device).load(params)

    def load(self, params: SamplingParams) -> "SamplingTensors":
        temp = np.float32(max(float(params.temperature), 1e-6))
        host = np.asarray([temp, np.float32(1) / temp, params.top_p,
                           params.repetition_penalty,
                           params.presence_penalty], np.float32)
        self.buf.copy_(torch.from_numpy(host))
        return self

    def __getattr__(self, name):
        if name in SamplingTensors.FIELDS:
            return self.buf[SamplingTensors.FIELDS.index(name)]
        raise AttributeError(name)


def stream_seed(seed: int, stream: int, position: int = 0) -> int:
    """The seed of one sampling call's stream (``stream_generator``)."""
    return (seed * 1_000_003 + stream + position * 2 ** 40) % (2 ** 63)


def stream_generator(device, seed: int, stream: int,
                     position: int = 0) -> torch.Generator:
    """The generator of one sampling call: seeded by ``(seed, stream)`` and
    the chain ``position`` (0 for a plain decode tick or a prefill piece;
    position j of a speculation round's chain is stream j of that round)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream, position))
    return gen


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: torch.Tensor) -> torch.Tensor:
    """HF-style repetition penalty: seen tokens' logits are divided by
    ``penalty`` when positive, multiplied when negative.

    logits: [B, V] fp32; seen_mask: [B, V] bool; penalty: an f32 tensor on
    the logits' device, a scalar or [B].
    """
    penalty = penalty.to(logits.dtype).expand(logits.shape[:1])[:, None]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def _mask_top_p(sorted_logits: torch.Tensor, top_p) -> torch.Tensor:
    """Mask (to -inf) the tail of descending-sorted logits beyond cumulative
    probability ``top_p`` (a float or per-row ``[B]``); the top-1 is always
    kept."""
    if isinstance(top_p, torch.Tensor) and top_p.dim():
        top_p = top_p.to(sorted_logits.dtype)[:, None]
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[..., 0] = True
    return torch.where(keep, sorted_logits,
                       torch.full_like(sorted_logits, float("-inf")))


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]):
    """One draw a row from the softmax of ``logits``: the exponential race
    ``argmax(p / q)``, q ~ Exp(1), that ``torch.multinomial(p, 1)`` runs
    (the same generator draws, the same bits), without its host-side check
    that the probabilities are finite, which reads back from the device."""
    probs = torch.softmax(logits, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _penalized(logits, seen_mask, vocab):
    """The seen mask's columns for these logits (this rank's shard under
    ``vocab``)."""
    return seen_mask if vocab is None else vocab.local(seen_mask)


def _argmax(logits: torch.Tensor, vocab) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) if vocab is None
            else vocab.argmax(logits))


def _topk(logits: torch.Tensor, k: int, vocab):
    """(values, global ids) of each row's top ``k``, descending."""
    if vocab is None:
        return torch.topk(logits, k, dim=-1)
    return vocab.topk(logits, k)


def _full(logits: torch.Tensor, vocab) -> torch.Tensor:
    """The whole vocabulary's row (gathered under ``vocab``)."""
    return logits if vocab is None else vocab.full(logits)


def _vocab_size(logits: torch.Tensor, vocab) -> int:
    return logits.shape[-1] if vocab is None else vocab.size


def _divide_by_temperature(logits: torch.Tensor,
                           sp: SamplingTensors) -> torch.Tensor:
    """``logits / temperature``, bit-equal to dividing by the Python float:
    CUDA divides by a host scalar as a product with its f32 reciprocal
    (ATen's true-division kernel), the CPU divides."""
    if logits.is_cuda:
        return logits * sp.inv_temperature
    return logits / sp.temperature


def sample(logits: torch.Tensor, params: SamplingParams,
           seen_mask: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           tensors: Optional[SamplingTensors] = None,
           vocab=None) -> torch.Tensor:
    """Draw one token per row. logits: [B, V] -> [B] int64.  ``params``
    gives the host values (greedy, top-k, whether top-p cuts the whole
    vocabulary); ``tensors`` the rest (default: made from ``params``, one
    copy to the device).  ``vocab``: the logits are this model rank's
    vocabulary shard (module docstring); the seen mask stays whole."""
    sp = tensors if tensors is not None else SamplingTensors.of(
        params, logits.device)
    logits = logits.float()
    if seen_mask is not None:
        seen = _penalized(logits, seen_mask, vocab)
        logits = apply_repetition_penalty(logits, seen,
                                          sp.repetition_penalty)
        logits = logits - torch.where(seen, sp.presence_penalty, 0.0)
    if params.greedy:
        return _argmax(logits, vocab)

    logits = _divide_by_temperature(logits, sp)
    if params.top_k and params.top_k > 0:
        k = min(params.top_k, _vocab_size(logits, vocab))
        top_vals, top_idx = _topk(logits, k, vocab)  # descending
        top_vals = _mask_top_p(top_vals, sp.top_p)
        choice = _categorical(top_vals, generator)
        return torch.gather(top_idx, 1, choice[:, None])[:, 0]
    logits = _full(logits, vocab)
    if params.top_p < 1.0:
        top_vals, top_idx = torch.sort(logits, dim=-1, descending=True)
        top_vals = _mask_top_p(top_vals, sp.top_p)
        choice = _categorical(top_vals, generator)
        return torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return _categorical(logits, generator)


def sample_rows(logits: torch.Tensor, generator: Optional[torch.Generator],
                *, k_cap: int, temperature: torch.Tensor,
                top_p: torch.Tensor, top_k: torch.Tensor,
                greedy: torch.Tensor, repetition_penalty: torch.Tensor,
                presence_penalty: Optional[torch.Tensor] = None,
                seen_mask: Optional[torch.Tensor] = None,
                vocab=None) -> torch.Tensor:
    """Per-row sampling, every parameter a ``[B]`` tensor on the logits'
    device: greedy rows take the exact argmax of the penalized logits; the
    others draw from their own top-k (``top_k`` 0 or above ``k_cap`` means
    ``k_cap``) and top-p after their temperature.  logits [B, V] -> [B]
    int64; under ``vocab`` this rank's vocabulary shard (``sample``)."""
    logits = logits.float()
    if seen_mask is not None:
        seen = _penalized(logits, seen_mask, vocab)
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
        if presence_penalty is not None:
            logits = logits - torch.where(seen,
                                          presence_penalty[:, None].float(),
                                          0.0)
    arg = _argmax(logits, vocab)
    scaled = logits / temperature.float().clamp(min=1e-6)[:, None]
    k_cap = min(k_cap, _vocab_size(logits, vocab))
    top_vals, top_idx = _topk(scaled, k_cap, vocab)
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
    """Mark ``tokens`` [B] as seen in the [B, V] presence mask (in place).
    The True is made on the mask's device: a Python ``True`` assigned
    through an index is copied from the host, which a CUDA graph's capture
    refuses."""
    rows = torch.arange(seen_mask.shape[0], device=seen_mask.device)
    seen_mask.index_put_((rows, tokens.long()), seen_mask.new_ones(()))
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
