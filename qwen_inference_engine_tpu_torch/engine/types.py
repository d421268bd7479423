"""Request / response dataclasses and pure helpers of the serving engine.

The port of the JAX package's ``engine/types.py``: the request state
machine of the continuous-batching scheduler, the incremental prompt-lookup
state of a running request (``pld_*``), and ``_accept_chain``, the
acceptance rule every speculative path shares.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from qwen_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
    sample_rows,
)

# decode ticks and speculation rounds draw from the seed streams past this
# (prefill pieces draw from their request ids' streams)
DECODE_STREAM = 100_000


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 128
    sampling: Optional[SamplingParams] = None
    # wall-clock budget from submission; exceeded -> finish_reason "timeout"
    timeout_s: Optional[float] = None
    # extra per-request stop token ids (on top of the model's EOS set; like
    # EOS, the stop token is the final entry of the output)
    stop_token_ids: Optional[Sequence[int]] = None


@dataclasses.dataclass
class _Running:
    request: Request
    slot: int
    pages: List[int]
    seq_len: int                      # final length once prefilled
    generated: List[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    t_submit: float = 0.0
    prefilled: int = 0                # prompt tokens already in cache
    admit_seq: int = 0                # monotonic admission order
    # incremental prompt-lookup state (speculative decoding): ngram ->
    # latest start position, kept by _pld_draft_host so a round costs
    # O(new tokens), not O(history)
    pld_hist: Optional[List[int]] = None
    pld_index: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    pld_done: int = 0

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= len(self.request.prompt)


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    token_ids: List[int]
    finish_reason: str    # eos | length | rejected | cancelled | timeout


def _accept_chain(logits: torch.Tensor, drafts: torch.Tensor,
                  generator_at: Callable[[int], torch.Generator],
                  sp_rows: dict, seen: torch.Tensor, active: torch.Tensor, *,
                  k: int, k_cap: int,
                  vocab=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample the model's own k+1-token chain from the verify logits
    ``[B, k+1, V]`` and accept the longest prefix of ``drafts [B, k]`` equal
    to it.  Position j draws with ``generator_at(j)`` through
    ``sample_rows`` against a tentative seen mask that holds chain[:j], so
    each token's penalty context is the sequential decode's.  Returns
    (chain [B, k+1], n_new [B] in 1..k+1).  ``seen [B, V]`` is updated in
    place with only the emitted tokens of active rows: rejected positions
    and mid-prefill slots leave no trace.  ``vocab``: the logits are this
    model rank's vocabulary shard (``ops/sampling.py``)."""
    B = logits.shape[0]
    rows = torch.arange(B, device=logits.device)
    tentative = seen.clone()
    chain = []
    for j in range(k + 1):
        tok = sample_rows(logits[:, j], generator_at(j), k_cap=k_cap,
                          seen_mask=tentative, vocab=vocab, **sp_rows)
        tentative[rows, tok] = True
        chain.append(tok)
    chain = torch.stack(chain, dim=1)
    match = (drafts == chain[:, :-1]).long()
    n_new = torch.cumprod(match, dim=1).sum(dim=1) + 1
    keep = (torch.arange(k + 1, device=logits.device)[None, :]
            < n_new[:, None]) & active[:, None]
    for j in range(k + 1):
        seen[rows, chain[:, j]] = seen[rows, chain[:, j]] | keep[:, j]
    return chain, n_new


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _is_stop(tok: int, eos: set, run: _Running) -> bool:
    st = run.request.stop_token_ids
    return tok in eos or (st is not None and tok in st)
