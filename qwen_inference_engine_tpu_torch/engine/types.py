"""Request / response dataclasses and pure helpers of the serving engine.

The port of the JAX package's ``engine/types.py``: the request state
machine of the continuous-batching scheduler.  The speculative decoding
state (``pld_*``) and ``_accept_chain`` come with the speculation slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams


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

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= len(self.request.prompt)


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    token_ids: List[int]
    finish_reason: str    # eos | length | rejected | cancelled | timeout


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _is_stop(tok: int, eos: set, run: _Running) -> bool:
    st = run.request.stop_token_ids
    return tok in eos or (st is not None and tok in st)
