"""Prompt-lookup speculative decoding (no draft model).

The port of the JAX package's ``engine/speculative.py``.  Each round
drafts ``k`` tokens per row by copying what followed the most recent
earlier occurrence of the row's final ``ngram``-token suffix in its own
history (prompt + generated: the "prompt lookup" draft, strong where
output echoes input), then verifies all drafts in ONE forward of T = k+1
tokens (``forward_hidden(..., ragged_multi=True)``: a per-row window write
and the contiguous chunk kernel with per-row starts).  The longest prefix
of drafts equal to the model's own token chain is kept (argmax for greedy,
a categorical draw per position otherwise), so greedy output is
token-identical to token-by-token decoding and every round emits 1..k+1
tokens.  KV written for rejected drafts is overwritten by the next round
before it can be attended (writes precede reads at every position).

The rounds run eagerly; the host looks at the rows' state every 4 rounds,
as the JAX loop does.

Under a ``(data, model)`` mesh (``Engine.generate_speculative`` with
``mesh``; the JAX engine runs it as GSPMD's XLA ops, whose ids equal the
run without a mesh) each rank takes its data group's rows of the batch
(padded to the engine's ``max_batch``; a padding row is done from the
start) and its TP shards: the prefill is the TP prefill
(``tp_step.make_tp_prefill_fn``'s one-chunk form, ``prefill`` with the
model group as ``reduce_group``), each verify ``forward_hidden(...,
ragged_multi=True, reduce_group=...)`` on the local contiguous cache (o's
and down's int8 activations scaled over the whole row, as under GSPMD:
``tp_step.model_group``), and greedy acceptance reads the sharded argmax of the vocabulary-sharded
logits.  The stop test is reduced over the data axis, so every group runs
the same rounds (the JAX loop stops on the whole batch; a finished row
keeps stepping, masked), and every rank returns the whole batch's ids in
prompt order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.models.qwen import (
    compute_logits,
    forward_hidden,
    prefill,
)
from qwen_inference_engine_tpu_torch.parallel.mesh import gather_data
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    data_rows,
    gather_data_rows,
    greedy_tokens,
    local_config,
    model_group,
)


def pld_draft(history: torch.Tensor, lens: torch.Tensor, *, ngram: int,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draft ``k`` tokens per row from the row's own history.

    history [B, S] (positions >= lens are don't-care); lens [B] = number of
    valid tokens.  Returns (drafts [B, k], found [B] bool).  A row with no
    earlier ngram match gets found=False and the tokens at the start of its
    history (the caller still verifies: the first verified token is always
    accepted, so correctness holds)."""
    B, S = history.shape
    dev = history.device
    lens = lens.long()
    pos = torch.arange(S, device=dev)[None, :]
    # suffix = the last `ngram` valid tokens of each row
    suf_idx = lens[:, None] - ngram + torch.arange(ngram, device=dev)[None, :]
    suffix = torch.gather(history, 1, suf_idx.clamp(min=0))
    # a window starting at j matches iff history[j:j+n] == suffix and the
    # window (plus k continuation tokens) lies strictly before the suffix
    eq = torch.ones((B, S), dtype=torch.bool, device=dev)
    for t in range(ngram):
        shifted = torch.roll(history, -t, dims=1)
        eq = eq & (shifted == suffix[:, t:t + 1])
    ok = eq & (pos + ngram <= lens[:, None] - ngram) & (pos + ngram + k <= S)
    # the LAST such window (argmax returns the first maximal index)
    j = torch.argmax(torch.where(ok, pos, torch.full_like(pos, -1)), dim=1)
    found = ok.any(dim=1)
    gather = j[:, None] + ngram + torch.arange(k, device=dev)[None, :]
    drafts = torch.gather(history, 1, gather.clamp(max=S - 1))
    return drafts, found


def speculative_step(params: dict, cfg: ModelConfig, history: torch.Tensor,
                     lens: torch.Tensor, cache, done: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *, k: int,
                     ngram: int, greedy: bool = True,
                     temperature: float = 0.7, reduce_group=None):
    """One speculation round over the contiguous cache.  history [B, S]
    holds prompt + generated so far (updated in place), lens [B] the
    valid length (= next position + 1: the last token is not yet in the
    cache).  Returns (history, lens', cache, done', n_new [B]): n_new tokens
    were appended to each row (0 once it is done).  A stochastic round
    draws position j of every row as the j-th draw of ``generator``.
    reduce_group: the TP step (``params`` / ``cache`` this model rank's
    shards, ``cfg`` the local config; greedy rounds only)."""
    B, S = history.shape
    dev = history.device
    eos = torch.tensor(list(cfg.eos_token_ids), device=dev)
    lens = lens.long()
    drafts, _ = pld_draft(history, lens, ngram=ngram, k=k)
    last = torch.gather(history, 1, lens[:, None] - 1)          # [B, 1]
    tokens = torch.cat([last, drafts], dim=1)                   # [B, k+1]
    ar = torch.arange(k + 1, device=dev)
    positions = lens[:, None] - 1 + ar[None, :]
    hidden, cache = forward_hidden(params, cfg, tokens, positions, cache,
                                   ragged_multi=True,
                                   reduce_group=reduce_group)
    logits = compute_logits(params, hidden, cfg.act_bits_lm_head)
    if greedy:
        chain = greedy_tokens(logits.reshape(B * (k + 1), -1), reduce_group,
                              cfg.vocab_size).reshape(B, k + 1)
    elif reduce_group is not None:
        raise ValueError("a stochastic round takes the whole vocabulary")
    else:
        t = max(float(temperature), 1e-6)
        chain = torch.stack(
            [torch.multinomial(torch.softmax(logits[:, j] / t, dim=-1), 1,
                               generator=generator)[:, 0]
             for j in range(k + 1)], dim=1)
    # accept drafts while draft[i] == chain[i-1]; then append chain[a]
    acc = torch.cumprod((drafts == chain[:, :-1]).long(), dim=1)
    a = acc.sum(dim=1)                                          # accepted
    within = ar[None, :] <= a[:, None]
    emit = torch.where(within, chain, torch.zeros_like(chain))
    # stop at the first EOS inside the emitted run
    is_eos = (emit[:, :, None] == eos[None, None, :]).any(dim=-1) & within
    any_eos = is_eos.any(dim=1)
    first_eos = torch.where(any_eos, torch.argmax(is_eos.long(), dim=1),
                            torch.full_like(a, k + 1))
    n_new = torch.where(done, torch.zeros_like(a),
                        torch.minimum(a + 1, first_eos + 1))
    # the emitted tokens go into the history at [lens, lens + n_new)
    keep = ar[None, :] < n_new[:, None]
    rows = torch.arange(B, device=dev)[:, None].expand(B, k + 1)
    tgt = lens[:, None] + ar[None, :]
    history[rows[keep], tgt[keep]] = emit[keep]
    return history, lens + n_new, cache, done | any_eos, n_new


def generate_speculative(params: dict, cfg: ModelConfig,
                         prompts: Sequence[Sequence[int]], cache,
                         max_new_tokens: int = 128, *, k: int = 8,
                         ngram: int = 3, mesh=None,
                         layout=None) -> List[List[int]]:
    """Greedy generation with prompt-lookup speculation over the
    contiguous cache (``cache`` holds at least ``len(prompts)`` rows).
    Token-identical to plain greedy decoding; 1..k+1 tokens per forward.
    Returns the generated ids of each prompt (cut after an EOS).

    mesh: this rank's ``(data, model)`` mesh; ``params`` and ``cache`` are
    its shards (``cache`` its data group's rows of the batch) and ``cfg``
    the global config.  Every rank returns every prompt's ids.  layout:
    the model's ``TpLayout`` (None: the even split)."""
    n = len(prompts)
    # the JAX engine runs it as GSPMD's ops: whole-row activation scales
    group = None if mesh is None or mesh.tp == 1 else model_group(
        mesh, whole_row_scales=True, layout=layout)
    cfg_l = cfg if group is None else (
        local_config(cfg, mesh.tp) if layout is None
        else layout.local_config(cfg))
    dpm = mesh if mesh is not None and mesh.dp > 1 else None
    if dpm is not None:
        # the whole batch, padded to every group's rows
        prompts = list(prompts) + [[0]] * (cache.k.shape[1] * dpm.dp - n)
    mine = data_rows(dpm, len(prompts))
    dev = cache.k.device
    max_len = max(len(p) for p in prompts)
    S = cache.k.shape[3]
    if max_len + max_new_tokens + k + 1 > S:
        raise ValueError(f"cache of {S} positions too small for prompts of "
                         f"{max_len} + {max_new_tokens} new + {k + 1}")
    hist = np.zeros((len(prompts), S), np.int64)
    lens0 = np.zeros((len(prompts),), np.int64)
    for i, p in enumerate(prompts):
        hist[i, :len(p)] = p
        lens0[i] = len(p)
    history = torch.from_numpy(hist[mine]).to(dev)
    lens = torch.from_numpy(lens0[mine]).to(dev)
    B = history.shape[0]
    logits, cache = prefill(params, cfg_l, history[:, :max_len], lens, cache,
                            reduce_group=group)
    first = greedy_tokens(logits, group, cfg.vocab_size)
    rows = torch.arange(B, device=dev)
    history[rows, lens] = first
    lens = lens + 1
    eos = torch.tensor(list(cfg.eos_token_ids), device=dev)
    padding = torch.from_numpy(np.arange(len(prompts))[mine] >= n).to(dev)
    done = (first[:, None] == eos[None, :]).any(dim=-1) | padding
    budget = lens + (max_new_tokens - 1)
    it = 0
    while True:
        history, lens, cache, done, _ = speculative_step(
            params, cfg_l, history, lens, cache, done, k=k, ngram=ngram,
            reduce_group=group)
        lens = torch.minimum(lens, budget)
        it += 1
        if it % 4 == 0 or it >= max_new_tokens:
            fin = (done | (lens >= budget)).all()
            if dpm is not None:   # every group runs the same rounds
                fin = gather_data(fin.to(torch.int32).reshape(1),
                                  dpm).bool().all()
            if bool(fin) or it >= max_new_tokens:
                break
    hist_np = gather_data_rows(history, dpm).cpu().numpy()
    lens_np = gather_data_rows(lens, dpm).cpu().numpy()
    outs = []
    for i in range(n):
        clipped = []
        for t in hist_np[i, int(lens0[i]):int(lens_np[i])].tolist():
            clipped.append(int(t))
            if t in cfg.eos_token_ids:
                break
        outs.append(clipped)
    return outs
