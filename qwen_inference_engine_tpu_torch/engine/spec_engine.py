"""Speculative decoding in the serving scheduler (a mixin of
``ContinuousBatchingEngine``).

The port of the JAX package's ``engine/spec_engine.py``.  Under a
``(data, model)`` mesh every forward here is the TP step on this rank's
shards (the makers of ``parallel/tp_step.py``: the verify, the
draft-model round), the drafter's greedy pick is the sharded argmax, and
acceptance samples on the vocab-sharded logits; with a data axis above 1
the verify and the round run the rows of this rank's data group, and
their logits and drafts are gathered over the data axis, so acceptance
runs on the whole batch as on one rank.  Under an EP mesh the verify and the round
are the EP step's (``parallel/ep_step.py``): this rank's slots, a dense
drafter local to them, the logits and drafts gathered so every rank
accepts on the whole batch's; a drafter's prefill piece runs on the
slot's owner alone.  Three modes over the paged pool (bf16 or
INT8), each scoring the row's last token and k drafts in one T = k+1
verify forward (``forward_hidden(..., ragged_multi=True)``:
``paged_append_ragged_t`` and ``paged_verify_attention_stacked[_q8]``)
and emitting 1..k+1 tokens per row:

* host-draft prompt lookup (``_step_speculative``, from ``step``): the
  host drafts from each slot's history (``_pld_draft_host``), one round
  per host sync;
* device-chained prompt lookup (``_spec_pld_batch``, from ``step_batch``):
  drafts come from a history buffer on the device (``pld_draft``), and the
  emitted tokens are appended there on the device, so rounds chain with
  one host sync per window; an acceptance EMA (``_pld_batch_policy``)
  falls back to plain chained decode on traffic that drafts nothing;
* draft-model speculation (``_step_speculative_model`` /
  ``_spec_model_batch``): k+1 greedy decode steps of a small same-vocab
  model over its own page pool (the target's page ids, written in
  lockstep), then the target's verify; each round's next inputs are
  computed on the device, so rounds chain too.

Every chain position is drawn through ``sample_rows`` with its own
generator: round r of the engine (its step count) and position j draw
from ``stream_generator(seed, 100_000 + r, j)``.  Greedy rows are
token-identical to plain decode; stochastic rows are exact per emitted
token (each is drawn from the model's distribution at its position, with
the sequential decode's penalty context), on streams that are not the JAX
package's.

State lives on the engine (``_hist_buf``, ``_spec_tpf_ema``, ...); this
class only groups the speculation logic.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.engine.speculative import pld_draft
from qwen_inference_engine_tpu_torch.engine.types import (
    DECODE_STREAM,
    FinishedRequest,
    _Running,
    _accept_chain,
    _is_stop,
)
from qwen_inference_engine_tpu_torch.ops.sampling import stream_generator
from qwen_inference_engine_tpu_torch.parallel.ep_step import (
    make_ep_spec_model_fn,
    make_ep_verify_fn,
)
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    gather_data_rows,
    make_tp_prefill_piece_fn,
    make_tp_spec_model_fn,
    make_tp_verify_fn,
)


class SpeculationMixin:
    def _drafter_piece(self, tokens: torch.Tensor, start: int,
                       table: torch.Tensor) -> None:
        """The drafter's prefill piece in lockstep with the target's (no
        sampling: the drafter only needs its pages filled)."""
        piece = make_tp_prefill_piece_fn(self.draft_cfg, self._tp,
                                         last=False,
                                         whole_row_scales=self._gspmd,
                                         layout=self.draft_layout)
        piece(self.draft_params, tokens, start, tokens.shape[1],
              self.draft_cache, table)

    def _verify(self, tokens, pos0, tables, drafts, active, sp_rows):
        """The T = k+1 verify forward of every slot and the acceptance:
        returns (chain [S, k+1], n_new [S]); the seen mask takes the
        emitted tokens of active rows."""
        T, r = self.spec_k + 1, self._rows
        verify = (make_ep_verify_fn(self.cfg, self._ep, T=T)
                  if self._ep is not None
                  else make_tp_verify_fn(self.cfg, self._tp, T=T,
                                         whole_row_scales=self._gspmd,
                                         layout=self.layout))
        logits, _ = verify(self.params, tokens[r], pos0[r], self.cache,
                           tables[r])
        logits = gather_data_rows(logits, self._dpm)
        return self._accept(logits, drafts, active, sp_rows)

    def _accept(self, logits, drafts, active, sp_rows):
        """The acceptance of a verify's logits ``[S, k+1, V]``: returns
        (chain [S, k+1], n_new [S]); the seen mask takes the emitted tokens
        of active rows."""
        k = self.spec_k
        stream = DECODE_STREAM + self._step_count
        chain, n_new = _accept_chain(
            logits, drafts,
            lambda j: stream_generator(self.device, self.seed, stream, j),
            sp_rows, self._seen, active, k=k, k_cap=self.k_cap,
            vocab=self._vocab)
        self._step_count += 1
        return chain, n_new

    def _model_round(self, tok_last, pos0, tables, active, sp_rows):
        """One draft-model round: k+1 greedy drafter decode steps, then the
        target's verify.  Drafter protocol: step 0 feeds the last token ->
        draft 1, steps 1..k-1 feed draft i -> draft i+1, and step k feeds
        draft k (its output unused), so the drafter writes the KV of every
        position the verify writes, in the same round, through the same
        tables.  It never rewrites a row it wrote before (a prefill piece
        rounds otherwise than a decode step, and the two pools would part):
        whatever the verify accepts, the drafter's pool holds every
        position before the next round's first.  Returns (chain, n_new)
        and the next round's (tok_last, pos0), computed on the device so
        rounds chain."""
        round_fn = (make_ep_spec_model_fn(self.cfg, self.draft_cfg, self._ep,
                                          k=self.spec_k)
                    if self._ep is not None
                    else make_tp_spec_model_fn(
                        self.cfg, self.draft_cfg, self._tp, k=self.spec_k,
                        whole_row_scales=self._gspmd, layout=self.layout,
                        dlayout=self.draft_layout))
        r = self._rows
        logits, drafts = round_fn(self.params, self.draft_params,
                                  tok_last[r], pos0[r], self.cache,
                                  self.draft_cache, tables[r])
        logits = gather_data_rows(logits, self._dpm)
        drafts = gather_data_rows(drafts, self._dpm)
        chain, n_new = self._accept(logits, drafts, active, sp_rows)
        rows = torch.arange(chain.shape[0], device=self.device)
        return chain, n_new, chain[rows, n_new - 1], pos0 + n_new

    def _model_inputs(self, decoding):
        """(tok_last, pos0, tables) of a draft-model round."""
        tok_last = np.zeros((self.max_slots,), np.int64)
        pos0 = np.zeros((self.max_slots,), np.int64)
        for s in decoding:
            tok_last[s.slot] = s.last_token      # at position s.seq_len
            pos0[s.slot] = s.seq_len
        return (self._tensor(tok_last), self._tensor(pos0),
                self._tensor(self._run_tables(decoding)))

    def _step_speculative_model(self, decoding: List[_Running]) -> None:
        """One draft-model speculation round across all decoding slots."""
        t0 = time.perf_counter()
        tl, p0, tables = self._model_inputs(decoding)
        chain, n_new, _, _ = self._model_round(
            tl, p0, tables, self._active_mask(decoding), self._sp_rows())
        self._emit_spec_round(decoding, chain[None].cpu().numpy(),
                              n_new[None].cpu().numpy(), 1,
                              time.perf_counter() - t0)

    def _spec_model_batch(self, n: int,
                          decoding: List[_Running]) -> List[FinishedRequest]:
        """Up to ``n`` draft-model rounds chained on the device with one
        host sync (each round's next inputs come out of the round itself).
        Tokens a row produced after its stop are dropped on the host; their
        KV lands on pages freed with the request."""
        rounds = self._spec_rounds_cap(n, decoding)
        t0 = time.perf_counter()
        tl, p0, tables = self._model_inputs(decoding)
        active, sp_rows = self._active_mask(decoding), self._sp_rows()
        chains, n_news = [], []
        for _ in range(rounds):
            chain, n_new, tl, p0 = self._model_round(tl, p0, tables, active,
                                                     sp_rows)
            chains.append(chain)
            n_news.append(n_new)
        self._emit_spec_batch(decoding, torch.stack(chains).cpu().numpy(),
                              torch.stack(n_news).cpu().numpy(), rounds,
                              time.perf_counter() - t0)
        return self._drain_finished()

    def _spec_rounds_cap(self, n: int, decoding) -> int:
        """How many rounds one chained batch may run: sized by the expected
        acceptance (the EMA the policy tracks), not the worst case, so rows
        near their budgets do not starve the batch (their overshoot is
        dropped, as the plain chained path's post-stop ticks are); and no
        row's verify may write at or past the end of its block-table row
        (admission's +spec_k slack guarantees that one round fits)."""
        k = self.spec_k
        rem = min(s.request.max_new_tokens - len(s.generated)
                  for s in decoding)
        est = int(max(1.0, min(self._spec_tpf_ema or (k + 1), k + 1)))
        rounds = max(1, min(n, -(-rem // est)))
        limit = self.max_pages_per_seq * self.page_size
        max_pos = max(s.seq_len for s in decoding)
        return max(1, min(rounds, (limit - max_pos - 1) // (k + 1)))

    def _emit_spec_round(self, decoding, chain_np, n_new_np, rounds,
                         elapsed) -> int:
        """Hand out ``rounds`` rounds of chains (``chain_np [rounds, slots,
        k+1]``, ``n_new_np [rounds, slots]``); a row stops at its stop token
        or budget and drops what it produced after.  Returns the tokens
        handed out."""
        kept = 0
        for s in decoding:
            done = False
            for r in range(rounds):
                if done:
                    break
                for j in range(int(n_new_np[r, s.slot])):
                    tok = int(chain_np[r, s.slot, j])
                    s.seq_len += 1
                    self._seq_lens[s.slot] = s.seq_len
                    s.generated.append(tok)
                    s.last_token = tok
                    kept += 1
                    if self.on_token is not None:
                        self.on_token(s.request.request_id, tok)
                    if _is_stop(tok, self._eos, s):
                        self._finish(s, "eos")
                        done = True
                        break
                    if len(s.generated) >= s.request.max_new_tokens:
                        self._finish(s, "length")
                        done = True
                        break
        self.metrics.observe_decode(kept, elapsed)
        # per-row normalization: tokens per forward reads as the mean
        # tokens a row emitted per verify forward (1..k+1)
        self.metrics.observe_spec(rounds * len(decoding), kept)
        return kept

    def _emit_spec_batch(self, decoding, chain_np, n_new_np, rounds,
                         elapsed) -> None:
        """``_emit_spec_round`` of a chained batch, which also feeds the
        acceptance EMA of the chained prompt-lookup policy."""
        kept = self._emit_spec_round(decoding, chain_np, n_new_np, rounds,
                                     elapsed)
        tpf = kept / max(1, rounds * len(decoding))
        self._spec_tpf_ema = (tpf if self._spec_tpf_ema is None
                              else 0.6 * self._spec_tpf_ema + 0.4 * tpf)

    # ---------------- device-chained prompt lookup --------------------
    def _hist_cap(self) -> int:
        # every budgeted token, the not-yet-ingested last token and one
        # round's overshoot past a stop
        return (self.max_pages_per_seq * self.page_size
                + 2 * (self.spec_k + 1))

    def _sync_hist(self, decoding) -> torch.Tensor:
        """Push each decoding slot's prompt + generated tokens the device
        history buffer has not seen yet (watermarked: slots that advanced
        only through chained rounds need no push, the on-device append
        already wrote exactly the tokens the host kept).  Returns the
        history lengths [slots] (seq_len + 1: the last token, whose KV the
        verify writes, included)."""
        if self._hist_buf is None:
            self._hist_buf = torch.zeros((self.max_slots, self._hist_cap()),
                                         dtype=torch.long, device=self.device)
        lens = np.zeros((self.max_slots,), np.int64)
        for s in decoding:
            h = s.request.prompt + s.generated
            lens[s.slot] = len(h)
            start = self._hist_synced.get(s.slot, 0)
            if start < len(h):
                self._hist_buf[s.slot, start:len(h)] = self._tensor(
                    np.asarray(h[start:], np.int64))
                self._hist_synced[s.slot] = len(h)
        return self._tensor(lens)

    def _pld_round(self, lens, tables, active, sp_rows):
        """One prompt-lookup round on the device: draft from the history
        buffer, verify, append the emitted tokens to the buffer.  Returns
        (chain, n_new, lens')."""
        k, hist = self.spec_k, self._hist_buf
        cap = hist.shape[1]
        rows = torch.arange(hist.shape[0], device=self.device)
        drafts, _ = pld_draft(hist, lens, ngram=self.spec_ngram, k=k)
        pos0 = (lens - 1).clamp(min=0)
        tokens = torch.cat([hist[rows, pos0][:, None], drafts], dim=1)
        chain, n_new = self._verify(tokens, pos0, tables, drafts, active,
                                    sp_rows)
        n_new = torch.where(active, n_new, torch.zeros_like(n_new))
        ar = torch.arange(k + 1, device=self.device)
        idx = (lens[:, None] + ar[None, :]).clamp(max=cap - 1)
        emit = ar[None, :] < n_new[:, None]
        hist[rows[:, None].expand_as(idx)[emit], idx[emit]] = chain[emit]
        return chain, n_new, lens + n_new

    def _spec_pld_batch(self, n: int,
                        decoding: List[_Running]) -> List[FinishedRequest]:
        """Up to ``n`` prompt-lookup rounds chained on the device with one
        host sync: drafts come from the device history buffer, so nothing
        between rounds touches the host."""
        rounds = self._spec_rounds_cap(n, decoding)
        t0 = time.perf_counter()
        lens = self._sync_hist(decoding)
        tables = self._tensor(self._run_tables(decoding))
        active, sp_rows = self._active_mask(decoding), self._sp_rows()
        chains, n_news = [], []
        for _ in range(rounds):
            chain, n_new, lens = self._pld_round(lens, tables, active,
                                                 sp_rows)
            chains.append(chain)
            n_news.append(n_new)
        self._emit_spec_batch(decoding, torch.stack(chains).cpu().numpy(),
                              torch.stack(n_news).cpu().numpy(), rounds,
                              time.perf_counter() - t0)
        # live slots consumed every emitted token, so the device rows equal
        # the host history: advance the watermark (slots that stopped were
        # cleared by _finish for their next tenant)
        for s in decoding:
            if self._slots[s.slot] is s:
                self._hist_synced[s.slot] = s.seq_len + 1
        return self._drain_finished()

    def _pld_batch_policy(self) -> str:
        """Chained prompt lookup pays a (k+1)-token verify per round even
        when no draft hits: speculate ("spec") while the acceptance EMA
        clears 1.3 tokens per forward; else run plain chained ticks
        ("plain") with a short "probe" batch every 16 batches so a shift in
        the traffic re-enables speculation."""
        if self._spec_tpf_ema is None or self._spec_tpf_ema >= 1.3:
            return "spec"
        self._spec_probe_countdown -= 1
        if self._spec_probe_countdown <= 0:
            self._spec_probe_countdown = 16
            return "probe"
        return "plain"

    def _pld_draft_host(self, run: _Running) -> Optional[List[int]]:
        """Prompt-lookup draft on the host: the spec_k tokens that followed
        the most recent earlier occurrence of the history's final
        spec_ngram-token suffix, or None when there is none (the slot then
        verifies only its mandatory first position)."""
        n, k = self.spec_ngram, self.spec_k
        if run.pld_hist is None:
            run.pld_hist = list(run.request.prompt)
        hist = run.pld_hist
        base = len(run.request.prompt)
        if len(hist) - base < len(run.generated):
            hist.extend(run.generated[len(hist) - base:])
        if len(hist) < n + 1:
            return None
        # register every ngram that already has a continuation (ending at
        # most at len-2); later registrations overwrite earlier ones, so a
        # hit is the most recent earlier occurrence
        for e in range(max(run.pld_done, n - 1), len(hist) - 1):
            run.pld_index[tuple(hist[e - n + 1:e + 1])] = e - n + 1
        run.pld_done = max(run.pld_done, len(hist) - 1)
        j = run.pld_index.get(tuple(hist[-n:]))
        if j is not None:
            cont = hist[j + n:j + n + k]
            if cont:
                return cont + [0] * (k - len(cont))
        return None

    def _step_speculative(self, decoding: List[_Running],
                          host_drafts: Dict[int, Optional[List[int]]]
                          ) -> None:
        """One round across all decoding slots with host drafts (a slot
        without one verifies drafts of -1, which no sampled token equals)."""
        k = self.spec_k
        t0 = time.perf_counter()
        toks = np.zeros((self.max_slots, k + 1), np.int64)
        drafts = np.zeros((self.max_slots, k), np.int64)
        pos0 = np.zeros((self.max_slots,), np.int64)
        for s in decoding:
            toks[s.slot, 0] = s.last_token
            d = host_drafts.get(s.slot)
            if d is not None:
                toks[s.slot, 1:] = d
                drafts[s.slot] = d
            else:
                drafts[s.slot] = -1
            pos0[s.slot] = s.seq_len
        chain, n_new = self._verify(
            self._tensor(toks), self._tensor(pos0),
            self._tensor(self._run_tables(decoding)),
            self._tensor(drafts), self._active_mask(decoding),
            self._sp_rows())
        self._emit_spec_round(decoding, chain[None].cpu().numpy(),
                              n_new[None].cpu().numpy(), 1,
                              time.perf_counter() - t0)
