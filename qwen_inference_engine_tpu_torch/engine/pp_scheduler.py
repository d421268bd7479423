"""FIFO wave serving over a pipeline-parallel mesh.

The port of the JAX package's ``engine/pp_scheduler.py``
(``PPFifoScheduler``).  Pipeline parallelism cuts the layers over the
ranks (``parallel/pp_step.py``), so it cannot drop into the paged
continuous-batching scheduler, whose page pool and per-slot admission
assume every rank holds every layer.  It serves requests in waves:

* admit up to ``max_batch`` pending requests (one whose prompt plus
  ``max_new_tokens`` exceeds ``max_seq`` finishes as ``rejected``);
* prefill them together through the pipeline's forward (ragged lengths,
  T the longest prompt rounded up to a multiple of 8, at least 8), the
  seen mask set from the prompts;
* decode: a full wave whose rows stand at one position rides the 1F1B
  decode (``make_pp_decode_1f1b``: greedy, sampled, or penalized with the
  seen mask carried through the ticks); a ragged or partial wave takes
  the per-tick forward, ``n`` ticks chained with one host sync a window;
* a wave drains before the next is admitted (a finished row idles its
  lane: FIFO semantics, against the slot scheduler's continuous
  batching).

The engine contract is the serving engine's (``submit``, ``cancel``,
``has_work``, ``step``, ``step_batch``, ``run_to_completion``, ``k_cap``,
``metrics``, ``on_token``), so ``server/http.Server`` serves over it as
over ``ContinuousBatchingEngine``.  Every rank of the mesh builds the same
scheduler and runs the same calls: every rank samples the same broadcast
logits with the same generators, so every rank holds the same tokens and
takes the same host decisions.

Sampling draws from ``stream_generator`` (``ops/sampling.py``): stream
``step_count`` for a prefill or a decode tick, and within a 1F1B call
position ``t`` of that stream for tick ``t`` (the JAX ``fold_in(rkey,
t)``).  The streams are not the JAX package's, so only greedy rows match
it token for token.  As in the JAX scheduler, a request's ``timeout_s``
is not read.
"""

from __future__ import annotations

import time
import types
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.engine.engine import resolve_device
from qwen_inference_engine_tpu_torch.engine.types import (
    FinishedRequest,
    Request,
    _is_stop,
)
from qwen_inference_engine_tpu_torch.models.qwen import params_to
from qwen_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
    sample_rows,
    stream_generator,
    update_seen_mask,
)
from qwen_inference_engine_tpu_torch.parallel.pp_step import (
    make_pp_decode_1f1b,
    make_pp_forward_fn,
    pp_cache,
    pp_refusal,
    shard_for_pp,
)
from qwen_inference_engine_tpu_torch.utils.metrics import Metrics


class PPFifoScheduler:
    def __init__(self, cfg: ModelConfig, params: dict, *, mesh,
                 max_batch: int = 8, max_seq: int = 2048,
                 kv_dtype=torch.bfloat16,
                 sampling: Optional[SamplingParams] = None, seed: int = 1234,
                 on_token=None, device=None):
        stages = dict(mesh.shape)["stage"]
        why = pp_refusal(cfg, stages)
        if why is not None:
            raise ValueError(f"the pipeline does not take this model ({why})")
        if max_batch % stages:
            raise ValueError(f"max_batch={max_batch} must divide into one "
                             f"microbatch per stage (1F1B, {stages} stages)")
        self.cfg = cfg
        self.mesh = mesh
        self.stages = stages
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.sampling = sampling or SamplingParams()
        self.seed = seed
        self.on_token = on_token
        self.metrics = Metrics()
        self.k_cap = (cfg.vocab_size if self.sampling.top_k == 0
                      else max(64, self.sampling.top_k))
        self._eos = set(cfg.eos_token_ids)
        self.params = params_to(shard_for_pp(params, None, mesh)[0],
                                self.device)
        self.cache = pp_cache(cfg, mesh, max_batch, max_seq, kv_dtype,
                              self.device)
        self._pending: deque = deque()
        self._wave: List[Optional[dict]] = []   # per-row state this wave
        self._finished: List[FinishedRequest] = []
        self._step_count = 0
        self._seen = torch.zeros((max_batch, cfg.vocab_size),
                                 dtype=torch.bool, device=self.device)
        self._sp_rows_d: Dict[str, torch.Tensor] = {}
        # the pipeline's functions by the JAX scheduler's jit keys
        self._fns: Dict[tuple, object] = {}

    # ------------------------------------------------------------ API
    def submit(self, req: Request) -> None:
        self._pending.append(req)

    def cancel(self, request_id: int) -> bool:
        for i, r in enumerate(self._pending):
            if r.request_id == request_id:
                del self._pending[i]
                self._finished.append(
                    FinishedRequest(request_id, [], "cancelled"))
                return True
        for row in self._wave:
            if row is not None and row["req"].request_id == request_id:
                self._finish_row(row, "cancelled")
                return True
        return False

    def has_work(self) -> bool:
        return bool(self._pending) or any(r is not None for r in self._wave)

    def step(self) -> List[FinishedRequest]:
        return self.step_batch(1)

    def run_to_completion(self, sync_every: int = 8) -> List[FinishedRequest]:
        out: List[FinishedRequest] = []
        while self.has_work():
            out.extend(self.step_batch(sync_every))
        out.extend(self._drain())
        return out

    # ------------------------------------------------------ internals
    def _drain(self) -> List[FinishedRequest]:
        out, self._finished = self._finished, []
        return out

    def _finish_row(self, row: dict, reason: str) -> None:
        self._finished.append(
            FinishedRequest(row["req"].request_id, row["gen"], reason))
        self._wave[row["slot"]] = None

    def _fn(self, key: tuple):
        """The pipeline function of a JAX jit key: ``("pp_prefill", T)``,
        ``("pp_decode",)`` or ``("pp_1f1b", steps, sampled, penalized)``."""
        if key not in self._fns:
            if key[0] == "pp_1f1b":
                _, steps, sampled, penalized = key
                self._fns[key] = make_pp_decode_1f1b(
                    self.cfg, self.mesh,
                    microbatch_rows=self.max_batch // self.stages,
                    steps=steps, sampled=sampled, k_cap=self.k_cap,
                    penalized=penalized)
            else:
                self._fns[key] = make_pp_forward_fn(self.cfg, self.mesh)
        return self._fns[key]

    def _generator(self, stream: int) -> torch.Generator:
        return stream_generator(self.device, self.seed, stream)

    def _sp_rows(self, rows) -> Dict[str, torch.Tensor]:
        B = self.max_batch
        t = np.full((B,), self.sampling.temperature, np.float32)
        p = np.full((B,), self.sampling.top_p, np.float32)
        r = np.full((B,), self.sampling.repetition_penalty, np.float32)
        pp = np.full((B,), self.sampling.presence_penalty, np.float32)
        k = np.full((B,), self.sampling.top_k, np.int64)
        g = np.full((B,), self.sampling.greedy, bool)
        for row in rows:
            if row is not None and row["req"].sampling is not None:
                sp = row["req"].sampling
                i = row["slot"]
                t[i], p[i], r[i] = (sp.temperature, sp.top_p,
                                    sp.repetition_penalty)
                pp[i], k[i], g[i] = sp.presence_penalty, sp.top_k, sp.greedy
        dev = self.device
        return {"temperature": torch.from_numpy(t).to(dev),
                "top_p": torch.from_numpy(p).to(dev),
                "repetition_penalty": torch.from_numpy(r).to(dev),
                "presence_penalty": torch.from_numpy(pp).to(dev),
                "top_k": torch.from_numpy(k).to(dev),
                "greedy": torch.from_numpy(g).to(dev)}

    def _sample(self, logits, stream: int) -> torch.Tensor:
        """Each row's token from ``logits [B, V]`` against the seen mask,
        which then marks it."""
        tok = sample_rows(logits, self._generator(stream), k_cap=self.k_cap,
                          seen_mask=self._seen, **self._sp_rows_d)
        update_seen_mask(self._seen, tok)
        return tok

    def _admit_wave(self) -> None:
        take = []
        while self._pending and len(take) < self.max_batch:
            req = self._pending.popleft()
            if len(req.prompt) + req.max_new_tokens > self.max_seq:
                self._finished.append(
                    FinishedRequest(req.request_id, [], "rejected"))
                continue
            take.append(req)
        if not take:
            return
        B = self.max_batch
        T = max(len(r.prompt) for r in take)
        T = max(8, -(-T // 8) * 8)
        tokens = np.zeros((B, T), np.int64)
        lens = np.ones((B,), np.int64)
        seen = np.zeros((B, self.cfg.vocab_size), bool)
        self._wave = [None] * B
        for i, req in enumerate(take):
            tokens[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
            seen[i, np.asarray(req.prompt, np.int64)] = True
            self._wave[i] = {"req": req, "slot": i, "gen": [],
                             "pos": len(req.prompt), "last": 0}
        dev = self.device
        self._seen = torch.from_numpy(seen).to(dev)
        self._sp_rows_d = self._sp_rows(self._wave)
        stream = self._step_count
        self._step_count += 1
        t0 = time.perf_counter()
        tok_d = torch.from_numpy(tokens).to(dev)
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        logits, self.cache = self._fn(("pp_prefill", T))(
            self.params, tok_d, positions, torch.from_numpy(lens).to(dev),
            self.cache)
        tok = self._sample(logits, stream).cpu().numpy()
        self.metrics.observe_ttft(time.perf_counter() - t0)
        self.metrics.observe_prefill(int(lens.sum()))
        for row in list(self._wave):
            if row is not None:
                self._emit(row, int(tok[row["slot"]]))

    def _emit(self, row: dict, tok: int) -> bool:
        """Deliver one token to a live row; True if the row finished."""
        row["gen"].append(tok)
        # pos: tokens whose KV is written (prompt + generated but the
        # newest, which the next tick takes at this position)
        row["pos"] = len(row["req"].prompt) + len(row["gen"]) - 1
        row["last"] = tok
        if self.on_token is not None:
            self.on_token(row["req"].request_id, tok)
        if _is_stop(tok, self._eos, types.SimpleNamespace(
                request=row["req"])):
            self._finish_row(row, "eos")
            return True
        if len(row["gen"]) >= row["req"].max_new_tokens:
            self._finish_row(row, "length")
            return True
        return False

    def step_batch(self, n: int = 8) -> List[FinishedRequest]:
        live = [r for r in self._wave if r is not None]
        if not live:
            self._admit_wave()
            return self._drain()
        n = max(1, min(n,
                       min(r["req"].max_new_tokens - len(r["gen"])
                           for r in live),
                       self.max_seq - 1 - max(r["pos"] for r in live)))
        sp = self._sp_rows_d
        # a full wave at one position rides the 1F1B decode, any per-row
        # sampling mix included (sample_rows on stage 0 between hops), and
        # penalty rows too (the seen mask [M, b, V] carried through the
        # ticks); microbatches share their start position
        neutral = (bool((sp["repetition_penalty"] == 1.0).all())
                   and bool((sp["presence_penalty"] == 0.0).all()))
        aligned = (len({r["pos"] for r in live}) == 1
                   and len(live) == self.max_batch)
        all_greedy = bool(sp["greedy"].all())
        dev = self.device
        B = self.max_batch
        toks = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        for r in live:
            toks[r["slot"]] = r["last"]
            pos[r["slot"]] = r["pos"]
        tok_d = torch.from_numpy(toks).to(dev)
        t0 = time.perf_counter()
        if aligned:
            S = self.stages
            b = B // S
            init = tok_d.reshape(S, b)
            pos0 = [live[0]["pos"]] * S
            if all_greedy and neutral:
                ys, self.cache = self._fn(("pp_1f1b", n, False, False))(
                    self.params, init, pos0, self.cache)
            else:
                sp_mb = {k: v.reshape(S, b) for k, v in sp.items()}
                fn = self._fn(("pp_1f1b", n, True, not neutral))
                args = (self.params, init, pos0, self.cache,
                        (self.seed, self._step_count), sp_mb)
                if neutral:
                    ys, self.cache = fn(*args)
                else:
                    ys, self.cache, seen = fn(
                        *args, self._seen.reshape(S, b, -1))
                    self._seen = seen.reshape(B, -1)
            mat = ys.reshape(n, B).cpu().numpy()
            self._step_count += n
        else:
            tick = self._fn(("pp_decode",))
            pos_d = torch.from_numpy(pos).to(dev)
            ones = torch.ones((B,), dtype=torch.long, device=dev)
            cols = []
            for i in range(n):
                stream = self._step_count
                self._step_count += 1
                logits, self.cache = tick(self.params, tok_d[:, None],
                                          (pos_d + i)[:, None], ones,
                                          self.cache)
                tok_d = self._sample(logits, stream)
                cols.append(tok_d)
            mat = torch.stack(cols).cpu().numpy()   # one sync for n ticks
        kept = 0
        for r in live:
            for i in range(n):
                if self._wave[r["slot"]] is not r:
                    break
                kept += 1
                if self._emit(r, int(mat[i, r["slot"]])):
                    break
        self.metrics.observe_decode(kept, time.perf_counter() - t0)
        return self._drain()
