"""Fixed-batch generation engine over the contiguous KV cache.

The port of the JAX package's ``Engine.generate``: prompt lengths padded to
power-of-two buckets (at least 16), padded batch rows given length 1, the
uniform (aligned batch) or ragged decode chosen per call, EOS masked on the
device with the host polling on a growing cadence, the seen mask for the
penalties, and TTFT / decode tok/s measured around work that ends in a
device sync.  Each step runs eagerly; no CUDA graph yet.  Decode steps
run ``decode_step`` by default, as the JAX engine does off a TPU.  An
engine built with ``pumped=True`` decodes an aligned batch through
``decode_step_pumped`` (the batch as two halves, attention beside the MLP
in one launch) wherever ``pumped_supported`` holds for its batch: the JAX
engine's TPU branch, which on the H100 is slower than the plain step.

``Engine.generate_speculative`` is greedy generation with prompt-lookup
speculation (``engine/speculative.py``): token-identical to ``generate``
with greedy sampling, 1..k+1 tokens per forward.

The engine runs on the card unless the caller passes ``device="cpu"``
(the tests do): it never drops to the CPU by itself.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models.qwen import (
    decode_step,
    decode_step_pumped,
    params_to,
    prefill_chunked,
    pumped_supported,
)
from qwen_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
    sample,
    seen_mask_from_prompts,
    update_seen_mask,
)
from qwen_inference_engine_tpu_torch.utils.metrics import Metrics


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[List[int]]      # generated ids per sequence (no prompt)
    ttft_s: float                   # time to first token (this call)
    decode_tokens_per_s: float      # aggregate decode throughput
    steps: int


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


class Engine:
    """Fixed-batch generation over a contiguous KV cache.  ``pumped``
    opts into the double-pumped decode of aligned batches."""

    def __init__(self, cfg: ModelConfig, params: dict, *, max_batch: int = 8,
                 max_seq: int = 2048, kv_dtype=torch.bfloat16,
                 sampling: Optional[SamplingParams] = None, seed: int = 1234,
                 device=None, pumped: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.sampling = sampling or SamplingParams()
        self.seed = seed
        self.pumped = pumped
        self.metrics = Metrics()

    def new_cache(self) -> KVCache:
        return KVCache.create(self.cfg.num_layers, self.max_batch,
                              self.max_seq, self.cfg.num_kv_heads,
                              self.cfg.head_dim, dtype=self.kv_dtype,
                              device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate_speculative(self, prompts: Sequence[Sequence[int]],
                             max_new_tokens: int = 128, *, k: int = 8,
                             ngram: int = 3) -> List[List[int]]:
        """Greedy generation with prompt-lookup speculation (token-exact
        against ``generate`` with greedy sampling; 1..k+1 tokens per
        forward).  Returns the generated ids of each prompt."""
        from qwen_inference_engine_tpu_torch.engine.speculative import (
            generate_speculative,
        )

        if not 0 < len(prompts) <= self.max_batch:
            raise ValueError(f"{len(prompts)} prompts for max_batch "
                             f"{self.max_batch}")
        return generate_speculative(self.params, self.cfg, list(prompts),
                                    self.new_cache(),
                                    max_new_tokens=max_new_tokens, k=k,
                                    ngram=ngram)

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None,
                 seed: Optional[int] = None) -> GenerationResult:
        sp = sampling or self.sampling
        if not 0 < len(prompts) <= self.max_batch:
            raise ValueError(f"{len(prompts)} prompts for max_batch "
                             f"{self.max_batch}")
        B = self.max_batch
        lens_list = [len(p) for p in prompts]
        T = _bucket(max(lens_list))
        if T + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt bucket {T} + {max_new_tokens} new "
                             f"tokens exceeds max_seq {self.max_seq}")

        tokens = np.zeros((B, T), np.int64)
        lens = np.ones((B,), np.int64)  # padded rows get length 1 (harmless)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            lens[i] = len(p)
        dev = self.device
        tokens_d = torch.from_numpy(tokens).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)

        seen = None
        if sp.repetition_penalty != 1.0 or sp.presence_penalty != 0.0:
            seen = seen_mask_from_prompts(tokens_d, lens_d, self.cfg.vocab_size)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed if seed is None else seed)
        cache = self.new_cache()
        # aligned batch (all rows the same length) -> uniform decode: the
        # fresh KV rows go through the append kernels
        uniform = bool(np.all(lens == lens[0]))
        pumped = (self.pumped and uniform
                  and pumped_supported(self.cfg, self.params, cache, B))
        eos = torch.tensor(list(self.cfg.eos_token_ids), device=dev)

        self._sync()
        t0 = time.perf_counter()
        logits, cache = prefill_chunked(self.params, self.cfg, tokens_d,
                                        lens_d, cache, chunk=512)
        tok = sample(logits, sp, seen, gen)
        if seen is not None:
            update_seen_mask(seen, tok)
        first = tok.cpu().numpy()  # value fetch = device sync
        ttft = time.perf_counter() - t0
        self.metrics.observe_ttft(ttft)
        self.metrics.observe_prefill(int(lens[: len(prompts)].sum()))

        out_cols = [tok]
        done = torch.from_numpy(np.isin(first, list(self.cfg.eos_token_ids))
                                ).to(dev)
        t1 = time.perf_counter()
        steps = 0
        # EOS is polled on a growing cadence so the host rarely waits on
        # the device: dense early (short answers), then every 64 steps
        eos_every = 4
        next_poll = eos_every
        for step in range(1, max_new_tokens):
            pos = lens_d + (step - 1)
            if pumped:
                logits, cache = decode_step_pumped(self.params, self.cfg, tok,
                                                   pos, cache)
            else:
                logits, cache = decode_step(self.params, self.cfg, tok, pos,
                                            cache, uniform_decode=uniform)
            nxt = sample(logits, sp, seen, gen)
            if seen is not None:
                update_seen_mask(seen, nxt)
            is_eos = (nxt[:, None] == eos[None, :]).any(dim=-1)
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (is_eos & ~done)
            tok = nxt
            out_cols.append(tok)
            steps += 1
            if step >= next_poll:
                if bool(done.all()):
                    break
                eos_every = min(eos_every * 2, 64)
                next_poll = step + eos_every
        mat = torch.stack(out_cols, dim=1).cpu().numpy()  # one sync
        dt = max(time.perf_counter() - t1, 1e-9)
        n_real = len(prompts)
        self.metrics.observe_decode(steps * n_real, dt)

        outs: List[List[int]] = []
        for i in range(n_real):
            clipped = []
            for t in mat[i].tolist():
                clipped.append(int(t))
                if t in self.cfg.eos_token_ids:
                    break
            outs.append(clipped)
        return GenerationResult(
            token_ids=outs,
            ttft_s=ttft,
            decode_tokens_per_s=steps * n_real / dt if steps else 0.0,
            steps=steps + 1,
        )
