"""Fixed-batch generation engine over the contiguous KV cache.

The port of the JAX package's ``Engine.generate``: prompt lengths padded to
power-of-two buckets (at least 16), padded batch rows given length 1, the
uniform (aligned batch) or ragged decode chosen per call, EOS masked on the
device with the host polling on a growing cadence, the seen mask for the
penalties, and TTFT / decode tok/s measured around work that ends in a
device sync.  Decode steps run ``decode_step`` by default, as the JAX
engine does off a TPU.  An engine built with ``pumped=True`` decodes an
aligned batch through ``decode_step_pumped`` (the batch as two halves,
attention beside the MLP in one launch) wherever ``pumped_supported``
holds for its batch: the JAX engine's TPU branch, which on the H100 is
slower than the plain step.

The decode step is the counterpart of the JAX engine's ``_decode_step``:
one body (the forward, sampling, the EOS mask, the token written into
``out [B, max_seq]`` at a column kept on the device, the positions
advanced) over static buffers that the engine keeps across calls
(``_DecodeBuffers``: the KV cache, cleared each call as the JAX engine
reuses its donated cache, the generator, the sampling tensors).  On the
card it is captured as a CUDA graph once per key (``engine/
step_graph.py``; the key is the JAX engine's ``(top_k, greedy,
track_repetition, uniform)`` with ``pumped``, the batch, S, the KV dtype
and whether top-p cuts the whole vocabulary) and replayed; under
``step_graph.eager_steps()`` and on the CPU the same body runs eagerly.
The prefill stays eager.

``Engine.generate_speculative`` is greedy generation with prompt-lookup
speculation (``engine/speculative.py``): token-identical to ``generate``
with greedy sampling, 1..k+1 tokens per forward.

Under a ``(dp, tp)`` mesh (``parallel/mesh.py``) every rank builds the
same engine from the same global params and prompts, and runs its share:

* data rank ``d`` takes rows ``[d * B / dp, (d + 1) * B / dp)`` of the
  ``max_batch`` rows (the prompt bucket and the uniform decision stay the
  whole batch's, as on one device);
* with tp > 1 the model ranks run the TP step (``parallel/tp_step.py``) on
  their shards of the params and the cache's KV heads, and sample on
  their vocabulary shards (every model rank draws the same token from a
  generator seeded alike), in the model's ``TpLayout``;
* with tp == 1 (pure DP) each rank runs the single-card forward on its
  rows, kernels and all;
* ``generate`` and ``generate_speculative`` gather the rows over the
  data group, so every rank returns the whole batch's tokens in prompt
  order (``generate_speculative``: ``engine/speculative.py``, its stop
  test reduced over the data axis).

A model that does not split evenly over the model axis (``tp_refusal``;
the JAX engine then drops to GSPMD's partitioned XLA ops) runs in the
GSPMD layout that ``tp_step.tp_layout`` chooses block by block: its KV
heads replicated or its attention whole, its MLP split unevenly on whole
groups or whole, its vocabulary whole where tp does not divide it, every
step with whole-row activation scales and without ``fused_mlp``, on the
same kernels.  An expert-parallel or a pipeline-parallel mesh raises,
as the JAX ``Engine`` does: it builds ``NamedSharding(mesh, P("data"))``
(JAX ``engine/engine.py:120``) on a mesh that has no data axis.  Those
meshes are served by ``ContinuousBatchingEngine`` (``serve --ep``) and
``PPFifoScheduler`` (``serve --pp``).  The decode
step is captured where the model group is NCCL; a gloo group's
collectives run on the host, and the engine takes the eager step
(``graphs.capture`` is false from construction).

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
from qwen_inference_engine_tpu_torch.engine.step_graph import StepGraphs
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models.qwen import (
    decode_step_pumped,
    params_to,
    pumped_supported,
)
from qwen_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
    SamplingTensors,
    sample,
    seen_mask_from_prompts,
    update_seen_mask,
)
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    EP_AXIS,
    STAGE_AXIS,
    all_gather,
)
from qwen_inference_engine_tpu_torch.parallel.sharding import (
    batch_shard,
    shard_params,
)
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    make_tp_decode_fn,
    make_tp_prefill_fn,
    sampling_vocab,
    tp_layout,
)
from qwen_inference_engine_tpu_torch.utils.metrics import Metrics


@dataclasses.dataclass
class GenerationResult:
    token_ids: List[List[int]]      # generated ids per sequence (no prompt)
    ttft_s: float                   # time to first token (this call)
    decode_tokens_per_s: float      # aggregate decode throughput
    steps: int


@dataclasses.dataclass
class _DecodeBuffers:
    """The static buffers of one engine's decode steps (a captured step
    binds their addresses): the KV cache; the last tokens ``tok [B]``; the
    next write positions ``pos [B]``, advanced inside the step; the EOS
    mask ``done [B]``; the tokens so far ``out [B, max_seq]`` and the next
    column ``col [1]``; the seen mask ``[B, V]`` (made at the first call
    that tracks repetition); the EOS ids; the sampling tensors and the
    generator."""

    cache: KVCache
    tok: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    out: torch.Tensor
    col: torch.Tensor
    eos: torch.Tensor
    sp: SamplingTensors
    gen: torch.Generator
    seen: Optional[torch.Tensor] = None

    @torch.inference_mode()
    def state(self) -> dict:
        """A copy of everything a decode step reads or writes, the
        generator's state included."""
        snap = {f.name: getattr(self, f.name).clone()
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}
        snap["cache"] = [t.clone() for t in self._cache_tensors()]
        snap["sp"] = self.sp.buf.clone()
        snap["gen"] = self.gen.get_state()
        return snap

    @torch.inference_mode()
    def load_state(self, snap: dict) -> None:
        """Copy a ``state()`` back into the same buffers, in place."""
        for name, t in snap.items():
            if name == "cache":
                for dst, src in zip(self._cache_tensors(), t):
                    dst.copy_(src)
            elif name == "sp":
                self.sp.buf.copy_(t)
            elif name == "gen":
                self.gen.set_state(t)
            else:
                getattr(self, name).copy_(t)

    def _cache_tensors(self):
        c = self.cache
        return [t for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None]


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def tp_mesh(mesh, cfg: ModelConfig, params: dict):
    """``(mesh, layout)``: the mesh whose model axis a TP step splits over
    and the model's ``TpLayout`` on it, or ``(None, None)`` (no mesh, or
    tp == 1).  An expert-parallel and a pipeline-parallel mesh raise, as
    the JAX ``Engine`` does on them (``Engine``'s; the serving engines
    take them)."""
    why = ("it builds NamedSharding(mesh, P(\"data\")) (JAX engine/"
           "engine.py:120) on a mesh that has no data axis")
    if mesh is not None and EP_AXIS in dict(mesh.shape):
        raise NotImplementedError(
            f"Engine under an expert-parallel mesh: the JAX Engine raises on "
            f"it too ({why}); serve it with ContinuousBatchingEngine (serve "
            f"--ep)")
    if mesh is not None and STAGE_AXIS in dict(mesh.shape):
        raise NotImplementedError(
            f"Engine under a pipeline-parallel mesh: the JAX Engine has no "
            f"pipeline branch and raises on it too ({why}); serve it with "
            f"PPFifoScheduler (serve --pp)")
    if mesh is None or mesh.tp == 1:
        return None, None
    return mesh, tp_layout(cfg, params, mesh.tp)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


class Engine:
    """Fixed-batch generation over a contiguous KV cache.  ``pumped``
    opts into the double-pumped decode of aligned batches; ``mesh`` (this
    rank's ``parallel/mesh.Mesh``) runs this rank's share of a (dp, tp)
    mesh from the global ``params``."""

    def __init__(self, cfg: ModelConfig, params: dict, *, mesh=None,
                 max_batch: int = 8, max_seq: int = 2048,
                 kv_dtype=torch.bfloat16,
                 sampling: Optional[SamplingParams] = None, seed: int = 1234,
                 device=None, pumped: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self._tp, self.layout = tp_mesh(mesh, cfg, params)
        dp = 1 if mesh is None else mesh.dp
        if max_batch % dp:
            raise ValueError(f"max_batch {max_batch} does not split over "
                             f"dp={dp}")
        # this rank's rows of the batch, and its shard of the model
        self.local_batch = max_batch // dp
        self.params = params_to(params if self._tp is None
                                else shard_params(params, self._tp,
                                                  self.layout),
                                self.device)
        # the forward's config (this rank's heads), its prefill (the TP
        # step's on this rank's shards) and the samplers' view of the logits
        self._fcfg = (cfg if self._tp is None
                      else self.layout.local_config(cfg))
        self._prefill = make_tp_prefill_fn(cfg, self._tp, chunk=512,
                                           layout=self.layout)
        self._vocab = sampling_vocab(self._tp, cfg, self.layout)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_dtype = kv_dtype
        self.sampling = sampling or SamplingParams()
        self.seed = seed
        self.pumped = pumped
        self.metrics = Metrics()
        # the captured decode steps by key, and the buffers they bind; a
        # gloo model group's collectives run on the host: eager steps
        self.graphs = StepGraphs(
            self.device, capture=self._tp is None or self._tp.capturable)
        self._bufs: Optional[_DecodeBuffers] = None
        self._step = None     # (key, body) of the current call's steps

    def new_cache(self) -> KVCache:
        """This rank's cache: its rows and (under TP) its KV heads."""
        return KVCache.create(self.cfg.num_layers, self.local_batch,
                              self.max_seq, self._fcfg.num_kv_heads,
                              self.cfg.head_dim, dtype=self.kv_dtype,
                              device=self.device)

    def buffers(self) -> _DecodeBuffers:
        """The decode steps' static buffers, made at the first call."""
        if self._bufs is None:
            B, dev = self.local_batch, self.device
            cache = self.new_cache()

            def zeros(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=dev)

            self._bufs = _DecodeBuffers(
                cache=cache, tok=zeros(B), pos=zeros(B),
                done=zeros(B, dtype=torch.bool),
                out=zeros(B, cache.k.shape[3]), col=zeros(1),
                eos=torch.tensor(list(self.cfg.eos_token_ids), device=dev),
                sp=SamplingTensors.create(dev),
                gen=torch.Generator(device=dev))
        return self._bufs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate_speculative(self, prompts: Sequence[Sequence[int]],
                             max_new_tokens: int = 128, *, k: int = 8,
                             ngram: int = 3) -> List[List[int]]:
        """Greedy generation with prompt-lookup speculation (token-exact
        against ``generate`` with greedy sampling; 1..k+1 tokens per
        forward).  Returns the generated ids of each prompt; under a mesh
        every rank returns them all."""
        from qwen_inference_engine_tpu_torch.engine.speculative import (
            generate_speculative,
        )

        if not 0 < len(prompts) <= self.max_batch:
            raise ValueError(f"{len(prompts)} prompts for max_batch "
                             f"{self.max_batch}")
        mesh = (self.mesh if self.mesh is not None and self.mesh.size > 1
                else None)
        return generate_speculative(self.params, self.cfg, list(prompts),
                                    self.new_cache(),
                                    max_new_tokens=max_new_tokens, k=k,
                                    ngram=ngram, mesh=mesh,
                                    layout=self.layout)

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 128,
                 sampling: Optional[SamplingParams] = None,
                 seed: Optional[int] = None) -> GenerationResult:
        sp = sampling or self.sampling
        _, ttft = self.start(prompts, max_new_tokens, sp, seed)
        lens = [len(p) for p in prompts]
        self.metrics.observe_ttft(ttft)
        self.metrics.observe_prefill(sum(lens))
        b = self.buffers()
        t1 = time.perf_counter()
        steps = 0
        # EOS is polled on a growing cadence so the host rarely waits on
        # the device: dense early (short answers), then every 64 steps
        eos_every = 4
        next_poll = eos_every
        for step in range(1, max_new_tokens):
            self.decode()
            steps += 1
            if step >= next_poll:
                if bool(b.done.all()):
                    break
                eos_every = min(eos_every * 2, 64)
                next_poll = step + eos_every
        mat = self._gather_rows(b.out[:, :steps + 1], max_new_tokens,
                                steps)   # one sync
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

    def _gather_rows(self, out: torch.Tensor, width: int,
                     steps: int) -> np.ndarray:
        """The whole batch's tokens ``[max_batch, n]`` on every rank: this
        rank's rows, and under DP every data rank's, gathered in row order
        (a data rank that stopped early pads with zeros past its EOS)."""
        if self.mesh is None or self.mesh.dp == 1:
            return out.cpu().numpy()
        group = self.mesh.data_group
        padded = torch.zeros((out.shape[0], width), dtype=out.dtype,
                             device=out.device)
        padded[:, :out.shape[1]] = out
        rows = all_gather(padded, group).reshape(-1, width)
        n = int(all_gather(torch.tensor([steps], device=out.device),
                           group).max()) + 1
        return rows[:, :n].cpu().numpy()

    @torch.inference_mode()
    def start(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
              sp: SamplingParams, seed: Optional[int] = None):
        """A call's prefill (eager) and first token, into the decode
        buffers: the cache cleared and filled, the sampling tensors and
        the generator loaded, the seen mask (when the call tracks
        repetition), the first tokens in ``out[:, 0]``.  Sets the key of
        the call's decode steps.  Returns the first tokens ``[B]`` and the
        TTFT: from the prefill's launch to the value fetch of the first
        tokens, a device sync."""
        if not 0 < len(prompts) <= self.max_batch:
            raise ValueError(f"{len(prompts)} prompts for max_batch "
                             f"{self.max_batch}")
        B = self.local_batch
        lens_list = [len(p) for p in prompts]
        T = _bucket(max(lens_list))
        if T + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt bucket {T} + {max_new_tokens} new "
                             f"tokens exceeds max_seq {self.max_seq}")

        tokens = np.zeros((self.max_batch, T), np.int64)
        # padded rows get length 1 (harmless)
        lens = np.ones((self.max_batch,), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, : len(p)] = p
            lens[i] = len(p)
        dev = self.device
        b = self.buffers()
        # this data rank's rows (the whole batch decides T and uniform)
        tokens_d = batch_shard(torch.from_numpy(tokens), self.mesh,
                               ("data", None)).to(dev)
        lens_d = batch_shard(torch.from_numpy(lens), self.mesh,
                             ("data",)).to(dev)
        track = sp.repetition_penalty != 1.0 or sp.presence_penalty != 0.0
        seen = None
        if track:
            seen = seen_mask_from_prompts(tokens_d, lens_d,
                                          self.cfg.vocab_size)
            if b.seen is None:
                b.seen = seen
            else:
                b.seen.copy_(seen)
            seen = b.seen
        b.sp.load(sp)
        b.gen.manual_seed(self.seed if seed is None else seed)
        cache = b.cache
        cache.clear()
        # aligned batch (all rows the same length) -> uniform decode: the
        # fresh KV rows go through the append kernels
        uniform = bool(np.all(lens == lens[0]))
        pumped = (self.pumped and uniform and self._tp is None
                  and pumped_supported(self.cfg, self.params, cache, B))
        self._step = ((sp.top_k, sp.greedy, track, uniform, pumped, B,
                       cache.k.shape[3], self.kv_dtype,
                       not sp.greedy and sp.top_k <= 0 and sp.top_p < 1.0),
                      self._decode_body(sp, track, uniform, pumped))

        self._sync()
        t0 = time.perf_counter()
        logits, _ = self._prefill(self.params, tokens_d, lens_d, cache)
        tok = sample(logits, sp, seen, b.gen, b.sp, vocab=self._vocab)
        if seen is not None:
            update_seen_mask(seen, tok)
        first = tok.cpu().numpy()  # value fetch = device sync
        ttft = time.perf_counter() - t0
        b.tok.copy_(tok)
        b.pos.copy_(lens_d)
        b.out[:, 0] = tok
        b.col.fill_(1)
        b.done.copy_(torch.from_numpy(np.isin(first,
                                              self.cfg.eos_token_ids)))
        return first, ttft

    @torch.inference_mode()
    def decode(self) -> torch.Tensor:
        """One decode step of the call ``start`` began, captured or eager
        (``engine/step_graph.py``).  Returns its logits ``[B, V]``, valid
        until the next step."""
        key, body = self._step
        return self.graphs.run(key, body, (self.buffers().gen,))

    def _decode_body(self, sp: SamplingParams, track: bool, uniform: bool,
                     pumped: bool):
        """The decode step over the static buffers: forward, sampling with
        the call's tensors, the seen mask, the EOS mask (finished rows
        emit 0), the token into ``out`` at ``col``, ``col`` and the
        positions advanced.  Returns the logits."""
        b, params, vocab = self.buffers(), self.params, self._vocab
        seen = b.seen if track else None
        step = make_tp_decode_fn(self.cfg, self._tp, uniform_decode=uniform,
                                 layout=self.layout)

        def body():
            if pumped:
                logits, _ = decode_step_pumped(params, self.cfg, b.tok, b.pos,
                                               b.cache)
            else:
                logits, _ = step(params, b.tok, b.pos, b.cache)
            nxt = sample(logits, sp, seen, b.gen, b.sp, vocab=vocab)
            if seen is not None:
                update_seen_mask(seen, nxt)
            is_eos = (nxt[:, None] == b.eos[None, :]).any(dim=-1)
            nxt = torch.where(b.done, torch.zeros_like(nxt), nxt)
            b.done |= is_eos & ~b.done
            b.tok.copy_(nxt)
            b.out.index_copy_(1, b.col, nxt[:, None])
            b.col += 1
            b.pos += 1
            return logits

        return body
