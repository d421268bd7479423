"""Continuous batching over the paged KV cache.

The port of the JAX package's ``engine/scheduler.py``
(``ContinuousBatchingEngine``), single card, over a bf16 or an INT8 page
pool (``kv_dtype=torch.int8``: int8 pages with per-token f32 scales, twice
the requests at equal memory):

* a fixed ``max_slots`` decode batch; idle slots decode at position 0
  through a zeroed block-table row, so they only touch scratch page 0;
* a host-side page allocator over the device page pool with admission
  control by KV-page budget: a request is admitted only if its worst-case
  pages (prompt + max_new) are free (``engine/prefix_cache.py``);
* per-request chunked prefill, at most one ``prefill_chunk``-token piece
  per tick while other slots decode, then one decode step across all
  decoding slots;
* completion (EOS, a stop id, max tokens, cancel, timeout) frees the slot
  and pages at once;
* automatic prefix caching (page-granular, hash-chained, refcounted, LRU
  parked, sub-page tails through a partial-page copy);
* ``step_batch``: decode ticks chained on the device (each tick's sampled
  tokens feed the next, positions ``pos0 + i`` on the device) with one host
  sync per window; ``_mixed_chain_batch`` interleaves a prefilling slot's
  interior pieces with those ticks under the same sync;
* speculative decoding (``speculative=True``, ``engine/spec_engine.py``):
  prompt lookup drafted on the host in ``step`` and on the device in
  ``step_batch``, or a draft model (``draft_params`` / ``draft_cfg``, its
  own page pool on the target's page ids, prefilled in lockstep); each
  round verifies ``spec_k`` drafts per slot in one forward and emits 1..
  spec_k+1 tokens per slot.  Admission budgets ``spec_k`` tokens more per
  request, so a verify's rejected-draft writes stay on the request's own
  pages.

The plain decode tick is the counterpart of the JAX engine's
``_jit_decode``: one body (the forward over the page pool, per-row
sampling, the seen mask) over static buffers (``_TickBuffers``: the last
tokens, the positions, advanced inside the tick, the block tables, the
active mask, the sampling rows and one generator), captured on the card
as one CUDA graph per engine (``engine/step_graph.py``) and replayed by
``step``, ``step_batch`` and ``_mixed_chain_batch``; under
``step_graph.eager_steps()`` and on the CPU it runs eagerly.  One graph
serves every tick because every tick, and every verify, passes block
tables of the engine's full ``max_pages_per_seq`` width
(``_run_tables``): the paged attention plans its key splits over the
tables' width, so a row's output bits do not depend on the rows beside
it.  Prefill pieces and speculation rounds run eagerly.

Sampling draws from ``stream_generator`` (``ops/sampling.py``): seeded
per (seed, request id) for a prefill piece, per (seed, step count) for a
decode tick (the tick's generator reseeded in place with that stream's
seed) or a speculation round, and per chain position j within a round;
so a chained window samples exactly as the same ticks run one by one.
The streams are not the JAX package's ``fold_in`` streams, so only greedy
rows match it token for token.

Dense and Qwen3-MoE models serve alike, as target or drafter (an MoE
layer routes every row of a step, a verify's B x (k+1) rows included, as
one batch).

Under a ``(data, model)`` mesh (``parallel/mesh.py``) every rank builds
the same engine from the same global params, takes the same requests in
the same order and steps in lockstep, so every rank holds the same host
state (tokens, positions, slots, block tables, prefix index, step counts
and seeds: the one-rank scheduler's).  Each runs the TP step
(``parallel/tp_step.py``; the single-card step at tp 1) on its shards in
the model's ``TpLayout``: its KV heads of the pool (one KV head where
they are replicated, all where the attention runs whole), its params,
its vocabulary shard of the logits (``ShardedVocab`` sampling; every rank
draws the same token; the whole logits where the vocabulary runs whole).
A model that does not split evenly (the JAX scheduler's GSPMD run) takes
the GSPMD layout with whole-row activation scales.  Where the target runs
the JAX ``shard_map`` step (pure TP, ``supports_tp``) a drafter must
split as it does; one that does not drafts by prompt lookup, with a
warning, as in the JAX scheduler.  Where the target runs GSPMD the
drafter runs beside it in its own layout.  Deadlines are the
clock's and clocks differ between ranks: under a mesh the world's rank 0
decides them and broadcasts them in the step.

Under a data axis of ``dp`` > 1 (the JAX scheduler's GSPMD run, whose
tokens equal the run without a mesh) data group ``g`` owns slots ``[g * S
/ dp, (g + 1) * S / dp)`` and every group holds a page pool of all
``num_pages`` pages (the JAX pool has no data axis).  The decode tick, a
verify and a draft-model round run the group's own rows, and their
logits (a round's drafts too) are gathered over the data axis
(``tp_step.gather_data_rows``: ``S x V / tp x 4`` bytes a tick), so every
rank runs the one-rank sampler on the whole batch.  A prefill piece runs
on its owner group only, and a last piece's token reaches the other
groups by a broadcast over the data axis from the owner; pieces and ticks
keep the one-rank order.  A group writes only its own slots' pages, so
the prefix cache stays on across groups: the host state records which
groups hold each page's content (``_held``), and a hit by a slot of group
``g`` on pages ``g`` does not hold, or a partial-tail copy from such a
page, first broadcasts those pages, every layer and (INT8) their scales,
from a group that holds them (``PagePoolMixin._share_pages``).  As under
GSPMD, each token's int8 activations of a row-parallel projection (o,
down; W4A8 / W8A8) take their scale over the whole row, not over the
rank's K shard as in the pure-TP step (``tp_step.model_group``).

Under an expert-parallel ``("ep",)`` mesh (``parallel/mesh.make_ep_mesh``)
every rank again holds the same host state, and runs the EP step
(``parallel/ep_step.py``) on its own slots ``[p * S / P, (p + 1) * S /
P)`` and experts: a page pool of full size on every rank, each writing
only its own slots' pages (so the prefix cache is switched off, with a
warning, as in the JAX scheduler); the decode tick and a verify over this
rank's slots, their logits gathered so every rank runs the one-rank
sampler on the whole batch's (``S x V x 4`` bytes a tick); a single-slot
prefill piece on every rank (all must join the all-to-alls; the owner
writes its pool, the others a scratch pool), and interior pieces batched
one per owner rank where two owners have one (``_ep_prefill_batch_tick``);
a dense drafter local to each rank's slots (an MoE drafter drafts by
prompt lookup, with a warning, as in the JAX scheduler).  EP steps run
eager.  Where ``supports_ep`` is false (not a MoE model, ``E % ep`` or
``max_slots % ep`` non-zero) the engine raises, naming the condition, as
the JAX scheduler does: it drops to ``make_sharded_cache``, whose
``cache_pspecs`` reads the mesh's ``model`` axis, and an ``("ep",)``
mesh has none (``KeyError: 'model'``, JAX ``parallel/sharding.py:110``).

``max_slots`` that the data axis does not divide raises.  A
pipeline-parallel mesh raises, naming ``PPFifoScheduler``
(``engine/pp_scheduler.py``), the engine that serves it.

The engine runs on the card unless the caller passes ``device="cpu"`` (the
tests do): it never drops to the CPU by itself.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.engine.engine import (
    resolve_device,
    tp_mesh,
)
from qwen_inference_engine_tpu_torch.engine.prefix_cache import PagePoolMixin
from qwen_inference_engine_tpu_torch.engine.spec_engine import (
    SpeculationMixin,
)
from qwen_inference_engine_tpu_torch.engine.step_graph import StepGraphs
from qwen_inference_engine_tpu_torch.engine.types import (  # noqa: F401
    DECODE_STREAM,
    FinishedRequest,
    Request,
    _Running,
    _bucket,
    _is_stop,
)
from qwen_inference_engine_tpu_torch.kvcache.cache import (
    PagedKVCache,
    pages_required,
)
from qwen_inference_engine_tpu_torch.models.qwen import params_to
from qwen_inference_engine_tpu_torch.ops.sampling import (
    SamplingParams,
    sample_rows,
    stream_generator,
    stream_seed,
)
from qwen_inference_engine_tpu_torch.parallel.ep_step import (
    ep_param_shards,
    ep_refusal,
    ep_scratch,
    make_ep_decode_fn,
    make_ep_prefill_batch_fn,
    make_ep_prefill_piece_fn,
)
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EP_AXIS,
    broadcast,
    broadcast_object,
    is_ep_mesh,
)
from qwen_inference_engine_tpu_torch.parallel.sharding import shard_params
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    data_rows,
    gather_data_rows,
    make_tp_decode_fn,
    make_tp_prefill_piece_fn,
    sampling_vocab,
    tp_layout,
    tp_refusal,
)
from qwen_inference_engine_tpu_torch.utils.metrics import Metrics


def check_serving_mesh(mesh) -> None:
    """Refuse the meshes the serving engine does not take, naming why."""
    if mesh is None:
        return
    axes = dict(getattr(mesh, "shape", None) or {})
    if axes.get("stage", 1) > 1:
        raise NotImplementedError(
            "a pipeline-parallel mesh is served by engine/pp_scheduler."
            "PPFifoScheduler (FIFO waves; serve --pp), as the JAX HTTP "
            "server routes it: the slot scheduler's page pool assumes every "
            "rank holds every layer")
    if set(axes) == {EP_AXIS}:
        return
    if set(axes) != {"data", "model"}:
        raise TypeError(f"not a (data, model) or (ep,) mesh: {axes}")


@dataclasses.dataclass
class _TickBuffers:
    """The static buffers of the decode tick (a captured tick binds their
    addresses): the last tokens ``tok [slots]``, the next write positions
    ``pos [slots]`` (advanced inside the tick, so a chained window's tick
    i writes at ``pos0 + i``), the block tables ``[slots,
    max_pages_per_seq]``, the active mask, the sampling rows (``[slots]``
    each, refilled when the slot table changes), the row ids and the
    generator, reseeded before each tick."""

    tok: torch.Tensor
    pos: torch.Tensor
    tables: torch.Tensor
    active: torch.Tensor
    sp: Dict[str, torch.Tensor]
    rows: torch.Tensor
    gen: torch.Generator


class ContinuousBatchingEngine(PagePoolMixin, SpeculationMixin):
    def __init__(self, cfg: ModelConfig, params: dict, *, mesh=None,
                 max_slots: int = 8, page_size: int = 512,
                 num_pages: int = 512, max_pages_per_seq: int = 64,
                 kv_dtype=torch.bfloat16,
                 sampling: Optional[SamplingParams] = None, seed: int = 1234,
                 prefill_chunk: int = 256, on_token=None,
                 prefix_cache: bool = True, speculative: bool = False,
                 spec_k: int = 4, spec_ngram: int = 3,
                 draft_params: Optional[dict] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 top_k_cap: Optional[int] = None, device=None):
        check_serving_mesh(mesh)
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params requires draft_cfg (the drafter's "
                             "ModelConfig): pass both or neither")
        if draft_cfg is not None and draft_cfg.vocab_size > cfg.vocab_size:
            raise ValueError("the draft vocabulary must not exceed the "
                             "target's")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self._ep = mesh if is_ep_mesh(mesh) else None
        if self._ep is not None:
            why = ep_refusal(cfg, mesh, max_slots)
            if why is not None:
                raise ValueError(
                    f"the EP serving step does not take this model ({why}); "
                    f"the JAX scheduler raises here too: it drops to "
                    f"make_sharded_cache, whose cache_pspecs reads the "
                    f"mesh's 'model' axis, which an ('ep',) mesh lacks "
                    f"(KeyError: 'model', JAX parallel/sharding.py:110)")
            if (speculative and draft_params is not None
                    and draft_cfg is not None and draft_cfg.is_moe):
                # a dense drafter runs on each rank's own slots; an MoE one
                # would need its own all-to-alls: as the JAX scheduler,
                # draft by prompt lookup instead
                warnings.warn("MoE draft models are not supported under the "
                              "EP mesh; using prompt-lookup drafts")
                draft_params = draft_cfg = None
            if prefix_cache:
                warnings.warn("prefix cache disabled under the EP mesh: a "
                              "rank only holds KV for its own slots, so "
                              "pages cannot be shared across ranks")
                prefix_cache = False
        # an ("ep",) mesh of one rank serves as no mesh
        self._tp, self.layout = ((None, None) if mesh is None
                                 or EP_AXIS in dict(mesh.shape)
                                 else tp_mesh(mesh, cfg, params))
        # a data axis above 1: this rank's group runs its own slots' rows
        self._dpm = (mesh if mesh is not None
                     and dict(mesh.shape).get(DATA_AXIS, 1) > 1 else None)
        if self._dpm is not None and max_slots % self._dpm.dp:
            raise ValueError(f"max_slots {max_slots} does not split over "
                             f"the data axis of {self._dpm.dp}")
        self._rows = data_rows(self._dpm, max_slots)
        # the JAX scheduler's GSPMD run (a data axis, or a model that
        # does not split evenly): whole-row activation scales
        self._gspmd = self._dpm is not None or (
            self.layout is not None and self.layout.gspmd)
        self._model_draft = speculative and draft_params is not None
        self.draft_layout = None
        if self._model_draft and self._tp is not None:
            self.draft_layout = tp_layout(draft_cfg, draft_params,
                                          self._tp.tp)
            if not self._gspmd and tp_refusal(draft_cfg, draft_params,
                                              self._tp.tp) is not None:
                # under the JAX shard_map step the drafter runs in the
                # target's round, so it must split as the target does; as
                # the JAX scheduler, an unsplittable one drafts by prompt
                # lookup instead (under GSPMD it runs in its own layout)
                warnings.warn("draft model does not shard over this TP "
                              "mesh (head/group alignment); falling back "
                              "to prompt-lookup speculation")
                self._model_draft = False
                draft_params = draft_cfg = self.draft_layout = None
        self.params = params_to(self._shard(params, self.layout),
                                self.device)
        self.max_slots = max_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.sampling = sampling or SamplingParams()
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        # on_token(request_id, token_id) fires as tokens are produced: the
        # hook the HTTP server's streaming rides on
        self.on_token = on_token
        self.metrics = Metrics()
        # this rank's KV heads of the pool (all of them without TP)
        self.cache = PagedKVCache.create(
            cfg.num_layers, num_pages, page_size,
            self._local(cfg, self.layout).num_kv_heads, cfg.head_dim,
            dtype=kv_dtype,
            device=self.device)
        # speculation: spec_k drafts per round from prompt lookup
        # (spec_ngram-token suffixes) or from a draft model whose page
        # pool mirrors the target's page ids (written in lockstep, so the
        # allocator, tables, admission and prefix cache are shared)
        self.speculative = speculative
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.draft_cfg = draft_cfg
        self.draft_params = (params_to(self._shard(draft_params,
                                                   self.draft_layout),
                                       self.device)
                             if self._model_draft else None)
        self.draft_cache = (PagedKVCache.create(
            draft_cfg.num_layers, num_pages, page_size,
            self._local(draft_cfg, self.draft_layout).num_kv_heads,
            draft_cfg.head_dim,
            dtype=kv_dtype, device=self.device)
            if self._model_draft else None)
        # chained prompt lookup: the device history buffer [slots, cap]
        # (allocated at first use), its per-slot watermarks, and the
        # acceptance EMA that chooses between chained rounds and plain
        # chained ticks
        self._hist_buf: Optional[torch.Tensor] = None
        self._hist_synced: Dict[int, int] = {}
        self._spec_tpf_ema: Optional[float] = None
        self._spec_probe_countdown = 0
        # per-slot sampling-param rows change only when the slot table does
        self._sp_rows_stale = True
        # page 0 is the scratch page for idle slots / unallocated entries
        self._free_pages: List[int] = list(range(num_pages - 1, 0, -1))
        self.prefix_cache = prefix_cache
        self._page_refs: Dict[int, int] = {}
        self._prefix_index: Dict[int, tuple] = {}   # hash -> (page, parent, blk)
        self._page_hash: Dict[int, int] = {}        # registered page -> hash
        # parent hash -> {page: blk}: the registered continuations of a
        # prefix, searched for partial tail-page reuse
        self._prefix_children: Dict[Optional[int], Dict[int, tuple]] = {}
        self._cached_free: "OrderedDict[int, int]" = OrderedDict()  # page->hash
        # under a data axis: page -> bit mask of the data groups that hold
        # its content (the writer's group; a group a hit was copied to)
        self._held: Optional[Dict[int, int]] = (
            {} if self._dpm is not None and prefix_cache else None)
        self.pages_shared = 0    # pages copied between data groups
        self._block_tables = np.zeros((max_slots, max_pages_per_seq), np.int32)
        self._seq_lens = np.zeros((max_slots,), np.int32)
        self._slots: List[Optional[_Running]] = [None] * max_slots
        self._pending: Deque[Request] = deque()
        self._finished: List[FinishedRequest] = []
        self._step_count = 0
        self._admit_count = 0
        self._eos = set(cfg.eos_token_ids)
        # top-k selection width of the decode step; per-row top_k masks
        # within it, so a request may use any top_k in [0, k_cap]
        if top_k_cap is not None:
            assert top_k_cap >= max(1, self.sampling.top_k), \
                "top_k_cap below the default top_k would reject defaults"
            self.k_cap = min(top_k_cap, cfg.vocab_size)
        else:
            self.k_cap = (cfg.vocab_size if self.sampling.top_k == 0
                          else max(64, self.sampling.top_k))
        # per-slot presence mask of tokens seen (prompt + generated), on
        # the device: the repetition penalty's input in serving
        self._seen = torch.zeros((max_slots, cfg.vocab_size), dtype=torch.bool,
                                 device=self.device)
        # the forwards (tp_step's makers: this rank's shards under TP, the
        # whole model without), and the samplers' view of the logits
        if self._ep is not None:
            # a rank runs the pieces of the slots it does not own over a
            # scratch pool of one sequence
            sps = max_slots // self._ep.ep
            self._ep_scratch = ep_scratch(self.cache, max_pages_per_seq)
            self._pieces = {last: make_ep_prefill_piece_fn(
                cfg, self._ep, last=last, slots_per_shard=sps,
                scratch=self._ep_scratch) for last in (False, True)}
            self._piece_batch = make_ep_prefill_batch_fn(
                cfg, self._ep, scratch=self._ep_scratch)
            self._decode_fn = make_ep_decode_fn(cfg, self._ep)
        else:
            self._pieces = {last: make_tp_prefill_piece_fn(
                cfg, self._tp, last=last, whole_row_scales=self._gspmd,
                layout=self.layout) for last in (False, True)}
            self._decode_fn = make_tp_decode_fn(
                cfg, self._tp, paged=True, whole_row_scales=self._gspmd,
                layout=self.layout)
        self._vocab = sampling_vocab(self._tp, cfg, self.layout)
        # the captured decode tick and the buffers it binds; a gloo
        # group's collectives run on the host, and EP steps are eager
        step_mesh = self._ep or self._dpm or self._tp
        self.graphs = StepGraphs(
            self.device, capture=step_mesh is None or step_mesh.capturable)
        self._tick = self._tick_buffers()

    def _shard(self, params: dict, layout) -> dict:
        """This rank's shard of a global param tree in its ``layout`` (its
        experts under EP; the tree itself without a mesh)."""
        if self._ep is not None:
            return ep_param_shards(params, self._ep)
        return params if self._tp is None else shard_params(params, self._tp,
                                                            layout)

    def _owner(self, slot: int) -> int:
        """The index that runs ``slot``'s rows: its EP rank, its data
        group, or 0 (no such axis)."""
        n = self._ep.ep if self._ep is not None else (
            self._dpm.dp if self._dpm is not None else 1)
        return slot // (self.max_slots // n)

    def _owns(self, slot: int) -> bool:
        """Whether this rank runs ``slot``'s rows (under EP its own slots,
        under a data axis its group's; every slot otherwise)."""
        if self._ep is not None:
            return self._owner(slot) == self._ep.rank
        if self._dpm is not None:
            return self._owner(slot) == self._dpm.coords[0]
        return True

    def _local(self, cfg: ModelConfig, layout) -> ModelConfig:
        return cfg if self._tp is None else layout.local_config(cfg)

    def _tick_buffers(self) -> _TickBuffers:
        S, dev = self.max_slots, self.device

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return _TickBuffers(
            tok=zeros(S), pos=zeros(S),
            tables=zeros(S, self.max_pages_per_seq, dtype=torch.int32),
            active=zeros(S, dtype=torch.bool),
            sp={"temperature": zeros(S, dtype=torch.float32),
                "top_p": zeros(S, dtype=torch.float32),
                "repetition_penalty": zeros(S, dtype=torch.float32),
                "presence_penalty": zeros(S, dtype=torch.float32),
                "top_k": zeros(S), "greedy": zeros(S, dtype=torch.bool)},
            rows=torch.arange(S, device=dev),
            gen=torch.Generator(device=dev))

    # ------------------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    def has_work(self) -> bool:
        return self.num_active > 0 or self.num_pending > 0

    def submit(self, request: Request) -> None:
        request._t_submit = time.perf_counter()
        self._pending.append(request)

    def cancel(self, request_id: int) -> bool:
        """Cancel a pending or running request: its slot and pages are freed
        at once.  Returns True if it was found."""
        for i, r in enumerate(self._pending):
            if r.request_id == request_id:
                del self._pending[i]
                self._finished.append(
                    FinishedRequest(request_id, [], "cancelled"))
                return True
        for run in self._slots:
            if run is not None and run.request.request_id == request_id:
                self._finish(run, "cancelled")
                return True
        return False

    def _expire_deadlines(self) -> None:
        """Finish the requests past their deadlines with "timeout" (pending
        ones first, then running ones).  Under a mesh of several ranks the
        clocks differ: the world's rank 0 decides and broadcasts its ids,
        in a step where some request carries a deadline (every rank holds
        the same requests, so every rank takes the broadcast or none)."""
        now = time.perf_counter()
        reqs = [*self._pending,
                *(run.request for run in self._slots if run is not None)]
        ids = [r.request_id for r in reqs if r.timeout_s is not None
               and now - getattr(r, "_t_submit", now) > r.timeout_s]
        if self.mesh is not None and self.mesh.size > 1:
            if all(r.timeout_s is None for r in reqs):
                return
            ids = broadcast_object(ids, self.mesh.world_group)
        ids = set(ids)
        for r in [r for r in self._pending if r.request_id in ids]:
            self._pending.remove(r)
            self._finished.append(FinishedRequest(r.request_id, [], "timeout"))
        for run in list(self._slots):
            if run is not None and run.request.request_id in ids:
                self._finish(run, "timeout")

    # ------------------------------------------------------------------
    def _generator(self, stream: int) -> torch.Generator:
        """A generator for one sampling call, seeded by (seed, stream)."""
        return stream_generator(self.device, self.seed, stream)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sp_tensors(self, rows: List[SamplingParams]) -> dict:
        """Per-row sampling parameters as [len(rows)] device tensors."""
        def col(field, dtype):
            return self._tensor(np.asarray([getattr(sp, field) for sp in rows],
                                           dtype))

        return {"temperature": col("temperature", np.float32),
                "top_p": col("top_p", np.float32),
                "repetition_penalty": col("repetition_penalty", np.float32),
                "presence_penalty": col("presence_penalty", np.float32),
                "top_k": col("top_k", np.int64),
                "greedy": col("greedy", bool)}

    def _sp_rows(self) -> dict:
        """Each slot decodes with its own request's parameters; idle slots
        take the engine defaults.  The tick's static rows, refilled when
        the slot table changes."""
        if self._sp_rows_stale:
            rows = [self.sampling] * self.max_slots
            for s in self._slots:
                if s is not None and s.request.sampling is not None:
                    rows[s.slot] = s.request.sampling
            for name, t in self._sp_tensors(rows).items():
                self._tick.sp[name].copy_(t)
            self._sp_rows_stale = False
        return self._tick.sp

    def _active_mask(self, decoding) -> torch.Tensor:
        """[max_slots] bool: slots decoding this tick (seen-mask updates are
        gated on it, so mid-prefill and idle slots stay clean)."""
        m = np.zeros((self.max_slots,), bool)
        for s in decoding:
            m[s.slot] = True
        return self._tensor(m)

    # ------------------------------------------------------------------
    _ADMIT_WINDOW = 8

    def _try_admit(self) -> bool:
        """Admit one pending request if a slot and its worst-case pages are
        free.  Among the first _ADMIT_WINDOW pending requests, the one with
        the most cached prefix pages goes first (a bounded window with an
        arrival-order tie-break, so cold requests do not starve)."""
        if not self._pending:
            return False
        free_slot = next((i for i, s in enumerate(self._slots) if s is None),
                         None)
        if free_slot is None:
            return False
        if self.prefix_cache and len(self._pending) > 1:
            window = min(len(self._pending), self._ADMIT_WINDOW)
            best_i, best_h = 0, len(self._prefix_lookup(
                self._pending[0].prompt)[0])
            for i in range(1, window):
                nh = len(self._prefix_lookup(self._pending[i].prompt)[0])
                if nh > best_h:
                    best_i, best_h = i, nh
            if best_i:
                hot = self._pending[best_i]
                del self._pending[best_i]
                self._pending.appendleft(hot)
        req = self._pending[0]
        # bucket padding past the prompt lands on the scratch page (zeroed
        # table entries) or on masked future positions, so admission only
        # budgets real tokens; speculation writes up to spec_k rejected
        # drafts past the last token (overwritten before they are read):
        # they are budgeted so those writes stay on the request's pages
        total = len(req.prompt) + req.max_new_tokens
        if self.speculative:
            total += self.spec_k
        need = pages_required(total, self.page_size)
        if need > self.max_pages_per_seq:
            self._pending.popleft()
            self._finished.append(FinishedRequest(req.request_id, [],
                                                  "rejected"))
            return True
        hits, parent = (self._prefix_lookup(req.prompt) if self.prefix_cache
                        else ([], None))
        if need - len(hits) > self._page_budget():
            return False  # admission control: not enough KV budget yet
        part_src, part_t = (self._partial_lookup(req.prompt, len(hits), parent)
                            if self.prefix_cache else (None, 0))
        self._pending.popleft()
        # pin the hits (and the partial source) first: a revived page must
        # not be evicted for this same request's fresh allocations
        for p in hits:
            self._cached_free.pop(p, None)
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        if part_src is not None:
            self._cached_free.pop(part_src, None)
            self._page_refs[part_src] = self._page_refs.get(part_src, 0) + 1
        fresh = [self._alloc_page() for _ in range(need - len(hits))]
        for p in fresh:
            self._page_refs[p] = 1
        if self._held is not None:
            # the slot's group writes its fresh pages and must hold its
            # hits and the partial source before it reads them
            g = self._owner(free_slot)
            for p in fresh:
                self._held[p] = 1 << g
            self._share_pages(hits + ([] if part_src is None
                                      else [part_src]), g)
        pages = hits + fresh
        cached_len = len(hits) * self.page_size
        if part_src is not None:
            # the partially matching page is copied into this run's first
            # fresh page; its matched rows are then served from cache and
            # only the remainder prefills
            self._copy_page(part_src, fresh[0])
            cached_len += part_t
            self._release_page(part_src)  # drop the temporary pin
        if cached_len:
            self.metrics.observe_prefix_hit(cached_len)
        run = _Running(request=req, slot=free_slot, pages=pages,
                       seq_len=len(req.prompt), t_submit=time.perf_counter(),
                       prefilled=cached_len, admit_seq=self._admit_count)
        self._admit_count += 1
        self._slots[free_slot] = run
        self._sp_rows_stale = True
        # prompt-token presence row for the repetition penalty
        self._seen[free_slot] = False
        self._seen[free_slot, self._tensor(np.asarray(req.prompt, np.int64))] \
            = True
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[: len(pages)] = pages
        self._block_tables[free_slot] = row
        self._seq_lens[free_slot] = len(req.prompt)
        return True

    # ------------------------------------------------------------------
    def _run_piece(self, run: _Running, tokens: torch.Tensor, start: int,
                   nvalid: int, table: torch.Tensor, last: bool):
        """One prefill piece ``tokens [1, T]`` of ``run`` at ``start`` (the
        fresh-prefill branch when it is 0).  The last piece samples the
        request's first token with its own parameters and marks it seen;
        returns it as a device tensor [1] (None for an interior piece)."""
        args = (self.params, tokens, start, nvalid, self.cache, table)
        own = self._owns(run.slot)
        if self._ep is not None:
            logits = self._pieces[last](*args, run.slot)
        elif own:   # under a data axis the owner group alone
            logits = self._pieces[last](*args)
        if self._model_draft and own:
            self._drafter_piece(tokens, start, table)
        if not last:
            return None
        if self._ep is not None or own:
            sp = run.request.sampling or self.sampling
            seen = self._seen[run.slot:run.slot + 1]
            tok = sample_rows(logits, self._generator(run.request.request_id),
                              k_cap=self.k_cap, seen_mask=seen,
                              vocab=self._vocab, **self._sp_tensors([sp]))
        else:
            tok = torch.zeros((1,), dtype=torch.int64, device=self.device)
        if self._dpm is not None:
            # the owner's token on every group
            tok = broadcast(tok.to(torch.int64), self._dpm.data_group,
                            self._owner(run.slot))
        self._seen[run.slot, tok] = True
        return tok

    def _prefill_tick(self, run: _Running) -> None:
        """Advance ``run``'s prefill by one piece (bounded work per tick: a
        long prompt cannot stall active decodes for more than one piece's
        forward)."""
        prompt = run.request.prompt
        start = run.prefilled
        remaining = len(prompt) - start
        # single-piece prompts use a power-of-two bucket; pieces of longer
        # prompts are exactly prefill_chunk wide
        T = (min(_bucket(remaining), self.prefill_chunk)
             if remaining <= self.prefill_chunk else self.prefill_chunk)
        piece = prompt[start:start + T]
        last = start + T >= len(prompt)
        tokens = np.zeros((1, T), np.int64)
        tokens[0, : len(piece)] = piece
        tok = self._run_piece(run, self._tensor(tokens), start, len(piece),
                              self._tensor(self._block_tables[run.slot:
                                                              run.slot + 1]),
                              last)
        run.prefilled = start + len(piece)
        self.metrics.observe_prefill(len(piece))
        self._step_count += 1
        if not last:
            return
        first = int(tok[0])   # value fetch = device sync
        # TTFT counts from submit (queue time included), not admission
        t0 = getattr(run.request, "_t_submit", run.t_submit)
        self.metrics.observe_ttft(time.perf_counter() - t0)
        run.generated.append(first)
        run.last_token = first
        if self.on_token is not None:
            self.on_token(run.request.request_id, first)
        if (_is_stop(first, self._eos, run)
                or len(run.generated) >= run.request.max_new_tokens):
            self._finish(run, "eos" if _is_stop(first, self._eos, run)
                         else "length")

    def _finish(self, run: _Running, reason: str) -> None:
        self._finished.append(
            FinishedRequest(run.request.request_id, run.generated, reason))
        if self.prefix_cache:
            self._register_pages(run)
            for p in run.pages:
                self._release_page(p)
        else:
            self._free_pages.extend(run.pages)
        self._block_tables[run.slot] = 0
        self._seq_lens[run.slot] = 0
        self._slots[run.slot] = None
        self._hist_synced.pop(run.slot, None)   # the next tenant rewrites
        self._sp_rows_stale = True

    # ------------------------------------------------------------------
    def _drain_finished(self) -> List[FinishedRequest]:
        """Hand off (and clear) everything finished but not yet collected,
        so each completion is delivered exactly once however the caller
        mixes step / step_batch / run_to_completion."""
        out, self._finished = self._finished, []
        return out

    def _load_tick(self, decoding) -> None:
        """Load one decode window's inputs into the tick's buffers: last
        tokens and next write positions [max_slots], the block tables
        (``_run_tables``), the active mask and the sampling rows."""
        toks = np.zeros((self.max_slots,), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        for s in decoding:
            toks[s.slot] = s.last_token
            pos[s.slot] = s.seq_len   # next write position
        tables = self._run_tables(decoding)
        t = self._tick
        for dst, src in ((t.tok, toks), (t.pos, pos), (t.tables, tables)):
            dst.copy_(torch.from_numpy(src))
        t.active.copy_(self._active_mask(decoding))
        self._sp_rows()

    def _run_tables(self, runs) -> np.ndarray:
        """Block tables ``[max_slots, max_pages_per_seq]`` of a decode tick
        or a verify: the rows of ``runs``, every other row zeroed (so it
        only touches the scratch page).  Always the full width: the paged
        attention plans its key splits over the tables' width, so one
        width per engine keeps a row's bits off its neighbours' lengths."""
        tables = np.zeros_like(self._block_tables)
        for s in runs:
            tables[s.slot] = self._block_tables[s.slot]
        return tables

    def _decode_tick(self) -> torch.Tensor:
        """One decode step of every slot from the tick's buffers (loaded by
        ``_load_tick``, or left by the tick before it): captured or eager
        (``engine/step_graph.py``).  Returns the sampled tokens
        [max_slots], a tensor of its own; only active slots mark them
        seen."""
        t = self._tick
        t.gen.manual_seed(stream_seed(self.seed,
                                      DECODE_STREAM + self._step_count))
        nxt = self.graphs.run(
            ("decode", self.max_slots, self.max_pages_per_seq,
             self.cache.k_pages.dtype, self.k_cap), self._tick_body,
            (t.gen,))
        self._step_count += 1
        return nxt.clone()

    def _tick_body(self) -> torch.Tensor:
        """The decode tick over the static buffers: the forward, per-row
        sampling, the seen mask; the tokens and positions advanced for the
        next tick of a window.  Returns the sampled tokens."""
        t, r = self._tick, self._rows
        logits, _ = self._decode_fn(self.params, t.tok[r], t.pos[r],
                                    self.cache, t.tables[r])
        logits = gather_data_rows(logits, self._dpm)
        nxt = sample_rows(logits, t.gen, k_cap=self.k_cap,
                          seen_mask=self._seen, vocab=self._vocab, **t.sp)
        self._seen[t.rows, nxt] = self._seen[t.rows, nxt] | t.active
        t.tok.copy_(nxt)
        t.pos += 1
        return nxt

    def _deliver(self, decoding, mat: np.ndarray, t0: float) -> None:
        """Hand out a window's tokens ``mat [n, max_slots]`` row by row; a
        row stops at its stop token or budget (tokens it produced after
        that are dropped; their KV lands on pages freed with the request)."""
        kept = 0   # only delivered tokens count toward /stats throughput
        for s in decoding:
            for i in range(mat.shape[0]):
                tok = int(mat[i, s.slot])
                s.seq_len += 1
                self._seq_lens[s.slot] = s.seq_len
                s.generated.append(tok)
                s.last_token = tok
                kept += 1
                if self.on_token is not None:
                    self.on_token(s.request.request_id, tok)
                if _is_stop(tok, self._eos, s):
                    self._finish(s, "eos")
                    break
                if len(s.generated) >= s.request.max_new_tokens:
                    self._finish(s, "length")
                    break
        self.metrics.observe_decode(kept, time.perf_counter() - t0)

    def step(self) -> List[FinishedRequest]:
        """One scheduler tick: admit what fits, advance at most one prefill
        piece (all pieces if nothing is decoding), then one decode step for
        all decoding slots.  Returns every completion not yet collected."""
        self._expire_deadlines()
        while self._try_admit():
            pass
        prefilling = [s for s in self._slots
                      if s is not None and not s.prefill_done]
        decoding = [s for s in self._slots if s is not None and s.prefill_done]
        did_batch = False
        if prefilling and self._ep is not None:
            # EP: interior pieces one per owner rank in one forward (a
            # single-slot piece runs on every rank)
            if decoding:
                did_batch = self._ep_prefill_batch_tick(prefilling)
            else:
                while self._ep_prefill_batch_tick(
                        [s for s in self._slots
                         if s is not None and not s.prefill_done]):
                    pass
            prefilling = [s for s in self._slots
                          if s is not None and not s.prefill_done]
        if prefilling and not did_batch:
            # oldest admitted first (slot index is reuse order, not age)
            target = min(prefilling, key=lambda s: s.admit_seq)
            if decoding:
                self._prefill_tick(target)          # one piece only
            else:
                while not target.prefill_done:      # nothing to starve
                    self._prefill_tick(target)
                    if self._slots[target.slot] is not target:
                        break                       # finished at first token
        decoding = [s for s in self._slots if s is not None and s.prefill_done]
        if decoding and self._model_draft:
            self._step_speculative_model(decoding)
            return self._drain_finished()
        if decoding and self.speculative:
            host_drafts = {s.slot: self._pld_draft_host(s) for s in decoding}
            if any(d is not None for d in host_drafts.values()):
                self._step_speculative(decoding, host_drafts)
                return self._drain_finished()
            # no slot drafted anything: a verify would cost a (k+1)-token
            # forward for one token per row; take the plain tick
        if decoding:
            t0 = time.perf_counter()
            self._load_tick(decoding)
            nxt = self._decode_tick()
            self._deliver(decoding, nxt.cpu().numpy()[None], t0)
        return self._drain_finished()

    def step_batch(self, n: int = 8) -> List[FinishedRequest]:
        """Up to ``n`` decode ticks with one host sync.  Admissions run at
        the window start (host-only accounting); a prefilling slot's
        interior pieces interleave into the window; ticks that need a host
        decision (a last prefill piece, prefill-only states) take a single
        ``step()``."""
        if n <= 1:
            return self.step()
        self._expire_deadlines()
        while self._try_admit():
            pass
        prefilling = [s for s in self._slots
                      if s is not None and not s.prefill_done]
        decoding = [s for s in self._slots if s is not None and s.prefill_done]
        if not decoding:
            return self.step()   # prefill-only / idle: host-paced path
        if prefilling and (self.speculative or self._ep is not None):
            return self.step()   # speculative / EP mixed ticks: host-paced
        if prefilling:
            # interior pieces need no host decision (their sizes are fixed,
            # they sample nothing): they chain with the decode ticks; the
            # last piece (it samples) stays on step()
            target = min(prefilling, key=lambda s: s.admit_seq)
            interior = (len(target.request.prompt) - target.prefilled
                        - 1) // self.prefill_chunk
            if interior >= 1:
                return self._mixed_chain_batch(min(n, interior), decoding,
                                               target)
            return self.step()
        if self._model_draft:
            # model drafts need no host input: rounds chain on the device
            return self._spec_model_batch(n, decoding)
        if self.speculative:
            # prompt-lookup drafts chain too, from the device history
            # buffer; the acceptance EMA backs off to plain chained ticks
            # on traffic that drafts nothing
            mode = self._pld_batch_policy()
            if mode == "spec":
                return self._spec_pld_batch(n, decoding)
            if mode == "probe":
                return self._spec_pld_batch(min(n, 2), decoding)
        # cap by the tightest remaining token budget so no row overshoots
        n = max(1, min([n] + [s.request.max_new_tokens - len(s.generated)
                              for s in decoding]))
        t0 = time.perf_counter()
        self._load_tick(decoding)
        cols = [self._decode_tick() for _ in range(n)]
        self._deliver(decoding, torch.stack(cols, 0).cpu().numpy(), t0)
        return self._drain_finished()

    def _ep_prefill_batch_tick(self, prefilling) -> bool:
        """Advance up to one interior prefill piece per owner rank in one EP
        forward (``make_ep_prefill_batch_fn``).  Returns True if two or more
        pieces advanced; a single candidate stays on the single-slot
        piece, which runs on every rank."""
        ep = self._ep.ep
        sps = self.max_slots // ep
        chunk = self.prefill_chunk
        cand: Dict[int, _Running] = {}
        for s in sorted(prefilling, key=lambda r: r.admit_seq):
            # interior pieces only: exactly `chunk` tokens, no sampling
            if len(s.request.prompt) - s.prefilled > chunk:
                cand.setdefault(s.slot // sps, s)
        if len(cand) < 2:
            return False
        tokens = np.zeros((ep, chunk), np.int64)
        tables = np.zeros((ep, self.max_pages_per_seq), np.int32)
        starts, active = [0] * ep, [False] * ep
        for owner, s in cand.items():
            tokens[owner] = s.request.prompt[s.prefilled:s.prefilled + chunk]
            tables[owner] = self._block_tables[s.slot]
            starts[owner], active[owner] = s.prefilled, True
        tokens_d, tables_d = self._tensor(tokens), self._tensor(tables)
        self._piece_batch(self.params, tokens_d, starts, self.cache, tables_d,
                          active)
        mine = cand.get(self._ep.rank)
        if self._model_draft and mine is not None:
            # the drafter is dense: this rank's piece alone, locally
            r = self._ep.rank
            self._drafter_piece(tokens_d[r:r + 1], mine.prefilled,
                                tables_d[r:r + 1])
        for s in cand.values():
            s.prefilled += chunk
            self.metrics.observe_prefill(chunk)
        self._step_count += 1
        return True

    def _mixed_chain_batch(self, n: int, decoding: List[_Running],
                           target: _Running) -> List[FinishedRequest]:
        """``n`` [interior prefill piece + decode tick] pairs chained on the
        device with one host sync.  The step count and generator seeds run
        as in ``n`` consecutive ``step()`` calls (piece, then decode), so
        the outputs are token-identical to per-tick serving, stochastic
        rows included."""
        chunk = self.prefill_chunk
        n = max(1, min([n] + [s.request.max_new_tokens - len(s.generated)
                              for s in decoding]))
        t0 = time.perf_counter()
        self._load_tick(decoding)
        start0 = target.prefilled
        # the window's prompt tokens and the target's table, uploaded once
        prompt = self._tensor(np.asarray(
            target.request.prompt[start0:start0 + n * chunk], np.int64))[None]
        tgt_table = self._tensor(self._block_tables[target.slot:
                                                    target.slot + 1])
        cols = []
        for i in range(n):
            self._run_piece(target, prompt[:, i * chunk:(i + 1) * chunk],
                            start0 + i * chunk, chunk, tgt_table, last=False)
            target.prefilled = start0 + (i + 1) * chunk
            self.metrics.observe_prefill(chunk)
            self._step_count += 1
            cols.append(self._decode_tick())
        self._deliver(decoding, torch.stack(cols, 0).cpu().numpy(), t0)
        return self._drain_finished()

    def run_to_completion(self, sync_every: int = 8) -> List[FinishedRequest]:
        """Drain all pending and active requests.  Returns only completions
        not already handed out by earlier step() / step_batch() calls."""
        out: List[FinishedRequest] = []
        while self.has_work():
            out.extend(self.step_batch(sync_every))
        out.extend(self._drain_finished())
        return out
