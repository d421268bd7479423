"""The tensor-parallel step: each rank runs the single-card forward, with
its kernels, on its own shard.

The port's counterpart of the JAX package's ``parallel/tp_step.py``.  The
JAX package runs the whole step inside ``jax.shard_map``; the port is SPMD,
so each function here is a plain function that every model rank calls at
once on its local shards: the port's own ``decode_step`` /
``forward_hidden`` / ``prefill_chunked`` with the LOCAL config (heads
divided by tp) and the mesh's model group as ``reduce_group``, which issues
the Megatron all-reduces explicitly:

* ``q / k / v / gate / up``: column parallel, no collective;
* ``o / down``: row parallel, one all-reduce each a layer (an MoE layer's
  experts split over the group, its combine summed, ``moe_mlp``);
* KV cache and attention: split over the KV heads, attention is local;
* embedding and lm_head: split on the vocabulary (a masked lookup and a
  sum; the logits leave the step vocab-sharded and ``ShardedVocab``
  samples on them).

Row-parallel W4A8 / W8A8 projections quantize their activations per
token over this rank's K, as the JAX ``shard_map`` body does; where the
JAX package runs GSPMD's ops instead (its scheduler under a data axis,
``generate_speculative`` under any mesh) the makers take
``whole_row_scales`` and each token's scale is the whole row's
(``model_group``).

Every gate that picks a kernel (``fused_mlp_supported``, the split-K
plans, the paged split plans) sees the local shapes, as the JAX package's
``shard_map`` body does.  The makers are the forwards the engines run
(``Engine``'s prefill and decode step; the serving engine's pieces, tick,
verify and draft-model round), with or without a mesh: ``mesh=None``
gives the same functions without collectives, the single-card (or
pure-DP) step.  Each runs the rows it is given: under a data axis the
serving engine hands its tick, verify and round the rows of its own data
group (``data_rows``) and gathers their outputs over the data axis
(``gather_data_rows``), so every rank samples the whole batch.

The shards are plain slices (``parallel/sharding.shard_params``), so a
shard of a stacked ``QuantLinear`` is itself a valid ``QuantLinear`` where
no shard boundary cuts a group: ``supports_tp`` holds exactly when every
split is clean, and ``tp_refusal`` names the first condition that fails.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.models.qwen import (
    compute_logits,
    decode_step,
    forward_hidden,
    prefill_chunked,
)
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    Group,
    Mesh,
    all_gather,
    gather_data,
)


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The per-shard view of the model: heads divided over the model axis.
    hidden_size stays global (the residual stream is replicated);
    intermediate_size only sizes initialization (the forward reads shard
    shapes from the weights)."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"heads {cfg.num_heads} / KV heads "
                         f"{cfg.num_kv_heads} do not split over tp={tp}")
    return cfg.replace(num_heads=cfg.num_heads // tp,
                       num_kv_heads=cfg.num_kv_heads // tp,
                       intermediate_size=cfg.intermediate_size // tp)


def tp_aligned_group_size(k_logical: int, tp: int, group_size: int,
                          bits: int) -> int:
    """The largest group size <= ``group_size`` whose groups (for INT4,
    plane pairs = 2 groups) never straddle a row-parallel shard boundary,
    so a plain slice of (q, scales) is a valid local QuantLinear."""
    if k_logical % tp:
        raise ValueError(f"K={k_logical} does not split over tp={tp}")
    k_local = k_logical // tp
    gs = group_size
    unit = 2 if bits == 4 else 1
    while gs > 2 and k_local % (unit * gs):
        gs //= 2
    return gs


def _out(lin) -> int:
    return lin.w.shape[-1] if isinstance(lin, Linear) else lin.out_features


def _rows(lin) -> int:
    return lin.w.shape[-2] if isinstance(lin, Linear) else lin.q.shape[-2]


def tp_refusal(cfg: ModelConfig, params: dict, tp: int) -> Optional[str]:
    """Why the param tree cannot split at this tp (the first condition
    ``supports_tp`` finds false), or None where it can."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        return (f"heads {cfg.num_heads} / KV heads {cfg.num_kv_heads} do "
                f"not split over tp={tp}")
    layers = params["layers"]
    if "moe_gate" in layers:
        # MoE: TP attention + expert-sharded MLP (moe_mlp(reduce_group))
        if cfg.num_experts % tp:
            return f"{cfg.num_experts} experts do not split over tp={tp}"
        o = layers["o"]
        if isinstance(o, QuantLinear) and o.scales.shape[-2] % tp:
            return "o's scale groups do not split over tp"
        if _rows(o) % tp:
            return "o's rows do not split over tp"
        if o.b is not None:
            return "o has a bias (a row-parallel bias would be summed tp times)"
        return None
    if "gate" not in layers or "qkv" in layers or "gateup" in layers:
        return "fused projections (qkv / gateup) interleave heads and FFN " \
               "columns; TP needs the split layout"
    for name in ("q", "k", "v", "gate", "up"):
        if _out(layers[name]) % tp:
            return f"{name}'s {_out(layers[name])} columns do not split " \
                   f"over tp={tp}"
    for name in ("o", "down"):
        lin = layers[name]
        if _rows(lin) % tp:
            return f"{name}'s rows do not split over tp={tp}"
        if lin.b is not None:
            return f"{name} has a bias (a row-parallel bias would be " \
                   f"summed tp times)"
        if isinstance(lin, QuantLinear):
            if lin.scales.shape[-2] % tp:
                return f"{name}'s scale groups do not split over tp={tp}"
            unit = 2 if lin.bits == 4 else 1
            if (lin.in_features // tp) % (unit * lin.group_size):
                return (f"{name}'s row shards of K={lin.in_features} "
                        f"straddle group_size={lin.group_size} at tp={tp} "
                        f"(tp_aligned_group_size)")
    head = params.get("lm_head")
    if head is not None and _out(head) % tp:
        return f"the lm_head's {_out(head)} columns do not split over tp={tp}"
    if params["embed"].shape[0] % tp:
        return f"the embedding's {params['embed'].shape[0]} rows do not " \
               f"split over tp={tp}"
    return None


def supports_tp(cfg: ModelConfig, params: dict, tp: int) -> bool:
    """Whether the param tree splits at this tp degree (the JAX gate)."""
    return tp_refusal(cfg, params, tp) is None


def model_group(mesh: Optional[Mesh],
                whole_row_scales: bool = False) -> Optional[Group]:
    """The TP step's ``reduce_group`` (None without a mesh).
    whole_row_scales: the step keeps the JAX package's GSPMD semantics,
    where a row-parallel projection's int8 activations take each token's
    scale over the whole row (the JAX scheduler under a data axis above 1,
    and ``Engine.generate_speculative`` under any mesh); without it, over
    this rank's K, as the JAX ``shard_map`` step does."""
    if mesh is None:
        return None
    if whole_row_scales and mesh.tp > 1:
        return dataclasses.replace(mesh.model_group, whole_row_scales=True)
    return mesh.model_group


def sharded_argmax(logits_l: torch.Tensor, group: Group) -> torch.Tensor:
    """The argmax over a vocabulary split across ``group``, in global ids.
    Ties go to the lowest global id, as on one device: each rank reports
    its local (max, first argmax + offset), and the first rank that holds
    the global max wins."""
    v_l = logits_l.shape[-1]
    lmax = logits_l.amax(dim=-1)
    larg = torch.argmax(logits_l, dim=-1) + group.rank * v_l
    allmax = all_gather(lmax, group)                  # [tp, B]
    allarg = all_gather(larg, group)
    best = torch.argmax(allmax, dim=0)                # first rank wins ties
    return torch.gather(allarg, 0, best[None, :])[0]


class ShardedVocab:
    """The sampler's view of vocab-sharded logits (``ops/sampling.py``):
    this rank holds columns ``[rank * v_local, (rank + 1) * v_local)`` of
    ``size`` = ``v_local * group.size``."""

    def __init__(self, group: Group, v_local: int):
        self.group = group
        self.v_local = v_local
        self.size = v_local * group.size
        self.lo = group.rank * v_local

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t[..., self.lo:self.lo + self.v_local]

    def argmax(self, logits_l: torch.Tensor) -> torch.Tensor:
        return sharded_argmax(logits_l, self.group)

    def topk(self, logits_l: torch.Tensor, k: int):
        """(values, global ids) of the global top ``k`` of each row, from
        every rank's top-min(k, v_local) candidates."""
        vals, idx = torch.topk(logits_l, min(k, self.v_local), dim=-1)
        B = vals.shape[0]
        allv = all_gather(vals, self.group).permute(1, 0, 2).reshape(B, -1)
        alli = all_gather(idx + self.lo, self.group).permute(1, 0, 2) \
            .reshape(B, -1)
        top, j = torch.topk(allv, k, dim=-1)
        return top, torch.gather(alli, 1, j)

    def full(self, logits_l: torch.Tensor) -> torch.Tensor:
        """The whole row ``[B, size]``, in global column order."""
        parts = all_gather(logits_l, self.group)          # [tp, B, v_local]
        return parts.permute(1, 0, 2).reshape(logits_l.shape[0], -1)


def sampling_vocab(mesh: Optional[Mesh], cfg: ModelConfig):
    """The ``vocab`` argument of the samplers under ``mesh``'s TP step
    (None without model parallelism)."""
    if mesh is None or mesh.tp == 1:
        return None
    return ShardedVocab(mesh.model_group, cfg.vocab_size // mesh.tp)


def _local(cfg: ModelConfig, mesh: Optional[Mesh]) -> ModelConfig:
    return cfg if mesh is None else local_config(cfg, mesh.tp)


def data_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's data group's rows of a batch of ``n``: ``[d * n / dp,
    (d + 1) * n / dp)`` (every row without a data axis)."""
    if mesh is None or mesh.dp == 1:
        return slice(None)
    if n % mesh.dp:
        raise ValueError(f"{n} rows do not split over dp={mesh.dp}")
    k = n // mesh.dp
    return slice(mesh.coords[0] * k, (mesh.coords[0] + 1) * k)


def gather_data_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data group's rows of ``t`` in data-index order, ``[dp * rows,
    ...]`` (``gather_data``); ``t`` itself without a data axis."""
    if mesh is None or mesh.dp == 1:
        return t
    return gather_data(t, mesh).reshape(-1, *t.shape[1:])


def make_tp_decode_fn(cfg: ModelConfig, mesh: Optional[Mesh], *,
                      uniform_decode: bool = False, paged: bool = False,
                      whole_row_scales: bool = False):
    """``fn(params_l, tok, pos, cache_l[, tables]) -> (logits_l, cache_l)``:
    one decode step of the rows given on this rank's shards; the logits
    are this rank's vocabulary columns.  paged: the cache is the page pool
    and the fn takes the block tables.  whole_row_scales (every maker
    here): ``model_group``'s."""
    cfg_l = _local(cfg, mesh)
    group = model_group(mesh, whole_row_scales)

    def fn(params_l, tok, pos, cache_l, tables=None):
        return decode_step(params_l, cfg_l, tok, pos, cache_l, tables,
                           uniform_decode=uniform_decode,
                           reduce_group=group)

    return fn


def make_tp_verify_fn(cfg: ModelConfig, mesh: Optional[Mesh], *, T: int,
                      whole_row_scales: bool = False):
    """``fn(params_l, tokens [B, T], pos0 [B], cache_l, tables) -> (logits_l
    [B, T, V/tp], cache_l)``: the speculative verify of the rows given (T
    consecutive tokens a row from its start) over the page pool, or over
    the contiguous cache with ``tables`` None; acceptance runs on the
    sharded logits outside."""
    cfg_l = _local(cfg, mesh)
    group = model_group(mesh, whole_row_scales)

    def fn(params_l, tokens, pos0, cache_l, tables):
        positions = pos0[:, None] + torch.arange(T, device=tokens.device)
        hidden, cache_l = forward_hidden(
            params_l, cfg_l, tokens, positions, cache_l,
            block_tables=tables, ragged_multi=True, reduce_group=group)
        return compute_logits(params_l, hidden, cfg_l.act_bits_lm_head), \
            cache_l

    return fn


def make_tp_spec_model_fn(cfg: ModelConfig, dcfg: ModelConfig,
                          mesh: Optional[Mesh], *, k: int,
                          whole_row_scales: bool = False):
    """One draft-model round on this rank's shards: the drafter's k+1
    greedy decode steps (the sharded argmax on its vocab-sharded logits)
    feed the target's T = k+1 verify.  ``fn(params_l, dparams_l, tok_last,
    pos0, cache_l, dcache_l, tables) -> (logits_l [B, k+1, V/tp], drafts
    [B, k])``.  Drafter protocol: step 0 feeds the last token, steps 1..k-1
    feed draft i, step k feeds draft k (its output unused), so the drafter
    writes the KV of every position the verify writes."""
    dcfg_l = _local(dcfg, mesh)
    group = model_group(mesh, whole_row_scales)
    verify = make_tp_verify_fn(cfg, mesh, T=k + 1,
                               whole_row_scales=whole_row_scales)

    def fn(params_l, dparams_l, tok_last, pos0, cache_l, dcache_l, tables):
        cur, drafts = tok_last, []
        for i in range(k + 1):
            logits, _ = decode_step(dparams_l, dcfg_l, cur, pos0 + i,
                                    dcache_l, tables, reduce_group=group)
            if i < k:
                cur = (torch.argmax(logits, dim=-1) if group is None
                       else sharded_argmax(logits, group))
                drafts.append(cur)
        drafts = torch.stack(drafts, dim=1)                  # [B, k]
        tokens = torch.cat([tok_last[:, None], drafts], dim=1)
        logits, _ = verify(params_l, tokens, pos0, cache_l, tables)
        return logits, drafts

    return fn


def make_tp_prefill_fn(cfg: ModelConfig, mesh: Optional[Mesh], *,
                       chunk: int = 512):
    """``fn(params_l, tokens, lengths, cache_l) -> (logits_l, cache_l)``:
    the chunked prefill on this rank's shards."""
    cfg_l, group = _local(cfg, mesh), model_group(mesh)

    def fn(params_l, tokens, lengths, cache_l):
        return prefill_chunked(params_l, cfg_l, tokens, lengths, cache_l,
                               chunk=chunk, reduce_group=group)

    return fn


def make_tp_prefill_piece_fn(cfg: ModelConfig, mesh: Optional[Mesh], *,
                             last: bool, whole_row_scales: bool = False):
    """One prefill piece of one sequence over the page pool (a scheduler
    tick) on this rank's shards: ``fn(params_l, tokens [1, T], start,
    nvalid, cache_l, tables [1, W]) -> logits_l [1, V/tp]`` of the piece's
    last valid token when ``last``, else None.  ``start`` is a host int (0:
    the fresh-prefill branch).  Under a data axis only the slot's own data
    group runs it."""
    cfg_l = _local(cfg, mesh)
    group = model_group(mesh, whole_row_scales)

    def fn(params_l, tokens, start, nvalid, cache_l, tables):
        T = tokens.shape[1]
        positions = start + torch.arange(T, device=tokens.device)[None, :]
        hidden, _ = forward_hidden(
            params_l, cfg_l, tokens, positions, cache_l, block_tables=tables,
            fresh_prefill=start == 0, start=None if start == 0 else start,
            reduce_group=group)
        if not last:
            return None
        h = hidden[:, min(max(nvalid - 1, 0), T - 1)]
        return compute_logits(params_l, h, cfg_l.act_bits_lm_head)

    return fn
