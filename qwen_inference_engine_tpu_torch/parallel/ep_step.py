"""The expert-parallel serving step: the scheduler's paged forwards over an
``("ep",)`` mesh, each rank on its own slots and experts.

The port of the JAX package's ``parallel/ep_step.py``.  The JAX package
runs each step under ``jax.shard_map``; the port is SPMD, so each maker
returns a plain function that every rank of the mesh calls at once:

* expert stacks ``moe_gate / moe_up / moe_down``: split on the expert axis
  (``ep_param_shards``: rank ``p`` keeps experts ``[p * E / P, (p + 1) * E
  / P)``); every other weight whole on every rank;
* the decode batch, a verify's rows and a draft-model round: split by slot,
  rank ``p`` running slots ``[p * S / P, (p + 1) * S / P)``; attention and
  the dense projections are local, the MoE layers route through the
  all-to-alls (``forward_hidden(..., ep_group=...)``);
* the page pool: the same structure on every rank, different contents.
  Each rank writes and reads only its own slots' pages, so no collective
  touches it;
* a single-slot prefill piece runs on every rank, because every rank must
  join the all-to-alls.  Only the slot's owner (``slot // slots_per_shard``)
  runs it over the pool; the others run it over a scratch pool of one
  sequence (``EpScratch``), so their pools keep their bytes (the JAX
  package writes ``where(owner, new, old)``), and the last piece's logits
  are the owner's (a masked all-reduce, the JAX ``psum(where(owner,
  ...))``);
* batched interior pieces: one per owner rank, ranks without a piece
  riding along over the scratch pool;
* the dense drafter runs locally on each rank for its own slots.

The decode, verify and draft-model makers gather their rows' logits over
the group (``gather_rows``), so every rank runs the one-rank sampler on
the same ``[S, ...]`` logits and draws the same tokens: ``S x V x 4``
bytes a decode tick (each rank sends its ``S / P`` rows), ``S x (k+1) x V
x 4`` a verify.

EP steps run eager (``EpMesh.capturable`` is false).  Where the JAX
package drops to GSPMD's XLA ops (``supports_ep`` false) the port raises,
naming the condition (``ep_refusal``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
from qwen_inference_engine_tpu_torch.models.qwen import (
    compute_logits,
    decode_step,
    forward_hidden,
)
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    EP_AXIS,
    EpMesh,
    all_gather,
    all_reduce,
)
from qwen_inference_engine_tpu_torch.parallel.sharding import EXPERTS, _slice


def ep_refusal(cfg: ModelConfig, mesh, max_slots: int) -> Optional[str]:
    """Why the serving engine cannot run this model on ``mesh``'s ep axis
    (the first condition the JAX ``supports_ep`` finds false), or None."""
    ep = dict(mesh.shape).get(EP_AXIS, 1)
    if not cfg.is_moe:
        return f"{cfg.name} is not a MoE model"
    if ep < 2:
        return f"the ep axis is {ep}"
    if cfg.num_experts % ep:
        return f"{cfg.num_experts} experts do not split over ep={ep}"
    if max_slots % ep:
        return f"max_slots={max_slots} does not split over ep={ep}"
    return None


def supports_ep(cfg: ModelConfig, mesh, max_slots: int) -> bool:
    """The JAX package's gate for the EP serving step."""
    return ep_refusal(cfg, mesh, max_slots) is None


def ep_param_shards(params: dict, mesh: EpMesh) -> dict:
    """This rank's tree (the JAX ``shard_for_ep``): the expert stacks cut to
    its experts on their expert axis (dim 1 of ``[L, E, ...]``, copies),
    every other leaf shared with ``params``."""
    def cut(leaf):
        if isinstance(leaf, QuantLinear):
            return dataclasses.replace(leaf, q=cut(leaf.q),
                                       scales=cut(leaf.scales))
        return _slice(leaf, 1, mesh.rank, mesh.ep, "an expert stack")

    layers = {name: cut(leaf) if name in EXPERTS else leaf
              for name, leaf in params["layers"].items()}
    return dict(params, layers=layers)


@dataclasses.dataclass
class EpScratch:
    """Where a rank runs a prefill piece of a slot it does not own: a page
    pool of one sequence's ``W`` pages (the engine pool's layout) and its
    identity block table ``[1, W]``.  Its contents are never read as data."""

    pool: PagedKVCache
    table: torch.Tensor


def ep_scratch(pool: PagedKVCache, max_pages_per_seq: int) -> EpScratch:
    """An ``EpScratch`` shaped like ``pool`` for tables of
    ``max_pages_per_seq`` pages."""
    L, _, Hk, ps, Dh = pool.k_pages.shape
    dev = pool.k_pages.device
    return EpScratch(
        pool=PagedKVCache.create(L, max_pages_per_seq, ps, Hk, Dh,
                                 dtype=pool.k_pages.dtype, device=dev),
        table=torch.arange(max_pages_per_seq, dtype=torch.int32,
                           device=dev)[None])


def gather_rows(t: torch.Tensor, mesh: EpMesh) -> torch.Tensor:
    """Every rank's rows of ``t`` in rank order: ``[P * rows, ...]``."""
    return all_gather(t, mesh.ep_group).reshape(-1, *t.shape[1:])


def _rows(mesh: EpMesh, B: int) -> slice:
    """This rank's slots of a batch of ``B`` (``B % ep == 0``)."""
    n = B // mesh.ep
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def _ep_kw(mesh: EpMesh) -> dict:
    return dict(ep_group=mesh.ep_group, ep_ragged=mesh.ragged)


def make_ep_decode_fn(cfg: ModelConfig, mesh: EpMesh):
    """``fn(params_l, tok [S], pos [S], cache_l, tables [S, W]) -> (logits
    [S, V], cache_l)``: one decode step of this rank's slots over its pool;
    the logits gathered over the group."""
    kw = _ep_kw(mesh)

    def fn(params_l, tok, pos, cache_l, tables):
        r = _rows(mesh, tok.shape[0])
        hidden, _ = forward_hidden(params_l, cfg, tok[r, None],
                                   pos[r, None], cache_l,
                                   block_tables=tables[r], **kw)
        logits = compute_logits(params_l, hidden[:, 0],
                                cfg.act_bits_lm_head)
        return gather_rows(logits, mesh), cache_l

    return fn


def _verify_rows(cfg: ModelConfig, mesh: EpMesh, params_l, tokens_l,
                 pos0_l, cache_l, tables_l) -> torch.Tensor:
    """The verify forward of this rank's rows ``tokens_l [S/P, T]`` from
    their starts ``pos0_l``: their logits ``[S/P, T, V]``."""
    T = tokens_l.shape[1]
    positions = pos0_l[:, None] + torch.arange(T, device=tokens_l.device)
    hidden, _ = forward_hidden(params_l, cfg, tokens_l, positions, cache_l,
                               block_tables=tables_l, ragged_multi=True,
                               **_ep_kw(mesh))
    return compute_logits(params_l, hidden, cfg.act_bits_lm_head)


def make_ep_verify_fn(cfg: ModelConfig, mesh: EpMesh, *, T: int):
    """``fn(params_l, tokens [S, T], pos0 [S], cache_l, tables) -> (logits
    [S, T, V], cache_l)``: the speculative verify of this rank's slots;
    the logits gathered over the group (acceptance runs outside)."""
    def fn(params_l, tokens, pos0, cache_l, tables):
        if tokens.shape[1] != T:
            raise ValueError(f"the verify takes T={T} tokens a row, not "
                             f"{tokens.shape[1]}")
        r = _rows(mesh, tokens.shape[0])
        logits = _verify_rows(cfg, mesh, params_l, tokens[r], pos0[r],
                              cache_l, tables[r])
        return gather_rows(logits, mesh), cache_l

    return fn


def make_ep_spec_model_fn(cfg: ModelConfig, dcfg: ModelConfig,
                          mesh: EpMesh, *, k: int):
    """One draft-model round of this rank's slots: a DENSE drafter's k+1
    greedy decode steps, local (its weights whole on every rank, its pool
    divergent like the target's), feed the target's T = k+1 verify.
    ``fn(params_l, dparams, tok_last, pos0, cache_l, dcache, tables) ->
    (logits [S, k+1, V], drafts [S, k])``, both gathered over the group.
    The drafter protocol is ``tp_step.make_tp_spec_model_fn``'s."""
    if dcfg.is_moe:
        raise ValueError("the drafter of an EP round must be a dense model: "
                         "an MoE drafter would need its own all-to-alls")

    def fn(params_l, dparams, tok_last, pos0, cache_l, dcache, tables):
        r = _rows(mesh, tok_last.shape[0])
        cur, drafts = tok_last[r], []
        for i in range(k + 1):
            logits, _ = decode_step(dparams, dcfg, cur, pos0[r] + i, dcache,
                                    tables[r])
            if i < k:
                cur = torch.argmax(logits, dim=-1)
                drafts.append(cur)
        drafts = torch.stack(drafts, dim=1)                   # [S/P, k]
        tokens = torch.cat([tok_last[r, None], drafts], dim=1)
        logits = _verify_rows(cfg, mesh, params_l, tokens, pos0[r], cache_l,
                              tables[r])
        return gather_rows(logits, mesh), gather_rows(drafts, mesh)

    return fn


def make_ep_prefill_piece_fn(cfg: ModelConfig, mesh: EpMesh, *, last: bool,
                             slots_per_shard: int, scratch: EpScratch):
    """One prefill piece of one slot, on every rank:
    ``fn(params_l, tokens [1, T], start, nvalid, cache_l, tables [1, W],
    slot) -> logits [1, V]`` of the piece's last valid token (the owner's,
    on every rank) when ``last``, else None.  ``start`` is a host int (0:
    the fresh-prefill branch).  A rank that does not own ``slot`` runs the
    piece over ``scratch``, its pool untouched."""
    kw = _ep_kw(mesh)

    def fn(params_l, tokens, start, nvalid, cache_l, tables, slot):
        owner = slot // slots_per_shard == mesh.rank
        pool, table = ((cache_l, tables) if owner
                       else (scratch.pool, scratch.table))
        T = tokens.shape[1]
        positions = start + torch.arange(T, device=tokens.device)[None, :]
        hidden, _ = forward_hidden(
            params_l, cfg, tokens, positions, pool, block_tables=table,
            fresh_prefill=start == 0, start=None if start == 0 else start,
            **kw)
        if not last:
            return None
        if owner:
            h = hidden[:, min(max(nvalid - 1, 0), T - 1)]
            logits = compute_logits(params_l, h, cfg.act_bits_lm_head)
        else:
            logits = torch.zeros((1, cfg.vocab_size), dtype=torch.float32,
                                 device=tokens.device)
        return all_reduce(logits, mesh.ep_group)

    return fn


def make_ep_prefill_batch_fn(cfg: ModelConfig, mesh: EpMesh, *,
                             scratch: EpScratch):
    """Interior prefill pieces batched one per owner rank:
    ``fn(params_l, tokens [P, T], starts, cache_l, tables [P, W], active)``
    with ``starts`` and ``active`` host lists of P.  Rank ``p`` advances row
    ``p`` over its pool where ``active[p]``; an inactive rank rides along
    over ``scratch``.  Interior pieces only: exactly T tokens, no
    logits."""
    kw = _ep_kw(mesh)

    def fn(params_l, tokens, starts: List[int], cache_l, tables,
           active: List[bool]) -> None:
        p = mesh.rank
        if active[p]:
            pool, table, start = cache_l, tables[p:p + 1], starts[p]
        else:
            pool, table, start = scratch.pool, scratch.table, 0
        T = tokens.shape[1]
        positions = start + torch.arange(T, device=tokens.device)[None, :]
        forward_hidden(params_l, cfg, tokens[p:p + 1], positions, pool,
                       block_tables=table, fresh_prefill=start == 0,
                       start=None if start == 0 else start, **kw)

    return fn
