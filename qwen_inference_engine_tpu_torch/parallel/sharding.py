"""Tensor-parallel split rules for params and KV caches, and this rank's
local pieces.

The port's counterpart of the JAX package's ``parallel/sharding.py``.  The
JAX package states PartitionSpecs and lets ``device_put`` place the
shards; the port is SPMD, so each rank cuts its own local tree out of the
global one with plain slices (copies, so the global tensors can be freed):

* ``q / k / v / gate / up`` (and the fused ``qkv / gateup``): column
  parallel, split on the output axis with their biases and scales;
* ``o / down``: row parallel, split on the input axis, both the packed
  rows of a ``QuantLinear`` and its scale rows (the bias, added after the
  all-reduce, stays whole);
* ``embed`` and ``lm_head``: split on the vocabulary;
* the expert stacks ``moe_gate / moe_up / moe_down``: split on the expert
  axis (dim 1);
* everything else (norms, RoPE tables, the router) is replicated.

A slice of a stacked ``QuantLinear`` is itself a valid ``QuantLinear`` as
long as no shard boundary cuts a scale group (or, for INT4, a plane pair
of groups): ``parallel/tp_step.supports_tp`` asks for that before any
engine shards.  ``split_dims`` is ``param_pspecs`` as one split dimension a
leaf (None = replicated).

Caches: the contiguous cache splits its KV heads on ``model`` and its batch
rows on ``data``; the page pool splits its KV heads only, so every data
group holds all ``num_pages`` pages, as the JAX ``cache_pspecs`` puts no
data axis on the pool (each group writes its own slots' pages; the serving
engine copies prefix pages between groups, ``engine/prefix_cache.py``).

A model that does not split evenly (``parallel/tp_step.TpLayout``, the
JAX package's GSPMD cases) is cut by its layout instead, block by block:
each rank takes its query heads' columns and, where the KV heads are
replicated, the columns of its one KV head ``r // (tp / Hk)`` at full
head_dim (the fused ``qkv`` the same three column ranges), its MLP
columns and down rows (the fused ``gateup`` its gate columns then its up
columns), and the whole leaves of a block that runs whole.  The cache
follows the attention block: its KV heads, the one KV head it replicates,
or all of them.  The JAX package splits head_dim where the model axis
does not divide the KV heads; no attention kernel takes a split head_dim
(GSPMD itself replicates there), so the port replicates the KV head
instead.  ``batch_shard`` puts a token axis on ``model`` for the
sequence-parallel prefill.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache, PagedKVCache
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
)

COLUMN = ("q", "k", "v", "gate", "up", "qkv", "gateup")
ROW = ("o", "down")
EXPERTS = ("moe_gate", "moe_up", "moe_down")
REPLICATED = ("input_norm", "post_norm", "q_norm", "k_norm", "router")


def _linear_dims(lin, shard: str, stacked: bool):
    """Split dims of a Linear / QuantLinear: 'out' (column) or 'in' (row);
    ``stacked`` leaves carry a leading layer axis."""
    nd = 3 if stacked else 2
    if shard == "out":
        w, b, s = nd - 1, nd - 2, nd - 1
    else:
        w, b, s = nd - 2, None, nd - 2
    if isinstance(lin, Linear):
        return Linear(w=w, b=None if lin.b is None else b)
    if isinstance(lin, QuantLinear):
        return QuantLinear(q=w, scales=s, b=None if lin.b is None else b,
                           bits=lin.bits, group_size=lin.group_size)
    raise TypeError(type(lin))


def split_dims(params: dict) -> dict:
    """The tree of split dimensions mirroring ``params`` (the JAX
    ``param_pspecs`` with the ``model`` axis's position for each leaf; None
    where a leaf is replicated)."""
    lspecs = {}
    for name, leaf in params["layers"].items():
        if name in COLUMN:
            lspecs[name] = _linear_dims(leaf, "out", stacked=True)
        elif name in ROW:
            lspecs[name] = _linear_dims(leaf, "in", stacked=True)
        elif name in EXPERTS:
            lspecs[name] = (dataclasses.replace(leaf, q=1, scales=1, b=None)
                            if isinstance(leaf, QuantLinear) else 1)
        elif name == "router":
            lspecs[name] = Linear(w=None, b=None)
        elif name in REPLICATED:
            lspecs[name] = None
        else:
            raise KeyError(name)
    specs = {"embed": 0, "layers": lspecs, "final_norm": None,
             "rope_cos": None, "rope_sin": None}
    if "lm_head" in params:
        specs["lm_head"] = _linear_dims(params["lm_head"], "out",
                                        stacked=False)
    return specs


def _slice(t: torch.Tensor, dim: Optional[int], index: int, parts: int,
           what: str) -> torch.Tensor:
    if dim is None or parts == 1:
        return t
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does not "
                         f"split into {parts} shards")
    w = n // parts
    return t.narrow(dim, index * w, w).clone(
        memory_format=torch.contiguous_format)


def _map(tree, dims, fn, path=""):
    if isinstance(tree, dict):
        return {k: _map(v, dims[k], fn, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (Linear, QuantLinear)):
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name), getattr(dims, f.name),
                       f"{path}.{f.name}")
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if tree is None:
        return None
    return fn(tree, dims, path)


def _take(t: torch.Tensor, dim: int, ranges, scale: int = 1
          ) -> torch.Tensor:
    """The ``ranges`` of ``t`` along ``dim`` (each ``(lo, hi)`` divided by
    ``scale``), concatenated, as a copy."""
    parts = [t.narrow(dim, lo // scale, (hi - lo) // scale)
             for lo, hi in ranges]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return out.clone(memory_format=torch.contiguous_format)


def _cut_linear(lin, *, cols=None, rows=None):
    """A stacked Linear / QuantLinear cut to its output ``cols`` or its
    logical input ``rows`` (the bias of a row cut stays whole)."""
    if cols is not None:
        if isinstance(lin, Linear):
            return Linear(w=_take(lin.w, -1, cols),
                          b=None if lin.b is None else _take(lin.b, -1, cols))
        return dataclasses.replace(
            lin, q=_take(lin.q, -1, cols), scales=_take(lin.scales, -1, cols),
            b=None if lin.b is None else _take(lin.b, -1, cols))
    if isinstance(lin, Linear):
        return Linear(w=_take(lin.w, -2, rows), b=lin.b)
    pack = 2 if lin.bits == 4 else 1
    return dataclasses.replace(lin, q=_take(lin.q, -2, rows, pack),
                               scales=_take(lin.scales, -2, rows,
                                            lin.group_size))


def _layout_leaves(params: dict, layout, m: int) -> dict:
    """Model rank ``m``'s tree under a ``TpLayout``."""
    lyr, out = params["layers"], {}
    mlp_cols = layout.mlp_cols[m] if layout.mlp == "split" else None
    for name, leaf in lyr.items():
        if name in REPLICATED or name == "router":
            out[name] = leaf
        elif name == "q":
            out[name] = _cut_linear(leaf, cols=layout.q_cols(m))
        elif name in ("k", "v"):
            out[name] = _cut_linear(leaf, cols=layout.kv_cols(m))
        elif name == "qkv":
            out[name] = _cut_linear(leaf, cols=layout.qkv_cols(m))
        elif name == "o":
            k = leaf.w.shape[-2] if isinstance(leaf, Linear) \
                else leaf.in_features
            out[name] = (leaf if layout.o != "split"
                         else _cut_linear(leaf, rows=layout.o_rows(m, k)))
        elif name in ("gate", "up", "gateup", "down"):
            if mlp_cols is None:
                out[name] = leaf
            elif name == "down":
                out[name] = _cut_linear(leaf, rows=(layout.mlp_rows[m],))
            elif name == "gateup":
                f = (leaf.w.shape[-1] if isinstance(leaf, Linear)
                     else leaf.out_features) // 2
                lo, hi = mlp_cols
                out[name] = _cut_linear(leaf, cols=((lo, hi),
                                                    (f + lo, f + hi)))
            else:
                out[name] = _cut_linear(leaf, cols=(mlp_cols,))
        elif name in EXPERTS:
            out[name] = leaf if layout.mlp == "whole" else _map(
                leaf, split_dims(params)["layers"][name],
                lambda t, d, what: _slice(t, d, m, layout.tp, what))
        else:
            raise KeyError(name)
    tree = {k: v for k, v in params.items() if k != "layers"}
    tree["layers"] = out
    if layout.vocab == "split":
        tree["embed"] = _slice(params["embed"], 0, m, layout.tp, "embed")
        if "lm_head" in params:
            head = params["lm_head"]
            w = (head.w.shape[-1] if isinstance(head, Linear)
                 else head.out_features) // layout.tp
            tree["lm_head"] = _cut_linear(head, cols=((m * w, (m + 1) * w),))
    return tree


def shard_params(params: dict, mesh: Mesh, layout=None) -> dict:
    """This rank's local tree: every split leaf cut to its model index's
    slice (copies), replicated leaves shared with ``params``.  layout: the
    model's ``TpLayout`` (None: the even split, ``split_dims``); a
    shard_map layout is the even split."""
    tp, index = mesh.tp, mesh.coords[1]
    if layout is not None and layout.gspmd and tp > 1:
        return _layout_leaves(params, layout, index)
    return _map(params, split_dims(params),
                lambda t, d, what: _slice(t, d, index, tp, what))


def cache_split_dims(cache, mesh: Mesh, layout=None):
    """Split dims of a cache's leaves, as ``(model dim, data dim)`` per
    leaf (the JAX ``cache_pspecs``; None where unsplit).  Under a layout
    whose attention does not split its KV heads the model dim is cut by
    ``make_sharded_cache`` from ``layout.kv_heads``; without a layout the
    KV heads must split evenly."""
    hk = (cache.k_pages.shape[2] if isinstance(cache, PagedKVCache)
          else cache.k.shape[2])
    if layout is None and hk % mesh.tp:
        raise ValueError(
            f"{hk} KV heads do not split over a model axis of {mesh.tp}: "
            f"pass the model's TpLayout (parallel/tp_step.tp_layout), which "
            f"replicates a KV head or keeps the attention whole")
    if isinstance(cache, PagedKVCache):
        return PagedKVCache(
            k_pages=(2, None), v_pages=(2, None),
            k_scale=None if cache.k_scale is None else (2, None),
            v_scale=None if cache.v_scale is None else (2, None),
            page_size=cache.page_size)
    return KVCache(k=(2, 1), v=(2, 1),
                   k_scale=None if cache.k_scale is None else (2, 1),
                   v_scale=None if cache.v_scale is None else (2, 1))


def make_sharded_cache(cache, mesh: Optional[Mesh], layout=None):
    """This rank's local piece of a global cache (KV heads on ``model``,
    contiguous-cache rows on ``data``); ``cache`` itself without a mesh.
    layout: the model's ``TpLayout``: its KV heads ``kv_heads(rank)`` (one
    KV head where they are replicated, all of them where the attention
    runs whole)."""
    if mesh is None:
        return cache
    dims = cache_split_dims(cache, mesh, layout)
    d_idx, m_idx = mesh.coords

    def cut(t, dd, what):
        if layout is None:
            t = _slice(t, dd[0], m_idx, mesh.tp, what)
        else:
            h0, n = layout.kv_heads(m_idx)
            t = _take(t, dd[0], ((h0, h0 + n),))
        return _slice(t, dd[1], d_idx, mesh.dp, what)

    if isinstance(cache, PagedKVCache):
        return PagedKVCache(
            k_pages=cut(cache.k_pages, dims.k_pages, "k_pages"),
            v_pages=cut(cache.v_pages, dims.v_pages, "v_pages"),
            k_scale=None if cache.k_scale is None else
            cut(cache.k_scale, dims.k_scale, "k_scale"),
            v_scale=None if cache.v_scale is None else
            cut(cache.v_scale, dims.v_scale, "v_scale"),
            page_size=cache.page_size)
    return KVCache(*[None if t is None else cut(t, dd, n) for t, dd, n in (
        (cache.k, dims.k, "k"), (cache.v, dims.v, "v"),
        (cache.k_scale, dims.k_scale, "k_scale"),
        (cache.v_scale, dims.v_scale, "v_scale"))])


def batch_shard(x: torch.Tensor, mesh: Optional[Mesh],
                spec: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's piece of a batch input under ``spec`` (an axis name or
    None a dim, as a JAX PartitionSpec): ``data`` splits dim 0's rows;
    ``model`` on a later dim (a token axis) splits the tokens into ``tp``
    equal slices, the input of the sequence-parallel prefill
    (``parallel/tp_step.make_tp_sp_prefill_fn``)."""
    if mesh is None:
        return x
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS and dim == 0:
            raise ValueError("'model' splits a token axis (a dim after the "
                             "rows), not the batch rows")
        if axis == DATA_AXIS and dim != 0:
            raise ValueError("'data' splits the batch rows (dim 0) only")
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            x = _slice(x, dim, mesh.coords[1], mesh.tp, "tokens")
    if spec and spec[0] == DATA_AXIS:
        return _slice(x, 0, mesh.coords[0], mesh.dp, "batch rows")
    return x
