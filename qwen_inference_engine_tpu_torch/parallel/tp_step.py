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

``tp_layout(cfg, params, tp)`` gives every model its ``TpLayout``: a pure
function of the model and tp, the same on every rank and device.  Where
``supports_tp`` holds it is the even split above, with the JAX
``shard_map`` step's semantics (unless ``o`` or ``down`` is
quantizer-padded: an even split would pair its rows with other ranks'
columns, ``_padding_refusal``).  Where it does not (the JAX package then
runs GSPMD's partitioned XLA ops), each block is laid out on its own so
that every kernel still sees whole heads and whole groups, and every step
keeps GSPMD's semantics (whole-row activation scales, no ``fused_mlp``):

* attention: the heads split where tp divides both head counts; the query
  heads split and each KV head replicated over ``tp / Hk`` ranks where tp
  divides the query heads and the KV heads divide tp; else the block runs
  whole on every rank.  ``o`` stays row-parallel where its rows split on
  whole groups, else the attention output is all-gathered and ``o`` runs
  whole;
* MLP: F split at multiples of the alignment unit (the matmul kernels' N
  multiple for gate / up, INT4 plane pairs or INT8 groups for down), as
  evenly as the unit allows, the first ranks taking the extra unit and the
  last one down's quantizer padding; whole where there are fewer units than
  ranks.  The expert stacks split where tp divides the experts, else whole;
* vocabulary: split where tp divides it, else whole.

A block that runs whole takes no collective after it; a row-parallel
bias is added once, after the all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.models.qwen import (
    compute_logits,
    decode_step,
    forward_hidden,
    prefill_chunked,
    prefill_sequence_parallel,
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


Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class TpLayout:
    """How one model splits over a model axis of ``tp`` ranks, block by
    block (``tp_layout``).  ``gspmd``: the block layout (``supports_tp``
    false, or a quantizer-padded row-parallel K), whose steps keep the
    JAX package's GSPMD semantics; ``why`` names the condition.
    ``attn``: "heads", "kv_replicated" or "whole"; ``o``: "split"
    (row-parallel, summed), "gather" (the attention output all-gathered,
    ``o`` whole) or "whole"; ``mlp``: "split", "experts" or "whole", with
    each rank's gate / up columns ``mlp_cols`` and down rows ``mlp_rows``
    (logical, down's padding in the last rank's rows) in units of
    ``mlp_unit``; ``vocab``: "split" or "whole"."""

    tp: int
    gspmd: bool
    attn: str
    o: str
    mlp: str
    vocab: str
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mlp_unit: int = 0
    mlp_cols: Ranges = ()
    mlp_rows: Ranges = ()
    why: Optional[str] = None

    @property
    def local_heads(self) -> Tuple[int, int]:
        """(query heads, KV heads) on each rank."""
        hq, hk, tp = self.num_heads, self.num_kv_heads, self.tp
        return {"heads": (hq // tp, hk // tp), "kv_replicated": (hq // tp, 1),
                "whole": (hq, hk)}[self.attn]

    def local_config(self, cfg: ModelConfig) -> ModelConfig:
        """The forward's config on every rank: its heads (``intermediate_
        size`` only sizes initialization)."""
        hq, hk = self.local_heads
        f = cfg.intermediate_size // self.tp if self.mlp != "whole" \
            else cfg.intermediate_size
        return cfg.replace(num_heads=hq, num_kv_heads=hk, intermediate_size=f)

    def kv_heads(self, m: int) -> Tuple[int, int]:
        """(first KV head, count) of model rank ``m``."""
        hk = self.local_heads[1]
        if self.attn == "kv_replicated":
            return m // (self.tp // self.num_kv_heads), 1
        return (0, hk) if self.attn == "whole" else (m * hk, hk)

    def q_cols(self, m: int) -> Ranges:
        hq, d = self.local_heads[0], self.head_dim
        lo = 0 if self.attn == "whole" else m * hq * d
        return ((lo, lo + hq * d),)

    def kv_cols(self, m: int) -> Ranges:
        h0, n = self.kv_heads(m)
        return ((h0 * self.head_dim, (h0 + n) * self.head_dim),)

    def qkv_cols(self, m: int) -> Ranges:
        """Rank ``m``'s columns of the fused ``qkv``: its q heads' | its
        KV heads' k | v."""
        qd = self.num_heads * self.head_dim
        kd = self.num_kv_heads * self.head_dim
        (k0, k1), = self.kv_cols(m)
        return self.q_cols(m) + ((qd + k0, qd + k1),
                                 (qd + kd + k0, qd + kd + k1))

    def o_rows(self, m: int, k: int) -> Ranges:
        """Rank ``m``'s rows of ``o`` (``k`` rows, padding included)."""
        if self.o != "split":
            return ((0, k),)
        (lo, hi), = self.q_cols(m)
        return ((lo, k if m == self.tp - 1 else hi),)

    @property
    def reduce_o(self) -> bool:
        return self.o == "split"

    @property
    def reduce_mlp(self) -> bool:
        return self.mlp != "whole"

    def collectives(self, num_layers: int, act_bits: int = 0) -> dict:
        """A forward's collectives over the model group on every rank:
        ``all_reduce`` (the row-parallel sums, the vocab-split embedding's
        and, under GSPMD semantics with int8 activations, the whole-row
        maxima of a split ``o`` and ``down``) and ``all_gather`` (``o``'s
        input where it is gathered)."""
        sums = self.reduce_o + self.reduce_mlp
        maxima = 0
        if self.gspmd and act_bits == 8:
            maxima = self.reduce_o + (self.mlp == "split")
        return {"all_reduce": num_layers * (sums + maxima)
                + (self.vocab == "split"),
                "all_gather": num_layers * (self.o == "gather")}

    def summary(self) -> str:
        """One line: the layout of every block."""
        hq, hk = self.local_heads
        head = (f"tp {self.tp}, "
                + (f"GSPMD layout ({self.why})" if self.gspmd
                   else "shard_map layout"))
        over = self.tp // max(self.num_kv_heads, 1)
        attn = {"heads": "heads split",
                "kv_replicated": f"KV heads replicated over {over} ranks",
                "whole": "whole"}[self.attn]
        attn = (f"attention {attn}: {self.num_heads} / {self.num_kv_heads} "
                f"heads -> {hq} / {hk} a rank, o "
                + {"split": "row-parallel", "gather": "whole after an "
                   "all-gather", "whole": "whole"}[self.o])
        if self.mlp == "split":
            cols = "/".join(str(b - a) for a, b in self.mlp_cols)
            rows = "/".join(str(b - a) for a, b in self.mlp_rows)
            how = (f"in units of {self.mlp_unit}" if self.mlp_unit
                   else "evenly")
            mlp = f"MLP split {how}: gate/up N {cols}, down K {rows}"
        else:
            mlp = ("MLP experts split" if self.mlp == "experts"
                   else "MLP whole")
        return f"{head} | {attn} | {mlp} | vocabulary {self.vocab}"


def _mlp_parts(layers: dict):
    """(gate-like, F, down) of a dense layer's MLP."""
    if "gateup" in layers:
        return layers["gateup"], _out(layers["gateup"]) // 2, layers["down"]
    return layers["gate"], _out(layers["gate"]), layers["down"]


def _in(lin) -> int:
    return lin.w.shape[-2] if isinstance(lin, Linear) else lin.in_features


def _group_unit(lin) -> int:
    """Row multiple that keeps a row split on whole groups (INT4: plane
    pairs)."""
    if not isinstance(lin, QuantLinear):
        return 1
    return lin.group_size * (2 if lin.bits == 4 else 1)


def _mlp_split(cfg: ModelConfig, layers: dict, tp: int):
    """(unit, cols, rows) of the MLP's split, or None where it runs
    whole: F in units of lcm(gate / up's kernel N multiple, down's group
    unit), spread as evenly as possible, the first ranks taking the extra
    unit, down's padding in the last rank's rows."""
    gate, F, down = _mlp_parts(layers)
    n_mult = 1 if isinstance(gate, Linear) else (
        128 if cfg.act_bits == 8 else 64)
    unit = math.lcm(n_mult, _group_unit(down))
    n = -(-F // unit)
    if n < tp:
        return None
    counts = [n // tp + (m < n % tp) for m in range(tp)]
    bounds = [sum(counts[:m]) * unit for m in range(tp + 1)]
    cols = tuple((min(bounds[m], F), min(bounds[m + 1], F))
                 for m in range(tp))
    rows = tuple((bounds[m], _in(down) if m == tp - 1 else bounds[m + 1])
                 for m in range(tp))
    return unit, cols, rows


def _padding_refusal(cfg: ModelConfig, layers: dict) -> Optional[str]:
    """Why an even split of a quantizer-padded row-parallel K would pair
    rows with the wrong columns, or None.  Rank r's even slice of ``down``
    (or ``o``) starts at ``r * K_pad / tp``, its gate / up (or heads')
    columns at ``r * F / tp``: they part where K_pad != F.  The JAX
    ``supports_tp`` does not ask, and its ``shard_map`` step computes other
    logits than its unsharded run there (0.5B and 3B at INT4 groups of
    256, tp 2)."""
    rows = [("o", layers["o"], cfg.num_heads * cfg.head_dim)]
    if not cfg.is_moe:
        _, f, down = _mlp_parts(layers)
        rows.append(("down", down, f))
    for name, lin, k in rows:
        if isinstance(lin, QuantLinear) and lin.in_features != k:
            return (f"{name}'s K={k} is quantizer-padded to "
                    f"{lin.in_features}: an even split would pair its rows "
                    f"with other ranks' columns")
    return None


def tp_layout(cfg: ModelConfig, params: dict, tp: int) -> TpLayout:
    """The model's layout over a model axis of ``tp`` (module docstring):
    the shard_map step's even split where ``supports_tp`` holds, else one
    chosen block by block.  A quantizer-padded ``o`` or ``down`` takes the
    block layout too (``_padding_refusal``), which keeps the padding in
    the last rank's rows."""
    layers = params["layers"]
    why = tp_refusal(cfg, params, tp) or _padding_refusal(cfg, layers)
    hq, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    base = dict(tp=tp, num_heads=hq, num_kv_heads=hk, head_dim=d)
    if why is None:
        kw = {}
        if not cfg.is_moe:
            _, F, down = _mlp_parts(layers)
            K = _in(down)
            kw = dict(mlp_cols=tuple((m * F // tp, (m + 1) * F // tp)
                                     for m in range(tp)),
                      mlp_rows=tuple((m * K // tp, (m + 1) * K // tp)
                                     for m in range(tp)))
        return TpLayout(gspmd=False, attn="heads", o="split",
                        mlp="experts" if cfg.is_moe else "split",
                        vocab="split", **base, **kw)
    if hq % tp == 0 and hk % tp == 0:
        attn = "heads"
    elif hq % tp == 0 and tp % hk == 0:
        attn = "kv_replicated"
    else:
        attn = "whole"
    o = "whole"
    if attn != "whole":
        o = ("split" if (hq // tp * d) % _group_unit(layers["o"]) == 0
             else "gather")
    kw = {}
    if cfg.is_moe:
        mlp = "experts" if cfg.num_experts % tp == 0 else "whole"
    else:
        split = _mlp_split(cfg, layers, tp)
        mlp = "whole" if split is None else "split"
        if split is not None:
            kw = dict(mlp_unit=split[0], mlp_cols=split[1],
                      mlp_rows=split[2])
    head = params.get("lm_head")
    vocab = "split" if params["embed"].shape[0] % tp == 0 and (
        head is None or _out(head) % tp == 0) else "whole"
    return TpLayout(gspmd=True, attn=attn, o=o, mlp=mlp, vocab=vocab,
                    why=why, **base, **kw)


def model_group(mesh: Optional[Mesh], whole_row_scales: bool = False,
                layout: Optional[TpLayout] = None) -> Optional[Group]:
    """The TP step's ``reduce_group`` (None without a mesh).
    whole_row_scales: the step keeps the JAX package's GSPMD semantics,
    where a row-parallel projection's int8 activations take each token's
    scale over the whole row (the JAX scheduler under a data axis above 1,
    ``Engine.generate_speculative`` under any mesh, and every step of a
    GSPMD layout); without it, over this rank's K, as the JAX
    ``shard_map`` step does.  layout: the model's ``TpLayout``, which
    ``forward_hidden`` reads for the blocks that run whole (None: the even
    split)."""
    if mesh is None:
        return None
    whole = whole_row_scales or (layout is not None and layout.gspmd)
    if mesh.tp > 1 and (whole or layout is not None):
        return dataclasses.replace(mesh.model_group,
                                   whole_row_scales=whole, layout=layout)
    return mesh.model_group


def greedy_tokens(logits: torch.Tensor, group: Optional[Group],
                  vocab_size: int) -> torch.Tensor:
    """The argmax of logits that are the whole vocabulary or, under a
    vocab-split layout, this rank's shard of it (``sharded_argmax``)."""
    if group is None or logits.shape[-1] == vocab_size:
        return torch.argmax(logits, dim=-1)
    return sharded_argmax(logits, group)


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


def sampling_vocab(mesh: Optional[Mesh], cfg: ModelConfig,
                   layout: Optional[TpLayout] = None):
    """The ``vocab`` argument of the samplers under ``mesh``'s TP step
    (None without model parallelism, or where the layout keeps the
    vocabulary whole)."""
    if mesh is None or mesh.tp == 1 or (layout is not None
                                        and layout.vocab == "whole"):
        return None
    return ShardedVocab(mesh.model_group, cfg.vocab_size // mesh.tp)


def _local(cfg: ModelConfig, mesh: Optional[Mesh],
           layout: Optional[TpLayout] = None) -> ModelConfig:
    if mesh is None:
        return cfg
    return local_config(cfg, mesh.tp) if layout is None \
        else layout.local_config(cfg)


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
                      whole_row_scales: bool = False,
                      layout: Optional[TpLayout] = None):
    """``fn(params_l, tok, pos, cache_l[, tables]) -> (logits_l, cache_l)``:
    one decode step of the rows given on this rank's shards; the logits
    are this rank's vocabulary columns (all of them where the layout keeps
    the vocabulary whole).  paged: the cache is the page pool and the fn
    takes the block tables.  whole_row_scales and layout (every maker
    here): ``model_group``'s; the params are ``shard_params`` of the same
    layout."""
    cfg_l = _local(cfg, mesh, layout)
    group = model_group(mesh, whole_row_scales, layout)

    def fn(params_l, tok, pos, cache_l, tables=None):
        return decode_step(params_l, cfg_l, tok, pos, cache_l, tables,
                           uniform_decode=uniform_decode,
                           reduce_group=group)

    return fn


def make_tp_verify_fn(cfg: ModelConfig, mesh: Optional[Mesh], *, T: int,
                      whole_row_scales: bool = False,
                      layout: Optional[TpLayout] = None):
    """``fn(params_l, tokens [B, T], pos0 [B], cache_l, tables) -> (logits_l
    [B, T, V/tp], cache_l)``: the speculative verify of the rows given (T
    consecutive tokens a row from its start) over the page pool, or over
    the contiguous cache with ``tables`` None; acceptance runs on the
    sharded logits outside."""
    cfg_l = _local(cfg, mesh, layout)
    group = model_group(mesh, whole_row_scales, layout)

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
                          whole_row_scales: bool = False,
                          layout: Optional[TpLayout] = None,
                          dlayout: Optional[TpLayout] = None):
    """One draft-model round on this rank's shards: the drafter's k+1
    greedy decode steps (the sharded argmax on its vocab-sharded logits)
    feed the target's T = k+1 verify.  ``fn(params_l, dparams_l, tok_last,
    pos0, cache_l, dcache_l, tables) -> (logits_l [B, k+1, V/tp], drafts
    [B, k])``.  Drafter protocol: step 0 feeds the last token, steps 1..k-1
    feed draft i, step k feeds draft k (its output unused), so the drafter
    writes the KV of every position the verify writes.  The drafter runs
    in its own ``dlayout``."""
    dcfg_l = _local(dcfg, mesh, dlayout)
    group = model_group(mesh, whole_row_scales, dlayout)
    verify = make_tp_verify_fn(cfg, mesh, T=k + 1,
                               whole_row_scales=whole_row_scales,
                               layout=layout)

    def fn(params_l, dparams_l, tok_last, pos0, cache_l, dcache_l, tables):
        cur, drafts = tok_last, []
        for i in range(k + 1):
            logits, _ = decode_step(dparams_l, dcfg_l, cur, pos0 + i,
                                    dcache_l, tables, reduce_group=group)
            if i < k:
                cur = greedy_tokens(logits, group, dcfg.vocab_size)
                drafts.append(cur)
        drafts = torch.stack(drafts, dim=1)                  # [B, k]
        tokens = torch.cat([tok_last[:, None], drafts], dim=1)
        logits, _ = verify(params_l, tokens, pos0, cache_l, tables)
        return logits, drafts

    return fn


def make_tp_prefill_fn(cfg: ModelConfig, mesh: Optional[Mesh], *,
                       chunk: int = 512, layout: Optional[TpLayout] = None):
    """``fn(params_l, tokens, lengths, cache_l) -> (logits_l, cache_l)``:
    the chunked prefill on this rank's shards."""
    cfg_l = _local(cfg, mesh, layout)
    group = model_group(mesh, layout=layout)

    def fn(params_l, tokens, lengths, cache_l):
        return prefill_chunked(params_l, cfg_l, tokens, lengths, cache_l,
                               chunk=chunk, reduce_group=group)

    return fn


def make_tp_prefill_piece_fn(cfg: ModelConfig, mesh: Optional[Mesh], *,
                             last: bool, whole_row_scales: bool = False,
                             layout: Optional[TpLayout] = None):
    """One prefill piece of one sequence over the page pool (a scheduler
    tick) on this rank's shards: ``fn(params_l, tokens [1, T], start,
    nvalid, cache_l, tables [1, W]) -> logits_l [1, V/tp]`` of the piece's
    last valid token when ``last``, else None.  ``start`` is a host int (0:
    the fresh-prefill branch).  Under a data axis only the slot's own data
    group runs it."""
    cfg_l = _local(cfg, mesh, layout)
    group = model_group(mesh, whole_row_scales, layout)

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


def make_tp_sp_prefill_fn(cfg: ModelConfig, mesh: Mesh, *,
                          layout: Optional[TpLayout] = None):
    """The sequence-sharded prefill (the JAX package's prompt with its
    token axis on ``model``, GSPMD semantics): ``fn(params_l, tokens_l [B,
    T / tp], lengths [B], cache_l) -> (logits_l [B, V / tp], cache_l)``,
    where ``tokens_l`` is this rank's ``batch_shard(tokens, mesh, (None,
    "model"))`` and ``lengths`` the whole rows' (``models/qwen.
    prefill_sequence_parallel``)."""
    cfg_l = _local(cfg, mesh, layout)
    group = model_group(mesh, whole_row_scales=True, layout=layout)

    def fn(params_l, tokens_l, lengths, cache_l):
        return prefill_sequence_parallel(params_l, cfg_l, tokens_l, lengths,
                                         cache_l, group)

    return fn
