"""Qwen2 / Qwen2.5 / Qwen3 and Qwen3-MoE transformer forward over the KV
cache.

The port of the JAX package's ``models/qwen.py`` for the main path: the
layer ``lax.scan`` becomes a Python loop over layers that updates the
stacked ``[L, ...]`` cache in place, and the weights stay stacked
``[L, ...]`` (the quantized matmuls take the layer index, no slab copy).

Per-layer schedule: rmsnorm -> q/k/v proj -> qk-norm (Qwen3) -> RoPE ->
KV write + attention -> o proj -> residual -> rmsnorm -> gate/up proj ->
SiLU * up -> down proj -> residual; then final norm -> lm_head.  A
Qwen3-MoE layer replaces gate/up/down by ``moe_mlp``: top-k routing over
the layer's experts and three grouped matmuls (``ops/grouped_matmul.py``)
over the (token, expert) pairs sorted by expert.

Attention branches (each a kernel of the port):

* fresh prefill (positions 0..T-1): the fresh K/V are written to the cache
  (quantized for an int8 cache) and ``flash_attention`` attends over the
  unquantized fresh K/V;
* prefill continuation (T > 1 at positions ``start..start+T-1`` over a
  cache that holds the earlier chunks): a uniform window write, then
  ``chunk_attention_contiguous`` (bf16 KV) or ``_q8`` (INT8 KV);
* uniform decode (all rows at one position): ``decode_attention_appending``
  writes the fresh row and attends in one kernel (bf16 KV); INT8 KV runs
  ``quantize_kv``, ``kv_append_uniform_q8``, then
  ``decode_attention_contiguous_q8``;
* ragged decode: ``kv_append_ragged_t`` writes each row's K/V at its own
  position (``quantize_kv``'s bytes and scales for INT8 KV, in the same
  launch), then ``decode_attention_contiguous[_q8]`` with per-row lengths;
* the speculative verify (``ragged_multi``: T > 1 consecutive positions
  from a per-row start): ``kv_append_ragged_t`` writes each row's window,
  then ``chunk_attention_contiguous[_q8]``, both with the per-row starts
  on the device;
* the deferred-append decode (``deferred_append``, an ablation no entry
  point dispatches: the branch the JAX forward dropped after measuring it
  slower on its chip): an aligned batch over a bf16 cache attends with
  ``decode_attention_contiguous_fresh`` (the cache's old tokens, and the
  current token from the layer's own K/V), keeps every layer's fresh K/V,
  and writes all of them after the layer loop with one
  ``kv_append_all_uniform`` launch.

Over the paged cache (``PagedKVCache`` with ``block_tables [B, max_pages]``,
the serving scheduler's path; bf16, int8 or f32 pages; an int8 pool's
appends take ``quantize_kv``'s bytes and scales):

* a fresh piece (positions ``0..T-1``): ``paged_append_prefill`` writes
  the piece through its table, ``flash_attention`` attends over the fresh
  (unquantized) K/V;
* a continuation piece (``start..start+T-1``, ``start`` a host int):
  ``paged_append_prefill``, then ``paged_chunk_attention[_q8]`` over the
  paged prefix;
* decode (T == 1, per-row positions on the device): ``paged_append_ragged``
  then ``paged_decode_attention_stacked[_q8]`` with lengths
  ``position + 1``;
* the speculative verify (``ragged_multi``, T >= 2 tokens per row at
  per-row starts on the device): ``paged_append_ragged_t``, then
  ``paged_verify_attention_stacked[_q8]`` with lengths ``start + T``.

A prefill piece is one sequence (the scheduler's pieces are; the JAX
package's batched piece goes through XLA and no caller of the port needs
it).

The MLP of a dense layer is ``fused_mlp`` (one kernel: gate, up, SiLU and
down, the [M, F] intermediates kept in f32 / bf16 workspaces) wherever the
JAX package's TPU dispatch takes it: pad-free INT4 weights, no int8
activations, M = B * T <= 256 (``fused_mlp_supported``); else the three
matmuls.  Offline-fused parameters (``quant/quantize.fuse_projections``)
run ``qkv`` as one matmul split at ``Hq * Dh`` and ``Hq * Dh + Hk * Dh``,
and ``gateup`` as one matmul split in halves, then ``down``: 4 matmuls a
layer where the split parameters run 7.  They never take ``fused_mlp`` or
the pumped decode (both ask for ``gate``), as in the JAX package.
``decode_step_pumped`` is the JAX package's double-pumped decode
for aligned batches of more than 128 rows (``pumped_supported``): the
batch runs as two halves staggered by half a layer, each layer's
attention of one half in the same launch as the other half's MLP
(``fused_attn_mlp``), the halves' fresh K/V written by
``kv_append_uniform``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.kvcache.cache import (
    KVCache,
    PagedKVCache,
    write_prefill_stacked,
    write_window_stacked,
)
from qwen_inference_engine_tpu_torch.ops.chunk_attention import (
    chunk_attention_contiguous,
    chunk_attention_contiguous_q8,
    paged_chunk_attention,
    paged_chunk_attention_q8,
)
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    decode_attention_appending,
    decode_attention_contiguous,
    decode_attention_contiguous_fresh,
    decode_attention_contiguous_q8,
)
from qwen_inference_engine_tpu_torch.ops.flash_attention import flash_attention
from qwen_inference_engine_tpu_torch.ops.fused_step import (
    fused_attn_mlp,
    fused_mlp,
    fused_mlp_supported,
)
from qwen_inference_engine_tpu_torch.ops.grouped_matmul import (
    grouped_matmul_dense,
    grouped_quant_matmul,
    grouped_quant_matmul_supported,
)
from qwen_inference_engine_tpu_torch.ops.kv_append import (
    kv_append_all_uniform,
    kv_append_ragged_t,
    kv_append_uniform,
    kv_append_uniform_q8,
    paged_append_prefill,
    paged_append_ragged,
    paged_append_ragged_t,
)
from qwen_inference_engine_tpu_torch.ops.linear import (
    Linear,
    QuantLinear,
    apply_linear,
)
from qwen_inference_engine_tpu_torch.ops.norms import qk_norm, rms_norm
from qwen_inference_engine_tpu_torch.ops.paged_attention import (
    paged_decode_attention_stacked,
    paged_decode_attention_stacked_q8,
    paged_verify_attention_stacked,
    paged_verify_attention_stacked_q8,
)
from qwen_inference_engine_tpu_torch.ops.rope import apply_rope, precompute_rope
from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Random layer-stacked params (tests and smoke runs), drawn from
    ``generator`` one ``[K, N]`` slab (a layer's, or a layer's expert's) at
    a time so no f32 copy of a whole stacked tensor is ever live.  The
    generator must live on ``device``."""
    L, D, Fi, V = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Qd, Kd = cfg.q_dim, cfg.kv_dim

    def normal(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=device)
        slabs = out.view(-1, *shape[-2:]) if len(shape) >= 3 else out[None]
        for s in slabs:
            s.copy_(torch.randn(s.shape, generator=generator, device=device,
                                dtype=torch.float32) * scale)
        return out

    def dense(shape):
        return normal(shape, shape[-2] ** -0.5)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    bias = cfg.attention_bias
    layers = {
        "input_norm": ones((L, D)),
        "q": Linear(dense((L, D, Qd)), zeros((L, Qd)) if bias else None),
        "k": Linear(dense((L, D, Kd)), zeros((L, Kd)) if bias else None),
        "v": Linear(dense((L, D, Kd)), zeros((L, Kd)) if bias else None),
        "o": Linear(dense((L, Qd, D))),
        "post_norm": ones((L, D)),
    }
    if cfg.is_moe:
        E, Fm = cfg.num_experts, cfg.moe_intermediate_size
        layers["router"] = Linear(dense((L, D, E)))
        layers["moe_gate"] = normal((L, E, D, Fm), D ** -0.5)
        layers["moe_up"] = normal((L, E, D, Fm), D ** -0.5)
        layers["moe_down"] = normal((L, E, Fm, D), Fm ** -0.5)
    else:
        layers["gate"] = Linear(dense((L, D, Fi)))
        layers["up"] = Linear(dense((L, D, Fi)))
        layers["down"] = Linear(dense((L, Fi, D)))
    if cfg.qk_norm:
        layers["q_norm"] = ones((L, cfg.head_dim))
        layers["k_norm"] = ones((L, cfg.head_dim))
    cos, sin = precompute_rope(cfg.max_position_embeddings, cfg.head_dim,
                               cfg.rope_theta, device=device)
    params = {
        "embed": normal((V, D), 0.02),
        "layers": layers,
        "final_norm": ones((D,)),
        "rope_cos": cos,
        "rope_sin": sin,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = Linear(dense((D, V)))
    return params


def init_quantized_params(cfg: ModelConfig, generator: torch.Generator,
                          bits: int = 4, group_size: int = 128,
                          dtype=torch.bfloat16, quantize_lm_head: bool = False,
                          pad_free: bool = False, device=None) -> dict:
    """Random params with the projections drawn directly in packed INT4 /
    INT8 form, so a 7B model never exists in bf16 (what the JAX bench
    runs).  Shapes, group sizes and K padding are the JAX function's;
    the values come from ``generator`` (on ``device``), not ``jax.random``.

    pad_free: shrink INT4 group sizes instead of padding reduction axes.
    A Qwen3-MoE model's expert stacks ``[L, E, K/pack, N]`` are drawn one
    layer's ``[E, K/pack, N]`` slab at a time on ``device`` (the INT4
    stacks of Qwen3-30B-A3B are 14.5 GB; they never pass through the host
    or bf16), its router stays a bf16 ``Linear``."""
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        pad_free_group_size,
    )

    L, D, Fi, V = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Qd, Kd = cfg.q_dim, cfg.kv_dim
    qmax = 7 if bits == 4 else 127
    pack = 2 if bits == 4 else 1
    # INT4: random packed bytes (the full int8 range decodes to the full
    # nibble range); INT8: values in [-127, 127]
    lohi = (-128, 128) if bits == 4 else (-qmax, qmax + 1)

    def randint(shape):
        return torch.randint(*lohi, shape, generator=generator, device=device,
                             dtype=torch.int8)

    def qlin(kin: int, out: int, bias: bool) -> QuantLinear:
        gs = group_size
        if bits == 4 and pad_free:
            gs = pad_free_group_size(kin, gs)
        if bits == 4:
            # mirror quantize_linear: shrink gs for tiny dims, pad huge ones
            while gs > 2 and (kin % gs or (kin // gs) % 2):
                gs //= 2
            kt = -(-kin // (2 * gs))
            if kt > 20 and kt % 2 == 1:
                kt += 1
            kin = kt * 2 * gs
        else:
            while gs > 2 and kin % gs:
                gs //= 2
        scales = torch.full((L, kin // gs, out), (kin ** -0.5) / qmax,
                            dtype=torch.float32, device=device)
        b = torch.zeros((L, out), dtype=dtype, device=device) if bias else None
        return QuantLinear(q=randint((L, kin // pack, out)), scales=scales,
                           b=b, bits=bits, group_size=gs)

    def qexperts(kin: int, out: int) -> QuantLinear:
        """A random packed expert stack [L, E, kin/pack, out] (cf. qlin)."""
        E = cfg.num_experts
        gs = group_size
        while gs > 2 and (kin % gs or (bits == 4 and (kin // gs) % 2)):
            gs //= 2
        q = torch.empty((L, E, kin // pack, out), dtype=torch.int8,
                        device=device)
        for slab in q:
            slab.copy_(randint(slab.shape))
        scales = torch.full((L, E, kin // gs, out), (kin ** -0.5) / qmax,
                            dtype=torch.float32, device=device)
        return QuantLinear(q=q, scales=scales, b=None, bits=bits,
                           group_size=gs)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    bias = cfg.attention_bias
    layers = {
        "input_norm": torch.ones((L, D), dtype=dtype, device=device),
        "q": qlin(D, Qd, bias),
        "k": qlin(D, Kd, bias),
        "v": qlin(D, Kd, bias),
        "o": qlin(Qd, D, False),
        "post_norm": torch.ones((L, D), dtype=dtype, device=device),
    }
    if cfg.is_moe:
        E, Fm = cfg.num_experts, cfg.moe_intermediate_size
        layers["router"] = Linear(normal((L, D, E), D ** -0.5))
        layers["moe_gate"] = qexperts(D, Fm)
        layers["moe_up"] = qexperts(D, Fm)
        layers["moe_down"] = qexperts(Fm, D)
    else:
        layers["gate"] = qlin(D, Fi, False)
        layers["up"] = qlin(D, Fi, False)
        layers["down"] = qlin(Fi, D, False)
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, cfg.head_dim), dtype=dtype,
                                      device=device)
        layers["k_norm"] = torch.ones((L, cfg.head_dim), dtype=dtype,
                                      device=device)
    cos, sin = precompute_rope(cfg.max_position_embeddings, cfg.head_dim,
                               cfg.rope_theta, device=device)
    params = {
        "embed": normal((V, D), 0.02),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
        "rope_cos": cos,
        "rope_sin": sin,
    }
    if not cfg.tie_word_embeddings:
        if quantize_lm_head:
            gs = group_size
            while gs > 2 and (D % gs or (D // gs) % 2):
                gs //= 2
            params["lm_head"] = QuantLinear(
                q=randint((D // pack, V)),
                scales=torch.full((D // gs, V), (D ** -0.5) / qmax,
                                  dtype=torch.float32, device=device),
                b=None, bits=bits, group_size=gs)
        else:
            params["lm_head"] = Linear(normal((D, V), D ** -0.5))
    return params


def map_params(params, fn):
    """The same params with ``fn`` applied to every tensor (dicts and the
    tensor fields of Linear / QuantLinear are walked)."""
    if isinstance(params, torch.Tensor):
        return fn(params)
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    if isinstance(params, (Linear, QuantLinear)):
        return dataclasses.replace(params, **{
            f.name: fn(getattr(params, f.name)) for f in dataclasses.fields(params)
            if isinstance(getattr(params, f.name), torch.Tensor)})
    return params


def params_to(params: dict, device) -> dict:
    """The same params with every tensor on ``device``."""
    return map_params(params, lambda t: t.to(device))


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------

def _expert_matmul(xs: torch.Tensor, w, group_sizes: torch.Tensor,
                   layer: int, act_bits: int = 0) -> torch.Tensor:
    """Grouped matmul over expert-sorted rows.  A quantized stack goes to
    ``grouped_quant_matmul``, with int8 activations (W4A8) only where the
    JAX package's shape gate holds, as there; a bf16 stack ``[L, E, K, N]``
    runs one torch matmul per expert (the JAX package's ``ragged_dot``)."""
    if isinstance(w, QuantLinear):
        a8 = (act_bits == 8 and w.bits == 4
              and grouped_quant_matmul_supported(w, xs.shape[0]))
        return grouped_quant_matmul(xs, w, group_sizes, layer,
                                    act_bits=8 if a8 else 0)
    return grouped_matmul_dense(xs, w[layer], group_sizes)


def moe_mlp(h: torch.Tensor, router: torch.Tensor, w_gate, w_up, w_down,
            top_k: int, norm_topk: bool, layer: int = 0,
            act_bits: int = 0) -> torch.Tensor:
    """Qwen3-MoE sparse MLP of one layer: h [N, D] -> [N, D].

    router [D, E]; w_gate / w_up ``[L, E, D, Fm]`` and w_down
    ``[L, E, Fm, D]`` (bf16 stacks or quantized, see ``_expert_matmul``).
    Top-k of the softmax of the f32 router logits (renormalized when
    ``norm_topk``); the N * k (token, expert) pairs are stably sorted by
    expert so each expert's rows are contiguous, the three grouped matmuls
    run over them, and each token sums its k weighted rows.  Exact routing,
    no capacity limit, as the JAX function.  Nothing here waits for the
    device: the expert sizes are counted with ``scatter_add_`` (CUDA's
    ``bincount`` reads its input's max on the host) and stay on the device,
    where the kernels read them; the combine un-sorts the rows with
    ``index_copy_`` and sums each token's k rows in f32 (no atomics).
    """
    N, D = h.shape
    E = router.shape[-1]
    logits = h.float() @ router.to(h.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)        # [N, k]
    if norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    flat_e = topi.reshape(-1)                            # [N*k]
    order = torch.argsort(flat_e, stable=True)
    group_sizes = torch.zeros(E, dtype=torch.int32, device=h.device)
    group_sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e,
                                                         dtype=torch.int32))
    xs = h.index_select(0, order // top_k)               # [N*k, D]
    g = _expert_matmul(xs, w_gate, group_sizes, layer, act_bits)
    u = _expert_matmul(xs, w_up, group_sizes, layer, act_bits)
    mid = F.silu(g.float()) * u.float()
    y = _expert_matmul(mid.to(xs.dtype), w_down, group_sizes, layer,
                       act_bits)                         # [N*k, D]
    contrib = y * topw.reshape(-1)[order].to(y.dtype)[:, None]
    rows = torch.empty_like(contrib).index_copy_(0, order, contrib)
    return rows.view(N, top_k, -1).float().sum(dim=1).to(y.dtype)


def _paged_attention(cache: PagedKVCache, layer: int, q, k, v,
                     block_tables, *, fresh_prefill: bool, ragged_multi: bool,
                     start: int, row_pos, lengths):
    """Write this layer's fresh K/V into the page pool (an int8 pool takes
    ``quantize_kv``'s bytes and scales) and attend (the paged branches of
    the module docstring)."""
    T = q.shape[1]
    ps = cache.page_size
    pools = (cache.k_pages, cache.v_pages)
    kw, scales = {}, ()
    kn, vn = k, v
    if cache.quantized:
        kn, ks = quantize_kv(k)
        vn, vs = quantize_kv(v)
        scales = (cache.k_scale, cache.v_scale)
        kw = dict(k_scale=cache.k_scale, v_scale=cache.v_scale, ks_new=ks,
                  vs_new=vs)
    if T == 1 and not fresh_prefill:
        paged_append_ragged(*pools, kn, vn, row_pos, block_tables, layer,
                            page_size=ps, **kw)
        attend = (paged_decode_attention_stacked_q8 if cache.quantized
                  else paged_decode_attention_stacked)
        return attend(q, *pools, *scales, block_tables, lengths, ps, layer)
    if ragged_multi:
        paged_append_ragged_t(*pools, kn, vn, row_pos, block_tables, layer,
                              page_size=ps, **kw)
        attend = (paged_verify_attention_stacked_q8 if cache.quantized
                  else paged_verify_attention_stacked)
        return attend(q, *pools, *scales, block_tables, lengths, ps, layer)
    paged_append_prefill(*pools, kn, vn, start, block_tables, layer,
                         page_size=ps, **kw)
    if fresh_prefill:
        return flash_attention(q, k, v)
    attend = (paged_chunk_attention_q8 if cache.quantized
              else paged_chunk_attention)
    return attend(q, *pools, *scales, block_tables, layer, start, ps)


def _append_rows(cache: KVCache, layer: int, k, v, starts) -> None:
    """``kv_append_ragged_t`` of this layer's ``k / v [B, T, Hk, D]`` at the
    per-row starts on the device; an int8 cache takes ``quantize_kv``'s
    bytes and scales in the same launch."""
    if not cache.quantized:
        kv_append_ragged_t(cache.k, cache.v, k, v, starts, layer)
        return
    qk, sk = quantize_kv(k)
    qv, sv = quantize_kv(v)
    kv_append_ragged_t(cache.k, cache.v, qk, qv, starts, layer,
                       k_scale=cache.k_scale, v_scale=cache.v_scale,
                       ks_new=sk, vs_new=sv)


def _check_deferred(cache, T: int, fresh_prefill: bool,
                    uniform_decode: bool) -> None:
    """The deferred-append decode's requirements, each named when it is
    not met."""
    if isinstance(cache, PagedKVCache) or cache.quantized:
        raise ValueError("deferred_append needs a contiguous unquantized "
                         "cache (the fresh-merge kernel has no int8 or paged "
                         "form)")
    cpu = cache.k.device.type == "cpu"
    if not (cache.k.dtype == torch.bfloat16
            or (cpu and cache.k.dtype == torch.float32)):
        raise ValueError(f"deferred_append needs a bf16 cache (f32 on the "
                         f"CPU), not {cache.k.dtype} on {cache.k.device}")
    if fresh_prefill or T != 1:
        raise ValueError(f"deferred_append is a decode step: T == 1, not "
                         f"{T}{' (a fresh prefill)' if fresh_prefill else ''}")
    if not uniform_decode:
        raise ValueError("deferred_append needs an aligned batch "
                         "(uniform_decode=True): every row at one position")


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, cache, *,
                   block_tables: Optional[torch.Tensor] = None,
                   fresh_prefill: bool = False,
                   uniform_decode: bool = False,
                   ragged_multi: bool = False,
                   start: Optional[int] = None,
                   deferred_append: bool = False):
    """Run the transformer stack; returns (hidden [B, T, D], cache).

    tokens / positions: [B, T].  The cache (a ``KVCache``, or a
    ``PagedKVCache`` with ``block_tables [B, max_pages]``) is updated in
    place.  uniform_decode: the caller promises every row decodes at the
    same position (an aligned batch); it selects the contiguous append
    kernels.  ragged_multi: the caller promises each row's T > 1 positions
    are consecutive from a per-row start (``positions[:, j] ==
    positions[:, 0] + j``): the speculative verify forward.  start: a
    prefill continuation chunk (T > 1, not fresh, not ragged_multi) gives
    its first position as a host int; every row's positions are
    ``start..start+T-1``.  deferred_append: the deferred-append decode (a
    uniform decode step, T = 1, over a contiguous bf16 cache, or f32 on the
    CPU): each layer attends with the current token merged from its own
    K/V, and one launch writes every layer's K/V after the loop.
    """
    B, T = tokens.shape
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    Qd, Kd = Hq * Dh, Hk * Dh
    eps = cfg.rms_norm_eps
    act = cfg.act_bits
    if deferred_append:
        _check_deferred(cache, T, fresh_prefill, uniform_decode)
        fresh_k, fresh_v = [], []
    if ragged_multi and (fresh_prefill or T < 2):
        raise ValueError("ragged_multi is the verify of T > 1 tokens over a "
                         "filled cache")
    continuation = not fresh_prefill and T > 1 and not ragged_multi
    if continuation and start is None:
        raise ValueError("a prefill continuation chunk (T > 1 over a filled "
                         "cache) needs its first position `start`")
    paged = isinstance(cache, PagedKVCache)
    if paged:
        if block_tables is None:
            raise ValueError("a paged cache needs block_tables")
        if B != 1 and (fresh_prefill or continuation):
            raise ValueError(f"a paged prefill piece takes one sequence, "
                             f"not {B}")
        block_tables = block_tables.to(torch.int32).contiguous()
        if fresh_prefill:
            start = 0
    x = params["embed"][tokens]
    cos, sin = params["rope_cos"], params["rope_sin"]
    lyr = params["layers"]
    if not fresh_prefill:
        # int32 once per step, as the kernels read them (on the device)
        position = positions[:1, 0].int()     # uniform decode
        row_pos = positions[:, 0].int()       # paged decode / verify starts
        lengths = (positions[:, 0] + T).int()  # ragged decode / verify
    else:
        row_pos = lengths = None
    # the single-pass SwiGLU kernel (fused_mlp has no int8-activation path)
    use_mlp_kernel = (not cfg.is_moe and "gate" in lyr and act != 8
                      and fused_mlp_supported(lyr["gate"], lyr["up"],
                                              lyr["down"], B * T))
    for l in range(cfg.num_layers):
        h = rms_norm(x, lyr["input_norm"][l], eps)
        if "qkv" in lyr:
            # offline-fused projection (quant/quantize.fuse_projections):
            # one matmul in place of three
            qkv = apply_linear(h, lyr["qkv"], l, act)
            q = qkv[..., :Qd].reshape(B, T, Hq, Dh)
            k = qkv[..., Qd:Qd + Kd].reshape(B, T, Hk, Dh)
            v = qkv[..., Qd + Kd:].reshape(B, T, Hk, Dh)
        else:
            q = apply_linear(h, lyr["q"], l, act).reshape(B, T, Hq, Dh)
            k = apply_linear(h, lyr["k"], l, act).reshape(B, T, Hk, Dh)
            v = apply_linear(h, lyr["v"], l, act).reshape(B, T, Hk, Dh)
        if cfg.qk_norm:
            q = qk_norm(q, lyr["q_norm"][l], eps)
            k = qk_norm(k, lyr["k_norm"][l], eps)
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)

        if paged:
            attn = _paged_attention(cache, l, q, k, v, block_tables,
                                    fresh_prefill=fresh_prefill,
                                    ragged_multi=ragged_multi, start=start,
                                    row_pos=row_pos, lengths=lengths)
        elif fresh_prefill:
            cache.write(l, k, v, write_prefill_stacked)
            attn = flash_attention(q, k, v)
        elif continuation or ragged_multi:
            if ragged_multi:
                # per-row windows: the rows' starts stay on the device
                _append_rows(cache, l, k, v, row_pos)
            else:
                cache.write(l, k, v, functools.partial(write_window_stacked,
                                                       start=start))
            first = row_pos if ragged_multi else start
            if cache.quantized:
                attn = chunk_attention_contiguous_q8(
                    q, cache.k, cache.v, cache.k_scale, cache.v_scale, l,
                    first)
            else:
                attn = chunk_attention_contiguous(q, cache.k, cache.v, l,
                                                  first)
        elif cache.quantized:
            if uniform_decode:
                qk, sk = quantize_kv(k)
                qv, sv = quantize_kv(v)
                kv_append_uniform_q8(cache.k, cache.v, cache.k_scale,
                                     cache.v_scale, qk, qv, sk, sv, position,
                                     l)
            else:
                _append_rows(cache, l, k, v, row_pos)
            attn = decode_attention_contiguous_q8(
                q, cache.k, cache.v, cache.k_scale, cache.v_scale, l, lengths)
        elif deferred_append:
            attn = decode_attention_contiguous_fresh(q, cache.k, cache.v, k, v,
                                                     l, row_pos)
            fresh_k.append(k)
            fresh_v.append(v)
        elif uniform_decode:
            attn, _, _ = decode_attention_appending(q, cache.k, cache.v, k, v,
                                                    l, position)
        else:
            _append_rows(cache, l, k, v, row_pos)
            attn = decode_attention_contiguous(q, cache.k, cache.v, l, lengths)

        o = apply_linear(attn.reshape(B, T, Hq * Dh), lyr["o"], l, act)
        x = x + o
        h = rms_norm(x, lyr["post_norm"][l], eps)
        if cfg.is_moe:
            # the batch flattened: a verify of B x (k+1) rows routes as one
            d = moe_mlp(h.reshape(B * T, -1), lyr["router"].w[l],
                        lyr["moe_gate"], lyr["moe_up"], lyr["moe_down"],
                        cfg.num_experts_per_tok, cfg.norm_topk_prob, layer=l,
                        act_bits=act).reshape(B, T, -1).to(x.dtype)
        elif use_mlp_kernel:
            ga, ua, da_ = lyr["gate"], lyr["up"], lyr["down"]
            d = fused_mlp(h.reshape(B * T, -1), ga.q, ga.scales, ua.q,
                          ua.scales, da_.q, da_.scales, l,
                          gs_gate=ga.group_size,
                          gs_down=da_.group_size).reshape(B, T, -1)
        elif "gateup" in lyr:
            gu = apply_linear(h, lyr["gateup"], l, act)
            F2 = gu.shape[-1] // 2
            d = apply_linear(F.silu(gu[..., :F2]) * gu[..., F2:], lyr["down"],
                             l, act)
        else:
            gate = apply_linear(h, lyr["gate"], l, act)
            up = apply_linear(h, lyr["up"], l, act)
            d = apply_linear(F.silu(gate) * up, lyr["down"], l, act)
        x = x + d
    if deferred_append:
        kv_append_all_uniform(cache.k, cache.v, torch.stack(fresh_k),
                              torch.stack(fresh_v), position)
    return rms_norm(x, params["final_norm"], eps), cache


def compute_logits(params: dict, hidden: torch.Tensor,
                   act_bits: int = 0) -> torch.Tensor:
    """hidden [..., D] -> fp32 logits [..., V] (tied or untied head)."""
    if "lm_head" in params:
        logits = apply_linear(hidden, params["lm_head"], act_bits=act_bits)
    else:
        logits = torch.matmul(hidden, params["embed"].to(hidden.dtype).T)
    return logits.float()


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Fresh prefill from position 0 of right-padded prompts ``[B, T]``.
    Returns (last-valid-token logits [B, V], cache)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    hidden, cache = forward_hidden(params, cfg, tokens, positions, cache,
                                   fresh_prefill=True)
    last = hidden[torch.arange(B, device=tokens.device), lengths.long() - 1]
    return compute_logits(params, last, cfg.act_bits_lm_head), cache


def prefill_chunked(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    lengths: torch.Tensor, cache: KVCache, *,
                    chunk: int = 512) -> Tuple[torch.Tensor, KVCache]:
    """Prefill right-padded prompts ``[B, T]`` in ``chunk``-token pieces to
    bound activation memory.  Returns (last-valid-token logits [B, V], cache).

    Chunk 0 is a fresh prefill; chunks 1.. are continuations at positions
    ``i * chunk ..``, causal by absolute position over the cache so far (the
    JAX package's ``lax.scan`` over chunks becomes a Python loop).  The
    prompt is padded to whole chunks, and the padded tail is written to the
    cache like any token, so the padded length must fit in the cache.
    """
    B, T = tokens.shape
    if T <= chunk:
        return prefill(params, cfg, tokens, lengths, cache)
    n_chunks = -(-T // chunk)
    capacity = cache.k.shape[3]
    if n_chunks * chunk > capacity:
        raise ValueError(
            f"chunked prefill would write {n_chunks * chunk} positions "
            f"(T={T} padded to a multiple of chunk={chunk}) but the cache "
            f"holds only {capacity}; grow the cache/block tables or lower "
            f"the chunk size")
    tokens = F.pad(tokens, (0, n_chunks * chunk - T))
    last = lengths.long() - 1
    rows = torch.arange(B, device=tokens.device)
    arange_c = torch.arange(chunk, device=tokens.device)
    for i in range(n_chunks):
        lo = i * chunk
        positions = (lo + arange_c)[None, :].expand(B, chunk)
        hidden, cache = forward_hidden(
            params, cfg, tokens[:, lo:lo + chunk], positions, cache,
            fresh_prefill=i == 0, start=None if i == 0 else lo)
        # each row keeps the hidden state of the chunk that holds its last
        # valid token
        sel = hidden[rows, (last - lo).clamp(0, chunk - 1)]
        in_chunk = (last >= lo) & (last < lo + chunk)
        hidden_last = sel if i == 0 else torch.where(in_chunk[:, None], sel,
                                                     hidden_last)
    return compute_logits(params, hidden_last, cfg.act_bits_lm_head), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache, block_tables=None, *,
                uniform_decode: bool = False, deferred_append: bool = False):
    """One decode step for every sequence: tokens [B] at positions [B]
    (a paged cache takes ``block_tables [B, max_pages]``).  Returns
    (logits [B, V], cache).  deferred_append: ``forward_hidden``'s
    deferred-append decode (with ``uniform_decode``)."""
    hidden, cache = forward_hidden(params, cfg, tokens[:, None],
                                   positions[:, None], cache,
                                   block_tables=block_tables,
                                   uniform_decode=uniform_decode,
                                   deferred_append=deferred_append)
    return compute_logits(params, hidden[:, 0], cfg.act_bits_lm_head), cache


def score_logits(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: KVCache) -> torch.Tensor:
    """Full ``[B, T, V]`` fp32 logits of one fresh prefill over positions
    ``0..T-1`` into ``cache`` (the perplexity harness, ``utils/ppl.py``).
    As in the JAX package the logits take no int8 activations:
    ``cfg.act_bits_lm_head`` is not read, so a W4A8 lm_head is scored with
    bf16 inputs."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    hidden, _ = forward_hidden(params, cfg, tokens, positions, cache,
                               fresh_prefill=True)
    return compute_logits(params, hidden)


def pumped_supported(cfg: ModelConfig, params: dict, cache,
                     batch: int) -> bool:
    """Whether ``decode_step_pumped`` covers this model and cache (the JAX
    package's gate, copied): a contiguous unquantized cache with S % 256,
    an even batch of more than 128 rows, G <= 8, head_dim and hidden size
    multiples of 128, and pad-free stacked INT4 gate / up / down without
    bias (gate / up out == down in), F % 512, equal gate and up group
    sizes, 512 % (2 * gs_down)."""
    if isinstance(cache, PagedKVCache) or getattr(cache, "quantized", False):
        return False
    if batch % 2 or batch <= 128 or cfg.num_heads // cfg.num_kv_heads > 8:
        return False
    if cfg.head_dim % 128 or cache.k.shape[3] % 256:
        return False
    layers = params["layers"]
    if "gate" not in layers or "up" not in layers:
        return False
    gate, up, down = layers["gate"], layers["up"], layers["down"]
    for lin in (gate, up, down):
        if not isinstance(lin, QuantLinear) or lin.bits != 4 \
                or lin.b is not None:
            return False
    F_ = gate.out_features
    if up.out_features != F_ or down.in_features != F_:
        return False
    if F_ % 512 or gate.group_size != up.group_size:
        return False
    if 512 % (2 * down.group_size) or cfg.hidden_size % 128:
        return False
    return True


def decode_step_pumped(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       positions: torch.Tensor, cache: KVCache):
    """Double-pumped decode of an aligned batch: tokens [B] (B even) all at
    the one position ``positions[0]``.  Returns (logits [B, V], cache).

    The batch is split in halves A and B staggered by half a layer; per
    layer l (the JAX package's ``decode_step_pumped``):

      q/k/v_A(l) -> rope -> kv_append_uniform(rows of A)
      fused_attn_mlp:  attn_A(l)  and  mlp_B(l-1)
      o_A(l) (+ residual)
      q/k/v_B(l) -> rope -> kv_append_uniform(rows of B)
      fused_attn_mlp:  attn_B(l)  and  mlp_A(l)
      o_B(l) (+ residual)

    At l = 0 half B's MLP input is zeros (its output is exactly 0; the
    launch still runs, 2 * L fused launches a step); half B's last MLP
    drains through the three matmuls.  As in the JAX package the
    projections and the logits take no int8 activations (``cfg.act_bits``
    and ``act_bits_lm_head`` are not read), and the queries and the MLP
    inputs are rounded to bf16 for the fused kernel.
    """
    B = tokens.shape[0]
    Mb = B // 2
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    lyr = params["layers"]
    gate, up, down = lyr["gate"], lyr["up"], lyr["down"]
    gs_gate, gs_down = gate.group_size, down.group_size
    cos, sin = params["rope_cos"], params["rope_sin"]

    x = params["embed"][tokens]                       # [B, D]
    pos = positions[:1].int()                         # uniform, on the device
    pos_half = positions[:1, None].expand(Mb, 1)      # [Mb, 1] for RoPE
    lens = (positions[:Mb] + 1).int()

    def qkv_rope(h, l):
        hn = rms_norm(h, lyr["input_norm"][l], eps)
        q = apply_linear(hn, lyr["q"], l).reshape(Mb, 1, Hq, Dh)
        k = apply_linear(hn, lyr["k"], l).reshape(Mb, 1, Hk, Dh)
        v = apply_linear(hn, lyr["v"], l).reshape(Mb, 1, Hk, Dh)
        if cfg.qk_norm:
            q = qk_norm(q, lyr["q_norm"][l], eps)
            k = qk_norm(k, lyr["k_norm"][l], eps)
        return (apply_rope(q, pos_half, cos, sin),
                apply_rope(k, pos_half, cos, sin), v)

    def fused(l_attn, l_mlp, q, xm, row0):
        attn, mlp = fused_attn_mlp(
            lens, l_attn, l_mlp, q.to(torch.bfloat16), cache.k, cache.v,
            xm.to(torch.bfloat16), gate.q, gate.scales, up.q, up.scales,
            down.q, down.scales, gs_gate=gs_gate, gs_down=gs_down, row0=row0)
        return attn.reshape(Mb, Hq * Dh).to(x.dtype), mlp.to(x.dtype)

    xa, xb_mid = x[:Mb], x[Mb:]
    for l in range(cfg.num_layers):
        # ---- A: q/k/v, append, then attn_A(l) beside mlp_B(l-1)
        qa, ka, va = qkv_rope(xa, l)
        kv_append_uniform(cache.k, cache.v, ka, va, pos, l, row0=0)
        lm = max(l - 1, 0)
        mlp_in_b = rms_norm(xb_mid, lyr["post_norm"][lm], eps)
        if l == 0:
            mlp_in_b = torch.zeros_like(mlp_in_b)
        attn_a, mlp_b = fused(l, lm, qa, mlp_in_b, 0)
        xb = xb_mid + mlp_b
        xa = xa + apply_linear(attn_a, lyr["o"], l)
        # ---- B: q/k/v, append, then attn_B(l) beside mlp_A(l)
        qb, kb, vb = qkv_rope(xb, l)
        kv_append_uniform(cache.k, cache.v, kb, vb, pos, l, row0=Mb)
        mlp_in_a = rms_norm(xa, lyr["post_norm"][l], eps)
        attn_b, mlp_a = fused(l, l, qb, mlp_in_a, Mb)
        xb_mid = xb + apply_linear(attn_b, lyr["o"], l)
        xa = xa + mlp_a

    # drain: half B's last MLP (layer L-1) through the three matmuls
    last = cfg.num_layers - 1
    hb = rms_norm(xb_mid, lyr["post_norm"][last], eps)
    g = apply_linear(hb, gate, last)
    u = apply_linear(hb, up, last)
    xb = xb_mid + apply_linear(F.silu(g) * u, down, last)
    hidden = rms_norm(torch.cat([xa, xb], dim=0), params["final_norm"], eps)
    return compute_logits(params, hidden), cache
