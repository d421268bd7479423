"""Qwen2 / Qwen2.5 / Qwen3 dense transformer forward over the contiguous cache.

The port of the JAX package's ``models/qwen.py`` for the main path: the
layer ``lax.scan`` becomes a Python loop over layers that updates the
stacked ``[L, ...]`` cache in place, and the weights stay stacked
``[L, ...]`` (the quantized matmul takes the layer index, no slab copy).

Per-layer schedule: rmsnorm -> q/k/v proj -> qk-norm (Qwen3) -> RoPE ->
KV write + attention -> o proj -> residual -> rmsnorm -> gate/up proj ->
SiLU * up -> down proj -> residual; then final norm -> lm_head.

Attention branches (the kernels of this slice):

* fresh prefill (positions 0..T-1): ``flash_attention`` on the fresh K/V,
  which are also written to the cache;
* uniform decode (all rows at one position): ``decode_attention_appending``,
  which writes the fresh row and attends in one kernel;
* ragged decode: the plain stacked scatter, then
  ``decode_attention_contiguous`` with per-row lengths.

A prefill continuation (T > 1 over a cache that already holds tokens) needs
the port of ``chunk_attention_contiguous`` and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.kvcache.cache import (
    KVCache,
    write_prefill_stacked,
    write_stacked,
)
from qwen_inference_engine_tpu_torch.ops.decode_attention import (
    decode_attention_appending,
    decode_attention_contiguous,
)
from qwen_inference_engine_tpu_torch.ops.flash_attention import flash_attention
from qwen_inference_engine_tpu_torch.ops.linear import (
    Linear,
    QuantLinear,
    apply_linear,
)
from qwen_inference_engine_tpu_torch.ops.norms import qk_norm, rms_norm
from qwen_inference_engine_tpu_torch.ops.rope import apply_rope, precompute_rope


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Random layer-stacked params (tests and smoke runs), drawn from
    ``generator`` one layer slab at a time so no f32 copy of a whole stacked
    tensor is ever live.  The generator must live on ``device``."""
    if cfg.is_moe:
        raise NotImplementedError("Qwen3-MoE is not ported yet")
    L, D, Fi, V = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Qd, Kd = cfg.q_dim, cfg.kv_dim

    def normal(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=device)
        slabs = out if len(shape) == 3 else out[None]
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
        "gate": Linear(dense((L, D, Fi))),
        "up": Linear(dense((L, D, Fi))),
        "down": Linear(dense((L, Fi, D))),
    }
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

def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, cache: KVCache, *,
                   fresh_prefill: bool = False,
                   uniform_decode: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Run the transformer stack; returns (hidden [B, T, D], cache).

    tokens / positions: [B, T].  The cache is updated in place.
    uniform_decode: the caller promises every row decodes at the same
    position (an aligned batch); it selects the append-fused kernel.
    """
    B, T = tokens.shape
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    act = cfg.act_bits
    if not fresh_prefill and T != 1:
        raise NotImplementedError(
            "a prefill continuation (T > 1 over a filled cache) needs the "
            "port of chunk_attention_contiguous")
    x = params["embed"][tokens]
    cos, sin = params["rope_cos"], params["rope_sin"]
    lyr = params["layers"]
    if not fresh_prefill:
        position = positions[:1, 0]           # uniform decode: read on device
        lengths = positions[:, 0] + 1          # ragged decode
    for l in range(cfg.num_layers):
        h = rms_norm(x, lyr["input_norm"][l], eps)
        q = apply_linear(h, lyr["q"], l, act).reshape(B, T, Hq, Dh)
        k = apply_linear(h, lyr["k"], l, act).reshape(B, T, Hk, Dh)
        v = apply_linear(h, lyr["v"], l, act).reshape(B, T, Hk, Dh)
        if cfg.qk_norm:
            q = qk_norm(q, lyr["q_norm"][l], eps)
            k = qk_norm(k, lyr["k_norm"][l], eps)
        q = apply_rope(q, positions, cos, sin)
        k = apply_rope(k, positions, cos, sin)

        if fresh_prefill:
            write_prefill_stacked(cache.k, l, k)
            write_prefill_stacked(cache.v, l, v)
            attn = flash_attention(q, k, v)
        elif uniform_decode:
            attn, _, _ = decode_attention_appending(q, cache.k, cache.v, k, v,
                                                    l, position)
        else:
            write_stacked(cache.k, l, k, positions)
            write_stacked(cache.v, l, v, positions)
            attn = decode_attention_contiguous(q, cache.k, cache.v, l, lengths)

        o = apply_linear(attn.reshape(B, T, Hq * Dh), lyr["o"], l, act)
        x = x + o
        h = rms_norm(x, lyr["post_norm"][l], eps)
        gate = apply_linear(h, lyr["gate"], l, act)
        up = apply_linear(h, lyr["up"], l, act)
        x = x + apply_linear(F.silu(gate) * up, lyr["down"], l, act)
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
    """Prefill in ``chunk``-token pieces.  Only one piece is ported: longer
    prompts need the port of chunk_attention_contiguous and raise."""
    if tokens.shape[1] > chunk:
        raise NotImplementedError(
            f"prompts longer than one {chunk}-token chunk need the port of "
            "chunk_attention_contiguous")
    return prefill(params, cfg, tokens, lengths, cache)


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: KVCache, *,
                uniform_decode: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for every sequence: tokens [B] at positions [B].
    Returns (logits [B, V], cache)."""
    hidden, cache = forward_hidden(params, cfg, tokens[:, None],
                                   positions[:, None], cache,
                                   uniform_decode=uniform_decode)
    return compute_logits(params, hidden[:, 0], cfg.act_bits_lm_head), cache
