"""Pipeline parallelism: the layers cut into stages, one stage a rank.

The port of the JAX package's ``parallel/pp_step.py``.  Every layer-stacked
weight and the ``[L, ...]`` contiguous KV cache are cut on their layer
axis over a ``("stage",)`` mesh (``parallel/mesh.make_pp_mesh``), so stage
``s`` of ``S`` holds only layers ``[s L / S, (s + 1) L / S)``: 1/S of the
layers' weights and KV on each rank.  The JAX package runs each function
under ``jax.shard_map``, every stage computing every hop and a masked
select keeping the active stage's work; the port is SPMD in the torch
idiom, so each maker returns a plain function that every rank of the
mesh calls at once, and a stage computes only its own work:

* ``make_pp_forward_fn``: one stream through the stages in turn.  Stage 0
  embeds; stage ``s`` runs its layers (``forward_hidden`` with
  ``inputs_embeds`` and ``apply_final_norm=False``) and passes the stream
  to stage ``s + 1`` (``ring_exchange``, one hop); the last stage passes it
  back to stage 0, as the JAX ring's last hop does.  Stage 0 applies the
  final norm, picks each row's last token and broadcasts those ``[B, D]``
  rows, and every rank computes the same logits.  A stage waits while the
  others run (the sequential pipeline's bubble), and computes none of the
  JAX bubble's don't-care data.
* ``make_pp_decode_1f1b``: the 1F1B microbatched decode, ``M = S``
  microbatches of ``b`` rows rotating through the ring.  At tick ``t``
  stage ``s`` works on microbatch ``(t - s) mod M`` at its step ``(t - s)
  // M``, over cache rows ``[m b, (m + 1) b)``; after the ``S``-tick
  warm-up every tick completes a token somewhere.  Stage 0 finishes each
  arriving stream (final norm, logits, ``argmax`` or ``sample_rows``) and
  embeds the next token; every tick ends in one full ring exchange.  The
  JAX warm-up ticks ``t < s`` (garbage that the real pass overwrites) are
  skipped, so the caches after a call equal the JAX function's.  The
  zero-copy form hands the whole local cache to ``forward_hidden`` with
  ``cache_row0`` (the row0 kernels); the sliced form copies the window
  out and back.

As in the JAX package, the logits of both functions take bf16
activations (``compute_logits`` without ``act_bits_lm_head``).  The
pipeline is dense only: an MoE model, or layers that do not divide by the
stages, is refused (``pp_refusal``); the JAX package runs those as GSPMD's
XLA ops, which the port does not.  Pipeline steps run eagerly
(``PpMesh.capturable`` is false).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from qwen_inference_engine_tpu_torch.config import ModelConfig
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models.qwen import (
    compute_logits,
    forward_hidden,
)
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.ops.norms import rms_norm
from qwen_inference_engine_tpu_torch.ops.sampling import (
    sample_rows,
    stream_generator,
)
from qwen_inference_engine_tpu_torch.parallel.mesh import (
    PpMesh,
    broadcast,
    ring_exchange,
)


def pp_refusal(cfg: ModelConfig, stages: int) -> Optional[str]:
    """Why the pipeline cannot run this model over ``stages`` stages (the
    first condition the JAX ``supports_pp`` finds false), or None."""
    if cfg.is_moe:
        return (f"{cfg.name} is a MoE model: the JAX package runs it over a "
                f"stage mesh as GSPMD's XLA ops, which the port does not")
    if stages < 1 or cfg.num_layers % stages:
        return (f"{cfg.num_layers} layers do not divide into {stages} "
                f"stages")
    return None


def supports_pp(cfg: ModelConfig, params: dict, stages: int) -> bool:
    """The JAX package's gate for the pipeline."""
    return pp_refusal(cfg, stages) is None


def _check(cfg: ModelConfig, mesh: PpMesh) -> ModelConfig:
    """The stage's config (its ``L / S`` layers), or raise naming why."""
    why = pp_refusal(cfg, mesh.stages)
    if why is not None:
        raise ValueError(f"the pipeline does not take this model ({why})")
    return cfg.replace(num_layers=cfg.num_layers // mesh.stages)


def _cut(t: Optional[torch.Tensor], s: int, stages: int):
    """Layers ``[s n, (s + 1) n)`` of a layer-stacked tensor (a copy)."""
    if t is None:
        return None
    n = t.shape[0] // stages
    return t[s * n:(s + 1) * n].clone()


def shard_for_pp(params: dict, cache: Optional[KVCache], mesh: PpMesh
                 ) -> Tuple[dict, Optional[KVCache]]:
    """This stage's params and cache (the JAX ``shard_for_pp``): every
    layer-stacked leaf (``Linear`` ``w`` / ``b``, ``QuantLinear`` ``q`` /
    ``scales`` / ``b``, the norms, fused ``qkv`` / ``gateup``) cut to the
    stage's layers; ``embed``, ``final_norm``, the rope tables and
    ``lm_head`` whole.  The cache ``[L, B, Hk, S, D]`` (and an INT8
    cache's scales ``[L, B, Hk, S]``) becomes ``[L / S, ...]``."""
    s, n = mesh.stage, mesh.stages

    def cut(leaf):
        if isinstance(leaf, (Linear, QuantLinear)):
            return dataclasses.replace(leaf, **{
                f.name: _cut(getattr(leaf, f.name), s, n)
                for f in dataclasses.fields(leaf)
                if isinstance(getattr(leaf, f.name), torch.Tensor)})
        return _cut(leaf, s, n)

    params_l = dict(params, layers={k: cut(v) for k, v in
                                    params["layers"].items()})
    if cache is None:
        return params_l, None
    return params_l, KVCache(*(_cut(t, s, n) for t in (
        cache.k, cache.v, cache.k_scale, cache.v_scale)))


def pp_cache(cfg: ModelConfig, mesh: PpMesh, batch: int, max_seq: int,
             dtype=torch.bfloat16, device=None) -> KVCache:
    """A stage's contiguous cache ``[L / S, batch, Hk, S, D]``, made at its
    own size (``shard_for_pp`` of the whole cache, without the whole)."""
    return KVCache.create(cfg.num_layers // mesh.stages, batch, max_seq,
                          cfg.num_kv_heads, cfg.head_dim, dtype=dtype,
                          device=device)


def make_pp_forward_fn(cfg: ModelConfig, mesh: PpMesh, *,
                       uniform_decode: bool = False):
    """Returns ``fn(params_l, tokens, positions, lengths, cache_l) ->
    (last-token logits [B, V], cache_l)``: T > 1 from position 0 is a fresh
    prefill (``lengths`` picks each row's last token), T == 1 a decode
    step.  Every rank returns the same logits."""
    cfg_l = _check(cfg, mesh)
    S, me, group = mesh.stages, mesh.stage, mesh.stage_group
    eps = cfg.rms_norm_eps

    def fn(params_l, tokens, positions, lengths, cache_l):
        B, T = tokens.shape
        embed = params_l["embed"]
        x = (embed[tokens] if me == 0 else
             embed.new_empty((B, T, cfg.hidden_size)))
        for hop in range(S):
            if hop == me:
                hidden, cache_l = forward_hidden(
                    params_l, cfg_l, tokens, positions, cache_l,
                    fresh_prefill=T > 1, uniform_decode=uniform_decode,
                    inputs_embeds=x, apply_final_norm=False)
                x = hidden.to(embed.dtype)
            got = ring_exchange(x, group, src=hop)
            if got is not None:
                x = got
        # the stream came back to stage 0: its rows' last tokens, to all
        if me == 0:
            x = rms_norm(x, params_l["final_norm"], eps)
            last = (x[torch.arange(B, device=x.device), lengths.long() - 1]
                    if T > 1 else x[:, 0])
        else:
            last = embed.new_empty((B, cfg.hidden_size))
        last = broadcast(last, group)
        return compute_logits(params_l, last), cache_l

    return fn


def make_pp_decode_1f1b(cfg: ModelConfig, mesh: PpMesh, *,
                        microbatch_rows: int, steps: int,
                        zero_copy_cache: Optional[bool] = None,
                        sampled: bool = False, k_cap: int = 64,
                        penalized: bool = False):
    """Returns ``fn(params_l, init_toks [M, b], init_pos [M], cache_l,
    key=None, sp_dyn=None, seen=None) -> (tokens [steps, M, b], cache_l[,
    seen])``:
    ``steps`` tokens for every microbatch, pipelined across the stages
    (``M = S`` microbatches of ``b = microbatch_rows`` rows; the local cache
    holds their ``M b`` rows, microbatch ``m`` in rows ``[m b, (m + 1)
    b)``).  Greedy, or with ``sampled`` per-row sampling on stage 0
    (``key = (seed, stream)``: tick ``t`` draws from
    ``stream_generator(device, seed, stream, t)``, the JAX ``fold_in(rkey,
    t)``; ``sp_dyn`` the ``sample_rows`` rows ``[M, b]``); ``penalized``
    (with ``sampled``) carries the seen mask ``seen [M, b, V]`` through the
    ticks and returns it marked with every emitted token.  Token ``k`` of
    microbatch ``m`` completes at tick ``S + k M + m``.  Every rank returns
    the same tokens (and mask).  ``zero_copy_cache`` (default: on the card)
    passes the whole local cache with ``cache_row0``; else each tick copies
    its window out and back."""
    if penalized and not sampled:
        raise ValueError("penalized requires sampled=True")
    cfg_l = _check(cfg, mesh)
    S, me, group = mesh.stages, mesh.stage, mesh.stage_group
    M, b = S, microbatch_rows
    n_ticks = S + steps * M
    eps = cfg.rms_norm_eps

    def finish(params_l, x, t, key, sp_dyn, seen):
        """Stage 0: the token of the stream arriving at tick ``t``."""
        m = t % M
        xf = rms_norm(x, params_l["final_norm"], eps)
        logits = compute_logits(params_l, xf[:, 0])
        if not sampled:
            return torch.argmax(logits, dim=-1)
        gen = stream_generator(logits.device, key[0], key[1], t)
        sp_m = {name: v[m] for name, v in sp_dyn.items()}
        tok = sample_rows(logits, gen, k_cap=k_cap,
                          seen_mask=seen[m] if penalized else None, **sp_m)
        if penalized:
            seen[m, torch.arange(b, device=tok.device), tok] = True
        return tok

    def fn(params_l, init_toks, init_pos, cache_l, key=None, sp_dyn=None,
           seen=None):
        if cache_l.k.shape[1] != M * b:
            raise ValueError(f"the cache holds {cache_l.k.shape[1]} rows, "
                             f"the 1F1B decode {M} x {b}")
        embed = params_l["embed"]
        dev = embed.device
        zero_copy = (cache_l.k.is_cuda if zero_copy_cache is None
                     else zero_copy_cache)
        pos0 = [int(p) for p in torch.as_tensor(init_pos).tolist()]
        if penalized:
            seen = seen.clone()
        emitted = []
        toks_m = torch.zeros((b, 1), dtype=torch.long, device=dev)
        x = embed.new_zeros((b, 1, cfg.hidden_size))
        for t in range(n_ticks):
            if me == 0:
                if t >= S:
                    tok = finish(params_l, x, t, key, sp_dyn, seen)
                    emitted.append(tok)
                else:
                    tok = init_toks[t % M]
                x = embed[tok.to(dev).long()][:, None, :]
            if t >= me:
                m = (t - me) % M
                row0 = m * b
                positions = torch.full((b, 1), pos0[m] + (t - me) // M,
                                       dtype=torch.long, device=dev)
                if zero_copy:
                    hidden, cache_l = forward_hidden(
                        params_l, cfg_l, toks_m, positions, cache_l,
                        uniform_decode=True, inputs_embeds=x,
                        apply_final_norm=False, cache_row0=row0)
                else:
                    rows = slice(row0, row0 + b)
                    win = KVCache(*(None if c is None else c[:, rows].clone()
                                    for c in (cache_l.k, cache_l.v,
                                              cache_l.k_scale,
                                              cache_l.v_scale)))
                    hidden, win = forward_hidden(
                        params_l, cfg_l, toks_m, positions, win,
                        uniform_decode=True, inputs_embeds=x,
                        apply_final_norm=False)
                    for full, w in zip((cache_l.k, cache_l.v,
                                        cache_l.k_scale, cache_l.v_scale),
                                       (win.k, win.v, win.k_scale,
                                        win.v_scale)):
                        if full is not None:
                            full[:, rows] = w
                x = hidden.to(embed.dtype)
            if t < n_ticks - 1:
                # a stage before its first microbatch sends its (zero)
                # stream, which the next stage, also before its first,
                # does not read
                x = ring_exchange(x, group)
        out = (torch.stack(emitted).reshape(steps, M, b) if me == 0 else
               torch.zeros((steps, M, b), dtype=torch.long, device=dev))
        out = broadcast(out, group)
        if not penalized:
            return out, cache_l
        mask = broadcast(seen.to(torch.uint8), group).bool()
        return out, cache_l, mask

    return fn
