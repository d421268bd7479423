"""Jobs the ranks of a ``tests/torch_parallel_world.World`` run for the
pipeline-parallel tests (``tests/test_torch_pp_*.py``): the port over a
``("stage",)`` mesh of the whole world on the CPU (gloo).  Each takes
``(mesh_of, rank, *args)`` (``mesh_of`` unused: the stage mesh is the
world) and returns numpy arrays or plain values; no JAX here."""

from __future__ import annotations

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models import qwen
from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh
from qwen_inference_engine_tpu_torch.parallel import pp_step


def fake_pp_mesh(stages, stage=0):
    """Stage ``stage``'s view of a stage mesh, with no process group (for
    what reads only the stage and the stage count)."""
    g = pmesh.Group(pg=None, size=stages, rank=stage, backend="gloo",
                    ranks=tuple(range(stages)))
    return pmesh.PpMesh(shape={"stage": stages}, rank=stage, stage_group=g,
                        world_group=g)


def ring(mesh_of, rank, rows):
    """``ring_exchange`` over the world's stage mesh: the full ring (each
    stage sends ``rows`` rows of its stage index), then a hop from each
    stage in turn, then ``broadcast`` from stage 0.  Returns (what the
    ring gave, what each hop gave (None where nothing arrived), the
    broadcast, launches and bytes sent of both)."""
    mesh = pmesh.make_pp_mesh()
    g = mesh.stage_group
    before = [(c.launches, c.sent_bytes)
              for c in (pmesh.ring_exchange, pmesh.broadcast)]
    x = torch.full((rows, 3), float(mesh.stage))
    full = pmesh.ring_exchange(x, g).tolist()
    hops = []
    for src in range(mesh.stages):
        got = pmesh.ring_exchange(x + 10 * src, g, src=src)
        hops.append(None if got is None else got.tolist())
    b = pmesh.broadcast(torch.full((2,), float(mesh.stage + 5)), g).tolist()
    counts = [(c.launches - n, c.sent_bytes - m) for c, (n, m) in zip(
        (pmesh.ring_exchange, pmesh.broadcast), before)]
    return full, hops, b, counts


def _cache_np(cache: KVCache):
    return [None if t is None else t.numpy().copy()
            for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]


def forward_steps(mesh_of, rank, cfg, params, prompts, lens, toks, kv,
                  max_seq=64):
    """``make_pp_forward_fn``: a fresh prefill of ``prompts [B, T]`` at
    ``lens``, then a decode step for each row of ``toks [steps, B]`` at
    positions ``lens + s`` (aligned rows: the uniform decode; ragged: the
    per-row one).  Returns (the logits of each, launches of the ring
    exchange and the broadcast)."""
    mesh = pmesh.make_pp_mesh()
    B, T = prompts.shape
    params_l, cache = pp_step.shard_for_pp(params, KVCache.create(
        cfg.num_layers, B, max_seq, cfg.num_kv_heads, cfg.head_dim,
        dtype=kv), mesh)
    aligned = len(set(lens.tolist())) == 1
    pre = pp_step.make_pp_forward_fn(cfg, mesh)
    dec = pp_step.make_pp_forward_fn(cfg, mesh, uniform_decode=aligned)
    before = (pmesh.ring_exchange.launches, pmesh.broadcast.launches)
    lens_t = torch.as_tensor(lens)
    logits, cache = pre(params_l, torch.as_tensor(prompts),
                        torch.arange(T)[None].expand(B, T), lens_t, cache)
    outs = [logits.numpy()]
    for s, tok in enumerate(toks):
        logits, cache = dec(params_l, torch.as_tensor(tok)[:, None],
                            (lens_t + s)[:, None], lens_t, cache)
        outs.append(logits.numpy())
    return outs, (pmesh.ring_exchange.launches - before[0],
                  pmesh.broadcast.launches - before[1])


def decode_1f1b(mesh_of, rank, cfg, params, prompts, b, steps, kv,
                zero_copy=None, max_seq=64):
    """The port's own prefill of ``prompts [M b, T]`` (aligned) on every
    rank, its cache cut to this stage, then ``make_pp_decode_1f1b`` greedy
    from the prefill's argmax.  Returns (tokens [steps, M, b], this
    stage's cache after the call, the row0 kernels' plain calls a tick
    counted as forward calls with cache_row0)."""
    mesh = pmesh.make_pp_mesh()
    B, T = prompts.shape
    M = mesh.stages
    cache = KVCache.create(cfg.num_layers, B, max_seq, cfg.num_kv_heads,
                           cfg.head_dim, dtype=kv)
    logits, cache = qwen.prefill(params, cfg, torch.as_tensor(prompts),
                                 torch.full((B,), T), cache)
    first = torch.argmax(logits, dim=-1)
    params_l, cache_l = pp_step.shard_for_pp(params, cache, mesh)
    calls = []
    forward = pp_step.forward_hidden

    def counted(*a, **k):
        calls.append(k.get("cache_row0"))
        return forward(*a, **k)

    pp_step.forward_hidden = counted
    try:
        fn = pp_step.make_pp_decode_1f1b(cfg, mesh, microbatch_rows=b,
                                         steps=steps,
                                         zero_copy_cache=zero_copy)
        toks, cache_l = fn(params_l, first.reshape(M, b), [T] * M, cache_l)
    finally:
        pp_step.forward_hidden = forward
    return toks.numpy(), _cache_np(cache_l), calls


def pp_serve(mesh_of, rank, cfg, params, waves, max_new, max_batch, kw):
    """``PPFifoScheduler`` over the world's stage mesh (``rank`` None: no
    world, one stage): each wave of ``{request id: (prompt, sampling)}``
    submitted and run to completion in turn on one scheduler.  Returns
    (tokens by request, finish reasons, the pipeline functions' keys
    used)."""
    from qwen_inference_engine_tpu_torch.engine.pp_scheduler import (
        PPFifoScheduler,
    )
    from qwen_inference_engine_tpu_torch.engine.types import Request

    mesh = pmesh.make_pp_mesh()
    pp = PPFifoScheduler(cfg, params, mesh=mesh, max_batch=max_batch,
                         max_seq=64, device="cpu", **kw)
    toks, why = {}, {}
    for wave in waves:
        for rid, (prompt, sp) in wave.items():
            pp.submit(Request(request_id=rid, prompt=list(prompt),
                              max_new_tokens=max_new, sampling=sp))
        for f in pp.run_to_completion():
            toks[f.request_id] = f.token_ids
            why[f.request_id] = f.finish_reason
    return toks, why, sorted(pp._fns)


def http_serve_pp(mesh_of, rank, cfg, params, bodies, max_slots):
    """``tests/torch_parallel_jobs.http_serve`` over the stage mesh of the
    world: rank 0's answers, the other ranks None."""
    from tests.torch_parallel_jobs import http_serve as serve_http

    return serve_http(lambda _: pmesh.make_pp_mesh(), rank, "pp", cfg,
                      params, bodies, max_slots=max_slots)

