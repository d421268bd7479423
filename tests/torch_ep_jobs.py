"""Jobs the ranks of a ``tests/torch_parallel_world.World`` run for the
expert-parallel tests (``tests/test_torch_ep_*.py``): the port under an
``("ep",)`` mesh over the whole world on the CPU (gloo).  Each takes
``(mesh_of, rank, *args)`` (``mesh_of`` unused: the EP mesh is the world)
and returns numpy arrays or plain values; no JAX here."""

from __future__ import annotations

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh
from qwen_inference_engine_tpu_torch.parallel.ep_step import ep_param_shards


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def moe_layer(mesh_of, rank, h, router, stacks, top_k, norm_topk,
              act_bits=0):
    """``ep_moe_layer`` of this rank's rows of ``h [P * N, D]`` over its
    experts of ``stacks`` (the global ``(gate, up, down)``, cut by
    ``ep_param_shards``), in the ragged and the dense form: (ragged out,
    dense out, launches of the ragged call by collective)."""
    from qwen_inference_engine_tpu_torch.parallel.ep_moe import ep_moe_layer

    mesh = pmesh.make_ep_mesh()
    names = ("moe_gate", "moe_up", "moe_down")
    local = ep_param_shards({"layers": dict(zip(names, stacks))}, mesh)
    w = [local["layers"][n] for n in names]
    n = h.shape[0] // mesh.ep
    h_l = torch.from_numpy(h[rank * n:(rank + 1) * n])
    r = torch.from_numpy(router)
    outs, counts = [], None
    for ragged in (True, False):
        before = {c.__name__: c.launches for c in
                  (pmesh.all_gather, pmesh.all_to_all, pmesh.all_reduce)}
        outs.append(ep_moe_layer(h_l, r, *w, top_k, norm_topk,
                                 mesh.ep_group, ragged=ragged,
                                 act_bits=act_bits).numpy())
        if ragged:
            counts = {c.__name__: c.launches - before[c.__name__] for c in
                      (pmesh.all_gather, pmesh.all_to_all, pmesh.all_reduce)}
    return outs[0], outs[1], counts


def forward_steps(mesh_of, rank, cfg, params, prompts, steps, ragged):
    """``forward_hidden(ep_group=...)`` over this rank's rows of a
    contiguous cache: a fresh prefill of ``prompts [B, T]`` then ``steps``
    greedy decode steps; the last position's logits of each."""
    from qwen_inference_engine_tpu_torch.models.qwen import (
        compute_logits,
        forward_hidden,
    )

    mesh = pmesh.make_ep_mesh(ragged=ragged)
    params_l = ep_param_shards(params, mesh)
    B, T = prompts.shape
    n = B // mesh.ep
    toks = _t(prompts[rank * n:(rank + 1) * n])
    cache = KVCache.create(cfg.num_layers, n, 32, cfg.num_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
    kw = dict(ep_group=mesh.ep_group, ep_ragged=mesh.ragged)
    pos = torch.arange(T)[None, :].expand(n, T)
    hidden, _ = forward_hidden(params_l, cfg, toks, pos, cache,
                               fresh_prefill=True, **kw)
    logits = compute_logits(params_l, hidden[:, -1])
    outs = [logits.numpy()]
    for s in range(steps):
        tok = torch.argmax(logits, dim=-1)
        hidden, _ = forward_hidden(params_l, cfg, tok[:, None],
                                   torch.full((n, 1), T + s), cache, **kw)
        logits = compute_logits(params_l, hidden[:, -1])
        outs.append(logits.numpy())
    return outs


def serve(mesh_of, rank, cfg, params, prompts, max_new, kw, draft=None):
    """Greedy ``ContinuousBatchingEngine`` under the EP mesh of the world
    (``rank`` None: one process, no mesh): every request's tokens, the
    speculation snapshot and how many batched interior-piece ticks ran."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    kw = dict(kw)
    if draft is not None:
        kw.update(draft_cfg=draft[0], draft_params=draft[1])
    kw.setdefault("sampling", SamplingParams(greedy=True))
    kw.setdefault("kv_dtype", torch.float32)
    kw.setdefault("max_slots", 4)
    cb = ContinuousBatchingEngine(
        cfg, params, mesh=None if rank is None else pmesh.make_ep_mesh(),
        page_size=8, num_pages=96, max_pages_per_seq=8, device="cpu",
        prefix_cache=False, **kw)
    batched = [0]
    if rank is not None:
        tick = cb._ep_prefill_batch_tick

        def counted(prefilling):
            did = tick(prefilling)
            batched[0] += did
            return did
        cb._ep_prefill_batch_tick = counted
    for i, pr in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=list(pr),
                          max_new_tokens=max_new))
    out = cb.run_to_completion()
    cb.check_page_invariants()
    snap = cb.metrics.snapshot()
    return ({f.request_id: f.token_ids for f in out}, snap["spec_rounds"],
            snap["spec_tokens_per_forward"], batched[0])


def piece_pools(mesh_of, rank, cfg, params, prompt):
    """One request admitted to slot 0 (rank 0's), then its first prefill
    piece: whether this rank's pool bytes changed."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=pmesh.make_ep_mesh(), max_slots=4, page_size=8,
        num_pages=32, max_pages_per_seq=8, kv_dtype=torch.float32,
        device="cpu", prefix_cache=False)
    cb.submit(Request(request_id=0, prompt=list(prompt), max_new_tokens=4))
    assert cb._try_admit()
    run = cb._slots[0]
    pools = (cb.cache.k_pages, cb.cache.v_pages)
    before = [p.clone() for p in pools]
    cb._prefill_tick(run)
    return any(not torch.equal(a, b) for a, b in zip(before, pools))


def sampled(mesh_of, rank, cfg, params, prompts, max_new):
    """A seeded sampled run (temperature, top-k, top-p, a repetition
    penalty) under the EP mesh: every request's tokens."""
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9,
                        repetition_penalty=1.2)
    return serve(mesh_of, rank, cfg, params, prompts, max_new,
                 {"sampling": sp})[0]


def http_serve_ep(mesh_of, rank, cfg, params, bodies, max_slots):
    """``tests/torch_parallel_jobs.http_serve`` under the EP mesh of the
    world: rank 0's answers, the other ranks None."""
    from tests.torch_parallel_jobs import http_serve as serve_http

    return serve_http(lambda _: pmesh.make_ep_mesh(), rank, "ep", cfg,
                      params, bodies, max_slots=max_slots)
