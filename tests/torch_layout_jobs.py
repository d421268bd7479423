"""Jobs the ranks of a ``tests/torch_parallel_world.World`` run for the TP
layouts of models that do not split evenly (``parallel/tp_step.
TpLayout``): the port on the CPU (gloo), no JAX here.  Each takes
``(mesh_of, rank, *args)`` and returns plain values."""

from __future__ import annotations

import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.parallel.sharding import (
    batch_shard,
    shard_params,
)
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    make_tp_prefill_fn,
    make_tp_sp_prefill_fn,
    tp_layout,
)


def _serve(cfg, params, mesh, prompts, max_new, **kw):
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=mesh, max_slots=2, page_size=8, num_pages=64,
        max_pages_per_seq=16, sampling=SamplingParams(greedy=True),
        kv_dtype=torch.float32, device="cpu", **kw)
    for i, pr in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=pr, max_new_tokens=max_new))
    out = {f.request_id: f.token_ids for f in cb.run_to_completion()}
    return out, cb.metrics.snapshot(), cb


def every_entry_point(mesh_of, rank, shape, cfg, params, prompts, max_new):
    """The four entry points under the mesh on one model: greedy
    ``Engine.generate``, ``generate_speculative`` (k 3), the serving
    engine over prompts that share a 16-token prefix (two slots, so the
    third request hits the first one's pages) and the serving engine with
    the model as its own drafter.  Returns each one's ids, the layout's
    summary, the local cache's KV heads, the prefix hits and the draft
    rounds."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    mesh = mesh_of(shape)
    eng = Engine(cfg, params, mesh=mesh,
                 max_batch=-(-len(prompts) // shape[0]) * shape[0],
                 max_seq=64, kv_dtype=torch.float32,
                 sampling=SamplingParams(greedy=True), device="cpu")
    gen = eng.generate(prompts, max_new_tokens=max_new).token_ids
    spec = eng.generate_speculative(prompts, max_new_tokens=max_new, k=3)
    served, snap, cb = _serve(cfg, params, mesh, prompts, max_new)
    drafted, dsnap, dcb = _serve(cfg, params, mesh, prompts, max_new,
                                 speculative=True, spec_k=3,
                                 draft_params=params, draft_cfg=cfg)
    return {"generate": gen, "speculative": spec,
            "serve": [served[i] for i in range(len(prompts))],
            "drafter": [drafted[i] for i in range(len(prompts))],
            "layout": eng.layout.summary(),
            "cache_kv_heads": (eng.new_cache().k.shape[2],
                               cb.cache.k_pages.shape[2],
                               dcb.draft_cache.k_pages.shape[2]),
            "prefix_hit_tokens": snap["prefix_hit_tokens"],
            "draft_rounds": dsnap["spec_rounds"],
            "model_draft": dcb._model_draft}


def prefill_cache(mesh_of, rank, shape, cfg, params, prompts):
    """The TP prefill of ``prompts [B, T]`` in the model's layout: this
    rank's logits and its local cache's K and V."""
    mesh = mesh_of(shape)
    layout = tp_layout(cfg, params, mesh.tp)
    params_l = shard_params(params, mesh, layout)
    cfg_l = layout.local_config(cfg)
    B, T = prompts.shape
    cache = KVCache.create(cfg.num_layers, B, 64, cfg_l.num_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
    fn = make_tp_prefill_fn(cfg, mesh, layout=layout)
    logits, cache = fn(params_l, torch.from_numpy(prompts),
                       torch.full((B,), T), cache)
    return logits.numpy(), cache.k.numpy(), cache.v.numpy()


def sp_prefill(mesh_of, rank, shape, cfg, params, prompts, lengths):
    """The sequence-parallel prefill of ``prompts [B, T]`` (this rank's
    ``T / tp`` tokens of each row, ``batch_shard(..., (None, "model"))``):
    its logits, the collectives it called (launches of each) and its
    local cache's K."""
    from qwen_inference_engine_tpu_torch.utils.metrics import (
        collective_wrappers,
    )

    mesh = mesh_of(shape)
    layout = tp_layout(cfg, params, mesh.tp)
    params_l = shard_params(params, mesh, layout)
    cfg_l = layout.local_config(cfg)
    B, T = prompts.shape
    cache = KVCache.create(cfg.num_layers, B, 64, cfg_l.num_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
    tokens_l = batch_shard(torch.from_numpy(prompts), mesh, (None, "model"))
    fn = make_tp_sp_prefill_fn(cfg, mesh, layout=layout)
    counts = collective_wrappers()
    before = {n: w.launches for n, w in counts.items()}
    logits, cache = fn(params_l, tokens_l, torch.from_numpy(lengths), cache)
    calls = {n: w.launches - before[n] for n, w in counts.items()}
    return logits.numpy(), {n: c for n, c in calls.items() if c}, \
        cache.k.numpy(), tuple(tokens_l.shape)


def gspmd_step_paths(mesh_of, rank, shape, cfg, params, prompts):
    """One prefill and one decode step of the serving engine in the
    model's layout, with ``fused_mlp`` replaced by a recorder and the
    collectives counted: (this rank's fused_mlp calls, its all-reduces and
    all-gathers during the decode step, the layout's formula for one
    forward, ``fused_mlp_supported`` of this rank's shards at the step's
    rows)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.ops.fused_step import (
        fused_mlp_supported,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.parallel import mesh as mesh_mod

    calls = []
    real = qwen.fused_mlp
    qwen.fused_mlp = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        cb = ContinuousBatchingEngine(
            cfg, params, mesh=mesh_of(shape), max_slots=1, page_size=8,
            num_pages=16, max_pages_per_seq=8,
            sampling=SamplingParams(greedy=True), kv_dtype=torch.float32,
            device="cpu")
        cb.submit(Request(request_id=0, prompt=prompts[0], max_new_tokens=3))
        while cb._slots[0] is None or not cb._slots[0].generated:
            cb.step()
        before = (mesh_mod.all_reduce.launches, mesh_mod.all_gather.launches)
        cb.step()
        during = (mesh_mod.all_reduce.launches - before[0],
                  mesh_mod.all_gather.launches - before[1])
    finally:
        qwen.fused_mlp = real
    lyr = cb.params["layers"]
    supported = fused_mlp_supported(lyr["gate"], lyr["up"], lyr["down"], 1)
    return (len(calls), during,
            cb.layout.collectives(cfg.num_layers, cfg.act_bits), supported,
            cb.layout.summary())
