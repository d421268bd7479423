"""Jobs the ranks of a ``tests/torch_parallel_world.World`` run: the port
under a ``(dp, tp)`` mesh on the CPU (gloo).  Each takes ``(mesh_of, rank,
*args)`` and returns numpy arrays or plain lists; no JAX here."""

from __future__ import annotations

import numpy as np
import torch

from qwen_inference_engine_tpu_torch.kvcache.cache import (
    KVCache,
    PagedKVCache,
)
from qwen_inference_engine_tpu_torch.parallel.sharding import (
    batch_shard,
    shard_params,
)
from qwen_inference_engine_tpu_torch.parallel.tp_kernels import (
    quant_matmul_tp_column,
    quant_matmul_tp_row,
)
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    local_config,
    make_tp_decode_fn,
    make_tp_prefill_fn,
    make_tp_prefill_piece_fn,
    make_tp_verify_fn,
    sharded_argmax,
)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def warned(mesh_of, rank, job, *args):
    """``job(mesh_of, rank, *args)`` with its warnings recorded: (its
    result, the warnings' messages)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = job(mesh_of, rank, *args)
    return out, [str(w.message) for w in caught]


def tp_matmuls(mesh_of, rank, shape, lin, x, layer):
    """(this rank's column-parallel columns, the row-parallel sum) of
    ``x @ lin`` (the row product takes this rank's K shard of x)."""
    mesh = mesh_of(shape)
    x = torch.from_numpy(x)
    col = quant_matmul_tp_column(x, lin, mesh, layer=layer)
    k_l = x.shape[-1] // mesh.tp
    m = mesh.coords[1]
    row = quant_matmul_tp_row(x[..., m * k_l:(m + 1) * k_l], lin, mesh,
                              layer=layer)
    return col.numpy(), row.numpy()


def contiguous_steps(mesh_of, rank, shape, cfg, params, prompts, steps,
                     chunk):
    """The TP prefill then ``steps`` uniform decode steps (greedy by the
    sharded argmax) over this rank's rows and heads: the local logits of
    each step."""
    mesh = mesh_of(shape)
    B = prompts.shape[0]
    cfg_l = local_config(cfg, mesh.tp)
    params_l = shard_params(params, mesh)
    cache = KVCache.create(cfg.num_layers, B // mesh.dp, 64,
                           cfg_l.num_kv_heads, cfg.head_dim,
                           dtype=torch.float32)
    pre = make_tp_prefill_fn(cfg, mesh, chunk=chunk)
    dec = make_tp_decode_fn(cfg, mesh, uniform_decode=True)
    tokens = batch_shard(_t(prompts), mesh, ("data", None))
    lens = torch.full((tokens.shape[0],), prompts.shape[1])
    logits, _ = pre(params_l, tokens, lens, cache)
    outs = [logits.numpy()]
    for s in range(steps):
        tok = sharded_argmax(logits, mesh.model_group)
        logits, _ = dec(params_l, tok, lens + s, cache)
        outs.append(logits.numpy())
    return outs


def paged_steps(mesh_of, rank, shape, cfg, params, prompts, page_size,
                tables, verify, whole_row_scales=False):
    """Over a page pool of this rank's heads: each prompt's first piece
    (fresh) and second piece (a continuation), a T-token verify of every
    row and a decode step; the local logits of each (``shape`` None: one
    process)."""
    mesh = None if shape is None else mesh_of(shape)
    cfg_l = local_config(cfg, 1 if mesh is None else mesh.tp)
    params_l = params if mesh is None else shard_params(params, mesh)
    whole = dict(whole_row_scales=whole_row_scales)
    pool = PagedKVCache.create(cfg.num_layers, 32, page_size,
                               cfg_l.num_kv_heads, cfg.head_dim,
                               dtype=torch.float32)
    tables = _t(tables, torch.int32)
    piece = make_tp_prefill_piece_fn(cfg, mesh, last=True, **whole)
    outs = []
    half = prompts.shape[1] // 2
    for r in range(prompts.shape[0]):
        for start, n in ((0, half), (half, prompts.shape[1] - half)):
            toks = _t(prompts[r:r + 1, start:start + n])
            outs.append(piece(params_l, toks, start, n, pool,
                              tables[r:r + 1]).numpy())
    pos0 = torch.full((prompts.shape[0],), prompts.shape[1])
    vfn = make_tp_verify_fn(cfg, mesh, T=verify.shape[1], **whole)
    logits, _ = vfn(params_l, _t(verify), pos0, pool, tables)
    outs.append(logits.numpy())
    dec = make_tp_decode_fn(cfg, mesh, paged=True, **whole)
    logits, _ = dec(params_l, _t(verify[:, -1]), pos0 + verify.shape[1],
                    pool, tables)
    outs.append(logits.numpy())
    return outs


def engine_generate(mesh_of, rank, shape, cfg, params, prompts, max_new):
    """Greedy ``Engine.generate`` under the mesh: every rank's tokens."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    eng = Engine(cfg, params, mesh=mesh_of(shape),
                 max_batch=-(-len(prompts) // shape[0]) * shape[0],
                 max_seq=64, kv_dtype=torch.float32,
                 sampling=SamplingParams(greedy=True), device="cpu")
    return eng.generate(prompts, max_new_tokens=max_new).token_ids


def serve(mesh_of, rank, shape, cfg, params, prompts, max_new, kw,
          oracle=None, draft=None):
    """Greedy ``ContinuousBatchingEngine`` under the mesh: every request's
    tokens and the speculation snapshot.  ``oracle``: host drafts of the
    known continuation through ``step()`` (prompt lookup at full
    acceptance); ``draft``: the drafter's (cfg, params)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    if draft is not None:
        kw = dict(kw, draft_cfg=draft[0], draft_params=draft[1])
    cb = ContinuousBatchingEngine(
        cfg, params, mesh=None if shape is None else mesh_of(shape),
        max_slots=2, page_size=8, num_pages=64, max_pages_per_seq=16,
        sampling=SamplingParams(greedy=True), kv_dtype=torch.float32,
        device="cpu", **kw)
    k = cb.spec_k
    if oracle is not None:
        def host_draft(run):
            i = len(run.generated)
            cont = list(oracle[run.request.request_id][i:i + k])
            return cont + [0] * (k - len(cont)) if cont else None
        cb._pld_draft_host = host_draft
    for i, pr in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=pr, max_new_tokens=max_new))
    if oracle is not None:
        out = []
        while cb.has_work():
            out += cb.step()
        out += cb._drain_finished()
    else:
        out = cb.run_to_completion()
    snap = cb.metrics.snapshot()
    return ({f.request_id: f.token_ids for f in out},
            snap["spec_rounds"], snap["spec_tokens_per_forward"])


def serve_deadlines(mesh_of, rank, shape, cfg, params, prompts, max_new):
    """``run_to_completion`` under the mesh (no server) with request 0 past
    its deadline at once and the others under a long one: every request's
    (finish reason, tokens)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    cb = ContinuousBatchingEngine(
        cfg, params, mesh=None if shape is None else mesh_of(shape),
        max_slots=2, page_size=8, num_pages=64, max_pages_per_seq=16,
        sampling=SamplingParams(greedy=True), kv_dtype=torch.float32,
        device="cpu")
    for i, pr in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=pr, max_new_tokens=max_new,
                          timeout_s=0.0 if i == 0 else 600.0))
    return {f.request_id: (f.finish_reason, f.token_ids)
            for f in cb.run_to_completion()}


def argmax_ties(mesh_of, rank, shape, logits):
    """The sharded argmax of this rank's columns of ``logits``."""
    mesh = mesh_of(shape)
    v_l = logits.shape[-1] // mesh.tp
    m = mesh.coords[1]
    local = torch.from_numpy(logits[:, m * v_l:(m + 1) * v_l])
    return sharded_argmax(local, mesh.model_group).numpy()


def sample_sharded(mesh_of, rank, shape, logits, seen, kind, seed):
    """``sample`` / ``sample_rows`` on this rank's vocabulary shard, a
    generator seeded alike on every rank."""
    from qwen_inference_engine_tpu_torch.parallel.tp_step import (
        ShardedVocab,
    )

    mesh = mesh_of(shape)
    v_l = logits.shape[-1] // mesh.tp
    m = mesh.coords[1]
    local = torch.from_numpy(logits[:, m * v_l:(m + 1) * v_l])
    vocab = ShardedVocab(mesh.model_group, v_l)
    return draw(local, torch.from_numpy(seen), kind, seed, vocab)


def draw(logits, seen, kind, seed, vocab=None):
    """One sampling call of ``kind`` on ``logits`` (a shard under
    ``vocab``)."""
    from qwen_inference_engine_tpu_torch.ops.sampling import (
        SamplingParams,
        sample,
        sample_rows,
    )

    gen = torch.Generator().manual_seed(seed)
    B = logits.shape[0]
    if kind == "rows":
        def col(v, dtype=torch.float32):
            return torch.full((B,), v, dtype=dtype)

        return sample_rows(
            logits, gen, k_cap=24, temperature=col(0.8), top_p=col(0.9),
            top_k=torch.tensor([0, 5, 24, 3][:B]),
            greedy=torch.tensor([False, False, True, False][:B]),
            repetition_penalty=col(1.3), presence_penalty=col(0.2),
            seen_mask=seen, vocab=vocab).numpy()
    sp = {"greedy": SamplingParams(greedy=True, repetition_penalty=1.3),
          "top_k": SamplingParams(top_k=7, top_p=0.8,
                                  repetition_penalty=1.3),
          "top_p": SamplingParams(top_k=0, top_p=0.7),
          "plain": SamplingParams(top_k=0, temperature=1.2)}[kind]
    return sample(logits, sp, seen, gen, vocab=vocab).numpy()



def http_serve(mesh_of, rank, shape, cfg, params, bodies, max_slots=2):
    """``Server`` under the mesh: rank 0 serves HTTP and answers
    ``bodies`` (POST /generate, one after another, then two at once),
    the other ranks follow its ticks until it shuts down.  Rank 0 returns
    the answers, the others None."""
    import http.client
    import json
    import threading
    import types
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    from qwen_inference_engine_tpu_torch.server.http import (
        Server,
        _make_handler,
    )
    from qwen_inference_engine_tpu_torch.tokenizer import ByteTokenizer

    args = types.SimpleNamespace(
        temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
        greedy=True, max_slots=max_slots, page_size=8, num_pages=64,
        max_seq=64, kv_bits=32, seed=0, device="cpu")
    server = Server(cfg, params, ByteTokenizer(),
                    None if shape is None else mesh_of(shape), args)
    if shape is not None and rank != 0:
        server.follow()
        return None
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=60)
        conn.request("POST", "/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        out = json.loads(conn.getresponse().read())
        return out["token_ids"], out["finish_reason"]

    try:
        answers = [post(b) for b in bodies]
        with ThreadPoolExecutor(2) as pool:
            answers += list(pool.map(post, bodies[:2]))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(timeout=10)
    return answers


def spec_model_round(mesh_of, rank, shape, cfg, params, prompts, page_size,
                     tables, k):
    """One draft-model round (a drafter equal to the target) over page
    pools of this rank's heads, after each prompt's prefill piece: the
    local verify logits and the drafts (``shape`` None: one process)."""
    from qwen_inference_engine_tpu_torch.parallel.tp_step import (
        make_tp_spec_model_fn,
    )

    mesh = None if shape is None else mesh_of(shape)
    tp = 1 if mesh is None else mesh.tp
    params_l = params if mesh is None else shard_params(params, mesh)
    pools = [PagedKVCache.create(cfg.num_layers, 32, page_size,
                                 cfg.num_kv_heads // tp, cfg.head_dim,
                                 dtype=torch.float32) for _ in range(2)]
    tables = _t(tables, torch.int32)
    piece = make_tp_prefill_piece_fn(cfg, mesh, last=False)
    for r in range(prompts.shape[0]):
        for pool in pools:
            piece(params_l, _t(prompts[r:r + 1]), 0, prompts.shape[1], pool,
                  tables[r:r + 1])
    fn = make_tp_spec_model_fn(cfg, cfg, mesh, k=k)
    n = prompts.shape[1]
    logits, drafts = fn(params_l, params_l, _t(prompts[:, -1]),
                        torch.full((prompts.shape[0],), n - 1), pools[0],
                        pools[1], tables)
    return logits.numpy(), drafts.numpy()


def serve_waves(mesh_of, rank, shape, cfg, params, waves, max_new, kw,
                draft=None):
    """Greedy ``ContinuousBatchingEngine`` on 4 slots under the mesh
    (``shape`` None: one process), prefix cache on: each wave of prompts
    submitted and drained in turn, request ids numbered across waves.
    ``check_page_invariants`` must hold after every wave.  Returns
    ({request id: (finish reason, tokens)}, the prefix hit tokens after
    each wave, spec rounds, pages copied between data groups)."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

    if draft is not None:
        kw = dict(kw, draft_cfg=draft[0], draft_params=draft[1])
    kw = dict(dict(kv_dtype=torch.float32), **kw)
    cb = ContinuousBatchingEngine(
        cfg, params, mesh=None if shape is None else mesh_of(shape),
        max_slots=4, page_size=8, num_pages=64, max_pages_per_seq=16,
        sampling=SamplingParams(greedy=True), device="cpu", **kw)
    out, hits, rid = {}, [], 0
    for wave in waves:
        for pr in wave:
            cb.submit(Request(request_id=rid, prompt=list(pr),
                              max_new_tokens=max_new))
            rid += 1
        for f in cb.run_to_completion():
            out[f.request_id] = (f.finish_reason, f.token_ids)
        cb.check_page_invariants()
        hits.append(cb.metrics.snapshot()["prefix_hit_tokens"])
    return (out, hits, cb.metrics.snapshot()["spec_rounds"],
            cb.pages_shared)


def spec_generate(mesh_of, rank, shape, cfg, params, prompts, max_new,
                  max_batch, k=4, kv_dtype=torch.float32):
    """``Engine.generate_speculative`` under the mesh (``shape`` None: one
    process): every rank's ids."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine

    eng = Engine(cfg, params, mesh=None if shape is None else mesh_of(shape),
                 max_batch=max_batch, max_seq=64, kv_dtype=kv_dtype,
                 device="cpu")
    return eng.generate_speculative(prompts, max_new_tokens=max_new, k=k)
