"""The port's engines under a mesh in gloo worlds of CPU processes vs the
JAX engines on the virtual mesh of the same shape: greedy
``Engine.generate`` at (1, 2), (1, 4) and (2, 2), the serving engine under
pure TP (paged pool, MoE, prompt lookup, a drafter), every rank's tokens
equal; and ``generate --tp / --dp`` against ``--tp 1``.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

from qwen_inference_engine_tpu.parallel import tp_step as jtp
from qwen_inference_engine_tpu.parallel.sharding import (
    shard_params as j_shard_params,
)
from tests import torch_parallel_jobs as jobs
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    MOE_KW,
    SHAPES,
    TP_SHAPES,
    jmesh,
    models,
    run,
    worlds,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PROMPTS = [[5, 9, 17, 3], [100, 200, 300, 400, 500, 42], [7, 7, 7],
           [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]]


@pytest.mark.parametrize("case", ["f32", "int8", "moe"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_engine_generate_tokens_match_jax(worlds, shape, case):
    """Greedy ``Engine.generate`` under the mesh: every rank returns the
    whole batch, equal to the JAX engine's on the same mesh (its TP step
    under a (2, 2) mesh as under pure TP)."""
    from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )

    jcfg, jparams, tcfg, tparams = models(
        MOE_KW if case == "moe" else CFG_KW, bits=8 if case == "int8" else 16,
        seed=5)
    mesh = jmesh(shape)
    assert jtp.supports_tp(jcfg, jparams, shape[1])
    jeng = JEngine(jcfg, j_shard_params(jparams, mesh), mesh=mesh,
                   max_batch=4, max_seq=64, kv_dtype=jnp.float32,
                   sampling=JSamplingParams(greedy=True))
    want = jeng.generate(PROMPTS, max_new_tokens=6).token_ids
    got = run(worlds, shape, jobs.engine_generate, tcfg, tparams, PROMPTS,
               6)
    for r, toks in enumerate(got):
        assert toks == want, (r, toks, want)


def _j_serve(jcfg, jparams, mesh, prompts, max_new, **kw):
    from qwen_inference_engine_tpu.engine.scheduler import (
        ContinuousBatchingEngine as JCB,
        Request as JRequest,
    )
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )

    p = jparams if mesh is None else j_shard_params(jparams, mesh)
    if "draft_params" in kw and mesh is not None:
        kw["draft_params"] = p
    cb = JCB(jcfg, p, mesh=mesh, max_slots=2, page_size=8, num_pages=64,
             max_pages_per_seq=16, sampling=JSamplingParams(greedy=True),
             kv_dtype=jnp.float32, **kw)
    for i, pr in enumerate(prompts):
        cb.submit(JRequest(request_id=i, prompt=pr, max_new_tokens=max_new))
    return {f.request_id: f.token_ids for f in cb.run_to_completion()}


SERVE_PROMPTS = [[5, 9, 17, 3] * 3, [40, 41, 42, 43] * 3,
                 [100, 200, 300, 400, 500, 42]]


@pytest.mark.parametrize("case", ["paged", "moe", "moe int8"])
@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_scheduler_tokens_match_jax(worlds, shape, case):
    """Greedy ``ContinuousBatchingEngine`` over the paged pool under pure
    TP (chained ticks, prefill pieces, a slot reused), equal to the JAX
    scheduler on the same mesh, on every rank; MoE with its experts split
    over the model group, bf16-stack and INT8 experts."""
    kw = MOE_KW if case.startswith("moe") else CFG_KW
    jcfg, jparams, tcfg, tparams = models(
        kw, bits=8 if case.endswith("int8") else 16, seed=7)
    want = _j_serve(jcfg, jparams, jmesh(shape), SERVE_PROMPTS, 8)
    got = run(worlds, shape, jobs.serve, tcfg, tparams, SERVE_PROMPTS, 8,
               {})
    for r, (toks, _, _) in enumerate(got):
        assert toks == want, (r, toks, want)


@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_scheduler_prompt_lookup_under_tp_matches_jax(worlds, shape):
    """Prompt-lookup speculation under TP: host drafts of the known greedy
    continuation (full acceptance, through ``step()``) and the chained
    device drafts (``run_to_completion``) both equal the JAX
    non-speculative scheduler's tokens, on every rank."""
    jcfg, jparams, tcfg, tparams = models(seed=7)
    want = _j_serve(jcfg, jparams, None, SERVE_PROMPTS, 8)
    assert want == _j_serve(jcfg, jparams, jmesh(shape), SERVE_PROMPTS, 8,
                            speculative=True, spec_k=3, spec_ngram=2)
    spec = {"speculative": True, "spec_k": 3, "spec_ngram": 2}
    got = run(worlds, shape, jobs.serve, tcfg, tparams, SERVE_PROMPTS, 8,
               spec, want)
    for r, (toks, rounds, tpf) in enumerate(got):
        assert toks == want and rounds > 0 and tpf > 2.0, (r, rounds, tpf)
    got = run(worlds, shape, jobs.serve, tcfg, tparams, SERVE_PROMPTS, 8,
               spec)
    for r, (toks, rounds, _) in enumerate(got):
        assert toks == want and rounds > 0, (r, toks, want)


@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_scheduler_deadlines_under_tp_expire_on_every_rank(worlds, shape):
    """Deadlines under a mesh without the HTTP server: rank 0's clock
    decides and every rank expires the same requests in the same step, so
    a request past its deadline ends "timeout" and the others finish as in
    one process, on every rank."""
    _, _, tcfg, tparams = models(seed=7)
    want = jobs.serve_deadlines(None, 0, None, tcfg, tparams, SERVE_PROMPTS,
                                8)
    assert want[0] == ("timeout", [])
    assert all(why == "length" for why, _ in list(want.values())[1:])
    got = run(worlds, shape, jobs.serve_deadlines, tcfg, tparams,
              SERVE_PROMPTS, 8)
    for r, toks in enumerate(got):
        assert toks == want, (r, toks, want)


@pytest.mark.parametrize("case", ["dense", "moe"])
@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_scheduler_drafter_under_tp_matches_jax(worlds, shape, case):
    """A drafter equal to the target, split over the same model group (the
    sharded argmax drives its chain): tokens equal to the JAX TP drafter
    run and to the non-speculative scheduler, about k + 1 tokens a
    forward, on every rank."""
    kw = MOE_KW if case == "moe" else CFG_KW
    jcfg, jparams, tcfg, tparams = models(kw, seed=7)
    want = _j_serve(jcfg, jparams, None, SERVE_PROMPTS, 8)
    if case == "dense":
        assert want == _j_serve(jcfg, jparams, jmesh(shape), SERVE_PROMPTS,
                                8, speculative=True, spec_k=3,
                                draft_params=jparams, draft_cfg=jcfg)
    got = run(worlds, shape, jobs.serve, tcfg, tparams, SERVE_PROMPTS, 8,
               {"speculative": True, "spec_k": 3}, None, (tcfg, tparams))
    for r, (toks, rounds, tpf) in enumerate(got):
        assert toks == want and rounds > 0 and tpf > 3.0, (r, rounds, tpf)


@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_drafter_that_does_not_split_drafts_by_prompt_lookup(worlds, shape):
    """JAX engine/scheduler.py:201-220: a drafter whose one KV head does
    not split over the model axis warns and serves with prompt-lookup
    drafts: every rank warns, and its tokens equal the JAX TP scheduler's
    downgraded run (which warns alike), speculation rounds run."""
    from qwen_inference_engine_tpu.engine.scheduler import (
        ContinuousBatchingEngine as JCB,
        Request as JRequest,
    )
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )

    jcfg, jparams, tcfg, tparams = models(seed=7)
    dkw = dict(CFG_KW, num_heads=4, num_kv_heads=1)
    djcfg, djparams, dtcfg, dtparams = models(dkw, seed=8)
    mesh = jmesh(shape)
    with pytest.warns(UserWarning, match="draft model does not shard over "
                                         "this TP mesh"):
        cb = JCB(jcfg, j_shard_params(jparams, mesh), mesh=mesh, max_slots=2,
                 page_size=8, num_pages=64, max_pages_per_seq=16,
                 sampling=JSamplingParams(greedy=True), kv_dtype=jnp.float32,
                 speculative=True, spec_k=3, draft_params=djparams,
                 draft_cfg=djcfg)
    assert not cb._model_draft
    for i, pr in enumerate(SERVE_PROMPTS):
        cb.submit(JRequest(request_id=i, prompt=pr, max_new_tokens=8))
    want = {f.request_id: f.token_ids for f in cb.run_to_completion()}
    got = worlds(shape[0] * shape[1]).run(
        jobs.warned, jobs.serve, shape, tcfg, tparams, SERVE_PROMPTS, 8,
        {"speculative": True, "spec_k": 3}, None, (dtcfg, dtparams))
    for r, ((toks, rounds, _), msgs) in enumerate(got):
        assert toks == want and rounds > 0, (r, toks, want)
        assert any("draft model does not shard over this TP mesh (head/"
                   "group alignment); falling back to prompt-lookup "
                   "speculation" in m for m in msgs), msgs


@pytest.mark.parametrize("shape", TP_SHAPES, ids=str)
def test_http_server_over_tp_ranks_answers_as_one_rank(worlds, shape):
    """``qie serve --tp N``'s ``Server``: rank 0 serves HTTP and sends each
    tick's admissions to the other ranks, which follow its ticks; its
    answers (one request at a time, then two at once) equal the
    single-rank server's, and every rank stops with rank 0."""
    _, _, tcfg, tparams = models(dict(CFG_KW, vocab_size=260), seed=9)
    bodies = [{"prompt": "tensor parallel", "max_new_tokens": 6},
              {"prompt": [5, 9, 17, 3, 5, 9], "max_new_tokens": 8},
              {"prompt": "abc", "max_new_tokens": 4, "greedy": True}]
    want = jobs.http_serve(None, 0, None, tcfg, tparams, bodies)
    got = run(worlds, shape, jobs.http_serve, tcfg, tparams, bodies)
    assert got[0] == want and all(g is None for g in got[1:])


# -------------------------------------------------------------------- CLI
@functools.lru_cache(maxsize=None)
def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "qwen_inference_engine_tpu_torch.server.cli",
         "generate", "--model", "tiny", "--device", "cpu", "--greedy",
         "--kv-bits", "32", "--max-new-tokens", "6", "--prompt", "hello",
         "--prompt", "tensor parallel", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("mesh", [("--tp", "2"), ("--dp", "2"),
                                  ("--tp", "2", "--dp", "2")],
                         ids=["tp2", "dp2", "dp2tp2"])
def test_cli_generate_over_ranks_prints_the_single_rank_output(mesh):
    """``generate --tp / --dp --device cpu`` spawns the ranks (gloo) and
    rank 0 alone prints: the same sequences as ``--tp 1``."""
    assert _cli(*mesh) == _cli("--tp", "1")
