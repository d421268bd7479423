"""The port's serving engine under an expert-parallel mesh, in gloo worlds
of 2 and 4 CPU processes, against the JAX package's schedulers.

A tiny Qwen3-MoE (8 experts, top-2, f32, ``tests/torch_parallel_ref.
models``) served on 4 slots.  Greedy tokens of every rank equal, at ep 2
and 4, the JAX single-device scheduler's in every case: plain, prompt
lookup, batched interior prefill pieces (``prefill_chunk`` 8, four long
prompts: the batched tick must run), a dense drafter, an INT8 pool; and
the JAX EP scheduler's in the plain case.  Also: a non-owner's pool bytes
stay as they were across a prefill piece; a seeded sampled run draws the
same tokens on every rank; ``Server`` over ep ranks answers as one rank
does; ``serve --ep 2 --device cpu`` answers HTTP as ``serve`` does.
"""

import functools
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from tests import torch_ep_jobs as jobs
from tests.torch_parallel_jobs import http_serve, warned
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    MOE_KW,
    models,
    worlds,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REP = [11, 12, 13, 14] * 5
PROMPTS = {
    "plain": [[5, 9, 17, 3], list(range(30, 44)), [7, 8, 9],
              [100, 200, 300, 400, 250]],
    "prompt lookup": [REP, [7, 8, 9], list(range(40, 52)), REP[:12]],
    "batched pieces": [[(7 * i + j) % 300 + 1 for j in range(21 + 3 * i)]
                       for i in range(4)],
}
PROMPTS["drafter"] = PROMPTS["plain"]
PROMPTS["int8 pool"] = PROMPTS["plain"]
KW = {"plain": {}, "prompt lookup": {"speculative": True, "spec_k": 3},
      "batched pieces": {"prefill_chunk": 8},
      "drafter": {"speculative": True, "spec_k": 3},
      "int8 pool": {"kv_dtype": torch.int8}}


@functools.lru_cache(maxsize=None)
def _moe():
    return models(MOE_KW, seed=7)


@functools.lru_cache(maxsize=None)
def _j_serve(case, ep=None):
    """The JAX scheduler's greedy tokens (single device, or its EP
    scheduler on the virtual mesh of ``ep``), non-speculative."""
    from qwen_inference_engine_tpu.engine.scheduler import (
        ContinuousBatchingEngine as JCB,
        Request as JRequest,
    )
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )
    from qwen_inference_engine_tpu.parallel.ep_step import (
        make_ep_mesh,
        shard_for_ep,
    )

    jcfg, jparams, _, _ = _moe()
    mesh = None if ep is None else make_ep_mesh(ep)
    cb = JCB(jcfg, jparams if mesh is None else shard_for_ep(jparams, mesh),
             mesh=mesh, max_slots=4, page_size=8, num_pages=96,
             max_pages_per_seq=8, sampling=JSamplingParams(greedy=True),
             kv_dtype=jnp.int8 if case == "int8 pool" else jnp.float32,
             prefix_cache=False,
             prefill_chunk=8 if case == "batched pieces" else 256)
    if ep is not None:
        assert cb._ep_step
    for i, pr in enumerate(PROMPTS[case]):
        cb.submit(JRequest(request_id=i, prompt=pr, max_new_tokens=6))
    return {f.request_id: f.token_ids for f in cb.run_to_completion()}


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("case", list(KW))
def test_scheduler_tokens_match_jax(worlds, case, ep):
    _, _, tcfg, tparams = _moe()
    want = _j_serve(case)
    if case == "plain" and ep == 4:
        assert _j_serve(case, ep) == want
    draft = models(CFG_KW, seed=5)[2:] if case == "drafter" else None
    got = worlds(ep).run(jobs.serve, tcfg, tparams, PROMPTS[case], 6,
                         KW[case], draft, timeout=240)
    for r, (toks, rounds, tpf, batched) in enumerate(got):
        assert toks == want, (r, toks, want)
        if case == "prompt lookup":
            assert rounds > 0 and tpf > 1.0, (rounds, tpf)
        if case == "drafter":
            assert rounds > 0
        if case == "batched pieces":
            assert batched > 0, "the batched interior pieces did not run"


def test_moe_drafter_under_ep_drafts_by_prompt_lookup(worlds):
    """JAX engine/scheduler.py:151-161: an MoE draft model under the EP
    mesh warns and serves with prompt-lookup drafts: every rank warns, and
    its tokens equal the JAX EP scheduler's downgraded run (which warns
    alike), speculation rounds run and no drafter is kept."""
    from qwen_inference_engine_tpu.engine.scheduler import (
        ContinuousBatchingEngine as JCB,
        Request as JRequest,
    )
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )
    from qwen_inference_engine_tpu.parallel.ep_step import (
        make_ep_mesh,
        shard_for_ep,
    )

    jcfg, jparams, tcfg, tparams = _moe()
    prompts = PROMPTS["prompt lookup"]
    mesh = make_ep_mesh(2)
    with pytest.warns(UserWarning, match="MoE draft models are not "
                                         "supported under the EP mesh"):
        cb = JCB(jcfg, shard_for_ep(jparams, mesh), mesh=mesh, max_slots=4,
                 page_size=8, num_pages=96, max_pages_per_seq=8,
                 sampling=JSamplingParams(greedy=True), kv_dtype=jnp.float32,
                 prefix_cache=False, speculative=True, spec_k=3,
                 draft_params=jparams, draft_cfg=jcfg)
    assert cb._ep_step and not cb._model_draft
    for i, pr in enumerate(prompts):
        cb.submit(JRequest(request_id=i, prompt=pr, max_new_tokens=6))
    want = {f.request_id: f.token_ids for f in cb.run_to_completion()}
    got = worlds(2).run(warned, jobs.serve, tcfg, tparams, prompts, 6,
                        KW["prompt lookup"], (tcfg, tparams), timeout=240)
    for r, ((toks, rounds, _, _), msgs) in enumerate(got):
        assert toks == want and rounds > 0, (r, toks, want)
        assert any("MoE draft models are not supported under the EP mesh; "
                   "using prompt-lookup drafts" in m for m in msgs), msgs


def test_a_piece_leaves_a_non_owners_pool_alone(worlds):
    """Slot 0 belongs to rank 0: its first prefill piece writes rank 0's
    pool, and every other rank's pool keeps its bytes (the JAX step's
    ``where(owner, new, old)``)."""
    _, _, tcfg, tparams = _moe()
    changed = worlds(2).run(jobs.piece_pools, tcfg, tparams,
                            list(range(3, 20)))
    assert changed == [True, False]


def test_sampled_tokens_are_equal_on_every_rank(worlds):
    """A seeded sampled run: every rank samples the whole batch's gathered
    logits with the same generator, so every rank draws the same tokens."""
    _, _, tcfg, tparams = _moe()
    got = worlds(2).run(jobs.sampled, tcfg, tparams, PROMPTS["plain"], 8)
    assert got[0] == got[1] and all(len(t) == 8 for t in got[0].values())


BODIES = [{"prompt": "expert parallel", "max_new_tokens": 6},
          {"prompt": [5, 9, 17, 3, 5, 9], "max_new_tokens": 8},
          {"prompt": "abc", "max_new_tokens": 4, "greedy": True}]


def test_http_server_over_ep_ranks_answers_as_one_rank(worlds):
    """The counterpart of ``tests/test_http.py``'s EP test: rank 0 serves
    HTTP and the other ranks follow its ticks; its answers equal the
    single-rank server's."""
    _, _, tcfg, tparams = models(dict(MOE_KW, vocab_size=260), seed=9)
    want = http_serve(None, 0, None, tcfg, tparams, BODIES, max_slots=4)
    got = worlds(4).run(jobs.http_serve_ep, tcfg, tparams, BODIES, 4,
                        timeout=240)
    assert got[0] == want and all(g is None for g in got[1:])


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out["token_ids"], out["finish_reason"]


def _serve_answers(*extra):
    """Start ``serve --model tiny-moe --device cpu`` with ``extra`` flags,
    post BODIES, stop it: the answers."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen_inference_engine_tpu_torch.server.cli",
         "serve", "--model", "tiny-moe", "--device", "cpu", "--greedy",
         "--kv-bits", "32", "--page-size", "16", "--max-seq", "128",
         "--max-slots", "2", "--no-prefix-cache", "--port", str(port),
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        deadline = time.time() + 180
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                       timeout=5).read()
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(proc.communicate()[0])
                time.sleep(0.5)
        return [_post(port, b) for b in BODIES]
    finally:
        # the server and the ranks it spawned: one process group
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def test_cli_serve_ep2_answers_as_one_rank():
    """``serve --ep 2 --device cpu`` spawns two gloo ranks over the EP mesh
    and answers as ``serve`` on one process does."""
    assert _serve_answers("--ep", "2") == _serve_answers()
