"""The port's serving engine under a ``(data, model)`` mesh with a data axis
above 1, in gloo worlds of 2 and 4 CPU processes, against the JAX
package's scheduler on the virtual mesh of the same shape (GSPMD's run,
whose tokens equal the run without a mesh).

A tiny 2-layer Qwen2 (f32, ``tests/torch_parallel_ref.models``) served on
4 slots over pages of 8, prefix cache on, in two waves: the second wave's
prompts share a prefix with first-wave requests whose pages another data
group wrote (a whole-page hit and a partial-tail copy), so the port's
cross-group page copy runs.  Every rank's tokens, finish reasons and
prefix hits equal the JAX scheduler's under the same mesh, and the page
invariants hold on every rank after each wave, at (2, 1), (4, 1) and
(2, 2); also prompt lookup and a dense drafter, a tiny MoE at (2, 2) and
an INT8 pool (every prompt one prefill piece: one plan), and a W4A8
model, whose row-parallel activations take GSPMD's whole-row scales.  ``Server`` over
data ranks answers as one rank, and so does ``serve --dp 2 --device
cpu``.
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
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.parallel.sharding import (
    shard_params as j_shard_params,
)
from tests import torch_parallel_jobs as jobs
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    MOE_KW,
    jmesh,
    models,
    run,
    vocab_cat,
    worlds,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REP = [11, 12, 13, 14] * 4
WAVE1 = [[5, 9, 17, 3, 8], list(range(30, 50)), REP[:11],
         list(range(100, 121))]
# slot 0 (data group 0) takes the first: a page and 5 rows of slot 3's
# request (group 1 at dp 2 and 4), the partial tail through a copy
WAVE2 = [WAVE1[3][:13] + [44, 45, 46], WAVE1[1][:16] + [1, 2], REP]
WAVES = (WAVE1, WAVE2)
NEW = 8
# each case's engine keywords and whether it drafts with a model
CASES = {"plain": ({}, False),
         "prompt lookup": ({"speculative": True, "spec_k": 3,
                            "spec_ngram": 2}, False),
         "drafter": ({"speculative": True, "spec_k": 3}, True),
         "moe": ({}, False),
         "int8 pool": ({"kv_dtype": torch.int8}, False),
         "w4a8": ({}, False)}


@functools.lru_cache(maxsize=None)
def _models(case):
    if case == "w4a8":
        return models(dict(CFG_KW, num_layers=2, act_bits=8), bits=4,
                      seed=7)
    kw = MOE_KW if case == "moe" else CFG_KW
    return models(dict(kw, num_layers=2), seed=7)


@functools.lru_cache(maxsize=None)
def _drafter():
    return models(dict(CFG_KW, num_layers=2), seed=5)


def _jkw(case, mesh):
    """The JAX scheduler's keywords of ``case`` (its drafter sharded as the
    target)."""
    kw, draft = CASES[case]
    kw = dict(kw, kv_dtype=(jnp.int8 if case == "int8 pool"
                            else jnp.float32))
    if draft:
        djcfg, djparams, _, _ = _drafter()
        kw.update(draft_cfg=djcfg, draft_params=(
            djparams if mesh is None else j_shard_params(djparams, mesh)))
    return kw


@functools.lru_cache(maxsize=None)
def _j_waves(case, shape=None):
    """The JAX scheduler's ({request id: (reason, tokens)}, hits after each
    wave) on the virtual mesh of ``shape`` (None: one device)."""
    from qwen_inference_engine_tpu.engine.scheduler import (
        ContinuousBatchingEngine as JCB,
        Request as JRequest,
    )
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )

    jcfg, jparams, _, _ = _models(case)
    mesh = None if shape is None else jmesh(shape)
    cb = JCB(jcfg, jparams if mesh is None else j_shard_params(jparams, mesh),
             mesh=mesh, max_slots=4, page_size=8, num_pages=64,
             max_pages_per_seq=16, sampling=JSamplingParams(greedy=True),
             **_jkw(case, mesh))
    out, hits, rid = {}, [], 0
    for wave in WAVES:
        for pr in wave:
            cb.submit(JRequest(request_id=rid, prompt=list(pr),
                               max_new_tokens=NEW))
            rid += 1
        for f in cb.run_to_completion():
            out[f.request_id] = (f.finish_reason, f.token_ids)
        hits.append(cb.metrics.snapshot()["prefix_hit_tokens"])
    return out, hits


def _port(worlds, case, shape):
    _, _, tcfg, tparams = _models(case)
    kw, draft = CASES[case]
    return run(worlds, shape, jobs.serve_waves, tcfg, tparams, WAVES, NEW,
               kw, _drafter()[2:] if draft else None, timeout=240)


def _check(got, want, spec=False):
    toks, hits = want
    assert hits[0] == 0 and hits[1] > 16, hits   # the second wave hits
    for r, (t, h, rounds, shared) in enumerate(got):
        assert t == toks and h == hits, (r, t, toks, h, hits)
        assert shared > 0, f"rank {r}: no page crossed the data axis"
        assert not spec or rounds > 0, (r, rounds)


@pytest.mark.parametrize("case,shape", [
    ("plain", (2, 1)), ("plain", (4, 1)), ("plain", (2, 2)),
    ("w4a8", (2, 1)), ("w4a8", (2, 2))], ids=str)
def test_dp_serving_matches_the_jax_scheduler(worlds, case, shape):
    """Greedy serving: every rank's tokens, finish reasons and prefix hits
    equal the JAX scheduler's on the same mesh (which equal its run
    without a mesh), a prefix hit on pages another data group wrote
    included, the page invariants holding on every rank.  ``w4a8``: INT4
    weights, int8 activations; the JAX scheduler runs GSPMD's ops, whose
    per-token activation scales are the whole row's, so at (2, 2) the
    port's row-parallel o and down take theirs over the model group."""
    want = _j_waves(case, shape)
    if shape == (4, 1) or case == "w4a8":
        assert want == _j_waves(case)
    _check(_port(worlds, case, shape), want)


@pytest.mark.parametrize("case", ["prompt lookup", "drafter"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=str)
def test_dp_speculation_matches_the_jax_scheduler(worlds, shape, case):
    """Prompt-lookup speculation (host drafts in ``step``, chained rounds
    in ``step_batch``) and a dense drafter split over the model axis: each
    group verifies its own rows, the logits (and drafts) are gathered over
    the data axis and acceptance runs on the whole batch; tokens and hits
    equal the JAX speculative scheduler's on the same mesh."""
    want = _j_waves(case, shape)
    # speculation is token-exact
    assert want[0] == _j_waves("plain", shape)[0]
    _check(_port(worlds, case, shape), want, spec=True)


def test_dp_serving_of_a_moe_model_matches_the_jax_scheduler(worlds):
    """A tiny Qwen3-MoE at (2, 2): each data group runs its rows through
    the TP-MoE step (experts split over the model axis)."""
    shape = (2, 2)
    _check(_port(worlds, "moe", shape), _j_waves("moe", shape))


def test_dp_serving_over_an_int8_pool_matches_the_jax_scheduler(worlds):
    """An INT8 pool at (2, 1): the copied pages carry their scales.  Every
    prompt is one prefill piece (one plan for every row a hit reads)."""
    shape = (2, 1)
    want = _j_waves("int8 pool", shape)
    assert want == _j_waves("int8 pool")
    _check(_port(worlds, "int8 pool", shape), want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_whole_row_scales_give_the_unsharded_w4a8_steps(worlds, shape):
    """``whole_row_scales`` (the serving engine's TP step under a data
    axis): W4A8 prefill pieces, a verify and a paged decode step over this
    rank's heads give one process's f32 logits within 1e-5; with each
    rank's own-K scales (the pure-TP step, as the JAX ``shard_map`` step)
    they part by far more."""
    _, _, tcfg, tparams = _models("w4a8")
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, 512, (2, 20))
    verify = rng.integers(0, 512, (2, 4))
    tables = np.asarray([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 0]])
    want = jobs.paged_steps(None, 0, None, tcfg, tparams, prompts, 8,
                            tables, verify)
    for whole in (True, False):
        got = run(worlds, shape, jobs.paged_steps, tcfg, tparams, prompts,
                  8, tables, verify, whole)
        # every data group runs every row: the first group's shards
        tp = shape[1]
        errs = [float(np.abs(vocab_cat([g[s] for g in got[:tp]], (1, tp))
                             - want[s]).max()) for s in range(len(want))]
        scale = max(float(np.abs(w).max()) for w in want)
        if whole:
            assert max(errs) <= 1e-5 * scale, (errs, scale)
        else:
            assert max(errs) > 1e-3 * scale, (errs, scale)


BODIES = [{"prompt": "data parallel", "max_new_tokens": 6},
          {"prompt": [5, 9, 17, 3, 5, 9], "max_new_tokens": 8},
          {"prompt": "abc", "max_new_tokens": 4, "greedy": True}]


def test_http_server_over_data_ranks_answers_as_one_rank(worlds):
    """``qie serve --dp 2``'s ``Server``: rank 0 serves HTTP and the other
    rank follows its ticks, each running its own slot; its answers (one
    at a time, then two at once) equal the single-rank server's."""
    _, _, tcfg, tparams = models(dict(CFG_KW, vocab_size=260), seed=9)
    want = jobs.http_serve(None, 0, None, tcfg, tparams, BODIES)
    got = run(worlds, (2, 1), jobs.http_serve, tcfg, tparams, BODIES,
              timeout=240)
    assert got[0] == want and got[1] is None


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out["token_ids"], out["finish_reason"]


def _serve_answers(*extra):
    """Start ``serve --model tiny --device cpu`` with ``extra`` flags, post
    BODIES, stop it: the answers."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen_inference_engine_tpu_torch.server.cli",
         "serve", "--model", "tiny", "--device", "cpu", "--greedy",
         "--kv-bits", "32", "--page-size", "16", "--max-seq", "128",
         "--max-slots", "2", "--port", str(port), *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
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


def test_cli_serve_dp2_answers_as_one_rank():
    """``serve --dp 2 --device cpu`` spawns two gloo ranks over a (2, 1)
    mesh and answers as ``serve`` on one process does."""
    assert _serve_answers("--dp", "2") == _serve_answers()
