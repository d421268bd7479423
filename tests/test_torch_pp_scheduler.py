"""The port's pipeline-parallel serving (``engine/pp_scheduler.py``,
``Server`` and ``serve --pp``) against the JAX package.

``PPFifoScheduler`` runs in gloo worlds of 2 and 4 CPU processes
(module-scoped, ``tests/torch_parallel_world.World``) on a tiny f32 model
of 4 layers carried over from the JAX params by ``loader/from_jax.py``;
the JAX ``PPFifoScheduler`` on its virtual mesh of 4 devices.  Greedy and
penalized tokens are held equal to the JAX scheduler's; sampled rows only
to themselves (the port's generators are not JAX's): the same on every
rank and on a second run.  The HTTP server over a 2-stage world and
``serve --pp 2`` answer as the single-rank server does.
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

from qwen_inference_engine_tpu.engine.pp_scheduler import (
    PPFifoScheduler as JPP,
)
from qwen_inference_engine_tpu.engine.scheduler import Request as JRequest
from qwen_inference_engine_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from qwen_inference_engine_tpu.parallel.pp_step import make_pp_mesh
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from tests import torch_pp_jobs as jobs
from tests.torch_parallel_jobs import http_serve
from tests.torch_parallel_ref import models, worlds  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = [2, 4]
KW = dict(num_layers=4)
# wave A: 4 aligned prompts (the 1F1B decode); wave B: ragged (the per-tick
# forward), with a request longer than max_seq (rejected)
ALIGNED = {i: [10 + i, 20 + i, 30 + i, 40 + i] for i in range(4)}
RAGGED = {10: [5, 9, 17], 11: list(range(50, 60)), 12: [1] * 70}
GREEDY = dict(greedy=True)
STOCH = dict(temperature=0.9, top_k=20)
PEN = dict(greedy=True, repetition_penalty=1e6, presence_penalty=0.5)


@functools.lru_cache(maxsize=None)
def _model():
    return models(KW, seed=5)


def _j_pp(devices8, waves, default, max_new, seed=1234):
    """The JAX PPFifoScheduler on 4 stages: each wave ``{rid: (prompt,
    sampling kwargs or None)}`` run to completion in turn."""
    jcfg, jparams, _, _ = _model()
    pp = JPP(jcfg, jparams, mesh=make_pp_mesh(devices=devices8[:4]),
             max_batch=4, max_seq=64, kv_dtype=jnp.float32,
             sampling=JSamplingParams(**default), seed=seed)
    got, why = {}, {}
    for wave in waves:
        for rid, (p, sp) in wave.items():
            pp.submit(JRequest(request_id=rid, prompt=p,
                               max_new_tokens=max_new,
                               sampling=None if sp is None
                               else JSamplingParams(**sp)))
        for f in pp.run_to_completion():
            got[f.request_id] = f.token_ids
            why[f.request_id] = f.finish_reason
    return got, why, set(pp._jit_cache)


def _rode_1f1b(keys, sampled, penalized):
    """Whether a 1F1B decode of these flags served a window."""
    return any(k[0] == "pp_1f1b" and k[2:] == (sampled, penalized)
               for k in keys)


def _t_waves(waves):
    return [{rid: (p, None if sp is None else SamplingParams(**sp))
             for rid, (p, sp) in w.items()} for w in waves]


def _run(worlds, stages, waves, default, max_new, seed=1234):
    _, _, tcfg, tparams = _model()
    return worlds(stages).run(
        jobs.pp_serve, tcfg, tparams, _t_waves(waves), max_new, 4,
        dict(sampling=SamplingParams(**default), kv_dtype=torch.float32,
             seed=seed), timeout=240)


@pytest.mark.parametrize("stages", STAGES)
def test_fifo_waves_match_jax(worlds, devices8, stages):
    """JAX test_pp_step.py:201: an aligned wave (1F1B) then a ragged wave
    (per-tick forward) on one scheduler: every rank's tokens and finish
    reasons equal the JAX PPFifoScheduler's, a prompt past max_seq
    rejected."""
    waves = [{r: (p, None) for r, p in ALIGNED.items()},
             {r: (p, None) for r, p in RAGGED.items()}]
    want, why, keys = _j_pp(tuple(devices8), waves, GREEDY, 6)
    assert why[12] == "rejected" and _rode_1f1b(keys, False, False)
    for r, (toks, reasons, used) in enumerate(_run(worlds, stages, waves,
                                                   GREEDY, 6)):
        assert toks == want and reasons == why, (r, toks, want)
        assert _rode_1f1b(used, False, False) and ("pp_decode",) in used, \
            used


@pytest.mark.parametrize("stages", STAGES)
def test_sampled_waves_ride_the_1f1b_decode(worlds, devices8, stages):
    """JAX test_pp_step.py:242: a full aligned wave of greedy and sampled
    rows rides the sampled 1F1B decode; greedy rows equal the JAX
    scheduler's, every rank draws the same tokens, and a second run with
    the same seed draws them again."""
    mix = {0: GREEDY, 1: STOCH, 2: GREEDY, 3: STOCH}
    waves = [{r: (p, mix[r]) for r, p in ALIGNED.items()}]
    want, _, keys = _j_pp(tuple(devices8), waves, GREEDY, 6, seed=7)
    assert _rode_1f1b(keys, True, False)
    first = _run(worlds, stages, waves, GREEDY, 6, seed=7)
    again = _run(worlds, stages, waves, GREEDY, 6, seed=7)
    for r, (toks, reasons, used) in enumerate(first):
        assert toks == first[0][0] == again[r][0], r
        assert _rode_1f1b(used, True, False), used
        for rid in (0, 2):
            assert toks[rid] == want[rid], (r, rid, toks[rid], want[rid])
        assert all(len(toks[rid]) == 6 for rid in (1, 3))


@pytest.mark.parametrize("stages", STAGES)
def test_penalized_waves_match_jax(worlds, devices8, stages):
    """JAX test_pp_step.py:297: greedy rows with repetition and presence
    penalties ride the penalized 1F1B decode (the seen mask carried
    through the ticks): tokens equal the JAX scheduler's on every rank,
    and no row repeats a token of its prompt or history."""
    waves = [{r: (p, None) for r, p in ALIGNED.items()}]
    want, _, keys = _j_pp(tuple(devices8), waves, PEN, 8)
    assert _rode_1f1b(keys, True, True)
    for r, (toks, _, used) in enumerate(_run(worlds, stages, waves, PEN,
                                             8)):
        assert toks == want, (r, toks, want)
        assert _rode_1f1b(used, True, True), used
        for rid, out in toks.items():
            assert len(set(out) | set(ALIGNED[rid])) == \
                len(out) + len(ALIGNED[rid]), (rid, out)


def test_pp_scheduler_refuses_what_the_pipeline_does_not_take():
    """An MoE model, layers that do not divide by the stages, and a batch
    that does not split into one microbatch a stage raise, naming why."""
    from qwen_inference_engine_tpu_torch.config import tiny_config
    from qwen_inference_engine_tpu_torch.engine.pp_scheduler import (
        PPFifoScheduler,
    )
    _, _, tcfg, tparams = _model()
    cases = [(tiny_config(num_layers=4, num_experts=4, num_experts_per_tok=2,
                          moe_intermediate_size=32), 4, "MoE model"),
             (tcfg.replace(num_layers=3), 4, "3 layers do not divide"),
             (tcfg, 6, "max_batch=6 must divide")]
    for cfg, batch, match in cases:
        with pytest.raises(ValueError, match=match):
            PPFifoScheduler(cfg, tparams, mesh=jobs.fake_pp_mesh(4),
                            max_batch=batch, device="cpu")


def test_engine_under_a_stage_mesh_names_why():
    """``Engine`` (generate) under a stage mesh raises: the JAX engine has
    no pipeline branch and raises there too (no data axis for its
    ``NamedSharding``); serving takes it."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine

    _, _, tcfg, tparams = _model()
    with pytest.raises(NotImplementedError, match="no pipeline branch.*"
                                                  "PPFifoScheduler"):
        Engine(tcfg, tparams, mesh=jobs.fake_pp_mesh(2), max_batch=2,
               max_seq=64, kv_dtype=torch.float32, device="cpu")


BODIES = [{"prompt": "pipeline parallel", "max_new_tokens": 6},
          {"prompt": [5, 9, 17, 3, 5, 9], "max_new_tokens": 8},
          {"prompt": "abc", "max_new_tokens": 4, "greedy": True}]


def test_http_server_over_pp_ranks_answers_as_one_rank(worlds):
    """JAX server/http.py:74-87's branch: ``Server`` over a 2-stage world
    serves FIFO waves through ``PPFifoScheduler``; rank 0 serves HTTP and
    the other rank follows its ticks; its answers equal the single-rank
    server's."""
    _, _, tcfg, tparams = models(dict(KW, vocab_size=260), seed=9)
    want = http_serve(None, 0, None, tcfg, tparams, BODIES, max_slots=4)
    got = worlds(2).run(jobs.http_serve_pp, tcfg, tparams, BODIES, 4,
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


def test_cli_serve_pp2_answers_as_one_rank():
    """``serve --pp 2 --device cpu`` spawns two gloo ranks over the stage
    mesh and answers as ``serve`` on one process does."""
    assert _serve_answers("--pp", "2") == _serve_answers()
