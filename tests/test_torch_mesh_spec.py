"""``Engine.generate_speculative`` under a ``(data, model)`` mesh, in gloo
worlds of 2 and 4 CPU processes, against the JAX engine on the virtual
mesh of the same shape (GSPMD's run, whose ids equal the run without a
mesh) and against the port's one-rank run.

A tiny 2-layer Qwen2 (f32, ``tests/torch_parallel_ref.models``) with EOS
ids that end two rows of the first data group early (one at its first
token), so the rows finish in different rounds and the groups must agree
on when to stop; and a W4A8 model, whose row-parallel activations take
GSPMD's whole-row scales.  Also: a batch shorter than ``max_batch`` under a data
axis (padding rows), and ``generate --speculative --tp 2 / --dp 2 --device
cpu`` printing what one rank prints.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest

from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.parallel.sharding import (
    shard_params as j_shard_params,
)
from tests import torch_parallel_jobs as jobs
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    jmesh,
    models,
    run,
    worlds,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REP = [11, 12, 13, 14] * 4
PROMPTS = [REP, [5, 9, 17, 3, 8, 2], list(range(30, 50)), [7, 8, 9] * 3]
# row 0's first token and row 1's fourth (seed 11): both rows of data
# group 0 at dp 2 end early, group 1's run on
EOS = (273, 41)
NEW, K = 12, 4


@functools.lru_cache(maxsize=None)
def _models():
    jcfg, jparams, tcfg, tparams = models(dict(CFG_KW, num_layers=2),
                                          seed=11)
    return (dataclasses.replace(jcfg, eos_token_ids=EOS), jparams,
            tcfg.replace(eos_token_ids=EOS), tparams)


@functools.lru_cache(maxsize=None)
def _w4a8():
    """A W4A8 model (INT4 weights, int8 activations), EOS off."""
    jcfg, jparams, tcfg, tparams = models(
        dict(CFG_KW, num_layers=2, act_bits=8), bits=4, seed=11)
    return (dataclasses.replace(jcfg, eos_token_ids=()), jparams,
            tcfg.replace(eos_token_ids=()), tparams)


@functools.lru_cache(maxsize=None)
def _j_spec(shape=None, w4a8=False):
    """The JAX engine's ids (a full batch of 4) on the virtual mesh of
    ``shape`` (None: one device)."""
    jcfg, jparams, _, _ = _w4a8() if w4a8 else _models()
    mesh = None if shape is None else jmesh(shape)
    eng = JEngine(jcfg, jparams if mesh is None
                  else j_shard_params(jparams, mesh), mesh=mesh, max_batch=4,
                  max_seq=64, kv_dtype=jnp.float32)
    return eng.generate_speculative(PROMPTS, max_new_tokens=NEW, k=K)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=str)
def test_generate_speculative_under_a_mesh_matches_jax(worlds, shape):
    """Every rank returns the whole batch's ids, equal to the JAX engine's
    on the same mesh and to the port's one-rank run; rows end at EOS in
    different rounds (row 0 at its first token)."""
    _, _, tcfg, tparams = _models()
    want = _j_spec(shape)
    assert want == _j_spec()
    lens = [len(ids) for ids in want]
    assert lens[0] == 1 and lens[1] < NEW and lens[2] == NEW, lens
    assert jobs.spec_generate(None, 0, None, tcfg, tparams, PROMPTS, NEW,
                              4, K) == want
    got = run(worlds, shape, jobs.spec_generate, tcfg, tparams, PROMPTS,
              NEW, 4, K, timeout=240)
    for r, ids in enumerate(got):
        assert ids == want, (r, ids, want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_generate_speculative_of_a_w4a8_model_matches_jax(worlds, shape):
    """W4A8: the JAX engine runs GSPMD's ops, whose per-token activation
    scales are the whole row's, so the port's row-parallel o and down take
    theirs over the model group; ids equal the JAX engine's on the same
    mesh, its run without a mesh and the port's one rank."""
    _, _, tcfg, tparams = _w4a8()
    want = _j_spec(shape, True)
    assert want == _j_spec(None, True)
    assert jobs.spec_generate(None, 0, None, tcfg, tparams, PROMPTS, NEW,
                              4, K) == want
    got = run(worlds, shape, jobs.spec_generate, tcfg, tparams, PROMPTS,
              NEW, 4, K, timeout=240)
    for r, ids in enumerate(got):
        assert ids == want, (r, ids, want)


def test_a_short_batch_under_a_data_axis_is_padded(worlds):
    """Three prompts on a (2, 2) mesh of ``max_batch`` 4: the padding row
    is done from the start, and every rank returns the three prompts' ids
    of the port's one-rank run (the JAX engine needs a full batch)."""
    _, _, tcfg, tparams = _models()
    want = jobs.spec_generate(None, 0, None, tcfg, tparams, PROMPTS[1:],
                              NEW, 3, K)
    assert want == _j_spec()[1:]
    got = run(worlds, (2, 2), jobs.spec_generate, tcfg, tparams,
              PROMPTS[1:], NEW, 4, K, timeout=240)
    for r, ids in enumerate(got):
        assert ids == want, (r, ids, want)


@functools.lru_cache(maxsize=None)
def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "qwen_inference_engine_tpu_torch.server.cli",
         "generate", "--model", "tiny", "--device", "cpu", "--speculative",
         "--spec-k", "4", "--kv-bits", "32", "--max-new-tokens", "8",
         "--prompt", "hello hello hello", "--prompt", "speculative",
         *extra], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("mesh", [("--tp", "2"), ("--dp", "2")],
                         ids=["tp2", "dp2"])
def test_cli_generate_speculative_over_ranks_prints_one_ranks_output(mesh):
    """``generate --speculative --tp 2`` and ``--dp 2 --device cpu`` spawn
    the ranks (gloo); rank 0 alone prints the sequences ``--tp 1``
    prints."""
    assert _cli(*mesh) == _cli("--tp", "1")
