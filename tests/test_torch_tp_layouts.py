"""Models that do not split evenly over the model axis, under a mesh in
gloo worlds of CPU processes, against the JAX package's GSPMD run on the
virtual mesh of the same shape (``parallel/tp_step.TpLayout``).

Each case is a model the port refused before (``supports_tp`` false):
KV heads that tp does not divide (each KV head replicated over ``tp /
Hk`` ranks), query heads that tp does not divide (attention whole), a
row-parallel ``o`` bias (added once, after the all-reduce), and MoE
experts that tp does not divide (experts whole).  Every rank runs
``Engine.generate``, ``generate_speculative``, the serving engine over
prompts that share a prefix (the third request hits the first's pages)
and the serving engine with the model as its drafter; each returns the
greedy ids of the JAX ``Engine.generate`` on the same mesh (GSPMD,
``use_pallas=False``), on every rank.  ``tests/test_torch_tp_fused.py``
holds the fused-projection and uneven-MLP cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.ops.sampling import (
    SamplingParams as JSamplingParams,
)
from qwen_inference_engine_tpu.parallel import tp_step as jtp
from qwen_inference_engine_tpu.parallel.sharding import (
    shard_params as j_shard_params,
)
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from tests import torch_layout_jobs as lj
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    MOE_KW,
    jmesh,
    models,
    run,
    worlds,
)

# three prompts, the first and third sharing 16 tokens (two pages of 8)
SHARED = [5, 9, 17, 3, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28]
PROMPTS = [SHARED + [30], [100, 200, 300, 400, 500, 42],
           SHARED + [31, 33]]
MAX_NEW = 6


def jax_gspmd_ids(jcfg, jparams, shape, prompts=PROMPTS, max_new=MAX_NEW):
    """The JAX engine's greedy ids on the virtual mesh of ``shape``; its
    shard_map step is off (``supports_tp`` false), so GSPMD runs it."""
    mesh = jmesh(shape)
    eng = JEngine(jcfg, j_shard_params(jparams, mesh), mesh=mesh,
                  max_batch=-(-len(prompts) // shape[0]) * shape[0],
                  max_seq=64, kv_dtype=jnp.float32,
                  sampling=JSamplingParams(greedy=True))
    assert not eng._tp_step and not eng.use_pallas
    return eng.generate(prompts, max_new_tokens=max_new).token_ids


def same_or_near_tie(jcfg, jparams, got, want, what):
    """Each row's ids equal the JAX ids, or part at a near-tie of the JAX
    model: at the first step where they differ, the JAX logits of the two
    ids lie within 1% of the largest logit (int8 activations round the
    two packages' f32 sums apart there); nothing after it is compared.
    Returns the number of rows that part."""
    from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
    from qwen_inference_engine_tpu.models.qwen import prefill as j_prefill

    parted = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next(j for j in range(min(len(g), len(w))) if g[j] != w[j])
        seq = PROMPTS[i] + w[:j]
        cache = JKVCache.create(jcfg.num_layers, 1, 64, jcfg.num_kv_heads,
                                jcfg.head_dim, dtype=jnp.float32)
        logits, _ = j_prefill(jparams, jcfg, jnp.asarray([seq]),
                              jnp.asarray([len(seq)]), cache,
                              use_pallas=False)
        logits = np.asarray(logits)[0]
        gap = abs(float(logits[w[j]] - logits[g[j]]))
        assert gap <= 1e-2 * float(np.abs(logits).max()), \
            (what, i, j, g, w, gap)
        parted += 1
    return parted


def check_every_entry_point(worlds, shape, jcfg, jparams, tcfg, tparams):
    """Every rank's four entry points give the JAX GSPMD ids (on the
    near-tie rule, ``same_or_near_tie``); returns rank 0's result."""
    assert not jtp.supports_tp(jcfg, jparams, shape[1])
    want = jax_gspmd_ids(jcfg, jparams, shape)
    got = run(worlds, shape, lj.every_entry_point, tcfg, tparams, PROMPTS,
              MAX_NEW, timeout=300)
    for r, res in enumerate(got):
        for entry in ("generate", "speculative", "serve", "drafter"):
            parted = same_or_near_tie(jcfg, jparams, res[entry], want,
                                      (r, entry))
            # f32 activations: no near-tie on these seeds
            assert parted == 0 or jcfg.act_bits == 8, (r, entry)
            assert res[entry] == got[0][entry], (r, entry)
        assert res["prefix_hit_tokens"] >= 16, (r, res["prefix_hit_tokens"])
        assert res["model_draft"] and res["draft_rounds"] > 0, r
        assert res["layout"] == got[0]["layout"]
    print(got[0]["layout"])
    return got[0]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_kv_heads_replicated_over_the_model_axis(worlds, shape):
    """8 query heads / 2 KV heads: at tp 4 each KV head is replicated over
    2 ranks (a local cache of one KV head); at (2, 2) tp 2 splits both
    head counts, and the data axis makes it a GSPMD run all the same for
    the serving engine."""
    kw = dict(CFG_KW, num_kv_heads=2)
    jcfg, jparams, tcfg, tparams = models(kw, seed=5)
    if shape[1] == 4:
        res = check_every_entry_point(worlds, shape, jcfg, jparams, tcfg,
                                      tparams)
        assert "KV heads replicated over 2 ranks" in res["layout"]
        assert res["cache_kv_heads"] == (1, 1, 1)
        return
    # tp 2 splits the heads (supports_tp holds): the JAX engine's own
    # shard_map step, and the serving engine's GSPMD run under dp 2
    assert jtp.supports_tp(jcfg, jparams, 2)
    mesh = jmesh(shape)
    want = JEngine(jcfg, j_shard_params(jparams, mesh), mesh=mesh,
                   max_batch=4, max_seq=64, kv_dtype=jnp.float32,
                   sampling=JSamplingParams(greedy=True)).generate(
        PROMPTS, max_new_tokens=MAX_NEW).token_ids
    got = run(worlds, shape, lj.every_entry_point, tcfg, tparams, PROMPTS,
              MAX_NEW, timeout=300)
    for r, res in enumerate(got):
        for entry in ("generate", "speculative", "serve", "drafter"):
            assert res[entry] == want, (r, entry, res[entry], want)
        assert res["cache_kv_heads"] == (1, 1, 1)
        assert "shard_map layout" in res["layout"]


def test_query_heads_that_do_not_split_run_attention_whole(worlds):
    """6 query heads / 2 KV heads at tp 4: neither head count splits, so
    attention (q, k, v, o and the cache) runs whole on every rank, with
    no all-reduce after o; the MLP and the vocabulary still split."""
    kw = dict(CFG_KW, num_heads=6, num_kv_heads=2)
    jcfg, jparams, tcfg, tparams = models(kw, seed=6)
    res = check_every_entry_point(worlds, (1, 4), jcfg, jparams, tcfg,
                                  tparams)
    assert "attention whole: 6 / 2 heads -> 6 / 2 a rank, o whole" in \
        res["layout"]
    assert res["cache_kv_heads"] == (2, 2, 2)


def test_row_parallel_o_bias_is_added_once(worlds):
    """An ``o`` with a bias at tp 2 (``supports_tp`` refuses it: an
    all-reduced bias would count tp times): the split keeps, and each
    rank adds the bias once after the all-reduce."""
    jcfg, jparams, tcfg, _ = models(seed=8)
    rng = np.random.default_rng(8)
    layers = dict(jparams["layers"])
    o = layers["o"]
    layers["o"] = dataclasses.replace(o, b=jnp.asarray(rng.normal(
        size=(jcfg.num_layers, jcfg.hidden_size)).astype(np.float32) * 0.5))
    jparams = dict(jparams, layers=layers)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    res = check_every_entry_point(worlds, (1, 2), jcfg, jparams, tcfg,
                                  tparams)
    assert "o row-parallel" in res["layout"]


def test_moe_experts_that_do_not_split_run_whole(worlds):
    """Qwen3-MoE with 6 experts at tp 4: the expert stacks run whole on
    every rank (no all-reduce after the MoE MLP), attention splits."""
    kw = dict(MOE_KW, num_experts=6)
    jcfg, jparams, tcfg, tparams = models(kw, seed=9)
    res = check_every_entry_point(worlds, (1, 4), jcfg, jparams, tcfg,
                                  tparams)
    assert "attention heads split" in res["layout"]
    assert "MLP whole" in res["layout"]


def test_cli_generate_tp4_runs_the_gspmd_layout():
    """``generate --tp 4 --device cpu`` of the tiny preset (4 query / 2 KV
    heads: each KV head replicated over 2 ranks) prints the ``--tp 1``
    sequences, and rank 0 prints the layout on stderr."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def cli(*extra):
        out = subprocess.run(
            [sys.executable, "-m",
             "qwen_inference_engine_tpu_torch.server.cli", "generate",
             "--model", "tiny", "--device", "cpu", "--greedy", "--kv-bits",
             "32", "--max-new-tokens", "6", "--prompt", "hello", "--prompt",
             "tensor parallel", *extra],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out

    four = cli("--tp", "4")
    assert four.stdout == cli("--tp", "1").stdout
    assert "[tp layout] tp 4, GSPMD layout" in four.stderr
    assert "KV heads replicated over 2 ranks" in four.stderr
