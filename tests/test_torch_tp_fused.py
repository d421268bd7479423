"""Fused projections and uneven MLP shards under a mesh, in gloo worlds of
CPU processes, against the JAX package's GSPMD run on the virtual mesh of
the same shape (``parallel/tp_step.TpLayout``).

Fused ``qkv`` / ``gateup`` (W8 and W4A8) split by column selection: a
rank's ``qkv`` is its q heads' columns, then its KV heads' k and v
columns; its ``gateup`` its gate columns, then its up columns.  An INT4
``down`` whose even row shards would cut its plane pairs splits F
unevenly on whole pairs instead (384 / 256 at tp 2, 256 / 128 / 128 / 128
at tp 4), and the ``o`` of 64 or 32 local rows at groups of 64 runs whole
after an all-gather of the attention output.  The four entry points of
each case give the JAX GSPMD ids on every rank
(``tests/test_torch_tp_layouts.check_every_entry_point``).
"""

import pytest

from qwen_inference_engine_tpu.quant.quantize import (
    fuse_projections as j_fuse_projections,
)
from qwen_inference_engine_tpu_torch.quant.quantize import fuse_projections
from tests.test_torch_tp_layouts import check_every_entry_point
from tests.torch_parallel_ref import (  # noqa: F401  (worlds: a fixture)
    CFG_KW,
    models,
    worlds,
)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("fmt", ["w8", "w4a8"])
def test_fused_projections_split_by_column_selection(worlds, shape, fmt):
    kw = dict(CFG_KW, act_bits=8) if fmt == "w4a8" else CFG_KW
    jcfg, jparams, tcfg, tparams = models(
        kw, bits=4 if fmt == "w4a8" else 8, group_size=16, seed=11)
    res = check_every_entry_point(worlds, shape, jcfg,
                                  j_fuse_projections(jparams), tcfg,
                                  fuse_projections(tparams))
    assert "fused projections" in res["layout"]
    assert "attention heads split" in res["layout"]
    assert "MLP split" in res["layout"]


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_down_straddling_groups_splits_unevenly(worlds, tp):
    """F = 640 at INT4 groups of 64: a plane pair is 128 rows, so even
    shards of 320 or 160 rows would cut pairs; F splits in 5 units of 128
    instead, the first ranks taking the extra unit."""
    kw = dict(CFG_KW, intermediate_size=640)
    jcfg, jparams, tcfg, tparams = models(kw, bits=4, group_size=64,
                                          seed=12)
    res = check_every_entry_point(worlds, (1, tp), jcfg, jparams, tcfg,
                                  tparams)
    widths = {2: "384/256", 4: "256/128/128/128"}[tp]
    assert f"gate/up N {widths}, down K {widths}" in res["layout"]
    assert "o whole after an all-gather" in res["layout"]


def test_quantizer_padded_down_keeps_its_padding_in_the_last_shard(worlds):
    """F = 1344 at INT4 groups of 32: the quantizer pads down's K to 1408
    (21 plane pairs, odd, above 20), and ``supports_tp`` holds at tp 2.
    The even split would give rank 1 down rows 704..1407 beside gate / up
    columns 672..1343, and the JAX ``shard_map`` step, which splits so,
    parts from its own unsharded run; the port's layout splits F on whole
    pairs (704 / 640 columns, 704 / 704 rows, the padding in rank 1's) and
    every entry point gives the JAX engine's ids without a mesh."""
    import jax.numpy as jnp

    from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
    from qwen_inference_engine_tpu.ops.sampling import (
        SamplingParams as JSamplingParams,
    )
    from qwen_inference_engine_tpu.parallel import tp_step as jtp
    from tests import torch_layout_jobs as lj
    from qwen_inference_engine_tpu.parallel.sharding import (
        shard_params as j_shard_params,
    )
    from tests.test_torch_tp_layouts import (
        MAX_NEW,
        PROMPTS,
        same_or_near_tie,
    )
    from tests.torch_parallel_ref import jmesh, run

    kw = dict(CFG_KW, intermediate_size=1344)
    jcfg, jparams, tcfg, tparams = models(kw, bits=4, group_size=32,
                                          seed=13)
    assert jparams["layers"]["down"].q.shape[-2] * 2 == 1408
    assert jtp.supports_tp(jcfg, jparams, 2)
    want = JEngine(jcfg, jparams, max_batch=4, max_seq=64,
                   kv_dtype=jnp.float32,
                   sampling=JSamplingParams(greedy=True)).generate(
        PROMPTS, max_new_tokens=MAX_NEW).token_ids
    mesh = jmesh((1, 2))
    jeng = JEngine(jcfg, j_shard_params(jparams, mesh), mesh=mesh,
                   max_batch=4, max_seq=64, kv_dtype=jnp.float32,
                   sampling=JSamplingParams(greedy=True))
    assert jeng._tp_step      # the JAX shard_map step parts from its run
    assert jeng.generate(PROMPTS, max_new_tokens=MAX_NEW).token_ids != want
    got = run(worlds, (1, 2), lj.every_entry_point, tcfg, tparams, PROMPTS,
              MAX_NEW, timeout=300)
    for r, res in enumerate(got):
        assert "quantizer-padded" in res["layout"]
        assert "gate/up N 704/640, down K 704/704" in res["layout"]
        for entry in ("generate", "speculative", "serve", "drafter"):
            assert same_or_near_tie(jcfg, jparams, res[entry], want,
                                    (r, entry)) == 0, (r, entry)
