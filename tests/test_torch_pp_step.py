"""The port's pipeline (``parallel/pp_step.py``, the row0 kernels,
``forward_hidden``'s stage arguments) against the JAX package.

The port runs in gloo worlds of 2 and 4 CPU processes (module-scoped,
``tests/torch_parallel_world.World``); the JAX side on its virtual mesh of
4 devices (``devices8``), its Pallas kernels in interpret mode where the
JAX test uses them.  Inputs are seeded numpy arrays carried over by
``loader/from_jax.py``; tiny f32 configs of 4 layers.  Tolerances: f32
logits within 1e-5 of the largest JAX logit (``torch_parallel_ref.
close``); tokens and the port's own zero-copy / sliced caches exact; f32
caches within 1e-5 of the JAX caches; the row0 plain versions as the
unwindowed kernels' tests (2e-3 bf16-cache attention, 2e-2 INT8, the
INT8 append bit for bit); a stage's stream through the JAX forward's
Pallas decode kernels within 2e-3 of its largest value (2e-2 over an
INT8 cache).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.decode_attention as jda
import qwen_inference_engine_tpu.ops.kv_append as jka
from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.parallel import pp_step as jpp
from qwen_inference_engine_tpu.quant.quantize import (
    QuantConfig as JQuantConfig,
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.convert import as_tensor
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops import decode_attention as tda
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.parallel import pp_step as tpp
from tests import torch_pp_jobs as jobs
from tests.helpers import interpret_pallas
from tests.torch_parallel_ref import close, worlds  # noqa: F401 (fixture)

STAGES = [2, 4]
CFG_KW = dict(num_layers=4)
# the zero-copy case: the JAX kernels' shapes (head_dim 128, S 256)
KERNEL_KW = dict(num_layers=4, num_heads=4, num_kv_heads=2, head_dim=128,
                 hidden_size=256)


def _t(a):
    """A torch copy of a numpy array (bf16 carried bit for bit)."""
    return as_tensor(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def _models(seed, kw=tuple(sorted(CFG_KW.items()))):
    """(jax cfg, jax params, port cfg, port params): f32, seeded."""
    kw = dict(kw)
    jcfg = j_tiny_config(**kw)
    jparams = jqwen.init_params(jcfg, jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, jparams, tiny_config(**kw), tparams


def _jmesh(devices8, n=4):
    return jpp.make_pp_mesh(devices=devices8[:n])


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("case", ["dense 4 layers", "moe", "3 layers"])
@pytest.mark.parametrize("stages", STAGES)
def test_pp_refusal_is_the_jax_gate(case, stages):
    """``pp_refusal`` names why exactly where the JAX ``supports_pp`` is
    false: an MoE model, layers that do not divide by the stages."""
    kw = {"dense 4 layers": dict(num_layers=4),
          "moe": dict(num_layers=4, num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=32),
          "3 layers": dict(num_layers=3)}[case]
    want = jpp.supports_pp(j_tiny_config(**kw), None, stages)
    cfg = tiny_config(**kw)
    why = tpp.pp_refusal(cfg, stages)
    assert (why is None) == want == tpp.supports_pp(cfg, None, stages)
    if case == "moe":
        assert "MoE" in why
    if case == "3 layers":
        assert f"do not divide into {stages} stages" in why
        with pytest.raises(ValueError, match="does not take this model"):
            tpp.make_pp_forward_fn(cfg, jobs.fake_pp_mesh(stages))


# ------------------------------------------------------------ the ring
@pytest.mark.parametrize("stages", STAGES)
def test_ring_exchange_is_the_jax_ppermute(worlds, stages):
    """``ring_exchange`` (gloo: one ``all_to_all_single``, every split but
    the next stage's empty) is the JAX ``ppermute`` over ``(s, s + 1)``:
    the full ring hands each stage its predecessor's tensor; a hop from
    ``src`` reaches ``src + 1`` alone; ``broadcast`` gives stage 0's
    tensor to all.  Each counts its calls and the bytes this rank sent."""
    got = worlds(stages).run(jobs.ring, 2)
    for r, (full, hops, b, counts) in enumerate(got):
        prev = (r - 1) % stages
        assert full == [[float(prev)] * 3] * 2
        for src, h in enumerate(hops):
            if (src + 1) % stages == r:
                assert h == [[float(prev + 10 * src)] * 3] * 2
            else:
                assert h is None
        assert b == [5.0, 5.0]
        sent = 24 * (1 + 1)     # the ring, and this stage's own hop
        assert counts == [(1 + stages, sent), (1, 8 if r == 0 else 0)]


# ------------------------------------------------------------ shards
def _leaves(tree):
    """(path, array) of every array leaf, in a fixed order."""
    out = []

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif x is None:
            return
        elif hasattr(x, "__dataclass_fields__"):
            for k in sorted(x.__dataclass_fields__):
                walk(getattr(x, k), f"{path}.{k}")
        elif hasattr(x, "shape"):
            out.append((path, x))
    walk(tree, "")
    return out


@pytest.mark.parametrize("fmt", ["bf16", "w4", "w8"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_shard_for_pp_equals_the_jax_shards(devices8, fmt, kv):
    """Each stage's leaves (``Linear``, W4 / W8 ``QuantLinear``, the norms;
    the global leaves whole) and cache (bf16, INT8 with its scales) equal
    the JAX ``shard_for_pp`` shard on that stage's device."""
    jcfg = j_tiny_config(**CFG_KW)
    jparams = jqwen.init_params(jcfg, jax.random.PRNGKey(3),
                                dtype=jnp.bfloat16)
    if fmt != "bf16":
        jparams = j_quantize_params(jparams, JQuantConfig(
            bits=4 if fmt == "w4" else 8, group_size=32))
    dt = jnp.int8 if kv == "int8" else jnp.bfloat16
    jcache = JKVCache.create(4, 2, 32, jcfg.num_kv_heads, jcfg.head_dim,
                             dtype=dt)
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.integers(-50, 50, a.shape)).astype(a.dtype),
        jcache)
    mesh = _jmesh(devices8)
    jp, jc = jpp.shard_for_pp(jparams, jcache, mesh)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tcache = KVCache(*[None if a is None else _t(np.asarray(a)) for a in (
        jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)])
    for s in range(4):
        dev = devices8[s]
        tp_, tc = tpp.shard_for_pp(tparams, tcache, jobs.fake_pp_mesh(4, s))
        want = _leaves({"p": jp, "c": jc})
        got = _leaves({"p": tp_, "c": tc})
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            shard = next(x.data for x in w.addressable_shards
                         if x.device == dev)
            np.testing.assert_array_equal(
                g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy(),
                np.asarray(shard.astype(jnp.float32) if shard.dtype ==
                           jnp.bfloat16 else shard), err_msg=path)


# ------------------------------------------------------------ kernels
def _int8_cache(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    s = np.abs(x).max(-1) / 127 + 1e-6
    return np.round(x / s[..., None]).astype(np.int8), s.astype(np.float32)


@pytest.mark.parametrize("kind", ["appending", "contiguous", "q8",
                                  "append q8"])
def test_row0_plain_versions_match_pallas_interpret(kind):
    """The four row0 variants at row0 = 2, 4 and 6 (microbatches of 2 rows
    of an 8-row cache): the plain versions' outputs and written caches
    against the JAX kernels in interpret mode."""
    L, Bc, b, Hk, G, D, S, layer, pos = 2, 8, 2, 2, 7, 128, 256, 1, 137
    rng = np.random.default_rng(5)
    if kind in ("q8", "append q8"):
        kc, ks = _int8_cache(rng, (L, Bc, Hk, S, D))
        vc, vs = _int8_cache(rng, (L, Bc, Hk, S, D))
        caches = (kc, vc, ks, vs)
    else:
        caches = tuple(rng.normal(size=(L, Bc, Hk, S, D)).astype(np.float32)
                       for _ in range(2))
    for row0 in (2, 4, 6):
        q = rng.normal(size=(b, 1, G * Hk, D)).astype(np.float32)
        kn = rng.normal(size=(b, 1, Hk, D)).astype(np.float32)
        vn = rng.normal(size=(b, 1, Hk, D)).astype(np.float32)
        lens = np.asarray([pos + 1, 40], np.int32)
        tc = [_t(a) for a in caches]
        jc = [jnp.asarray(a) for a in caches]
        if kind == "appending":
            with interpret_pallas(jda):
                ref, rk, rv = jda.decode_attention_appending(
                    jnp.asarray(q), *jc, jnp.asarray(kn), jnp.asarray(vn),
                    layer, pos, row0=row0)
            got, gk, gv = tda.decode_attention_appending(
                _t(q), *tc, _t(kn), _t(vn), layer, pos, row0=row0)
            pairs, tol = [(got, ref)], 2e-3
            writes = [(gk, rk), (gv, rv)]
        elif kind == "contiguous":
            with interpret_pallas(jda):
                ref = jda.decode_attention_contiguous(
                    jnp.asarray(q), *jc, layer, jnp.asarray(lens), row0=row0)
            got = tda.decode_attention_contiguous(_t(q), *tc, layer,
                                                  _t(lens), row0=row0)
            pairs, tol, writes = [(got, ref)], 2e-3, []
        elif kind == "q8":
            with interpret_pallas(jda):
                ref = jda.decode_attention_contiguous_q8(
                    jnp.asarray(q), *jc, layer, jnp.asarray(lens), row0=row0)
            got = tda.decode_attention_contiguous_q8(_t(q), *tc, layer,
                                                     _t(lens), row0=row0)
            pairs, tol, writes = [(got, ref)], 2e-2, []
        else:
            qk, sk = _int8_cache(rng, (b, 1, Hk, D))
            qv, sv = _int8_cache(rng, (b, 1, Hk, D))
            with interpret_pallas(jka):
                want = jka.kv_append_uniform_q8(
                    *jc, jnp.asarray(qk), jnp.asarray(qv), jnp.asarray(sk),
                    jnp.asarray(sv), jnp.int32(pos), layer, row0=row0)
            got = tka.kv_append_uniform_q8(*tc, _t(qk), _t(qv), _t(sk),
                                           _t(sv), pos, layer, row0=row0)
            pairs, tol = [], 0
            writes = list(zip(got, want))
        for g, w in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol, err_msg=f"{kind} {row0}")
        for g, w in writes:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{kind} {row0}")
    with pytest.raises(ValueError, match="outside the cache"):
        tda.decode_attention_contiguous(_t(q), _t(caches[0]), _t(caches[1]),
                                        layer, _t(lens), row0=Bc - 1)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_forward_hidden_stage_arguments_match_jax(kv):
    """``forward_hidden`` with ``inputs_embeds``, ``apply_final_norm=False``
    and ``cache_row0`` (a uniform decode of 2 rows at rows 2..3 of a
    4-row cache) against the JAX forward with its Pallas kernels in
    interpret mode: the stream and the whole cache after the step."""
    jcfg, jparams, tcfg, tparams = _models(4, tuple(sorted(
        KERNEL_KW.items())))
    B, T, b, row0 = 4, 6, 2, 2
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jdt = jnp.int8 if kv == "int8" else jnp.float32
    jcache = JKVCache.create(4, B, 256, jcfg.num_kv_heads, jcfg.head_dim,
                             dtype=jdt)
    _, jcache = jqwen.prefill(jparams, jcfg, jnp.asarray(prompts),
                              jnp.full((B,), T, jnp.int32), jcache)
    x = rng.normal(size=(b, 1, jcfg.hidden_size)).astype(np.float32)
    pos = np.full((b, 1), T, np.int32)
    toks = np.zeros((b, 1), np.int32)
    tcache = KVCache(*[None if a is None else _t(np.asarray(a)) for a in (
        jcache.k, jcache.v, jcache.k_scale, jcache.v_scale)])
    with interpret_pallas(jda), interpret_pallas(jka):
        jh, jc = jqwen.forward_hidden(
            jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), jcache,
            use_pallas=True, attn_impl="pallas", uniform_decode=True,
            inputs_embeds=jnp.asarray(x), apply_final_norm=False,
            cache_row0=row0)
    th, tc = tqwen.forward_hidden(
        tparams, tcfg, _t(toks).long(), _t(pos).long(), tcache,
        uniform_decode=True, inputs_embeds=_t(x), apply_final_norm=False,
        cache_row0=row0)
    # the JAX decode kernels round inside (as the attention tests: 2e-3,
    # 2e-2 over an int8 cache)
    jh = np.asarray(jh)
    err = float(np.abs(th.numpy() - jh).max())
    rule = 2e-2 if kv == "int8" else 2e-3
    assert err <= rule * float(np.abs(jh).max()), err
    # every cache entry but the window's new row keeps the prefill's bits;
    # the new row (position T of rows 2..3) as the stream, or within one
    # int8 step
    for g, w in zip((tc.k, tc.v, tc.k_scale, tc.v_scale),
                    (jc.k, jc.v, jc.k_scale, jc.v_scale)):
        if g is None:
            continue
        g, w = g.float().numpy(), np.asarray(w).astype(np.float32)
        new = np.zeros(g.shape, bool)
        new[:, row0:row0 + b, :, T] = True
        np.testing.assert_array_equal(g[~new], w[~new])
        tol = 1.0 if kv == "int8" and g.ndim == 5 else \
            rule * float(np.abs(w[new]).max())
        np.testing.assert_allclose(g[new], w[new], rtol=0, atol=tol)
    with pytest.raises(ValueError, match="cache_row0 .pipeline row-window"):
        tqwen.forward_hidden(tparams, tcfg, _t(toks).long(), _t(pos).long(),
                             tcache, inputs_embeds=_t(x), cache_row0=row0)


# ------------------------------------------------------------ the pipeline
@functools.lru_cache(maxsize=None)
def _j_forward(devices8):
    """JAX test_pp_step.py:25 on 4 stages: prefill + 3 uniform decode steps
    of the pipeline forward; (logits of each, the tokens fed)."""
    jcfg, jparams, _, _ = _models(0)
    mesh = _jmesh(devices8)
    B, T = 2, 8
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, T))
    lens = jnp.full((B,), T, jnp.int32)
    cache = JKVCache.create(4, B, 64, jcfg.num_kv_heads, jcfg.head_dim,
                            dtype=jnp.float32)
    params_s, cache_s = jpp.shard_for_pp(jparams, cache, mesh)
    pre = jax.jit(jpp.make_pp_forward_fn(jcfg, mesh, jparams, cache))
    dec = jax.jit(jpp.make_pp_forward_fn(jcfg, mesh, jparams, cache,
                                         uniform_decode=True))
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
    logits, cache_s = pre(params_s, jnp.asarray(prompts, jnp.int32), pos,
                          lens, cache_s)
    outs, toks = [np.asarray(logits)], []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for s in range(3):
        toks.append(np.asarray(tok))
        logits, cache_s = dec(params_s, tok[:, None], (lens + s)[:, None],
                              lens, cache_s)
        outs.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return prompts, np.stack(toks), outs


@pytest.mark.parametrize("stages", STAGES)
def test_pp_forward_matches_jax(worlds, devices8, stages):
    """JAX test_pp_step.py:25: the pipeline's prefill and decode logits
    equal the JAX pipeline's (4 stages) within 1e-5 of the largest logit,
    the same on every rank; a forward passes the stream S times (one hop
    each) and broadcasts once."""
    _, _, tcfg, tparams = _models(0)
    prompts, toks, want = _j_forward(tuple(devices8))
    got = worlds(stages).run(jobs.forward_steps, tcfg, tparams, prompts,
                             np.full((2,), 8), toks, torch.float32)
    for r, (outs, calls) in enumerate(got):
        for i, (g, w) in enumerate(zip(outs, want)):
            close(g, w, f"rank {r} step {i}")
            np.testing.assert_array_equal(g, got[0][0][i])
        assert calls == (4 * stages, 4), calls


@pytest.mark.parametrize("kv", [torch.float32, torch.int8], ids=["f32",
                                                                  "int8"])
@pytest.mark.parametrize("stages", STAGES)
def test_pp_forward_ragged_matches_one_rank(worlds, stages, kv):
    """Ragged prompts, then per-row decode steps (the scheduler's tick):
    every rank's logits equal the single-rank ``prefill`` / ``decode_step``
    within 1e-5 of the largest logit."""
    _, _, tcfg, tparams = _models(0)
    rng = np.random.default_rng(3)
    lens = np.asarray([8, 3, 5, 6])
    prompts = rng.integers(0, tcfg.vocab_size, (4, 8))
    toks = rng.integers(0, tcfg.vocab_size, (2, 4))
    cache = KVCache.create(4, 4, 64, tcfg.num_kv_heads, tcfg.head_dim,
                           dtype=kv)
    logits, cache = tqwen.prefill(tparams, tcfg, _t(prompts), _t(lens),
                                  cache)
    want = [logits.numpy()]
    for s, tok in enumerate(toks):
        logits, cache = tqwen.decode_step(tparams, tcfg, _t(tok),
                                          _t(lens + s), cache)
        want.append(logits.numpy())
    got = worlds(stages).run(jobs.forward_steps, tcfg, tparams, prompts,
                             lens, toks, kv)
    for r, (outs, _) in enumerate(got):
        for i, (g, w) in enumerate(zip(outs, want)):
            close(g, w, f"rank {r} step {i}")


def _j_1f1b_case(devices8, cfg_kw, seed, prompt_seed, kv, **kw):
    """JAX test_pp_step.py:68 / :113 / :161's 1F1B run on 4 stages, b = 2,
    3 steps from a 6-token aligned prefill: (prompts, tokens [3, 8], the
    global cache after the call)."""
    jcfg, jparams, _, _ = _models(seed, tuple(sorted(cfg_kw.items())))
    stages, b, steps, T = 4, 2, 3, 6
    B = stages * b
    max_seq = 256 if kw.get("zero_copy_cache") else 64
    prompts = np.random.default_rng(prompt_seed).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    cache = JKVCache.create(4, B, max_seq, jcfg.num_kv_heads, jcfg.head_dim,
                            dtype=kv)
    logits, cache = jqwen.prefill(jparams, jcfg, jnp.asarray(prompts),
                                  jnp.full((B,), T, jnp.int32), cache)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    mesh = _jmesh(devices8)
    params_s, cache_s = jpp.shard_for_pp(jparams, cache, mesh)
    fn = jpp.make_pp_decode_1f1b(jcfg, mesh, jparams, cache,
                                 microbatch_rows=b, steps=steps, **kw)
    with interpret_pallas(jda), interpret_pallas(jka):
        toks, cache_s = fn(params_s, first.reshape(stages, b),
                           jnp.full((stages,), T, jnp.int32), cache_s)
    return prompts, np.asarray(toks).reshape(steps, B), [
        None if a is None else np.asarray(a) for a in (
            cache_s.k, cache_s.v, cache_s.k_scale, cache_s.v_scale)]


@functools.lru_cache(maxsize=None)
def _j_1f1b(devices8, case):
    if case == "f32":
        return _j_1f1b_case(devices8, CFG_KW, 1, 7, jnp.float32)
    if case == "int8":
        return _j_1f1b_case(devices8, CFG_KW, 1, 13, jnp.int8)
    return _j_1f1b_case(devices8, KERNEL_KW, 1, 9, jnp.float32,
                        use_pallas=True, zero_copy_cache=True)


@pytest.mark.parametrize("case", ["f32", "int8", "zero copy"])
@pytest.mark.parametrize("stages", STAGES)
def test_pp_1f1b_matches_jax(worlds, devices8, stages, case):
    """JAX test_pp_step.py:68 (greedy), :113 (zero-copy vs sliced) and :161
    (INT8 KV): the port's 1F1B tokens equal the JAX pipeline's on every
    rank, in the zero-copy and the sliced form, whose caches are equal bit
    for bit; the f32 caches after the call equal the JAX call's within
    1e-5 (the port skips the JAX warm-up ticks, whose writes the real
    pass overwrites; at 2 stages before the tail's extra position, which
    the stage count decides; the JAX zero-copy run's kernels round inside,
    and the INT8 bytes may part by a rounding step); the zero-copy form
    calls ``forward_hidden`` with ``cache_row0`` on every tick a stage
    works (n_ticks - stage)."""
    kw = KERNEL_KW if case == "zero copy" else CFG_KW
    _, _, tcfg, tparams = _models(1, tuple(sorted(kw.items())))
    prompts, want, jcache = _j_1f1b(tuple(devices8), case)
    b, steps = 8 // stages, 3
    kv = torch.int8 if case == "int8" else torch.float32
    max_seq = 256 if case == "zero copy" else 64
    runs = {zc: worlds(stages).run(jobs.decode_1f1b, tcfg, tparams, prompts,
                                   b, steps, kv, zc, max_seq)
            for zc in (True, False)}
    n_ticks = stages + steps * stages
    for r in range(stages):
        (tz, cz, calls_z), (ts, cs, calls_s) = runs[True][r], runs[False][r]
        assert np.array_equal(tz.reshape(steps, 8), want), (r, tz, want)
        assert np.array_equal(tz, ts), r
        for a, c in zip(cz, cs):
            assert (a is None and c is None) or np.array_equal(a, c), r
        assert len(calls_z) == n_ticks - r and None not in calls_z
        assert calls_s == [None] * (n_ticks - r)
    if case == "f32":
        # the last ticks also run step `steps` (position T + steps) for the
        # microbatches that reach it: which depends on the stage count, so
        # at 2 stages the positions before it
        end = None if stages == 4 else 6 + steps
        for i, j in enumerate(jcache[:2]):
            got = np.concatenate([runs[True][r][1][i]
                                  for r in range(stages)])
            assert got.shape == j.shape
            np.testing.assert_allclose(got[..., :end, :], j[..., :end, :],
                                       rtol=1e-5, atol=1e-5)
