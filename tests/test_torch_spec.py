"""INT8 page pools and speculative decoding below the scheduler: the port
against the JAX package on the CPU.

Tiny Qwen2 / Qwen3 W4A8 params built in JAX and carried over (as in
tests/test_torch_model.py); the port runs its plain versions, the JAX
package its XLA paths.  Checked: ``pld_draft``; ``forward_hidden`` over an
INT8 page pool (fresh piece, continuation piece, decode) and the verify
forward (``ragged_multi``) over f32 and int8 pools and contiguous caches
(logits atol 1e-3; pools atol 1e-3, an int8 pool's bytes by one
quantization step: a K/V value on a .5 boundary rounds one step apart);
``Engine.generate_speculative`` against the JAX function and the port's
``Engine.generate``; the CLI flags.  The serving engine's tests are in
tests/test_torch_spec_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.engine import speculative as jspec
from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.kvcache.cache import PagedKVCache as JPaged
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu_torch.engine import speculative as tspec
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import (
    paged_cache_from_numpy,
)
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from tests.test_torch_model import _build

GREEDY = SamplingParams(greedy=True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test: the suite runs several workers on few
    cores, and the tiny models' many small ops lose more to thread
    contention than they gain from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
KV = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module", params=[False, True], ids=["qwen2", "qwen3"])
def models(request):
    return _build(request.param)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------- pld_draft -----------------------------------

def _histories(case):
    """(history [B, S], lens [B], ngram, k) of each edge case."""
    rng = np.random.default_rng(len(case))
    if case == "seeded":
        B, S = 4, 64
        hist = rng.integers(2, 40, size=(B, S))
        hist[0, 20:26] = hist[0, 5:11]          # an echo the suffix finds
        hist[1, 30:33] = hist[1, 3:6]
        lens = np.asarray([26, 33, 64, 10])
        return hist, lens, 3, 4
    if case == "no match":
        hist = np.arange(2, 2 + 2 * 48).reshape(2, 48)
        return hist, np.asarray([48, 20]), 3, 4
    if case == "match at the end":
        # the only earlier occurrence of the suffix ends right before it
        # (window [lens - 2n, lens - n)): its continuation is the suffix
        hist = rng.integers(100, 200, size=(1, 32))
        hist[0, 14:17] = hist[0, 17:20] = [7, 8, 9]
        return hist, np.asarray([20]), 3, 5
    if case == "k past the buffer":
        # the match's k continuation tokens would run past S: excluded
        hist = rng.integers(100, 200, size=(2, 16))
        hist[0, 10:12] = hist[0, 14:16] = [3, 4]
        hist[1, 2:4] = hist[1, 14:16] = [5, 6]
        return hist, np.asarray([16, 16]), 2, 5
    raise ValueError(case)


@pytest.mark.parametrize("case", ["seeded", "no match", "match at the end",
                                  "k past the buffer"])
def test_pld_draft_identical_to_jax(case):
    hist, lens, ngram, k = _histories(case)
    want, wfound = jspec.pld_draft(jnp.asarray(hist, jnp.int32),
                                   jnp.asarray(lens, jnp.int32), ngram=ngram,
                                   k=k)
    got, found = tspec.pld_draft(_t(hist).long(), _t(lens), ngram=ngram, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(found.numpy(), np.asarray(wfound))
    if case == "seeded":
        assert found.numpy().tolist()[:2] == [True, True]
    if case == "no match":
        assert not found.any()
    if case == "k past the buffer":
        assert found.numpy().tolist() == [False, True]


# ----------------------------- forward_hidden --------------------------------

@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_forward_and_verify_match_jax(models, kv):
    """Over one pool from zero: a fresh piece (positions 0-15), a
    continuation piece at start 16 whose 13 valid rows end mid-page, two
    decode steps of two rows (the second idle at position 0 on a zeroed
    table row), then a verify forward of 5 tokens per row (row 0 at 31, its
    window straddling pages 3 and 4; the idle row at 0).  Logits and the
    whole pool (scales included) against the JAX XLA path."""
    jcfg, jparams, tcfg, tparams = models
    jdt, tdt = KV[kv]
    L, Hk, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    page, T, P, max_pages = 8, 16, 12, 6
    rng = np.random.default_rng(5 + jcfg.qk_norm)
    jp = JPaged.create(L, P, page, Hk, D, dtype=jdt)
    tp = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp.quantized == (kv == "int8")
    table = np.zeros((1, max_pages), np.int32)
    table[0, :5] = rng.permutation(np.arange(1, P))[:5]
    prompt = rng.integers(2, jcfg.vocab_size, size=29)

    for start in (0, T):
        toks = np.zeros((1, T), np.int32)
        piece = prompt[start:start + T]
        toks[0, :len(piece)] = piece
        pos = start + np.arange(T, dtype=np.int32)[None]
        jh, jp = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(pos), jp, jnp.asarray(table),
                                      fresh_prefill=start == 0,
                                      attn_impl="xla")
        th, tp = tqwen.forward_hidden(tparams, tcfg, _t(toks).long(),
                                      _t(pos).long(), tp,
                                      block_tables=_t(table),
                                      fresh_prefill=start == 0,
                                      start=start or None)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3,
                                   rtol=0)
    tables = np.concatenate([table, np.zeros_like(table)])
    for step in range(2):
        nxt = rng.integers(2, jcfg.vocab_size, size=(2,)).astype(np.int32)
        pos = np.asarray([29 + step, 0], np.int32)
        jl, jp = jqwen.decode_step(jparams, jcfg, jnp.asarray(nxt),
                                   jnp.asarray(pos), jp, jnp.asarray(tables),
                                   attn_impl="xla")
        tl, tp = tqwen.decode_step(tparams, tcfg, _t(nxt).long(),
                                   _t(pos).long(), tp, _t(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=0)
    toks = rng.integers(2, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    pos = np.asarray([31, 0], np.int32)[:, None] + np.arange(5)[None]
    jh, jp = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos), jp, jnp.asarray(tables),
                                  ragged_multi=True, attn_impl="xla")
    th, tp = tqwen.forward_hidden(tparams, tcfg, _t(toks).long(),
                                  _t(pos).long(), tp, block_tables=_t(tables),
                                  ragged_multi=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3, rtol=0)
    # an int8 pool's bytes compare by the quantization step: a K/V value on
    # a .5 boundary rounds one step apart (the f32 K/V differ in the last
    # bit); the scales and an f32 pool to 1e-3
    step = 1 if kv == "int8" else 1e-3
    pairs = [(tp.k_pages, jp.k_pages, step), (tp.v_pages, jp.v_pages, step)]
    if kv == "int8":
        pairs += [(tp.k_scale, jp.k_scale, 1e-3), (tp.v_scale, jp.v_scale,
                                                   1e-3)]
    for got, want, tol in pairs:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=1e-6)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_contiguous_verify_forward_matches_jax(models, kv):
    """The fixed-batch speculative verify: three ragged rows prefilled,
    then 5 consecutive tokens per row from each row's own length (a
    per-row window write and the chunk kernel's plain version with per-row
    starts; the JAX package's XLA scatter and attention)."""
    jcfg, jparams, tcfg, tparams = models
    jdt, tdt = KV[kv]
    L, Hk, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(7 + jcfg.qk_norm)
    lens = np.asarray([5, 12, 9], np.int32)
    tokens = rng.integers(2, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    jc = JKVCache.create(L, 3, 64, Hk, D, dtype=jdt)
    tc = KVCache.create(L, 3, 64, Hk, D, dtype=tdt)
    jl, jc = jqwen.prefill(jparams, jcfg, jnp.asarray(tokens),
                           jnp.asarray(lens), jc, attn_impl="xla")
    tl, tc = tqwen.prefill(tparams, tcfg, _t(tokens).long(), _t(lens).long(),
                           tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    toks = rng.integers(2, jcfg.vocab_size, size=(3, 5)).astype(np.int32)
    pos = lens[:, None] + np.arange(5)[None]
    jh, jc = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos), jc, attn_impl="xla")
    th, tc = tqwen.forward_hidden(tparams, tcfg, _t(toks).long(),
                                  _t(pos).long(), tc, ragged_multi=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3, rtol=0)


def _prompts(seed):
    """A passage followed by its first half again, a row that repeats a
    short cycle, and a plain random prompt (the serving tests' traffic)."""
    rng = np.random.default_rng(seed)
    passage = rng.integers(2, 500, size=20).tolist()
    cycle = rng.integers(2, 500, size=4).tolist()
    return [passage + passage[:10], cycle * 6,
            rng.integers(2, 500, size=27).tolist()]


# --------------------------- the fixed-batch engine ---------------------------

def test_generate_speculative_identical_to_jax_and_to_generate(models):
    """Engine.generate_speculative (k 4, ngram 3) against the JAX function
    on a full batch (the JAX one writes every cache row), and against the
    port's greedy Engine.generate, on a full and a partial batch."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(101) + [_prompts(201)[1][:9]]
    jeng = JEngine(jcfg, jparams, max_batch=4, max_seq=128,
                   sampling=JSampling(greedy=True), kv_dtype=jnp.float32)
    teng = Engine(tcfg, tparams, max_batch=4, max_seq=128, sampling=GREEDY,
                  kv_dtype=torch.float32, device="cpu")
    want = jeng.generate_speculative(prompts, max_new_tokens=14, k=4)
    got = teng.generate_speculative(prompts, max_new_tokens=14, k=4)
    assert got == want
    assert teng.generate(prompts, max_new_tokens=14).token_ids == got
    assert teng.generate_speculative(prompts[1:], max_new_tokens=14,
                                     k=4) == got[1:]


# ---------------------------------- the CLI ----------------------------------

def test_cli_serve_speculative_int8_and_generate_speculative_on_cpu(
        monkeypatch, capsys):
    """``serve --speculative --kv-bits 8 --device cpu`` builds the server
    (prompt lookup over an INT8 pool), binds and stops; ``generate
    --speculative --device cpu`` prints the greedy tokens."""
    from qwen_inference_engine_tpu_torch.server import cli
    from qwen_inference_engine_tpu_torch.server import http as thttp

    built = []

    class Interrupted(thttp.ThreadingHTTPServer):
        def serve_forever(self, poll_interval=0.5):
            built.append(self.server_address)
            raise KeyboardInterrupt

    monkeypatch.setattr(thttp, "ThreadingHTTPServer", Interrupted)
    common = ["--model", "tiny", "--bits", "4", "--group-size", "64",
              "--act-bits", "8", "--device", "cpu", "--max-seq", "128"]
    rc = cli.main(["serve", *common, "--kv-bits", "8", "--speculative",
                   "--spec-k", "3", "--spec-ngram", "2", "--port", "0",
                   "--max-slots", "2", "--page-size", "16"])
    out = capsys.readouterr().out
    assert rc == 0 and built and "int8" in out and "speculative k=3" in out
    rc = cli.main(["generate", *common, "--kv-bits", "32", "--greedy",
                   "--speculative", "--spec-k", "4", "--prompt", "abcabc",
                   "--max-new-tokens", "6"])
    cap = capsys.readouterr()
    assert rc == 0 and "sequence 0" in cap.out and "speculative k=4" in cap.err
