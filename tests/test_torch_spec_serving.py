"""The serving engine over INT8 page pools and with speculative decoding:
the port against the JAX package on the CPU.

Tiny Qwen2 / Qwen3 W4A8 params built in JAX and carried over.  Greedy
``ContinuousBatchingEngine`` runs over an INT8 pool (prefix cache on and
off) and with speculation (prompt lookup through ``step`` and
``step_batch``, a draft model equal to the target) must give the JAX
engine's tokens and the port's own non-speculative run's.  A greedy run's
tokens do not depend on the path, so the JAX engine runs once per model,
KV type and drafting mode (through ``run_to_completion``), and both of the
port's modes are held against it.  The prompts (seed 1) put no near-tie on
any greedy path of these models: seed 0 does (one int8 activation of
Qwen3 rounds apart between the packages and a late token parts).
Stochastic speculative serving runs, repeats under one seed and emits only
valid ids.
"""

import jax.numpy as jnp
import pytest
import torch

from qwen_inference_engine_tpu.engine.scheduler import (
    ContinuousBatchingEngine as JCB,
)
from qwen_inference_engine_tpu.engine.scheduler import Request as JRequest
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from tests.test_torch_model import _build
from tests.test_torch_spec import _prompts

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
KW = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_seq=8,
          prefill_chunk=16)
SPEC = {"plain": {}, "pld": dict(speculative=True, spec_k=4, spec_ngram=3),
        "draft": dict(speculative=True, spec_k=3)}


@pytest.fixture(scope="module", params=[False, True], ids=["qwen2", "qwen3"])
def models(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def jax_tokens(models):
    """The JAX engine's greedy tokens, once per (KV type, drafting)."""
    memo = {}

    def get(kv, spec, n_new):
        key = (kv, spec, n_new)
        if key not in memo:
            jcfg, jparams = models[:2]
            extra = (dict(draft_params=jparams, draft_cfg=jcfg)
                     if spec == "draft" else {})
            eng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
                      kv_dtype=KV[kv][0], **KW, **SPEC[spec], **extra)
            memo[key] = _serve(eng, _prompts(1), "step_batch", JRequest,
                               n_new)
        return memo[key]
    return get


def _engine(models, kv, spec, **kw):
    tcfg, tparams = models[2:]
    extra = (dict(draft_params=tparams, draft_cfg=tcfg)
             if spec == "draft" else {})
    return ContinuousBatchingEngine(tcfg, tparams, sampling=GREEDY,
                                    kv_dtype=KV[kv][1], device="cpu",
                                    **dict(KW, **kw), **SPEC[spec], **extra)


def _serve(engine, prompts, mode, request_cls, n_new=12):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(request_id=i, prompt=p,
                                  max_new_tokens=n_new))
    if mode == "step":
        out = []
        while engine.has_work():
            out += engine.step()
        out += engine._drain_finished()
    else:
        out = engine.run_to_completion()
    return {f.request_id: (f.token_ids, f.finish_reason) for f in out}


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "plain"])
def test_int8_pool_serving_token_identical_to_jax(models, prefix_cache):
    """Two waves over the INT8 pool, the second sharing whole pages and a
    partial page with the first (a prefix hit copies int8 pages and their
    scales)."""
    jcfg, jparams = models[:2]
    jeng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
               kv_dtype=jnp.int8, prefix_cache=prefix_cache, **KW)
    teng = _engine(models, "int8", "plain", prefix_cache=prefix_cache)
    assert teng.cache.quantized
    first = _prompts(1)
    second = [first[0][:17] + [11, 12, 13], list(first[1])]
    got, want = {}, {}
    for wave, prompts in enumerate((first, second)):
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(request_id=10 * wave + i, prompt=p,
                                 max_new_tokens=6))
            teng.submit(Request(request_id=10 * wave + i, prompt=p,
                                max_new_tokens=6))
        want.update({f.request_id: (f.token_ids, f.finish_reason)
                     for f in jeng.run_to_completion()})
        got.update({f.request_id: (f.token_ids, f.finish_reason)
                    for f in teng.run_to_completion()})
        teng.check_page_invariants()
    assert got == want and len(got) == 5
    hits = teng.metrics.snapshot()["prefix_hit_tokens"]
    assert hits == jeng.metrics.snapshot()["prefix_hit_tokens"]
    assert (hits > 0) == prefix_cache


@pytest.mark.parametrize("mode", ["step", "step_batch"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_speculative_serving_token_identical_to_jax(models, jax_tokens, kv,
                                                    mode):
    """Prompt lookup, spec_k 4, ngram 3: host drafts through ``step``,
    device-chained rounds through ``step_batch`` (run_to_completion); the
    JAX engine's tokens, and the port's own non-speculative run's."""
    teng = _engine(models, kv, "pld")
    got = _serve(teng, _prompts(1), mode, Request)
    assert got == jax_tokens(kv, "pld", 12)
    assert _serve(_engine(models, kv, "plain"), _prompts(1), mode,
                  Request) == got
    snap = teng.metrics.snapshot()
    assert snap["spec_rounds"] > 0 and snap["spec_tokens_per_forward"] >= 1
    teng.check_page_invariants()


@pytest.mark.parametrize("mode", ["step", "step_batch"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_draft_model_equal_to_target_accepts_every_draft(models, jax_tokens,
                                                         kv, mode):
    """A drafter equal to the target: every round emits spec_k + 1 tokens
    (the 12 new tokens after the first are three full rounds at spec_k 3
    for each of two requests), the tokens equal the JAX engine's and the
    port's own plain run's, and the drafter's pool is of the target's
    type."""
    teng = _engine(models, kv, "draft")
    assert teng._model_draft and teng.draft_cache.quantized == (kv == "int8")
    prompts = _prompts(1)[:2]
    got = _serve(teng, prompts, mode, Request, n_new=13)
    want = jax_tokens(kv, "draft", 13)
    assert got == {i: want[i] for i in got}
    assert _serve(_engine(models, kv, "plain"), prompts, mode, Request,
                  n_new=13) == got
    snap = teng.metrics.snapshot()
    assert snap["spec_tokens_per_forward"] == 4.0 and snap["spec_rounds"] == 6
    teng.check_page_invariants()


def _prompt_rows(cache, table, n):
    """K / V (and scales) of a row's first n positions in a page pool."""
    ps = cache.page_size
    j = torch.arange(n)
    pages = torch.as_tensor(table, dtype=torch.long)[j // ps]
    return [t[:, pages, :, j % ps]
            for t in (cache.k_pages, cache.v_pages, cache.k_scale,
                      cache.v_scale) if t is not None]


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_drafter_keeps_the_rows_its_prefill_wrote(models, kv):
    """A drafter equal to the target writes the KV of the positions its
    round's verify writes, and never rewrites a row it wrote before.  On
    the card a decode step rounds the last prompt token's KV otherwise
    than the prefill piece that wrote it, and a rewrite would part the
    drafter's forward from the target's.  Here both pools' last prompt
    row is moved the same way after the prefill (a decode step would not
    reproduce it): after every step of the run each decoding row's prompt
    rows in the drafter's pool are still the target's, bit for bit."""
    teng = _engine(models, kv, "draft")
    run_piece = teng._run_piece

    def piece(run, tokens, start, nvalid, table, last):
        tok = run_piece(run, tokens, start, nvalid, table, last)
        if last:
            n, ps = len(run.request.prompt), teng.page_size
            pg = int(teng._block_tables[run.slot][(n - 1) // ps])
            for c in (teng.cache, teng.draft_cache):
                if c.quantized:
                    c.k_scale[:, pg, :, (n - 1) % ps] *= 2
                else:
                    c.k_pages[:, pg, :, (n - 1) % ps] += 0.25
        return tok

    teng._run_piece = piece
    for i, p in enumerate(_prompts(1)[:2]):
        teng.submit(Request(request_id=i, prompt=p, max_new_tokens=13))
    held = 0
    while teng.has_work():
        teng.step()
        for s in teng._slots:
            if s is not None and s.prefill_done and s.generated:
                n = len(s.request.prompt)
                table = teng._block_tables[s.slot]
                got = _prompt_rows(teng.draft_cache, table, n)
                want = _prompt_rows(teng.cache, table, n)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                held += 1
    assert held > 0


@pytest.mark.parametrize("spec", ["pld", "draft"])
def test_stochastic_speculative_serving_repeatable_and_valid(models, spec):
    """Temperature sampling (top-k 20, a repetition penalty) with prompt
    lookup or a draft model, through ``step`` and ``step_batch``: every
    request finishes, every id is in the vocabulary, and one seed gives
    the same tokens twice."""
    tcfg, tparams = models[2:]
    sp = SamplingParams(temperature=1.0, top_k=20, repetition_penalty=1.1)
    extra = dict(draft_params=tparams, draft_cfg=tcfg) if spec == "draft" \
        else {}
    runs = []
    for mode in ("step", "step_batch", "step_batch"):
        eng = ContinuousBatchingEngine(
            tcfg, tparams, sampling=sp, kv_dtype=torch.float32, device="cpu",
            seed=7, speculative=True, spec_k=3, spec_ngram=2, **KW, **extra)
        out = _serve(eng, _prompts(1), mode, Request, n_new=10)
        assert len(out) == 3 and all(r in ("length", "eos")
                                     for _, r in out.values())
        assert all(0 <= t < tcfg.vocab_size
                   for ids, _ in out.values() for t in ids)
        if spec == "draft" or mode == "step_batch":   # host drafts may miss
            assert eng.metrics.snapshot()["spec_rounds"] > 0
        runs.append(out)
    assert runs[1] == runs[2]


@pytest.fixture(scope="module")
def qwen2_models():
    return _build(False)


@pytest.mark.parametrize("page_size,spec_k", [(8, 8), (32, 16)],
                         ids=["window-past-page", "verify-past-16"])
def test_wide_verify_windows_token_identical_to_jax(qwen2_models, page_size,
                                                    spec_k):
    """Prompt lookup with a verify window of spec_k + 1 tokens wider than a
    page (9 > 8) or than 16 rows (17): the windowed append and the verify
    attention take any T, and the tokens equal the JAX engine's."""
    jcfg, jparams, tcfg, tparams = qwen2_models
    kw = dict(KW, page_size=page_size, speculative=True, spec_k=spec_k,
              spec_ngram=2)
    jeng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
               kv_dtype=jnp.float32, **kw)
    teng = ContinuousBatchingEngine(tcfg, tparams, sampling=GREEDY,
                                    kv_dtype=torch.float32, device="cpu", **kw)
    want = _serve(jeng, _prompts(1), "step_batch", JRequest)
    got = _serve(teng, _prompts(1), "step_batch", Request)
    assert got == want and len(got) == 3
    teng.check_page_invariants()
