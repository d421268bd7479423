"""The port's ContinuousBatchingEngine: against the JAX package's, and on
its own.

Against the JAX package: tiny Qwen2 / Qwen3 W4A8 (params built in JAX and
carried over, f32 params and KV), pages of 8 and 16, more requests than
slots, prompts of one to four pages that take more than one prefill piece,
a second wave that shares prefixes with the first, the prefix cache on and
off: every request's greedy tokens, its finish reason and the prefix-hit
count are identical (the JAX engine runs its XLA path on the CPU).

On its own, mirroring tests/test_engine.py (without its speculative, MoE
and mesh tests): admission control, oversize rejection, cancel and timeout,
per-request sampling and stop ids, the prefix cache (exact reuse, sharing,
generated-token pages, eviction, partial pages, sub-page tails), chained
windows equal to per-tick ``step()``, the page-invariant fuzz, and serving
equal to the port's own fixed-batch ``Engine.generate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.engine.scheduler import (
    ContinuousBatchingEngine as JCB,
)
from qwen_inference_engine_tpu.engine.scheduler import Request as JRequest
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models.qwen import (
    decode_step,
    init_params,
    prefill,
)
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from tests.test_torch_model import _build

CFG = tiny_config()
PARAMS = init_params(CFG, torch.Generator().manual_seed(42),
                     dtype=torch.float32)
GREEDY = SamplingParams(greedy=True)


# ----------------------------- vs the JAX package -----------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["qwen2", "qwen3"])
def models(request):
    return _build(request.param)


def _waves(page: int):
    """Two waves of prompts: the first spans one to four pages, the second
    shares whole pages and a partial page with the first."""
    rng = np.random.default_rng(page)

    def prompt(n):
        return rng.integers(2, 500, size=n).tolist()

    first = [prompt(n) for n in (page - 3, 2 * page + 5, 4 * page - 1,
                                 3 * page, page + 1)]
    second = [first[2][: 3 * page + 2] + prompt(4), first[3][:page] +
              prompt(page // 2), list(first[1])]
    return first, second


def test_serving_w4a16_greedy_token_identical_to_jax():
    """INT4 weights with bf16 activations (the CLI's default act_bits 0) and
    an INT4 lm_head, pages of 16, the prefix cache on."""
    jcfg, jparams, tcfg, tparams = _build(False, bits=4, group_size=64,
                                          act_bits=0, quantize_lm_head=True)
    kw = dict(max_slots=2, page_size=16, num_pages=40, max_pages_per_seq=8,
              prefill_chunk=16, prefix_cache=True)
    jeng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
               kv_dtype=jnp.float32, **kw)
    teng = ContinuousBatchingEngine(tcfg, tparams, sampling=GREEDY,
                                    kv_dtype=torch.float32, device="cpu", **kw)
    got, want = {}, {}
    rid = 0
    for wave in _waves(16):
        for p in wave:
            jeng.submit(JRequest(request_id=rid, prompt=p, max_new_tokens=4))
            teng.submit(Request(request_id=rid, prompt=p, max_new_tokens=4))
            rid += 1
        for f in jeng.run_to_completion():
            want[f.request_id] = (f.token_ids, f.finish_reason)
        for f in teng.run_to_completion():
            got[f.request_id] = (f.token_ids, f.finish_reason)
    assert got == want and len(got) == 8
    assert teng.metrics.snapshot()["prefix_hit_tokens"] == \
        jeng.metrics.snapshot()["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "plain"])
@pytest.mark.parametrize("page", [8, 16])
def test_serving_greedy_token_identical_to_jax(models, page, prefix_cache):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(max_slots=2, page_size=page, num_pages=40, max_pages_per_seq=8,
              prefill_chunk=16, prefix_cache=prefix_cache)
    jeng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
               kv_dtype=jnp.float32, **kw)
    teng = ContinuousBatchingEngine(tcfg, tparams, sampling=GREEDY,
                                    kv_dtype=torch.float32, device="cpu", **kw)
    got, want = {}, {}
    rid = 0
    for wave in _waves(page):
        for p in wave:
            n_new = 3 + rid % 4
            jeng.submit(JRequest(request_id=rid, prompt=p,
                                 max_new_tokens=n_new))
            teng.submit(Request(request_id=rid, prompt=p,
                                max_new_tokens=n_new))
            rid += 1
        for f in jeng.run_to_completion():
            want[f.request_id] = (f.token_ids, f.finish_reason)
        for f in teng.run_to_completion():
            got[f.request_id] = (f.token_ids, f.finish_reason)
        teng.check_page_invariants()
    assert got == want
    hits = teng.metrics.snapshot()["prefix_hit_tokens"]
    assert hits == jeng.metrics.snapshot()["prefix_hit_tokens"]
    assert (hits > 0) == prefix_cache


def test_near_max_seq_prompt_sent_twice_with_the_prefix_cache(models,
                                                              monkeypatch):
    """A prompt one token short of the table's end, sent again: 3 full-page
    hits and a partial copy leave one token, whose bucket-padded piece
    (start 27, 16 tokens) runs past the 4-page table (32 tokens).  Both
    requests finish, as in the JAX engine, token for token."""
    from qwen_inference_engine_tpu_torch.models import qwen as tqwen

    pieces = []
    chunk = tqwen.paged_chunk_attention

    def spy(q, *a):
        pieces.append((a[-2], q.shape[1]))
        return chunk(q, *a)

    monkeypatch.setattr(tqwen, "paged_chunk_attention", spy)
    jcfg, jparams, tcfg, tparams = models
    kw = dict(max_slots=1, page_size=8, num_pages=12, max_pages_per_seq=4,
              prefix_cache=True)
    jeng = JCB(jcfg, jparams, sampling=JSampling(greedy=True),
               kv_dtype=jnp.float32, **kw)
    teng = ContinuousBatchingEngine(tcfg, tparams, sampling=GREEDY,
                                    kv_dtype=torch.float32, device="cpu", **kw)
    prompt = np.random.default_rng(3).integers(2, 500, size=28).tolist()
    got, want = [], []
    for rid in (0, 1):
        jeng.submit(JRequest(request_id=rid, prompt=prompt, max_new_tokens=4))
        teng.submit(Request(request_id=rid, prompt=prompt, max_new_tokens=4))
        want += [(f.token_ids, f.finish_reason)
                 for f in jeng.run_to_completion()]
        got += [(f.token_ids, f.finish_reason)
                for f in teng.run_to_completion()]
        teng.check_page_invariants()
    assert teng.metrics.snapshot()["prefix_hit_tokens"] == len(prompt) - 1
    assert set(pieces) == {(27, 16)}
    assert got == want
    assert got[1] == got[0] and got[0][1] == "length"


# ------------------------------- on its own ----------------------------------

def _engine(**kw):
    base = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_seq=16,
                sampling=GREEDY, kv_dtype=torch.float32, device="cpu")
    base.update(kw)
    return ContinuousBatchingEngine(CFG, PARAMS, **base)


def _manual_greedy(prompt, steps):
    cache = KVCache.create(CFG.num_layers, 1, 128, CFG.num_kv_heads,
                           CFG.head_dim, dtype=torch.float32)
    logits, cache = prefill(PARAMS, CFG, torch.tensor([prompt]),
                            torch.tensor([len(prompt)]), cache)
    out = [int(logits[0].argmax())]
    for s in range(1, steps):
        pos = torch.tensor([len(prompt) + s - 1])
        logits, cache = decode_step(PARAMS, CFG, torch.tensor([out[-1]]), pos,
                                    cache)
        out.append(int(logits[0].argmax()))
        if out[-1] in CFG.eos_token_ids:
            break
    return out


def test_serving_matches_the_fixed_batch_engine():
    prompts = [[5, 9, 17, 3], [100, 200, 300, 400, 500, 42], [7, 8, 9]]
    cb = _engine()
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=6))
    by_id = {f.request_id: f for f in cb.run_to_completion()}
    eng = Engine(CFG, PARAMS, max_batch=3, max_seq=128, sampling=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    want = eng.generate(prompts, max_new_tokens=6).token_ids
    for i, p in enumerate(prompts):
        assert by_id[i].token_ids == want[i][: len(by_id[i].token_ids)]
        assert by_id[i].token_ids[: len(want[i])] == want[i]
        assert by_id[i].token_ids[:6] == _manual_greedy(p, 6)[:6]


def test_admission_control_and_pages_returned():
    cb = _engine(page_size=4, num_pages=16, max_pages_per_seq=8)
    for i in range(5):
        cb.submit(Request(request_id=i, prompt=[i + 1, i + 2, i + 3],
                          max_new_tokens=4))
    finished = cb.run_to_completion()
    assert sorted(f.request_id for f in finished) == list(range(5))
    assert all(len(f.token_ids) >= 1 for f in finished)
    assert sorted(cb._free_pages + list(cb._cached_free)) == list(range(1, 16))
    cb.check_page_invariants()


def test_rejects_oversized():
    cb = _engine(max_slots=1, page_size=4, num_pages=8, max_pages_per_seq=2)
    cb.submit(Request(request_id=0, prompt=[1, 2, 3], max_new_tokens=100))
    assert cb.run_to_completion()[0].finish_reason == "rejected"


def test_chunked_prefill_across_ticks_matches_manual():
    short = [7, 8, 9]
    long = list(range(1, 41))   # 40 tokens > prefill_chunk=16 -> 3 pieces
    cb = _engine(prefill_chunk=16)
    cb.submit(Request(request_id=0, prompt=short, max_new_tokens=8))
    done = cb.step()
    cb.submit(Request(request_id=1, prompt=long, max_new_tokens=6))
    ticks = 0
    while cb.has_work():
        done += cb.step()
        ticks += 1
        assert ticks < 64
    by_id = {f.request_id: f for f in done + cb.run_to_completion()}
    for rid, prompt, n in ((0, short, 8), (1, long, 6)):
        expect = _manual_greedy(prompt, n)
        assert by_id[rid].token_ids[: len(expect)] == expect


def test_stats_decode_throughput_nonzero():
    cb = _engine()
    cb.submit(Request(request_id=0, prompt=[5, 6, 7], max_new_tokens=5))
    while cb.has_work():
        cb.step()
    snap = cb.metrics.snapshot()
    assert snap["decode_tokens"] >= 4 and snap["decode_tokens_per_s"] > 0.0
    assert snap["ttft_p50_s"] > 0.0
    assert snap["spec_rounds"] == 0 and snap["prefix_hit_tokens"] == 0


def test_cancel_and_timeout():
    cb = _engine()
    free0 = cb._page_budget()
    cb.submit(Request(request_id=0, prompt=[5, 6, 7], max_new_tokens=50))
    cb.submit(Request(request_id=1, prompt=[8, 9], max_new_tokens=50,
                      timeout_s=0.0))
    done = cb.step()
    assert cb.cancel(0)
    out = {f.request_id: f for f in done + cb.run_to_completion()}
    assert out[0].finish_reason == "cancelled"
    assert out[1].finish_reason == "timeout"
    assert not cb.has_work()
    assert cb._page_budget() == free0
    assert cb.cancel(99) is False


def test_per_request_sampling_and_greedy_in_decode():
    """A cold (top-1) and a greedy request reproduce the solo greedy chain
    beside a hot neighbour, on an engine whose default samples."""
    prompt = [5, 9, 17, 3]
    expect = _manual_greedy(prompt, 8)
    for own in (SamplingParams(temperature=1e-6, top_k=1),
                SamplingParams(greedy=True)):
        cb = _engine(sampling=SamplingParams(temperature=5.0, top_k=50))
        cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=8,
                          sampling=own))
        cb.submit(Request(request_id=1, prompt=[7, 8, 9], max_new_tokens=8))
        by_id = {f.request_id: f for f in cb.run_to_completion()}
        assert by_id[0].token_ids == expect[: len(by_id[0].token_ids)]


def test_repetition_penalty_active_in_serving():
    prompt = [5, 9, 17, 3]

    def serve(pen):
        cb = _engine(max_slots=1)
        cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=12,
                          sampling=SamplingParams(greedy=True,
                                                  repetition_penalty=pen)))
        return cb.run_to_completion()[0].token_ids

    plain = serve(1.0)
    assert plain == _manual_greedy(prompt, 12)[: len(plain)]
    penalized = serve(1e6)
    seen = set(prompt)
    for t in penalized:
        if t in CFG.eos_token_ids:
            break
        assert t not in seen, (penalized, plain)
        seen.add(t)


def test_seen_mask_not_polluted_by_prefilling_slots():
    prompt_b = list(range(50, 90))   # 40 tokens > prefill_chunk=16

    def serve_b(with_neighbor):
        cb = _engine(prefill_chunk=16, prefix_cache=False)
        if with_neighbor:
            cb.submit(Request(request_id=9, prompt=[7, 8, 9],
                              max_new_tokens=20))
            cb.step()
        cb.submit(Request(request_id=0, prompt=prompt_b, max_new_tokens=8,
                          sampling=SamplingParams(greedy=True,
                                                  repetition_penalty=1e6)))
        return {f.request_id: f for f in cb.run_to_completion()}[0].token_ids

    assert serve_b(True) == serve_b(False)


def test_top_k_cap_widens_selection():
    cb = _engine(max_slots=1, num_pages=32, max_pages_per_seq=8,
                 sampling=SamplingParams(temperature=0.8, top_k=50),
                 top_k_cap=256)
    assert cb.k_cap == 256
    cb.submit(Request(request_id=0, prompt=[5, 9, 17], max_new_tokens=3,
                      sampling=SamplingParams(temperature=0.8, top_k=200)))
    fins = cb.run_to_completion()
    assert len(fins) == 1 and len(fins[0].token_ids) == 3
    with pytest.raises(AssertionError):
        _engine(sampling=SamplingParams(temperature=0.8, top_k=50),
                top_k_cap=10)


def test_per_request_stop_token_ids():
    prompt = [5, 9, 17, 3]
    full = _manual_greedy(prompt, 10)
    assert len(full) >= 3
    cb = _engine(max_slots=1)
    cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=10,
                      stop_token_ids=[full[2]]))
    out = cb.run_to_completion()[0]
    assert out.finish_reason == "eos" and out.token_ids == full[:3]


def _serve_per_tick_and_chained(build, window):
    """The same engine state served by step() alone and by step_batch."""
    def drain(cb, fn):
        got = {}
        while cb.has_work():
            for f in fn(cb):
                got[f.request_id] = f.token_ids
        for f in cb.run_to_completion():
            got[f.request_id] = f.token_ids
        cb.check_page_invariants()
        return got

    return (drain(build(), lambda cb: cb.step()),
            drain(build(), lambda cb: cb.step_batch(window)))


def test_step_batch_matches_per_tick_step():
    """Chained decode windows (tokens fed on the device, one sync) equal
    per-tick serving, a stochastic row included."""
    stoch = SamplingParams(temperature=0.8, top_k=30)

    def build():
        cb = _engine(max_slots=3, seed=5)
        for i, p in enumerate([[5, 9, 17, 3], [7, 8, 9], [40, 41]]):
            cb.submit(Request(request_id=i, prompt=p, max_new_tokens=10 + i,
                              sampling=stoch if i == 1 else None))
        return cb

    ref, got = _serve_per_tick_and_chained(build, 4)
    assert got == ref


def test_mixed_chain_batch_matches_per_tick_step():
    """A slot mid-prefill (interior pieces) chained with decode ticks equals
    per-tick serving, a stochastic row included; the mixed path ran windows
    of more than one pair."""
    long_prompt = [(3 * j) % 200 + 1 for j in range(40)]
    stoch = SamplingParams(temperature=0.8, top_k=30)
    calls = []

    def build():
        cb = _engine(max_slots=3, num_pages=96, prefill_chunk=8, seed=11)
        for i, p in enumerate([[5, 9, 17, 3], [7, 8, 9]]):
            cb.submit(Request(request_id=i, prompt=p, max_new_tokens=24,
                              sampling=stoch if i == 1 else None))
        for _ in range(3):
            cb.step()
        cb.submit(Request(request_id=9, prompt=long_prompt, max_new_tokens=4))
        orig = cb._mixed_chain_batch
        cb._mixed_chain_batch = lambda n, d, t: (calls.append(n)
                                                 or orig(n, d, t))
        return cb

    ref, got = _serve_per_tick_and_chained(build, 4)
    assert calls and max(calls) >= 2, calls
    assert got == ref


def test_fuzz_page_invariants():
    """Random submit / step / cancel churn: no page double-booked, tables
    consistent, every request ends once with a sane reason."""
    rng = np.random.default_rng(123)
    cb = _engine(max_slots=3, page_size=4, num_pages=48, max_pages_per_seq=12,
                 prefill_chunk=16)
    submitted, all_ids, finished = 0, [], []
    for _ in range(60):
        action = rng.random()
        if action < 0.5 and submitted < 18:
            plen = int(rng.integers(1, 20))
            cb.submit(Request(request_id=submitted,
                              prompt=rng.integers(1, 400, plen).tolist(),
                              max_new_tokens=int(rng.integers(1, 8))))
            all_ids.append(submitted)
            submitted += 1
        elif action < 0.6 and all_ids:
            cb.cancel(int(rng.choice(all_ids)))
        finished += cb.step_batch(int(rng.integers(1, 4)))
        cb.check_page_invariants()
    finished += cb.run_to_completion()
    ids = [f.request_id for f in finished]
    assert len(set(ids)) == len(ids), "completion delivered twice"
    assert set(ids) == set(all_ids)
    assert all(f.finish_reason in ("eos", "length", "rejected", "cancelled",
                                   "timeout") for f in finished)
    assert not cb.has_work()
    assert sorted(cb._free_pages + list(cb._cached_free)) == list(
        range(1, cb.num_pages))


# ---------------------------- the prefix cache -------------------------------

def _pc(**kw):
    base = dict(num_pages=32, max_pages_per_seq=8)
    base.update(kw)
    return _engine(**base)


def test_prefix_cache_sequential_reuse_exact():
    """2 full pages + 3 rows of the third through the partial-page copy;
    token-identical to the fresh run."""
    prompt = list(range(1, 21))
    expect = _manual_greedy(prompt, 6)
    cb = _pc()
    cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=6))
    first = cb.run_to_completion()[0]
    assert cb.metrics.snapshot()["prefix_hit_tokens"] == 0
    cb.submit(Request(request_id=1, prompt=prompt, max_new_tokens=6))
    second = cb.run_to_completion()[0]
    assert cb.metrics.snapshot()["prefix_hit_tokens"] == 19
    assert first.token_ids[: len(expect)] == expect
    assert second.token_ids == first.token_ids
    cb.check_page_invariants()


def test_prefix_cache_concurrent_sharing():
    prompt = [3 * i + 1 for i in range(19)]
    expect = _manual_greedy(prompt, 5)
    cb = _pc()
    cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=5))
    cb.run_to_completion()
    cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=5))
    cb.submit(Request(request_id=1, prompt=prompt, max_new_tokens=5))
    cb.step()
    assert [p for p, n in cb._page_refs.items() if n == 2]
    cb.check_page_invariants()
    done = {f.request_id: f for f in cb.run_to_completion()}
    for rid in (0, 1):
        assert done[rid].token_ids[: len(expect)] == expect
    cb.check_page_invariants()


def test_prefix_cache_extends_into_generated_tokens():
    prompt = list(range(40, 52))
    cb = _pc()
    cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=8))
    first = cb.run_to_completion()[0]
    convo = prompt + first.token_ids
    expect = _manual_greedy(convo, 4)
    cb.submit(Request(request_id=1, prompt=convo, max_new_tokens=4))
    second = cb.run_to_completion()[0]
    assert cb.metrics.snapshot()["prefix_hit_tokens"] >= 16
    assert second.token_ids[: len(expect)] == expect
    cb.check_page_invariants()


@pytest.mark.parametrize("max_new", [4, 1], ids=["full-pages", "sub-page-tail"])
def test_prefix_cache_eviction_under_pressure(max_new):
    """Cached ref-0 pages (whole pages, or a registered sub-page tail) are
    reclaimed when live work needs the pool; a resubmit re-prefills
    correctly."""
    pa = list(range(1, 18 if max_new == 4 else 20))
    cb = _pc(num_pages=12, max_pages_per_seq=6)
    cb.submit(Request(request_id=0, prompt=pa, max_new_tokens=max_new))
    cb.run_to_completion()
    assert cb._cached_free
    assert any(h in cb._prefix_index for h in cb._cached_free.values())
    for i in range(1, 4):
        cb.submit(Request(request_id=i, prompt=[100 * i + j for j in range(17)],
                          max_new_tokens=4))
    cb.run_to_completion()
    cb.check_page_invariants()
    expect = _manual_greedy(pa, 4)
    cb.submit(Request(request_id=9, prompt=pa, max_new_tokens=4))
    assert cb.run_to_completion()[0].token_ids[: len(expect)] == expect
    cb.check_page_invariants()


def test_prefix_cache_disabled_unchanged():
    prompt = list(range(1, 21))
    cb = _pc(prefix_cache=False)
    for rid in (0, 1):
        cb.submit(Request(request_id=rid, prompt=prompt, max_new_tokens=4))
    cb.run_to_completion()
    assert cb.metrics.snapshot()["prefix_hit_tokens"] == 0
    assert not cb._cached_free
    assert sorted(cb._free_pages) == list(range(1, cb.num_pages))
    cb.check_page_invariants()


def test_prefix_cache_partial_page_divergent_tail():
    p1 = list(range(1, 21))
    p2 = p1[:19] + [499]             # diverges inside the third page
    e2 = _manual_greedy(p2, 6)
    cb = _pc()
    cb.submit(Request(request_id=0, prompt=p1, max_new_tokens=6))
    cb.run_to_completion()
    cb.submit(Request(request_id=1, prompt=p2, max_new_tokens=6))
    out = cb.run_to_completion()[0]
    assert cb.metrics.snapshot()["prefix_hit_tokens"] == 19
    assert out.token_ids == e2
    cb.check_page_invariants()


def test_prefix_cache_sub_page_tail_registered():
    """max_new=1 writes only the prompt: 2 full pages + a 4-row tail; a
    resubmit reuses 16 + 3 tokens and stays token-identical."""
    prompt = list(range(1, 21))
    expect = _manual_greedy(prompt, 6)
    cb = _pc()
    cb.submit(Request(request_id=0, prompt=prompt, max_new_tokens=1))
    cb.run_to_completion()
    cb.submit(Request(request_id=1, prompt=prompt, max_new_tokens=6))
    out = cb.run_to_completion()[0]
    assert cb.metrics.snapshot()["prefix_hit_tokens"] == 19
    assert out.token_ids[: len(expect)] == expect
    cb.check_page_invariants()


def test_cache_aware_admission_prefers_hot_prefix():
    hot = list(range(1, 18))
    cold = [400 + i for i in range(17)]
    cb = _pc(max_slots=1)
    cb.submit(Request(request_id=0, prompt=hot, max_new_tokens=4))
    cb.run_to_completion()
    cb.submit(Request(request_id=1, prompt=cold, max_new_tokens=4))
    cb.submit(Request(request_id=2, prompt=hot, max_new_tokens=4))
    cb.step()
    s = next(s for s in cb._slots if s is not None)
    assert s.request.request_id == 2
    assert {f.request_id for f in cb.run_to_completion()} == {1, 2}
    cb.check_page_invariants()
