"""The captured decode steps on the card (marker ``cuda``; without a card
they skip, decided in a fixture, never at import).

``Engine.generate``'s decode step and the serving engine's decode tick
are captured as CUDA graphs (``engine/step_graph.py``).  These tests hold
the captured steps to the same bodies run eagerly under
``step_graph.eager_steps()``: logits, tokens and launch counts bit for
bit, at 2 layers of Qwen2.5-7B's widths (W4A8, bf16 and INT8 KV, ragged
and aligned; W4A16 through ``fused_mlp``; the pumped step at batch 130)
and for a tiny Qwen3-MoE, greedy and sampled; the serving
tick over bf16 and INT8 pools, one graph an engine.  Each path's eager
step runs under ``torch.cuda.set_sync_debug_mode("error")`` (nothing in
it may read back from the device or copy host data to it); the
device-tensor sampling is bit-equal to dividing by the Python floats; a
capture that fails raises, and a dead engine's graphs are not freed
inside another engine's capture.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_step_graph.py -q
"""

import contextlib
from typing import Optional

import pytest
import torch

from qwen_inference_engine_tpu_torch.config import PRESETS, tiny_config
from qwen_inference_engine_tpu_torch.engine import step_graph
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.models import qwen
from qwen_inference_engine_tpu_torch.ops import sampling
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from qwen_inference_engine_tpu_torch.quant.quantize import (
    QuantConfig,
    quantize_params,
)
from qwen_inference_engine_tpu_torch.utils.metrics import (
    kernel_wrappers,
    launch_counts,
)

pytestmark = pytest.mark.cuda

SAMPLED = SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                         repetition_penalty=1.1)
GREEDY = SamplingParams(greedy=True)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for the first build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _dense_7b(gen, fmt="w4a8"):
    """Qwen2.5-7B's widths at 2 layers: W4A8 gs 256; or W4A16 gs 128
    (``fused_mlp`` at decode); or the pumped weights (W4A16 gs 256
    pad-free, INT4 lm_head)."""
    cfg = PRESETS["qwen2.5-7b"].replace(num_layers=2)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    qc = {"w4a8": QuantConfig(bits=4, group_size=256),
          "w4a16": QuantConfig(bits=4, group_size=128),
          "pumped": QuantConfig(bits=4, group_size=256, pad_free=True,
                                quantize_lm_head=True)}[fmt]
    return (cfg.replace(act_bits=8 if fmt == "w4a8" else 0),
            quantize_params(params, qc))


def _moe(gen):
    """A tiny Qwen3-MoE (hidden 256, 8 experts of 256, top-2), W4A8."""
    cfg = tiny_config(qk_norm=True, hidden_size=256, num_heads=4,
                      num_kv_heads=2, head_dim=64, num_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=256)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    return cfg.replace(act_bits=8), quantize_params(
        params, QuantConfig(bits=4, group_size=128))


def _prompts(cfg, lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lengths]


def _decode_run(eng, n):
    """n decode steps of the call ``eng.start`` began: each step's logits
    (copied) and launches, then the tokens written."""
    wrappers = kernel_wrappers()
    logits, launches = [], []
    for _ in range(n):
        before = launch_counts(wrappers)
        out = eng.decode()
        logits.append(out.clone())
        after = launch_counts(wrappers)
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    b = eng.buffers()
    return logits, launches, b.out[:, :n + 1].clone()


@pytest.mark.parametrize("case", [
    "7b ragged bf16", "7b aligned bf16", "7b ragged int8", "7b aligned int8",
    "7b sampled", "7b w4a16", "7b pumped", "moe ragged", "moe sampled"])
def test_captured_decode_steps_equal_eager(gen, case):
    """From one prefill, 6 decode steps captured (the first eager, the
    second captured, then replays) and the same 6 from a copy of the
    buffers and the generator under eager_steps(): logits, tokens and each
    step's launches bit for bit; one graph for the call's key.  W4A16 runs
    its MLP as ``fused_mlp``; the pumped engine an aligned batch of 130
    through ``decode_step_pumped``."""
    fmt = case.split()[1] if case.split()[1] in ("w4a16", "pumped") \
        else "w4a8"
    cfg, params = _moe(gen) if case.startswith("moe") else _dense_7b(gen,
                                                                     fmt)
    kv = torch.int8 if case.endswith("int8") else torch.bfloat16
    lengths = ([64] * 130 if fmt == "pumped" else
               [64] * 4 if "aligned" in case else [37, 120, 64, 5])
    sp = SAMPLED if "sampled" in case else GREEDY
    eng = Engine(cfg, params, max_batch=len(lengths), max_seq=512,
                 kv_dtype=kv, sampling=sp, device="cuda",
                 pumped=fmt == "pumped")
    eng.start(_prompts(cfg, lengths), 8, sp, seed=7)
    snap = eng.buffers().state()
    cap = _decode_run(eng, 6)
    assert eng.graphs.captured == 1
    eng.buffers().load_state(snap)
    with step_graph.eager_steps():
        ref = _decode_run(eng, 6)
    for i, (a, b) in enumerate(zip(cap[0], ref[0])):
        assert torch.equal(a, b), i
    assert cap[1] == ref[1] and all(cap[1])
    assert torch.equal(cap[2], ref[2])
    want = {"w4a16": "fused_mlp", "pumped": "fused_attn_mlp"}.get(fmt)
    assert want is None or cap[1][-1].get(want, 0) > 0


@pytest.mark.parametrize("sp", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_generate_captured_equals_eager(gen, sp):
    """Engine.generate end to end, captured and eager: the same tokens,
    and the same launches; a second call replays the first call's graph."""
    cfg, params = _moe(gen)
    eng = Engine(cfg, params, max_batch=2, max_seq=128, sampling=sp,
                 device="cuda")
    prompts = _prompts(cfg, [9, 30])
    wrappers = kernel_wrappers()
    counts = []
    outs = []
    for ctx in (contextlib.nullcontext(), step_graph.eager_steps(),
                contextlib.nullcontext()):
        with ctx:
            before = launch_counts(wrappers)
            outs.append(eng.generate(prompts, max_new_tokens=12,
                                     seed=3).token_ids)
            after = launch_counts(wrappers)
        counts.append({k: after[k] - before[k] for k in after})
    assert outs[0] == outs[1] == outs[2]
    assert counts[0] == counts[1] == counts[2]
    assert eng.graphs.captured == 1


def _serve(cb, prompts, n_new, sp: Optional[SamplingParams] = None):
    for i, p in enumerate(prompts):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=n_new,
                          sampling=sp))
    done = cb.run_to_completion(sync_every=4)
    return {f.request_id: (f.token_ids, f.finish_reason) for f in done}


@pytest.mark.parametrize("sp", [None, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_serving_tick_captured_equals_eager(gen, kv, sp):
    """The serving engine's ticks (step_batch windows, mixed prefill
    windows, single steps) captured and eager: the same tokens and finish
    reasons, the same launches; one graph serves every tick, whatever the
    tables' width (requests of 1 to 4 pages)."""
    cfg, params = _dense_7b(gen)
    prompts = _prompts(cfg, [5, 40, 100, 200, 17, 64])
    wrappers = kernel_wrappers()
    res, counts, engines = [], [], []
    for ctx in (contextlib.nullcontext(), step_graph.eager_steps()):
        cb = ContinuousBatchingEngine(
            cfg, params, max_slots=4, page_size=64, num_pages=40,
            max_pages_per_seq=8, kv_dtype=kv, sampling=GREEDY,
            prefill_chunk=64, device="cuda")
        with ctx:
            before = launch_counts(wrappers)
            res.append(_serve(cb, prompts, 24, sp))
            after = launch_counts(wrappers)
        counts.append({k: after[k] - before[k] for k in after})
        engines.append(cb)
    assert res[0] == res[1]
    assert counts[0] == counts[1]
    assert engines[0].graphs.captured == 1
    assert engines[1].graphs.captured == 0


def _eager_engine_step(cfg, params, kv, sp, lengths, pumped=False):
    """An engine's decode step after a prefill of ``lengths``."""
    eng = Engine(cfg, params, max_batch=len(lengths), max_seq=512,
                 kv_dtype=kv, sampling=sp, device="cuda", pumped=pumped)
    eng.start(_prompts(cfg, lengths), 4, sp, seed=1)
    torch.cuda.synchronize()
    return eng.decode


def _eager_tick(cfg, params, kv, sp):
    cb = ContinuousBatchingEngine(cfg, params, max_slots=4, page_size=64,
                                  num_pages=40, max_pages_per_seq=8,
                                  kv_dtype=kv, sampling=sp, device="cuda")
    for i, p in enumerate(_prompts(cfg, [5, 40, 100])):
        cb.submit(Request(request_id=i, prompt=p, max_new_tokens=8))
    while len([s for s in cb._slots if s is not None and s.prefill_done]) < 3:
        cb.step()
    cb._load_tick([s for s in cb._slots if s is not None])
    torch.cuda.synchronize()
    return cb._decode_tick


@pytest.mark.parametrize("path", [
    "ragged bf16", "aligned bf16", "ragged int8", "aligned int8", "sampled",
    "w4a16", "pumped", "moe", "tick bf16", "tick int8", "tick sampled"])
def test_eager_decode_step_does_not_sync(gen, path):
    """One eager decode step (or serving tick) of each path under
    set_sync_debug_mode("error"): nothing in a step body waits on the
    device or copies host data to it, so the capture freezes nothing.
    W4A16 runs its MLP as ``fused_mlp``; the pumped step
    ``decode_step_pumped`` at an aligned batch of 130."""
    if path == "moe":
        cfg, params = _moe(gen)
    else:
        cfg, params = _dense_7b(gen, path if path in ("w4a16", "pumped")
                                else "w4a8")
    kv = torch.int8 if path.endswith("int8") else torch.bfloat16
    sp = SAMPLED if "sampled" in path else GREEDY
    if path.startswith("tick"):
        step = _eager_tick(cfg, params, kv, sp)
    elif path == "pumped":
        step = _eager_engine_step(cfg, params, kv, sp, [64] * 130,
                                  pumped=True)
    else:
        lengths = [64] * 4 if "aligned" in path else [37, 120, 64, 5]
        step = _eager_engine_step(cfg, params, kv, sp, lengths)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with step_graph.eager_steps():
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_a_failed_capture_raises(gen):
    """A step body that reads back from the device runs eagerly as a
    key's first step; its capture raises (nothing falls back to running
    eagerly), and the card stays usable."""
    graphs = step_graph.StepGraphs("cuda")
    x = torch.ones(4, device="cuda")

    def body():
        return float((x * 2).sum().item())

    assert graphs.run("k", body) == 8.0
    with pytest.raises(RuntimeError):
        graphs.run("k", body)
    torch.cuda.synchronize()
    assert float(x.sum()) == 4.0


def test_a_dead_engine_is_not_collected_inside_a_capture(gen):
    """An engine that captured its tick and then died in a reference cycle
    waits for the cyclic collector.  Run inside another engine's capture,
    the collector would destroy the dead engine's graph there, which
    invalidates the capture.  Here the dead engine becomes such garbage
    at the start of the second engine's capture, with the collector set
    to run at every allocation: the capture still holds, and the second
    engine serves the first one's tokens."""
    import gc

    cfg, params = _dense_7b(gen)
    prompts = _prompts(cfg, [5, 40, 100])

    def engine():
        return ContinuousBatchingEngine(
            cfg, params, max_slots=4, page_size=64, num_pages=40,
            max_pages_per_seq=8, sampling=GREEDY, prefill_chunk=64,
            device="cuda")

    first = engine()
    want = _serve(first, prompts, 12)
    assert first.graphs.captured == 1
    held = [first]
    del first
    cb = engine()
    body = cb._tick_body

    def tick_body():
        if held and torch.cuda.is_current_stream_capturing():
            loop = {"engine": held.pop()}
            loop["loop"] = loop
            del loop      # the dead engine is now cyclic garbage
        return body()

    cb._tick_body = tick_body
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = _serve(cb, prompts, 12)
    finally:
        gc.set_threshold(*thresholds)
    assert not held and got == want and cb.graphs.captured == 1


def _sample_float(logits, params, seen_mask=None, generator=None):
    """The float-valued sampling this port ran before its parameters
    became device tensors (the Python floats divide and compare on the
    host's side), with torch.multinomial's draw."""
    logits = logits.float()
    if seen_mask is not None:
        pen = torch.as_tensor(params.repetition_penalty, dtype=logits.dtype,
                              device=logits.device).expand(
                                  logits.shape[:1])[:, None]
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(seen_mask, penalized, logits)
        logits = logits - torch.where(
            seen_mask, torch.tensor(float(params.presence_penalty),
                                    device=logits.device), 0.0)
    if params.greedy:
        return torch.argmax(logits, dim=-1)

    def mask_top_p(vals):
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < params.top_p
        keep[..., 0] = True
        return torch.where(keep, vals, torch.full_like(vals, float("-inf")))

    def draw(vals):
        probs = torch.softmax(vals, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    logits = logits / max(float(params.temperature), 1e-6)
    if params.top_k and params.top_k > 0:
        vals, idx = torch.topk(logits, min(params.top_k, logits.shape[-1]),
                               dim=-1)
        return torch.gather(idx, 1, draw(mask_top_p(vals))[:, None])[:, 0]
    if params.top_p < 1.0:
        vals, idx = torch.sort(logits, dim=-1, descending=True)
        return torch.gather(idx, 1, draw(mask_top_p(vals))[:, None])[:, 0]
    return draw(logits)


@pytest.mark.parametrize("params", [
    SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                   repetition_penalty=1.1),
    SamplingParams(temperature=0.7, top_k=0, top_p=0.5,
                   presence_penalty=0.4),
    SamplingParams(temperature=1.3, top_k=0, top_p=1.0),
    SamplingParams(temperature=0.3, top_k=7, repetition_penalty=1.3,
                   presence_penalty=0.2),
    SamplingParams(greedy=True, repetition_penalty=1.2)],
    ids=["k50-p0.9-rep", "p0.5-pres", "full", "k7-both", "greedy"])
def test_tensor_sampling_equals_float_sampling_on_the_card(gen, params):
    """The device-tensor sampling and the float-valued path it replaced
    draw the same tokens from the same generator state, 20 draws of 16
    rows of 152064 logits."""
    logits = torch.randn((16, 152064), generator=gen, device="cuda") * 4
    seen = torch.rand((16, 152064), generator=gen, device="cuda") < 0.01
    g1 = torch.Generator(device="cuda").manual_seed(11)
    g2 = torch.Generator(device="cuda").manual_seed(11)
    tensors = sampling.SamplingTensors.of(params, "cuda")
    for _ in range(20):
        want = _sample_float(logits, params, seen, g1)
        got = sampling.sample(logits, params, seen, g2, tensors)
        assert torch.equal(got, want)
