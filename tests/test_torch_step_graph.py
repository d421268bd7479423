"""The decode steps' static-buffer bodies and their capture, on the CPU.

``Engine.generate`` and ``ContinuousBatchingEngine`` decode through one
step body each over static buffers (``engine/engine.py``,
``engine/scheduler.py``), which the card captures as CUDA graphs
(``engine/step_graph.py``) and the CPU runs eagerly.  Here:

* ``Engine.generate`` through those bodies is token-identical to the JAX
  ``Engine.generate`` for greedy decoding: Qwen2 and Qwen3, ragged and
  aligned (uniform) batches, f32 and INT8 KV, W4A8 and W4A16, and the
  tiny Qwen3-MoE (W4A16 experts: the JAX engine quantizes no expert
  activations off a TPU);
* the serving tick is token-identical to the JAX
  ``ContinuousBatchingEngine`` for greedy decoding, f32 and INT8 pools;
* the device-tensor sampling (``SamplingTensors``) is bit-equal to the
  float-valued path it replaced, seeded, with every penalty and top-k /
  top-p;
* the step keys: the same key reuses its step, another key builds its
  own; the scheduler's tick has one key whatever its tables' width;
* the launch accounting of a capture and its replays, on stand-in
  counters and a stand-in graph module, and the cyclic collector held
  off while a step is captured;
* a second call from restored buffers gives the same steps.

The card's own tests (captured against eager, bit for bit) are in
``tests/test_torch_cuda_step_graph.py``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.engine.scheduler import (
    ContinuousBatchingEngine as JCB,
)
from qwen_inference_engine_tpu.engine.scheduler import Request as JRequest
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu.quant.quantize import QuantConfig as JQuant
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine import step_graph
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.ops import sampling
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams

GREEDY = SamplingParams(greedy=True)
MOE = dict(qk_norm=True, hidden_size=256, num_heads=4, num_kv_heads=2,
           head_dim=64, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=256)
_MODELS = {}


def _models(arch: str, fmt: str):
    """(jax cfg, jax params, port cfg, port params): a tiny Qwen2 / Qwen3
    (random biases and norm weights) or the tiny Qwen3-MoE, quantized in
    JAX (W4A8 gs 64, W4A16 gs 64) and carried over."""
    key = (arch, fmt)
    if key in _MODELS:
        return _MODELS[key]
    kw = MOE if arch == "moe" else dict(qk_norm=arch == "qwen3")
    jcfg = j_tiny_config(**kw)
    params = jqwen.init_params(jcfg, jax.random.PRNGKey(3),
                               dtype=jnp.float32)
    rng = np.random.default_rng(29)
    layers = dict(params["layers"])
    for name, leaf in layers.items():
        if isinstance(leaf, JLinear) and leaf.b is not None:
            b = rng.normal(size=leaf.b.shape).astype(np.float32) * 0.5
            layers[name] = dataclasses.replace(leaf, b=jnp.asarray(b))
        elif name in ("input_norm", "post_norm", "q_norm", "k_norm"):
            layers[name] = jnp.asarray(rng.uniform(
                0.5, 1.5, size=leaf.shape).astype(np.float32))
    params = dict(params, layers=layers)
    params = j_quantize_params(params, JQuant(
        bits=4, group_size=128 if arch == "moe" else 64))
    act = 8 if fmt == "w4a8" else 0
    jcfg = jcfg.replace(act_bits=act)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    _MODELS[key] = (jcfg, params, tiny_config(**kw).replace(act_bits=act),
                    tparams)
    return _MODELS[key]


RAGGED = [[5, 9, 17, 3], [100, 200, 300, 400, 500, 42, 11, 12, 13], [7]]
ALIGNED = [[5, 9, 17, 3, 8], [100, 200, 300, 400, 500], [7, 1, 44, 2, 9]]


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("batch", ["ragged", "aligned"])
@pytest.mark.parametrize("fmt", ["w4a8", "w4a16"])
@pytest.mark.parametrize("arch", ["qwen2", "qwen3"])
def test_generate_token_identical_to_jax(arch, fmt, batch, kv):
    jcfg, jparams, tcfg, tparams = _models(arch, fmt)
    prompts = RAGGED if batch == "ragged" else ALIGNED
    jkv, tkv = ((jnp.float32, torch.float32) if kv == "f32"
                else (jnp.int8, torch.int8))
    jeng = JEngine(jcfg, jparams, max_batch=3, max_seq=64,
                   sampling=JSampling(greedy=True), kv_dtype=jkv)
    teng = Engine(tcfg, tparams, max_batch=3, max_seq=64, sampling=GREEDY,
                  kv_dtype=tkv, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=8).token_ids
    assert teng.generate(prompts, max_new_tokens=8).token_ids == want
    # the engine's one cache, cleared and reused: a second call agrees
    assert teng.generate(prompts, max_new_tokens=8).token_ids == want


@pytest.mark.parametrize("batch", ["ragged", "aligned"])
def test_moe_generate_token_identical_to_jax(batch):
    jcfg, jparams, tcfg, tparams = _models("moe", "w4a16")
    prompts = RAGGED if batch == "ragged" else ALIGNED
    jeng = JEngine(jcfg, jparams, max_batch=3, max_seq=64,
                   sampling=JSampling(greedy=True), kv_dtype=jnp.float32)
    teng = Engine(tcfg, tparams, max_batch=3, max_seq=64, sampling=GREEDY,
                  kv_dtype=torch.float32, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=8).token_ids
    assert teng.generate(prompts, max_new_tokens=8).token_ids == want


SERVE_PROMPTS = {0: [5, 9, 17, 3, 5, 9, 17, 3], 1: [40, 41, 42, 43],
                 2: list(range(2, 40)), 3: [7]}


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_serving_tick_token_identical_to_jax(kv):
    """Four requests of 2 to 6 pages of 8 on 3 slots: step_batch windows,
    mixed prefill windows and single ticks through the tick body."""
    jcfg, jparams, tcfg, tparams = _models("qwen2", "w4a8")
    jkv, tkv = ((jnp.float32, torch.float32) if kv == "f32"
                else (jnp.int8, torch.int8))
    outs = []
    for cls, req, extra in (
            (JCB, JRequest, dict(sampling=JSampling(greedy=True),
                                 kv_dtype=jkv)),
            (ContinuousBatchingEngine, Request,
             dict(sampling=GREEDY, kv_dtype=tkv, device="cpu"))):
        cb = cls(cfg=jcfg if cls is JCB else tcfg,
                 params=jparams if cls is JCB else tparams, max_slots=3,
                 page_size=8, num_pages=64, max_pages_per_seq=8,
                 prefill_chunk=16, **extra)
        for rid, p in SERVE_PROMPTS.items():
            cb.submit(req(request_id=rid, prompt=p, max_new_tokens=10))
        outs.append({f.request_id: f.token_ids
                     for f in cb.run_to_completion(sync_every=4)})
    assert outs[0] == outs[1] and len(outs[1]) == 4


def _sample_float(logits, params, seen_mask=None, generator=None):
    """The float-valued sampling the port ran before its parameters became
    device tensors, with torch.multinomial's draw."""
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


SAMPLINGS = {
    "k50-p0.9-rep": SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                   repetition_penalty=1.1),
    "p0.5-presence": SamplingParams(temperature=0.7, top_k=0, top_p=0.5,
                                    presence_penalty=0.4),
    "full-vocab": SamplingParams(temperature=1.3, top_k=0, top_p=1.0),
    "k7-both": SamplingParams(temperature=0.3, top_k=7,
                              repetition_penalty=1.3, presence_penalty=0.2),
    "tiny-temperature": SamplingParams(temperature=0.0, top_k=20,
                                       top_p=0.95),
    "greedy-rep": SamplingParams(greedy=True, repetition_penalty=1.2),
    "greedy-presence": SamplingParams(greedy=True, presence_penalty=0.7),
}


@pytest.mark.parametrize("seen", [False, True], ids=["no-seen", "seen"])
@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_tensor_sampling_is_bit_equal_to_the_float_path(name, seen):
    """The same generator seed, 30 draws of 6 rows of 700 logits: the same
    tokens; a call's tensors loaded once serve every draw."""
    params = SAMPLINGS[name]
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(6, 700)).astype(np.float32)
                              * 4)
    mask = (torch.from_numpy(rng.random((6, 700)) < 0.05) if seen else None)
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    tensors = sampling.SamplingTensors.of(params, "cpu")
    for _ in range(30):
        want = _sample_float(logits, params, mask, g1)
        assert torch.equal(sampling.sample(logits, params, mask, g2, tensors),
                           want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_sampling_tensors_reload_in_place():
    t = sampling.SamplingTensors.create("cpu")
    buf = t.buf
    t.load(SamplingParams(temperature=0.5, top_p=0.8,
                          repetition_penalty=1.2, presence_penalty=0.3))
    assert t.buf is buf
    assert float(t.temperature) == np.float32(0.5)
    assert float(t.inv_temperature) == np.float32(2.0)
    assert float(t.top_p) == np.float32(0.8)
    t.load(SamplingParams(temperature=0.0))
    assert float(t.temperature) == np.float32(1e-6)
    assert float(t.inv_temperature) == np.float32(1) / np.float32(1e-6)


# ------------------------------------------------------- keys and counts


class _Counter:
    """A stand-in kernel wrapper: a launch count."""

    def __init__(self):
        self.launches = 0


class _Graph:
    """A stand-in CUDA graph: counts replays, keeps its generators."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


class _Cuda:
    """A stand-in for ``torch.cuda``'s graph API.  Its capture runs the
    body (the real one records without running): the tests read only the
    counts and the keys."""

    def __init__(self):
        self.graphs = []
        self.pools = 0

    def graph_pool_handle(self):
        self.pools += 1
        return object()

    def CUDAGraph(self):
        self.graphs.append(_Graph())
        return self.graphs[-1]

    @contextlib.contextmanager
    def graph(self, graph, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and pool is not None
        yield


def _stand_in():
    wrappers = {"a": _Counter(), "b": _Counter(), "c": _Counter()}
    cuda = _Cuda()
    return wrappers, cuda, step_graph.StepGraphs("cuda", wrappers=wrappers,
                                                 cuda=cuda)


def test_a_capture_takes_its_launches_back_and_each_replay_adds_them():
    """Step 1 of a key eager (counted), step 2 captured (its calls taken
    back out) and replayed (added once), steps 3.. replayed: every step
    counts what its body launches, once."""
    wrappers, cuda, graphs = _stand_in()

    def body():
        wrappers["a"].launches += 3
        wrappers["b"].launches += 1
        return "out"

    gen = torch.Generator()
    for step in range(1, 6):
        assert graphs.run("k", body, (gen,)) == "out"
        assert wrappers["a"].launches == 3 * step
        assert wrappers["b"].launches == step
        assert wrappers["c"].launches == 0
    assert len(cuda.graphs) == 1 and cuda.graphs[0].replays == 4
    assert cuda.graphs[0].generators == [gen] and cuda.pools == 1


def test_a_key_reuses_its_step_and_another_key_builds_its_own():
    wrappers, cuda, graphs = _stand_in()

    def body_of(name):
        def body():
            wrappers[name].launches += 1
            return name
        return body

    for _ in range(3):
        assert graphs.run(("x", 1), body_of("a")) == "a"
    assert graphs.captured == 1 and len(cuda.graphs) == 1
    for _ in range(3):
        assert graphs.run(("x", 2), body_of("b")) == "b"
    assert graphs.captured == 2 and len(cuda.graphs) == 2
    # the first key's graph is reused, not captured again
    graphs.run(("x", 1), body_of("a"))
    assert len(cuda.graphs) == 2 and cuda.graphs[0].replays == 3
    assert cuda.pools == 1   # one memory pool for the engine's graphs
    assert wrappers["a"].launches == 4 and wrappers["b"].launches == 3


def test_the_cyclic_collector_is_held_off_while_a_step_is_captured():
    """A dead engine freed by the collector inside a capture would destroy
    its graphs there and invalidate the capture: the collector is off
    while the body is captured only, and back on after, also where the
    capture raises."""
    import gc

    wrappers, cuda, graphs = _stand_in()
    seen = []

    def body():
        seen.append(gc.isenabled())
        return "out"

    assert gc.isenabled()
    for _ in range(3):
        graphs.run("k", body)
    # the eager step and the capture ran the body; the replay did not
    assert seen == [True, False] and gc.isenabled()

    def failing():
        seen.append(gc.isenabled())
        if not seen[-1]:
            raise RuntimeError("capture invalidated")

    graphs.run("bad", failing)
    with pytest.raises(RuntimeError, match="invalidated"):
        graphs.run("bad", failing)
    assert seen[2:] == [True, False] and gc.isenabled()
    # a caller that turned the collector off keeps it off
    gc.disable()
    try:
        graphs.run("k2", body)
        graphs.run("k2", body)
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_eager_steps_and_the_cpu_run_every_step_eagerly():
    wrappers, cuda, graphs = _stand_in()

    def body():
        wrappers["c"].launches += 1

    with step_graph.eager_steps():
        assert step_graph.eager()
        for _ in range(3):
            graphs.run("k", body)
    assert not step_graph.eager()
    assert not cuda.graphs and wrappers["c"].launches == 3
    assert graphs.captured == 0
    cpu = step_graph.StepGraphs("cpu", wrappers=wrappers, cuda=cuda)
    for _ in range(3):
        cpu.run("k", body)
    assert not cuda.graphs and wrappers["c"].launches == 6


class _Recording(step_graph.StepGraphs):
    """Runs every step eagerly and records its key."""

    def __init__(self):
        super().__init__("cpu")
        self.calls = []

    def run(self, key, body, generators=()):
        self.calls.append(key)
        return body()


def test_generate_keys_its_steps_as_the_jax_engine_plus_the_port_fields():
    """(top_k, greedy, track_repetition, uniform, pumped, B, S, KV dtype,
    top-p over the whole vocabulary): a call's steps share one key; the
    same call again reuses it; another sampling or batch kind another."""
    _, _, tcfg, tparams = _models("qwen2", "w4a8")
    eng = Engine(tcfg, tparams, max_batch=3, max_seq=64, sampling=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    eng.graphs = rec = _Recording()
    keys = []
    for prompts, sp in ((RAGGED, GREEDY), (RAGGED, GREEDY),
                        (ALIGNED, GREEDY),
                        (RAGGED, SamplingParams(temperature=0.8)),
                        (RAGGED, SamplingParams(temperature=0.5)),
                        (RAGGED, SamplingParams(top_k=0, top_p=0.9)),
                        (RAGGED, SamplingParams(greedy=True,
                                                repetition_penalty=1.2))):
        rec.calls.clear()
        eng.generate(prompts, max_new_tokens=5, sampling=sp)
        assert len(set(rec.calls)) == 1 and len(rec.calls) == 4
        keys.append(rec.calls[0])
    assert keys[0] == keys[1]
    assert keys[0] == (50, True, False, False, False, 3, 256, torch.float32,
                       False)
    assert keys[2][3] is True                  # uniform
    assert keys[3] == keys[4]                  # temperature is a tensor
    assert keys[3][:2] == (50, False)
    assert keys[5][0] == 0 and keys[5][-1] is True
    assert keys[6][2] is True                  # track_repetition
    assert len({keys[0], keys[2], keys[3], keys[5], keys[6]}) == 5


def test_serving_ticks_share_one_key_whatever_the_pages_held():
    """Requests of 2 to 6 pages: every tick runs the one key, over tables
    of the engine's full width, while the pages the rows hold change."""
    _, _, tcfg, tparams = _models("qwen2", "w4a8")
    cb = ContinuousBatchingEngine(tcfg, tparams, max_slots=3, page_size=8,
                                  num_pages=64, max_pages_per_seq=8,
                                  sampling=GREEDY, kv_dtype=torch.float32,
                                  prefill_chunk=16, device="cpu")
    cb.graphs = rec = _Recording()
    held = set()
    run_tables = cb._run_tables

    def record(runs):
        tables = run_tables(runs)
        assert tables.shape == (3, 8)
        held.add(max(len(s.pages) for s in runs))
        return tables

    cb._run_tables = record
    for rid, p in SERVE_PROMPTS.items():
        cb.submit(Request(request_id=rid, prompt=p, max_new_tokens=10))
    cb.run_to_completion(sync_every=4)
    assert len(set(rec.calls)) == 1 and len(rec.calls) > 10
    assert len(held) > 1
    assert cb._tick.tables.shape == (3, 8)


def test_restored_buffers_replay_the_same_steps():
    """The decode buffers' state (cache, tokens, positions, masks, the
    generator) copied after a prefill and loaded back: the same sampled
    steps again."""
    _, _, tcfg, tparams = _models("qwen3", "w4a16")
    sp = SamplingParams(temperature=0.9, top_k=20, repetition_penalty=1.1)
    eng = Engine(tcfg, tparams, max_batch=3, max_seq=64, sampling=sp,
                 kv_dtype=torch.float32, device="cpu")
    eng.start(RAGGED, 9, sp, seed=4)
    b = eng.buffers()
    snap = b.state()
    runs = []
    for _ in range(2):
        logits = [eng.decode().clone() for _ in range(6)]
        runs.append((logits, b.out[:, :7].clone()))
        b.load_state(snap)
    for x, y in zip(runs[0][0], runs[1][0]):
        assert torch.equal(x, y)
    assert torch.equal(runs[0][1], runs[1][1])
    assert int(b.col) == 1 and torch.equal(b.pos, torch.tensor([4, 9, 1]))
