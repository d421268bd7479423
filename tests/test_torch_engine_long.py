"""Greedy Engine.generate with prompts longer than one 512-token chunk.

Prompts of 530-900 tokens fall in the 1024 bucket: chunk 0 is a fresh
prefill, chunk 1 a continuation over the cache (chunk_attention_contiguous
[_q8] on the card, its plain version here).  The port must be
token-identical to the JAX Engine for tiny Qwen2 / Qwen3 W4A8, aligned and
ragged, in an f32 and an int8 KV cache (max_seq 1280).  Each JAX engine is
built once per model and KV type, so its prefill compiles once for both
batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from tests.test_torch_model import _build

KV = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
BATCHES = {"aligned": [700, 700, 700], "ragged": [530, 777, 900]}


@pytest.fixture(scope="module", params=[False, True], ids=["qwen2", "qwen3"])
def models(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def engines(models):
    """(kv) -> (JAX engine, port engine), built once per model."""
    jcfg, jparams, tcfg, tparams = models
    out = {}

    def get(kv):
        if kv not in out:
            jdt, tdt = KV[kv]
            out[kv] = (
                JEngine(jcfg, jparams, max_batch=3, max_seq=1280,
                        sampling=JSampling(greedy=True), kv_dtype=jdt),
                Engine(tcfg, tparams, max_batch=3, max_seq=1280,
                       sampling=SamplingParams(greedy=True), kv_dtype=tdt,
                       device="cpu"))
        return out[kv]

    return get


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("kv", list(KV))
def test_engine_long_prompts_token_identical_to_jax(models, engines, kv,
                                                    batch):
    jcfg = models[0]
    lengths = BATCHES[batch]
    rng = np.random.default_rng(len(lengths))
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).tolist()
               for n in lengths]
    jeng, teng = engines(kv)
    want = jeng.generate(prompts, max_new_tokens=6).token_ids
    got = teng.generate(prompts, max_new_tokens=6)
    assert got.token_ids == want
    assert got.steps >= 1
