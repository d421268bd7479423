"""Qwen3-MoE in the port against the JAX package and HF, on the CPU.

A tiny Qwen3-MoE (hidden 256, 4 experts of width 256, top-2, 2 layers,
f32, random norm weights) is built in JAX, quantized there (INT4 / INT8
experts, gs 128) and carried over with ``params_from_numpy``:

* ``moe_mlp`` and ``forward_hidden`` against the JAX functions, for f32,
  W4A16 and W8A16 experts (both packages' CPU paths are dequantize + a
  matmul per expert: 1e-4), and W4A8 experts against the JAX functions
  with the grouped Pallas kernels in interpret mode (the port's plain
  version dequantizes to bf16 weights where the kernel scales in f32, and
  both round each expert output to bf16: 2e-2 for the MLP, 5e-2 for the
  hidden states of two layers);
* greedy tokens identical to the JAX ``Engine.generate`` and
  ``ContinuousBatchingEngine`` (plain and prompt lookup, the MoE-target
  case of ``tests/test_engine.py``), for f32, W4A16 and W8A16 experts;
* MoE prefill + decode equal to one full forward (1e-4);
* a tiny ``transformers.Qwen3MoeForCausalLM`` (8 experts, top-2): the
  port's logits within 2e-3 of HF's, and its ``save_pretrained`` shards
  loaded by the port and by the JAX loader to the same params; quantized
  checkpoints both ways;
* the MoE tree carried from JAX, ``init_quantized_params``' expert stacks
  and the CLI's ``--model tiny-moe``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.grouped_matmul as jgm
from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.engine.engine import Engine as JEngine
from qwen_inference_engine_tpu.engine.scheduler import (
    ContinuousBatchingEngine as JCB,
)
from qwen_inference_engine_tpu.engine.scheduler import Request as JRequest
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.loader.qcheckpoint import (
    save_quantized as j_save_quantized,
)
from qwen_inference_engine_tpu.loader.safetensors_loader import (
    load_checkpoint as j_load_checkpoint,
)
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.ops.linear import Linear as JLinear
from qwen_inference_engine_tpu.ops.sampling import SamplingParams as JSampling
from qwen_inference_engine_tpu.quant.quantize import QuantConfig as JQuantConfig
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    Request,
)
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.convert import (
    params_from_state_dict,
)
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
    load_quantized,
    save_quantized,
)
from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
    load_checkpoint,
)
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops.linear import Linear, QuantLinear
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from tests.helpers import interpret_pallas
from tests.test_torch_loader import assert_same_leaves

MOE = dict(qk_norm=True, hidden_size=256, num_experts=4,
           num_experts_per_tok=2, moe_intermediate_size=256)
# bits (16: f32 experts), act_bits
FORMATS = {"f32": (16, 0), "w4a16": (4, 0), "w8a16": (8, 0), "w4a8": (4, 8)}
GREEDY = SamplingParams(greedy=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fmt: str):
    """(jax cfg, jax params, port cfg, port params) of the tiny MoE."""
    bits, act_bits = FORMATS[fmt]
    jcfg = j_tiny_config(**MOE)
    params = jqwen.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    rng = np.random.default_rng(23)
    layers = dict(params["layers"])
    for name in ("input_norm", "post_norm", "q_norm", "k_norm"):
        layers[name] = jnp.asarray(rng.uniform(
            0.5, 1.5, size=layers[name].shape).astype(np.float32))
    params = dict(params, layers=layers)
    if bits < 16:
        params = j_quantize_params(params, JQuantConfig(bits=bits,
                                                        group_size=128))
    jcfg = jcfg.replace(act_bits=act_bits)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    tcfg = tiny_config(**MOE).replace(act_bits=act_bits)
    return jcfg, params, tcfg, tparams


_MODELS = {}


def _models(fmt):
    if fmt not in _MODELS:
        _MODELS[fmt] = _build(fmt)
    return _MODELS[fmt]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_moe_mlp_matches_jax(fmt):
    jcfg, jparams, tcfg, tparams = _models(fmt)
    jl, tl = jparams["layers"], tparams["layers"]
    h = np.random.default_rng(3).normal(size=(12, 256)).astype(np.float32)
    kernels = FORMATS[fmt][1] == 8
    with interpret_pallas(jgm):
        want = jqwen.moe_mlp(jnp.asarray(h), jl["router"].w[1], jl["moe_gate"],
                             jl["moe_up"], jl["moe_down"], 2, True, layer=1,
                             use_pallas=kernels, act_bits=jcfg.act_bits)
    got = tqwen.moe_mlp(_t(h), tl["router"].w[1], tl["moe_gate"],
                        tl["moe_up"], tl["moe_down"], 2, True, layer=1,
                        act_bits=tcfg.act_bits)
    tol = 2e-2 if kernels else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_forward_hidden_matches_jax(fmt):
    """A fresh prefill of 2 x 9 tokens, then a verify-shaped forward of
    2 x 3 tokens at per-row starts (the flattened B * T rows route as
    one batch)."""
    jcfg, jparams, tcfg, tparams = _models(fmt)
    kernels = FORMATS[fmt][1] == 8
    rng = np.random.default_rng(4)
    toks = rng.integers(2, 512, size=(2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jc = JKVCache.create(2, 2, 32, jcfg.num_kv_heads, jcfg.head_dim,
                         dtype=jnp.float32)
    tc = KVCache.create(2, 2, 32, tcfg.num_kv_heads, tcfg.head_dim,
                        dtype=torch.float32)
    impl = "pallas" if kernels else "xla"
    tol = 5e-2 if kernels else 1e-4
    with interpret_pallas(jgm):
        jh, jc = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(pos), jc, fresh_prefill=True,
                                      attn_impl=impl)
        th, tc = tqwen.forward_hidden(tparams, tcfg, _t(toks).long(),
                                      _t(pos).long(), tc, fresh_prefill=True)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=tol,
                                   atol=tol)
        toks = rng.integers(2, 512, size=(2, 3)).astype(np.int32)
        pos = np.asarray([[9], [5]], np.int32) + np.arange(3, dtype=np.int32)
        jh, _ = jqwen.forward_hidden(jparams, jcfg, jnp.asarray(toks),
                                     jnp.asarray(pos), jc, attn_impl=impl)
    th, _ = tqwen.forward_hidden(tparams, tcfg, _t(toks).long(),
                                 _t(pos).long(), tc, ragged_multi=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=tol,
                               atol=tol)


def test_prefill_then_decode_equals_one_forward():
    """Routing does not depend on the path: 6 prompt tokens, then 4 decode
    steps, give the last logits of one 10-token forward."""
    _, _, tcfg, tparams = _models("w4a16")
    toks = torch.tensor([[11, 200, 37, 5, 99, 301, 7, 45, 123, 66]])

    def cache():
        return KVCache.create(2, 1, 32, tcfg.num_kv_heads, tcfg.head_dim,
                              dtype=torch.float32)

    full, _ = tqwen.prefill(tparams, tcfg, toks, torch.tensor([10]), cache())
    logits, c = tqwen.prefill(tparams, tcfg, toks[:, :6], torch.tensor([6]),
                              cache())
    for p in range(6, 10):
        logits, c = tqwen.decode_step(tparams, tcfg, toks[:, p],
                                      torch.tensor([p]), c)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-4)


ENGINE_FORMATS = ["f32", "w4a16", "w8a16"]


@pytest.mark.parametrize("fmt", ENGINE_FORMATS)
def test_generate_token_identical_to_jax(fmt):
    jcfg, jparams, tcfg, tparams = _models(fmt)
    prompts = [[5, 9, 17, 3], [100, 200, 300, 400, 500, 42, 11, 12, 13], [7]]
    jeng = JEngine(jcfg, jparams, max_batch=3, max_seq=64,
                   sampling=JSampling(greedy=True), kv_dtype=jnp.float32)
    teng = Engine(tcfg, tparams, max_batch=3, max_seq=64, sampling=GREEDY,
                  kv_dtype=torch.float32, device="cpu")
    want = jeng.generate(prompts, max_new_tokens=8).token_ids
    assert teng.generate(prompts, max_new_tokens=8).token_ids == want


SERVE_PROMPTS = {0: [5, 9, 17, 3, 5, 9, 17, 3], 1: [40, 41, 42, 43]}


def _serve(cls, request_cls, cfg, params, kv, spec):
    cb = cls(cfg, params, max_slots=2, page_size=8, num_pages=64,
             max_pages_per_seq=16, kv_dtype=kv, speculative=spec, spec_k=3,
             spec_ngram=2, **({"device": "cpu", "sampling": GREEDY}
                              if cls is ContinuousBatchingEngine
                              else {"sampling": JSampling(greedy=True)}))
    for rid, p in SERVE_PROMPTS.items():
        cb.submit(request_cls(request_id=rid, prompt=p, max_new_tokens=12))
    out = {f.request_id: f.token_ids for f in cb.run_to_completion()}
    cb.check_page_invariants()
    return out, cb.metrics.snapshot()


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "pld"])
@pytest.mark.parametrize("fmt", ENGINE_FORMATS)
def test_serving_token_identical_to_jax(fmt, spec):
    """An MoE target through the serving engine, plain and with prompt
    lookup (the verify's B x (k+1) rows route as one batch)."""
    jcfg, jparams, tcfg, tparams = _models(fmt)
    want, _ = _serve(JCB, JRequest, jcfg, jparams, jnp.float32, spec)
    got, snap = _serve(ContinuousBatchingEngine, Request, tcfg, tparams,
                       torch.float32, spec)
    assert got == want and len(got) == 2
    assert (snap["spec_rounds"] > 0) == spec


def test_moe_drafter_runs_without_a_mesh():
    """An MoE drafter equal to its MoE target accepts every draft."""
    _, _, tcfg, tparams = _models("w4a16")
    cb = ContinuousBatchingEngine(tcfg, tparams, max_slots=2, page_size=8,
                                  num_pages=64, max_pages_per_seq=16,
                                  kv_dtype=torch.float32, device="cpu",
                                  sampling=GREEDY, speculative=True,
                                  spec_k=3, draft_params=tparams,
                                  draft_cfg=tcfg)
    cb.submit(Request(request_id=0, prompt=SERVE_PROMPTS[1],
                      max_new_tokens=9))
    out = cb.run_to_completion()
    assert len(out[0].token_ids) == 9
    assert cb.metrics.snapshot()["spec_tokens_per_forward"] == 4.0


# ------------------------------------------------------------------ HF

HF_MOE = dict(qk_norm=True, num_experts=8, num_experts_per_tok=2,
              moe_intermediate_size=64)


def _hf_moe(seed: int):
    import transformers

    cfg = tiny_config(**HF_MOE)
    hf_cfg = transformers.Qwen3MoeConfig(**cfg.to_hf_config(),
                                         attention_bias=False)
    torch.manual_seed(seed)
    return cfg, transformers.Qwen3MoeForCausalLM(hf_cfg).eval()


def test_logits_match_hf_qwen3_moe():
    """Router softmax / top-k / renormalization, the grouped expert
    matmuls and the weighted combine against the HF model (f32, 2e-3)."""
    cfg, model = _hf_moe(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(2, 10))
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).logits.float().numpy()
    params = params_from_state_dict(cfg, model.state_dict(),
                                    dtype=torch.float32, device="cpu")
    assert isinstance(params["layers"]["router"], Linear)
    assert params["layers"]["moe_down"].shape == (2, 8, 64, 128)
    cache = KVCache.create(2, 2, 32, cfg.num_kv_heads, cfg.head_dim,
                           dtype=torch.float32)
    pos = torch.arange(10)[None].expand(2, 10)
    with torch.inference_mode():
        hidden, _ = tqwen.forward_hidden(params, cfg,
                                         torch.from_numpy(tokens), pos,
                                         cache, fresh_prefill=True)
        got = tqwen.compute_logits(params, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_hf_moe_checkpoint_loads_like_the_jax_loader(tmp_path):
    """save_pretrained shards (router + 8 x 3 expert tensors a layer): the
    port's load_checkpoint gives the JAX loader's params leaf for leaf, in
    f32 and bf16."""
    cfg, model = _hf_moe(1)
    model.save_pretrained(tmp_path, max_shard_size="300KB",
                          safe_serialization=True)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        tcfg, tparams = load_checkpoint(str(tmp_path), dtype=tdt,
                                        device="cpu")
        assert tcfg.is_moe and tcfg.num_experts == 8
        _, jparams = j_load_checkpoint(str(tmp_path), dtype=jdt)
        assert_same_leaves(tparams, jparams, skip=("rope_cos", "rope_sin"))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_moe_checkpoints_both_ways(tmp_path, bits):
    """The JAX package's quantized MoE checkpoint loads in the port leaf for
    leaf (router Linear, [L, E, K/pack, N] experts and [L, E, K/gs, N]
    scales), and the port writes the JAX package's manifest and files.
    The JAX loader itself reads no MoE leaves, so the port's output is held
    to the JAX package's writer, not its reader."""
    jcfg, jparams, tcfg, tparams = _models("w4a16" if bits == 4 else "w8a16")
    j_save_quantized(str(tmp_path / "jax"), jcfg, jparams)
    cfg2, loaded = load_quantized(str(tmp_path / "jax"), device="cpu")
    assert cfg2.is_moe and isinstance(loaded["layers"]["moe_up"], QuantLinear)
    assert loaded["layers"]["moe_up"].q.dim() == 4
    assert_same_leaves(loaded, jparams)
    save_quantized(str(tmp_path / "port"), tcfg.replace(act_bits=0), tparams)
    mine = json.load(open(tmp_path / "port" / "manifest.json"))
    theirs = json.load(open(tmp_path / "jax" / "manifest.json"))
    assert mine == theirs
    for info in mine["leaves"].values():
        np.testing.assert_array_equal(np.load(tmp_path / "port" / info["file"]),
                                      np.load(tmp_path / "jax" / info["file"]))


def test_bf16_moe_tree_carries_over_from_jax(tmp_path):
    """The JAX package's default bf16 MoE params (raw expert stacks, router
    Linear), and their quantized form, carried bit for bit; a bf16 expert
    stack round-trips through the port's quantized-checkpoint format."""
    jcfg = j_tiny_config(**HF_MOE)
    jp = jqwen.init_params(jcfg, jax.random.PRNGKey(2))
    for tree in (jp, j_quantize_params(jp, JQuantConfig(bits=4,
                                                        group_size=32))):
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
        assert_same_leaves(tp, tree)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert tp["layers"]["moe_gate"].dtype == torch.bfloat16
    save_quantized(str(tmp_path), tiny_config(**HF_MOE), tp)
    _, back = load_quantized(str(tmp_path), device="cpu")
    assert_same_leaves(back, jp)


@pytest.mark.parametrize("bits", [4, 8])
def test_init_quantized_params_draws_the_jax_expert_stacks(bits):
    """Shapes, dtypes and group sizes of JAX ``init_quantized_params``; the
    router stays a bf16 Linear."""
    jcfg = j_tiny_config(**HF_MOE)
    jp = jqwen.init_quantized_params(jcfg, jax.random.PRNGKey(0), bits=bits,
                                     group_size=128)
    tp = tqwen.init_quantized_params(tiny_config(**HF_MOE),
                                     torch.Generator().manual_seed(0),
                                     bits=bits, group_size=128)
    for name in ("moe_gate", "moe_up", "moe_down"):
        j, t = jp["layers"][name], tp["layers"][name]
        assert t.q.shape == j.q.shape and t.scales.shape == j.scales.shape
        assert t.group_size == j.group_size and t.bits == bits
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert isinstance(tp["layers"]["router"], Linear)
    assert tp["layers"]["router"].w.dtype == torch.bfloat16
    assert isinstance(jp["layers"]["router"], JLinear)


def test_cli_generates_with_a_tiny_moe(capsys):
    from qwen_inference_engine_tpu_torch.server import cli

    rc = cli.main(["generate", "--model", "tiny-moe", "--bits", "4",
                   "--group-size", "32", "--act-bits", "8", "--kv-bits", "32",
                   "--device", "cpu", "--prompt", "hi", "--max-new-tokens",
                   "4", "--greedy"])
    assert rc == 0 and "sequence 0" in capsys.readouterr().out


def test_moe_params_cover_every_leaf_in_map_params():
    """map_params and params_to walk the raw expert stacks as tensors."""
    _, _, _, tparams = _models("f32")
    half = tqwen.map_params(tparams, lambda t: t.to(torch.bfloat16)
                            if t.is_floating_point() else t)
    assert half["layers"]["moe_gate"].dtype == torch.bfloat16
    assert half["layers"]["router"].w.dtype == torch.bfloat16
    assert dataclasses.is_dataclass(half["layers"]["router"])
