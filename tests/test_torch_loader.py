"""The port's checkpoint entry points against HF and the JAX package.

* ``params_from_numpy`` / ``paged_cache_from_numpy`` carry the JAX
  package's default bf16 params and page pools bit for bit;
* ``load_checkpoint`` on HF ``save_pretrained`` output (several shards and
  ``model.safetensors.index.json``; Qwen2 with q/k/v biases, Qwen3 with
  qk-norm, tied and untied embeddings): logits within 2e-3 of the HF model
  (f32, as ``tests/test_loader_roundtrip.py``), tensors identical to the
  JAX ``load_checkpoint``'s, in f32 and bf16;
* quantized checkpoints both ways (JAX save -> port load, port save -> JAX
  load), INT4 and INT8 with a quantized lm_head: identical leaves, leaf
  names and logits;
* the CLI on the CPU: ``quantize``, ``generate --ckpt``, ``generate
  --qckpt``;
* a BPE tokenizer built offline: the same ids and text through both
  packages' ``load_tokenizer``;
* the safetensors writer of ``chip_smoke.py``, read back by the
  ``safetensors`` package and by the port's reader.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.kvcache.cache import PagedKVCache as JPaged
from qwen_inference_engine_tpu.loader.qcheckpoint import _leaf_name
from qwen_inference_engine_tpu.loader.qcheckpoint import (
    load_quantized as j_load_quantized,
)
from qwen_inference_engine_tpu.loader.qcheckpoint import (
    save_quantized as j_save_quantized,
)
from qwen_inference_engine_tpu.loader.safetensors_loader import (
    load_checkpoint as j_load_checkpoint,
)
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.quant.quantize import QuantConfig as JQuantConfig
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu.tokenizer import load_tokenizer as j_load_tokenizer
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import (
    paged_cache_from_numpy,
    params_from_numpy,
)
from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
    _flat,
    load_quantized,
    save_quantized,
)
from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
    SafetensorsIndex,
    load_checkpoint,
)
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear
from qwen_inference_engine_tpu_torch.quant.quantize import (
    QuantConfig,
    quantize_params,
)
from qwen_inference_engine_tpu_torch.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    load_tokenizer,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_port(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_jax(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def port_leaves(params) -> dict:
    return {n: _np_port(t) for n, t in _flat(params)}


def jax_leaves(params) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {_leaf_name(p): _np_jax(a) for p, a in flat}


def assert_same_leaves(port, jx, skip=()) -> None:
    a, b = port_leaves(port), jax_leaves(jx)
    assert sorted(a) == sorted(b)
    for name in a:
        if name in skip:
            continue
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ------------------------------------------------------------------ repair

def test_params_from_numpy_carries_bf16_bit_for_bit():
    """The JAX package's default dtype is bf16; np.asarray gives
    ml_dtypes.bfloat16 arrays, which torch.from_numpy rejects."""
    jcfg = j_tiny_config(qk_norm=True)
    jp = jqwen.init_params(jcfg, jax.random.PRNGKey(1))  # bf16 default
    jp = j_quantize_params(jp, JQuantConfig(bits=4, group_size=32))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"]["q_norm"].dtype == torch.bfloat16
    assert_same_leaves(tp, jp)


def test_paged_cache_from_numpy_carries_bf16_pools_bit_for_bit():
    rng = np.random.default_rng(0)
    shape = (2, 5, 2, 8, 32)
    k = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    pool = JPaged(k_pages=k, v_pages=v, k_scale=None, v_scale=None,
                  page_size=8)
    got = paged_cache_from_numpy(jax.tree_util.tree_map(np.asarray, pool))
    assert got.k_pages.dtype == torch.bfloat16 and got.page_size == 8
    np.testing.assert_array_equal(_np_port(got.k_pages), _np_jax(k))
    np.testing.assert_array_equal(_np_port(got.v_pages), _np_jax(v))


# ------------------------------------------------------ HF safetensors

def _hf_model(cfg, seed: int):
    import transformers

    hf = cfg.to_hf_config()
    if cfg.qk_norm:
        model = transformers.Qwen3ForCausalLM(
            transformers.Qwen3Config(**hf, attention_bias=False))
    else:
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**hf))
    torch.manual_seed(seed)
    for p in model.parameters():  # biases and norms away from 0 / 1
        torch.nn.init.normal_(p, std=0.05 if p.dim() > 1 else 0.3)
    return model.eval()


def _save_hf(model, path, dtype=torch.float32) -> None:
    model.to(dtype).save_pretrained(path, max_shard_size="300KB",
                                    safe_serialization=True)
    model.float()
    assert len([f for f in os.listdir(path) if f.endswith(".safetensors")]) > 1
    assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))


def _port_logits(cfg, params, tokens: np.ndarray) -> np.ndarray:
    B, T = tokens.shape
    cache = KVCache.create(cfg.num_layers, B, 32, cfg.num_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
    toks = torch.from_numpy(tokens).long()
    pos = torch.arange(T)[None].expand(B, T)
    with torch.inference_mode():
        hidden, _ = tqwen.forward_hidden(params, cfg, toks, pos, cache,
                                         fresh_prefill=True)
        return tqwen.compute_logits(params, hidden).numpy()


@functools.lru_cache(maxsize=None)
def _jax_rope(max_position: int, head_dim: int, theta: float):
    """The JAX package's rope tables (what its loader stores,
    ``loader/convert.py:116``) from a fresh interpreter with no persistent
    compilation cache: neither an earlier test's state nor a cached
    executable compiled elsewhere reaches them (ROADMAP C.7)."""
    code = ("import sys, numpy as np, jax; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "from qwen_inference_engine_tpu.ops.rope import precompute_rope; "
            f"c, s = precompute_rope({max_position}, {head_dim}, {theta!r}); "
            "np.savez(sys.argv[1], cos=np.asarray(c), sin=np.asarray(s))")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rope.npz")
        subprocess.run([sys.executable, "-c", code, path], cwd=ROOT, env=env,
                       check=True, timeout=300)
        with np.load(path) as z:
            return z["cos"], z["sin"]


CKPT_CASES = [(False, False), (True, False), (False, True)]
CKPT_IDS = ["qwen2-bias", "qwen3-qknorm", "qwen2-tied"]


@pytest.mark.parametrize("qk_norm,tied", CKPT_CASES, ids=CKPT_IDS)
def test_load_checkpoint_matches_hf_and_the_jax_loader(tmp_path, qk_norm, tied):
    cfg = tiny_config(qk_norm=qk_norm, tie_word_embeddings=tied)
    model = _hf_model(cfg, seed=3 + qk_norm + 2 * tied)
    _save_hf(model, tmp_path)
    names = SafetensorsIndex(str(tmp_path)).names()
    assert ("lm_head.weight" in names) == (not tied)
    assert ("model.layers.0.self_attn.q_proj.bias" in names) == (not qk_norm)
    assert ("model.layers.0.self_attn.q_norm.weight" in names) == qk_norm

    tcfg, tparams = load_checkpoint(str(tmp_path), dtype=torch.float32,
                                    device="cpu")
    assert tcfg.qk_norm == qk_norm and tcfg.tie_word_embeddings == tied
    assert ("lm_head" in tparams) == (not tied)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    with torch.no_grad():
        hf_logits = model(torch.from_numpy(tokens).long()).logits.float().numpy()
    np.testing.assert_allclose(_port_logits(tcfg, tparams, tokens), hf_logits,
                               rtol=2e-3, atol=2e-3)

    jcfg, jparams = j_load_checkpoint(str(tmp_path), dtype=jnp.float32)
    assert_same_leaves(tparams, jparams, skip=("rope_cos", "rope_sin"))
    rope = (tcfg.max_position_embeddings, tcfg.head_dim, tcfg.rope_theta)
    assert rope == (jcfg.max_position_embeddings, jcfg.head_dim,
                    jcfg.rope_theta)
    for name, want in zip(("rope_cos", "rope_sin"), _jax_rope(*rope)):
        np.testing.assert_allclose(_np_port(tparams[name]), want, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["qwen2", "qwen3"])
def test_bf16_checkpoint_loads_bit_identical_to_the_jax_loader(tmp_path,
                                                               qk_norm):
    """BF16 shards: read through uint16 views (no ml_dtypes), kept in bf16
    and widened to f32, bit for bit as the JAX loader."""
    cfg = tiny_config(qk_norm=qk_norm)
    _save_hf(_hf_model(cfg, seed=11), tmp_path, dtype=torch.bfloat16)
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        _, tparams = load_checkpoint(str(tmp_path), dtype=tdt, device="cpu")
        _, jparams = j_load_checkpoint(str(tmp_path), dtype=jdt)
        assert tparams["layers"]["q"].w.dtype == tdt
        assert_same_leaves(tparams, jparams, skip=("rope_cos", "rope_sin"))


def test_load_checkpoint_reads_a_directory_without_an_index(tmp_path):
    cfg = tiny_config()
    model = _hf_model(cfg, seed=5)
    model.save_pretrained(tmp_path, safe_serialization=True)  # one shard
    assert not os.path.exists(tmp_path / "model.safetensors.index.json")
    _, tparams = load_checkpoint(str(tmp_path), dtype=torch.float32,
                                 device="cpu")
    np.testing.assert_array_equal(
        tparams["layers"]["down"].w[1].numpy(),
        model.model.layers[1].mlp.down_proj.weight.detach().numpy().T)


def test_moe_checkpoints_load():
    """A Qwen3-MoE state dict (router ``mlp.gate``, ``mlp.experts.{e}.*``)
    converts: the router a Linear [L, D, E], each expert stack [L, E, in,
    out] holding the transposed HF tensors."""
    import transformers

    from qwen_inference_engine_tpu_torch.loader.convert import (
        params_from_state_dict,
    )
    from qwen_inference_engine_tpu_torch.ops.linear import Linear

    cfg = tiny_config(qk_norm=True).replace(num_experts=4,
                                            num_experts_per_tok=2,
                                            moe_intermediate_size=64)
    torch.manual_seed(0)
    model = transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
        **cfg.to_hf_config(), attention_bias=False))
    sd = model.state_dict()
    params = params_from_state_dict(cfg, sd, dtype=torch.float32,
                                    device="cpu")
    lyr = params["layers"]
    assert isinstance(lyr["router"], Linear)
    np.testing.assert_array_equal(lyr["router"].w[1].numpy(),
                                  sd["model.layers.1.mlp.gate.weight"].numpy().T)
    assert lyr["moe_up"].shape == (2, 4, 128, 64)
    np.testing.assert_array_equal(
        lyr["moe_down"][1, 3].numpy(),
        sd["model.layers.1.mlp.experts.3.down_proj.weight"].numpy().T)


# ------------------------------------------------ quantized checkpoints

def _jax_quantized(bits: int, qk_norm: bool):
    jcfg = j_tiny_config(qk_norm=qk_norm)
    jp = jqwen.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    return jcfg, j_quantize_params(
        jp, JQuantConfig(bits=bits, group_size=32, quantize_lm_head=True))


def _same_logits(tcfg, tparams, jcfg, jparams) -> None:
    from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache

    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, 12)).astype(np.int32)
    lens = np.asarray([12, 7], np.int32)
    jcache = JKVCache.create(jcfg.num_layers, 2, 32, jcfg.num_kv_heads,
                             jcfg.head_dim, dtype=jnp.float32)
    jl, _ = jqwen.prefill(jparams, jcfg, jnp.asarray(tokens),
                          jnp.asarray(lens), jcache, attn_impl="xla")
    tcache = KVCache.create(tcfg.num_layers, 2, 32, tcfg.num_kv_heads,
                            tcfg.head_dim, dtype=torch.float32)
    with torch.inference_mode():
        tl, _ = tqwen.prefill(tparams, tcfg, torch.from_numpy(tokens).long(),
                              torch.from_numpy(lens).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["qwen2", "qwen3"])
def test_jax_quantized_checkpoint_loads_in_the_port(tmp_path, bits, qk_norm):
    jcfg, jparams = _jax_quantized(bits, qk_norm)
    j_save_quantized(str(tmp_path), jcfg, jparams)
    tcfg, tparams = load_quantized(str(tmp_path), device="cpu")
    assert isinstance(tparams["lm_head"], QuantLinear)
    assert tparams["lm_head"].bits == bits
    assert tcfg.hidden_size == jcfg.hidden_size
    assert tcfg.eos_token_ids == jcfg.eos_token_ids
    assert_same_leaves(tparams, jparams)
    _same_logits(tcfg, tparams, jcfg, jparams)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["qwen2", "qwen3"])
def test_port_quantized_checkpoint_loads_in_jax(tmp_path, bits, qk_norm):
    """The port writes the JAX package's manifest: the same leaf names,
    files, dtypes, shapes and quant records as a JAX-written one."""
    jcfg, jparams = _jax_quantized(bits, qk_norm)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = tiny_config(qk_norm=qk_norm)
    save_quantized(str(tmp_path / "port"), tcfg, tparams)
    j_save_quantized(str(tmp_path / "jax"), jcfg, jparams)
    mine = json.load(open(tmp_path / "port" / "manifest.json"))
    theirs = json.load(open(tmp_path / "jax" / "manifest.json"))
    assert mine == theirs
    for info in mine["leaves"].values():
        a = np.load(tmp_path / "port" / info["file"])
        b = np.load(tmp_path / "jax" / info["file"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jcfg2, jparams2 = j_load_quantized(str(tmp_path / "port"))
    assert_same_leaves(tparams, jparams2)
    _same_logits(tcfg, tparams, jcfg2, jparams2)


def test_bf16_leaves_round_trip_through_the_port(tmp_path):
    """bf16 leaves are stored as uint16 with "dtype": "bfloat16"."""
    jcfg = j_tiny_config()
    jp = j_quantize_params(jqwen.init_params(jcfg, jax.random.PRNGKey(2)),
                           JQuantConfig(bits=4, group_size=32))
    j_save_quantized(str(tmp_path), jcfg, jp)
    _, tparams = load_quantized(str(tmp_path), device="cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    save_quantized(str(tmp_path / "again"), tiny_config(), tparams)
    manifest = json.load(open(tmp_path / "again" / "manifest.json"))
    assert manifest["leaves"]["embed"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "again" / "embed.npy").dtype == np.uint16
    _, jp2 = j_load_quantized(str(tmp_path / "again"))
    assert_same_leaves(tparams, jp2)


# ----------------------------------------------------------------- CLI

def _ids(out: str):
    """The id list printed under each ``--- sequence`` header."""
    lines = out.splitlines()
    return [json.loads(lines[i + 1]) for i, line in enumerate(lines)
            if line.startswith("--- sequence")]


def test_cli_quantize_then_generate_from_both_checkpoints(tmp_path, capsys):
    """``quantize --ckpt`` writes the params that ``generate --ckpt --bits
    4`` builds at load, so both generate the same greedy tokens; the
    quantized checkpoint also loads in the JAX package."""
    from qwen_inference_engine_tpu_torch.server import cli

    cfg = tiny_config()
    ckpt, q = str(tmp_path / "hf"), str(tmp_path / "q")
    _save_hf(_hf_model(cfg, seed=21), ckpt)
    common = ["--bits", "4", "--group-size", "32", "--device", "cpu"]
    gen = ["--prompt", "hello", "--prompt", "hi!", "--max-new-tokens", "5",
           "--greedy", "--kv-bits", "32"]
    assert cli.main(["quantize", "--ckpt", ckpt, "--out", q, *common]) == 0
    assert "wrote quantized checkpoint" in capsys.readouterr().err
    assert cli.main(["generate", "--ckpt", ckpt, *common, *gen]) == 0
    out = capsys.readouterr()
    from_ckpt = _ids(out.out)
    assert "tokenizer: ByteTokenizer" in out.err
    assert cli.main(["generate", "--qckpt", q, "--device", "cpu", *gen]) == 0
    from_q = _ids(capsys.readouterr().out)
    assert len(from_ckpt) == 2 and from_ckpt == from_q
    _, jp = j_load_quantized(q)
    assert jp["layers"]["down"].bits == 4

    _, loaded = load_checkpoint(ckpt, dtype=torch.float32, device="cpu")
    want = quantize_params(loaded, QuantConfig(bits=4, group_size=32))
    _, got = load_quantized(q, device="cpu")
    for name in ("q", "down"):
        assert torch.equal(got["layers"][name].q, want["layers"][name].q)
        assert torch.equal(got["layers"][name].scales,
                           want["layers"][name].scales)


@pytest.mark.parametrize("extra", [["--bits", "8"],
                                   ["--bits", "8", "--act-bits", "8"],
                                   ["--bits", "8", "--group-size", "0"],
                                   ["--bits", "4", "--act-bits", "8"]],
                         ids=["w8a16", "w8a8", "w8a16-per-column", "w4a8"])
def test_cli_generate_from_a_checkpoint_in_each_format(tmp_path, capsys, extra):
    """--group-size 0 is one INT8 scale per column, as in the JAX CLI."""
    from qwen_inference_engine_tpu_torch.server import cli

    _save_hf(_hf_model(tiny_config(qk_norm=True), seed=8), tmp_path)
    rc = cli.main(["generate", "--ckpt", str(tmp_path), "--group-size", "32",
                   *extra, "--device", "cpu", "--prompt", "ok",
                   "--max-new-tokens", "3", "--greedy", "--kv-bits", "32"])
    assert rc == 0 and len(_ids(capsys.readouterr().out)) == 1


# ----------------------------------------------------------- tokenizer

@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    from tokenizers import ByteLevelBPETokenizer
    from transformers import PreTrainedTokenizerFast

    text = ["the quick brown fox jumps over the lazy dog",
            "hello world, hello tokenizer", "grüße aus dem süden"] * 20
    bpe = ByteLevelBPETokenizer()
    bpe.train_from_iterator(text, vocab_size=320, min_frequency=1,
                            special_tokens=["<|endoftext|>"])
    fast = PreTrainedTokenizerFast(tokenizer_object=bpe._tokenizer,
                                   eos_token="<|endoftext|>")
    path = tmp_path_factory.mktemp("tok")
    fast.save_pretrained(str(path))
    return str(path)


def test_tokenizer_from_files_matches_the_jax_package(tokenizer_dir):
    mine, theirs = load_tokenizer(tokenizer_dir), j_load_tokenizer(tokenizer_dir)
    assert isinstance(mine, HFTokenizer)
    assert mine.vocab_size == theirs.vocab_size
    assert mine.eos_token_id == theirs.eos_token_id
    for text in ("hello world", "the lazy fox, grüße", "unseen: ąę 🙂"):
        ids = mine.encode(text)
        assert ids == theirs.encode(text)
        assert mine.decode(ids) == theirs.decode(ids) == text


def test_tokenizer_falls_back_to_bytes(tokenizer_dir, tmp_path, monkeypatch):
    """No directory, no tokenizer files, or no transformers: the byte
    tokenizer, as in the JAX package."""
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path)), ByteTokenizer)
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert isinstance(load_tokenizer(tokenizer_dir), ByteTokenizer)


# ------------------------------------------- the smoke run's writer

def test_chip_smoke_safetensors_writer_round_trips(tmp_path):
    """chip_smoke.py writes its checkpoint without the safetensors package
    (the card's machine has none): the package reads the shards back, and
    so does the port's reader, bit for bit."""
    from safetensors.torch import load_file

    sys.path.insert(0, ROOT)
    from chip_smoke import write_hf_checkpoint

    rng = np.random.default_rng(0)
    tensors = {"a.weight": torch.from_numpy(rng.normal(size=(3, 5)).astype(
                   np.float32)).to(torch.bfloat16),
               "b.bias": torch.from_numpy(rng.normal(size=(7,)).astype(
                   np.float32)).to(torch.bfloat16),
               "c.weight": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    write_hf_checkpoint(str(tmp_path), {"model_type": "qwen2"}, tensors,
                        shards=2)
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    files = sorted(set(index["weight_map"].values()))
    assert len(files) == 2
    back = {}
    for f in files:
        back.update(load_file(str(tmp_path / f)))
    reader = SafetensorsIndex(str(tmp_path))
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype and torch.equal(back[name], t)
        assert torch.equal(reader.read(name), t)
