"""Perplexity (``utils/ppl.py``, ``models/qwen.score_logits``): the port
against the JAX package on the CPU.

Every test of ``tests/test_ppl.py`` runs against the port with its own
gates: the tiny model of ``init_params(PRNGKey(7))`` (f32) carried over
with ``params_from_numpy``, quantized by the port (whose packed bytes are
the JAX quantizer's), on the same synthetic stream (1024 tokens, windows
of 128).  Then the port against the JAX functions on the same parameters:
``perplexity`` within 1e-5 relative (f32, INT8, INT4: both packages' CPU
paths compute the same f32 sums in other orders; W4A8 with an INT4
lm_head within 1e-3, an int8 activation rounding apart),
``score_logits`` within 1e-4, ``nll_of_windows`` over a short
last batch (padded rows dropped) within 1e-5, ``perplexity_of_file``
with the byte tokenizer, and the short-stream ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.config import tiny_config as j_tiny_config
from qwen_inference_engine_tpu.kvcache.cache import KVCache as JKVCache
from qwen_inference_engine_tpu.models import qwen as jqwen
from qwen_inference_engine_tpu.quant.quantize import QuantConfig as JQuantConfig
from qwen_inference_engine_tpu.quant.quantize import (
    quantize_params as j_quantize_params,
)
from qwen_inference_engine_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from qwen_inference_engine_tpu.utils import ppl as jppl
from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.loader.from_jax import params_from_numpy
from qwen_inference_engine_tpu_torch.models import qwen as tqwen
from qwen_inference_engine_tpu_torch.quant.quantize import (
    QuantConfig,
    fuse_projections,
    quantize_params,
)
from qwen_inference_engine_tpu_torch.tokenizer import ByteTokenizer
from qwen_inference_engine_tpu_torch.utils.ppl import (
    nll_of_windows,
    perplexity,
    perplexity_of_file,
)

JCFG = j_tiny_config()
JPARAMS = jqwen.init_params(JCFG, jax.random.PRNGKey(7), dtype=jnp.float32)
CFG = tiny_config()
PARAMS = params_from_numpy(jax.tree_util.tree_map(np.asarray, JPARAMS))
RNG = np.random.default_rng(0)
# tests/test_ppl.py's stream: periodic, deterministic, 8 windows of 128
TOKENS = ((np.arange(1024) * 7 + RNG.integers(0, 5, 1024))
          % CFG.vocab_size).astype(np.int32)
_BASE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread per test: the suite runs several workers on few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _base() -> float:
    if "ppl" not in _BASE:
        _BASE["ppl"] = perplexity(PARAMS, CFG, TOKENS, seq_len=128)
    return _BASE["ppl"]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / b


# ---- tests/test_ppl.py against the port ---------------------------------

def test_perplexity_finite_and_reasonable():
    ppl = perplexity(PARAMS, CFG, TOKENS, seq_len=128, batch_size=4)
    assert np.isfinite(ppl)
    # a random model is near uniform over the vocabulary
    assert 10 < ppl < CFG.vocab_size * 3


def test_perplexity_batch_invariance():
    p1 = perplexity(PARAMS, CFG, TOKENS, seq_len=128, batch_size=1)
    p4 = perplexity(PARAMS, CFG, TOKENS, seq_len=128, batch_size=4)
    assert _rel(p1, p4) < 1e-4


@pytest.mark.parametrize("bits,limit", [(8, 0.02), (4, 0.10)])
def test_quantized_ppl_delta(bits, limit):
    qparams = quantize_params(PARAMS, QuantConfig(bits=bits, group_size=32))
    qppl = perplexity(qparams, CFG, TOKENS, seq_len=128)
    assert _rel(qppl, _base()) < limit, (_base(), qppl)


def test_quantized_lm_head_ppl_delta():
    qparams = quantize_params(
        PARAMS, QuantConfig(bits=4, group_size=32, quantize_lm_head=True))
    qppl = perplexity(qparams, CFG, TOKENS, seq_len=128)
    assert _rel(qppl, _base()) < 0.15, (_base(), qppl)


@pytest.mark.parametrize("gs", [16, 32, 64])
def test_int4_group_size_sweep(gs):
    qparams = quantize_params(PARAMS, QuantConfig(bits=4, group_size=gs))
    qppl = perplexity(qparams, CFG, TOKENS, seq_len=128)
    assert _rel(qppl, _base()) < 0.12, (gs, _base(), qppl)


def test_pad_free_quantization_ppl_matches_padded():
    a = quantize_params(PARAMS, QuantConfig(bits=4, group_size=32))
    b = quantize_params(PARAMS, QuantConfig(bits=4, group_size=32,
                                            pad_free=True))
    pa = perplexity(a, CFG, TOKENS, seq_len=128)
    pb = perplexity(b, CFG, TOKENS, seq_len=128)
    assert _rel(pb, pa) < 0.02, (pa, pb)


@pytest.mark.parametrize("bits,limit", [(8, 0.04), (4, 0.12)])
def test_act_quant_ppl_delta(bits, limit):
    qparams = quantize_params(PARAMS, QuantConfig(bits=bits, group_size=32))
    a8 = perplexity(qparams, CFG.replace(act_bits=8), TOKENS, seq_len=128)
    assert _rel(a8, _base()) < limit, (_base(), a8)


def test_act_quant_lm_head_ppl_delta():
    """As the JAX test: ``score_logits`` takes no int8 activations for the
    lm_head, so ``act_bits_lm_head`` 8 scores like 0 (it is not read)."""
    qparams = quantize_params(
        PARAMS, QuantConfig(bits=4, group_size=32, quantize_lm_head=True))
    a8 = perplexity(qparams, CFG.replace(act_bits=8, act_bits_lm_head=8),
                    TOKENS, seq_len=128)
    assert _rel(a8, _base()) < 0.16, (_base(), a8)
    a0 = perplexity(qparams, CFG.replace(act_bits=8), TOKENS, seq_len=128)
    assert a8 == a0


@pytest.mark.parametrize("bits,limit", [(8, 0.03), (4, 0.15)])
def test_quantized_moe_ppl_delta(bits, limit):
    jcfg = j_tiny_config(num_experts=4, num_experts_per_tok=2,
                         moe_intermediate_size=64)
    cfg = tiny_config(num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=64)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jqwen.init_params(jcfg, jax.random.PRNGKey(9),
                                      dtype=jnp.float32)))
    base = perplexity(params, cfg, TOKENS, seq_len=128)
    qparams = quantize_params(params, QuantConfig(bits=bits, group_size=32,
                                                  pad_free=True))
    qppl = perplexity(qparams, cfg, TOKENS, seq_len=128)
    assert _rel(qppl, base) < limit, (base, qppl)


# ---- the port against the JAX functions ---------------------------------

# arm: (QuantConfig keywords, act_bits, relative ppl tolerance against the
# JAX function).  Weight-only arms: the same f32 sums in other orders,
# 1e-5.  W4A8: an int8 activation whose f32 input lands within rounding of
# a .5 boundary rounds apart between the packages, and every later
# position of its row moves (measured: row 0 of the first batch from
# position 24 on, up to 5.7e-2 in a logit; 7.4e-5 in ppl), so 1e-3.
ARMS = {"f32": (None, 0, 1e-5),
        "int8 gs 32": (dict(bits=8, group_size=32), 0, 1e-5),
        "int4 gs 32": (dict(bits=4, group_size=32), 0, 1e-5),
        "w4a8 + int4 lm_head": (dict(bits=4, group_size=32,
                                     quantize_lm_head=True), 8, 1e-3)}


def _arm(name):
    """(jax params, jax cfg, port params, port cfg) of one arm."""
    q, act, _ = ARMS[name]
    jp, tp = JPARAMS, PARAMS
    if q is not None:
        jp = j_quantize_params(JPARAMS, JQuantConfig(**q))
        tp = quantize_params(PARAMS, QuantConfig(**q))
    return jp, JCFG.replace(act_bits=act), tp, CFG.replace(act_bits=act)


@pytest.mark.parametrize("name", sorted(ARMS))
def test_perplexity_matches_jax(name):
    jp, jcfg, tp, tcfg = _arm(name)
    want = jppl.perplexity(jp, jcfg, TOKENS, seq_len=128, batch_size=4)
    got = perplexity(tp, tcfg, TOKENS, seq_len=128, batch_size=4)
    assert _rel(got, want) < ARMS[name][2], (got, want)


@pytest.mark.parametrize("name", ["f32", "w4a8 + int4 lm_head"])
def test_score_logits_match_jax(name):
    """[B, T, V] f32 logits of one fresh prefill over positions 0..T-1
    (tokens that put no activation at a rounding boundary of W4A8)."""
    jp, jcfg, tp, tcfg = _arm(name)
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size,
                                             (2, 24)).astype(np.int32)
    jc = JKVCache.create(JCFG.num_layers, 2, 24, JCFG.num_kv_heads,
                         JCFG.head_dim)
    tc = KVCache.create(CFG.num_layers, 2, 24, CFG.num_kv_heads,
                        CFG.head_dim, dtype=torch.float32)
    want = np.asarray(jqwen.score_logits(jp, jcfg, jnp.asarray(toks), jc))
    got = tqwen.score_logits(tp, tcfg, torch.from_numpy(toks).long(), tc)
    assert got.dtype == torch.float32 and got.shape == (2, 24, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_score_logits_fused_equals_split():
    """``fuse_projections`` leaves the scores within f32 rounding (1e-5)."""
    _, _, tp, tcfg = _arm("w4a8 + int4 lm_head")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (2, 16))).long()
    out = []
    for p in (tp, fuse_projections(tp)):
        tc = KVCache.create(CFG.num_layers, 2, 16, CFG.num_kv_heads,
                            CFG.head_dim, dtype=torch.float32)
        out.append(tqwen.score_logits(p, tcfg, toks, tc))
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=1e-5)


def test_nll_of_windows_pads_a_short_last_batch_like_jax():
    """5 windows in batches of 4: the second batch is padded with copies of
    its window, whose rows are dropped; the sums equal the JAX function's
    (1e-5 relative) and the batch-1 sums (1e-5), and the token count is
    5 x 127."""
    windows = TOKENS[:5 * 128].reshape(5, 128)
    jn, jt = jppl.nll_of_windows(JPARAMS, JCFG, windows, batch_size=4)
    tn, tt = nll_of_windows(PARAMS, CFG, windows, batch_size=4)
    t1, _ = nll_of_windows(PARAMS, CFG, windows, batch_size=1)
    assert tt == jt == 5 * 127
    assert _rel(tn, jn) < 1e-5 and _rel(t1, tn) < 1e-5


def test_perplexity_of_file_with_the_byte_tokenizer(tmp_path):
    """A UTF-8 file of 700 bytes (5 windows of 128 byte tokens, a
    multi-byte character among them) scored by both packages' byte
    tokenizers: equal token ids, ppl within 1e-5, and the stream's
    ``perplexity``."""
    text = ("The quick brown fox jumps over the lazy dog. " * 15
            + "café " * 5)[:700]
    path = tmp_path / "corpus.txt"
    path.write_text(text, encoding="utf-8")
    tok = ByteTokenizer()
    assert tok.encode(text) == JByteTokenizer().encode(text)
    want = jppl.perplexity_of_file(JPARAMS, JCFG, str(path), JByteTokenizer(),
                                   seq_len=128)
    got = perplexity_of_file(PARAMS, CFG, str(path), tok, seq_len=128)
    assert _rel(got, want) < 1e-5
    assert got == perplexity(PARAMS, CFG, tok.encode(text), seq_len=128)


@pytest.mark.parametrize("n", [0, 127])
def test_short_stream_raises_like_jax(n):
    with pytest.raises(ValueError) as jerr:
        jppl.perplexity(JPARAMS, JCFG, TOKENS[:n], seq_len=128)
    with pytest.raises(ValueError) as terr:
        perplexity(PARAMS, CFG, TOKENS[:n], seq_len=128)
    assert str(terr.value) == str(jerr.value) == f"need ≥128 tokens, got {n}"
