"""The port's CUDA kernels against their plain versions, on the card.

These tests need a GPU and the CUDA toolkit (marker ``cuda``); without a
card they skip (the decision is made in a fixture, never at import).  They
cover the edges the smoke run's Qwen2.5-7B shapes do not: ragged M, any T,
G in 1..8, D=64, B smaller than the cache batch, continuation chunks from
1 to 512 tokens at the first, a mid-tile and the last start, the INT8 KV
append at the first and last position, and the wrappers' refusals.  On a GPU machine, from the repo root (this file imports no JAX,
so the JAX-pinning conftest can be skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.models import qwen
from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
from qwen_inference_engine_tpu_torch.ops import decode_attention as da
from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
from qwen_inference_engine_tpu_torch.ops import kv_append as ka
from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
from qwen_inference_engine_tpu_torch.quant.kv_quant import quantize_kv
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from qwen_inference_engine_tpu_torch.quant.quantize import (
    QuantConfig,
    quantize_params,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for the first build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("M,K,N,gs", [(1, 512, 128, 128), (17, 1024, 256, 64),
                                      (65, 768, 384, 128), (130, 2048, 128, 256)])
def test_quant_matmul4_a8_matches_plain(gen, M, K, N, gs):
    L = 3
    q = torch.randint(-128, 128, (L, K // 2, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((L, K // gs, N), generator=gen, device="cuda") * 0.01
    xq, sx = qm.quantize_activations(_bf16(gen, M, K))
    sx = sx.reshape(-1).contiguous()
    before = qm.quant_matmul4_a8.launches
    got = qm.quant_matmul4_a8(xq, sx, q, s, 2, gs)
    ref = qm.quant_matmul4_a8_plain(xq, sx, q, s, 2, gs)
    assert qm.quant_matmul4_a8.launches == before + 1
    # both round one f32 value to bf16: at most 2 ulps of the largest output
    tol = 2 ** -6 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_quant_matmul4_a8_refuses_what_it_cannot_take(gen):
    q = torch.zeros((1, 256, 200), dtype=torch.int8, device="cuda")
    s = torch.zeros((1, 4, 200), device="cuda")
    xq = torch.zeros((2, 512), dtype=torch.int8, device="cuda")
    sx = torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="N % 128"):
        qm.quant_matmul4_a8(xq, sx, q, s, 0, 128)
    q = torch.zeros((1, 256, 256), dtype=torch.int8, device="cuda")
    s = torch.zeros((1, 4, 256), device="cuda")
    with pytest.raises(IndexError):
        qm.quant_matmul4_a8(xq, sx, q, s, 1, 128)


@pytest.mark.parametrize("B,T,Hq,Hk,D", [(1, 1, 2, 1, 128), (2, 17, 4, 2, 64),
                                         (1, 100, 14, 2, 128), (3, 64, 5, 1, 128)])
def test_flash_attention_matches_plain(gen, B, T, Hq, Hk, D):
    q, k, v = _bf16(gen, B, T, Hq, D), _bf16(gen, B, T, Hk, D), _bf16(gen, B, T, Hk, D)
    got = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    # bf16 output; the plain version rounds probabilities to bf16
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("B,Bc,Hk,G,D,S,lens", [
    (3, 3, 2, 7, 128, 256, [1, 100, 256]),
    (2, 4, 1, 5, 64, 512, [300, 7]),
    (1, 1, 4, 8, 128, 256, [64]),
])
def test_decode_attention_contiguous_matches_plain(gen, B, Bc, Hk, G, D, S, lens):
    L = 2
    kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    lengths = torch.tensor(lens, device="cuda")
    got = da.decode_attention_contiguous(q, kc, vc, 1, lengths)
    ref = da.decode_attention_contiguous_plain(q, kc, vc, 1, lengths)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("pos,G", [(0, 7), (63, 7), (64, 1), (255, 4)])
def test_decode_attention_appending_matches_plain(gen, pos, G):
    L, B, Hk, D, S = 2, 3, 2, 128, 256
    kc, vc = _bf16(gen, L, B, Hk, S, D), _bf16(gen, L, B, Hk, S, D)
    q = _bf16(gen, B, 1, G * Hk, D)
    kn, vn = _bf16(gen, B, 1, Hk, D), _bf16(gen, B, 1, Hk, D)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, gk, gv = da.decode_attention_appending(q, k1, v1, kn, vn, 1, pos)
    ref, rk, rv = da.decode_attention_appending_plain(q, k2, v2, kn, vn, 1, pos)
    assert gk is k1 and gv is v1
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(gk, rk) and torch.equal(gv, rv)
    # the position may also come as a tensor on the card (read on device)
    got2, _, _ = da.decode_attention_appending(
        q, k1, v1, kn, vn, 1, torch.tensor([pos], device="cuda"))
    assert torch.equal(got2, got)


def test_decode_attention_refuses_f32_cache(gen):
    kc = torch.zeros((1, 1, 1, 256, 128), device="cuda")
    q = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="bf16"):
        da.decode_attention_contiguous(q, kc, kc, 0, torch.ones(1, device="cuda"))


def test_engine_runs_w4a8_on_the_card_through_all_four_kernels(gen):
    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    eng = Engine(cfg, params, max_batch=2, max_seq=128,
                 sampling=SamplingParams(greedy=True))
    wrappers = [qm.quant_matmul4_a8, fa.flash_attention,
                da.decode_attention_contiguous, da.decode_attention_appending]
    before = [w.launches for w in wrappers]
    ragged = eng.generate([[5, 9, 17], [100, 200, 300, 400, 500]], max_new_tokens=6)
    aligned = eng.generate([[5, 9, 17, 3], [7, 8, 9, 10]], max_new_tokens=6)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    for res in (ragged, aligned):
        assert all(0 <= t < cfg.vocab_size for row in res.token_ids for t in row)


def _int8_cache(gen, *shape):
    q, s = quantize_kv(torch.randn(shape, generator=gen, device="cuda"))
    return q, s


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T,where,G", [
    (1, "first", 7), (1, "mid", 4), (1, "last", 8),
    (7, "first", 4), (7, "mid", 8), (7, "last", 7),
    (64, "first", 8), (64, "mid", 7), (64, "last", 4),
    (512, "first", 7), (512, "mid", 4), (512, "last", 8),
])
def test_chunk_attention_matches_plain(gen, T, where, G, quant):
    """Continuation chunks of 1..512 tokens starting at 0, mid-tile (a start
    that is no multiple of the 64-key tile) and at S - T."""
    L, B, Bc, Hk, D, S = 2, 2, 3, 2, 128, 1024
    start = {"first": 0, "mid": 100, "last": S - T}[where]
    q = _bf16(gen, B, T, G * Hk, D)
    if quant:
        kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
        vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
        fn = ca.chunk_attention_contiguous_q8
        before = fn.launches
        got = fn(q, kc, vc, ks, vs, 1, start)
        ref = ca.chunk_attention_contiguous_q8_plain(q, kc, vc, ks, vs, 1,
                                                     start)
    else:
        kc, vc = _bf16(gen, L, Bc, Hk, S, D), _bf16(gen, L, Bc, Hk, S, D)
        fn = ca.chunk_attention_contiguous
        before = fn.launches
        got = fn(q, kc, vc, 1, start)
        ref = ca.chunk_attention_contiguous_plain(q, kc, vc, 1, start)
    assert fn.launches == before + 1
    # bf16 output; the plain version rounds probabilities to bf16
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("pos", [0, 255])
def test_kv_append_uniform_q8_bit_exact(gen, pos):
    L, B, Bc, Hk, D, S = 2, 2, 3, 4, 128, 256
    kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    kn, ksn = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen, device="cuda"))
    vn, vsn = quantize_kv(torch.randn((B, 1, Hk, D), generator=gen, device="cuda"))
    mine = [t.clone() for t in (kc, vc, ks, vs)]
    ref = ka.kv_append_uniform_q8_plain(*[t.clone() for t in (kc, vc, ks, vs)],
                                        kn, vn, ksn, vsn, pos, 1)
    got = ka.kv_append_uniform_q8(*mine, kn, vn, ksn, vsn,
                                  torch.tensor([pos], device="cuda"), 1)
    assert all(g is m for g, m in zip(got, mine))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("lens", [[1, 1], [256, 1], [256, 256]])
def test_decode_attention_q8_matches_plain(gen, lens):
    """Lengths 1 and S, G = 7, B smaller than the cache batch."""
    L, Bc, Hk, G, D, S = 2, 3, 2, 7, 128, 256
    kc, ks = _int8_cache(gen, L, Bc, Hk, S, D)
    vc, vs = _int8_cache(gen, L, Bc, Hk, S, D)
    q = _bf16(gen, len(lens), 1, G * Hk, D)
    lengths = torch.tensor(lens, device="cuda")
    before = da.decode_attention_contiguous_q8.launches
    got = da.decode_attention_contiguous_q8(q, kc, vc, ks, vs, 1, lengths)
    ref = da.decode_attention_contiguous_q8_plain(q, kc, vc, ks, vs, 1, lengths)
    assert da.decode_attention_contiguous_q8.launches == before + 1
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


def test_new_wrappers_refuse_wrong_dtype_or_shape(gen):
    kc = _bf16(gen, 1, 1, 2, 256, 128)
    k8, ks = _int8_cache(gen, 1, 1, 2, 256, 128)
    q = _bf16(gen, 1, 4, 4, 128)
    with pytest.raises(TypeError, match="bf16 queries"):
        ca.chunk_attention_contiguous(q.float(), kc, kc, 0, 0)
    with pytest.raises(TypeError, match="int8 cache"):
        ca.chunk_attention_contiguous_q8(q, kc, kc, ks, ks, 0, 0)
    with pytest.raises(ValueError, match="1..512"):
        ca.chunk_attention_contiguous(_bf16(gen, 1, 513, 4, 128),
                                      _bf16(gen, 1, 1, 2, 1024, 128),
                                      _bf16(gen, 1, 1, 2, 1024, 128), 0, 0)
    with pytest.raises(IndexError, match="outside the cache"):
        ca.chunk_attention_contiguous(q, kc, kc, 0, 253)
    with pytest.raises(ValueError, match="f32 scales"):
        da.decode_attention_contiguous_q8(q[:, :1], k8, k8, ks.half(), ks, 0,
                                          torch.ones(1, device="cuda"))
    with pytest.raises(TypeError, match="int8 cache"):
        da.decode_attention_contiguous_q8(q[:, :1], kc, kc, ks, ks, 0,
                                          torch.ones(1, device="cuda"))
    kn, ksn = quantize_kv(torch.randn((1, 1, 2, 128), generator=gen, device="cuda"))
    with pytest.raises(TypeError, match="f32 new scales"):
        ka.kv_append_uniform_q8(k8, k8, ks, ks, kn, kn, ksn.half(), ksn, 0, 0)
    with pytest.raises(ValueError, match="shapes"):
        ka.kv_append_uniform_q8(k8, k8, ks, ks, kn[:, :, :1], kn, ksn, ksn, 0, 0)
    with pytest.raises(IndexError, match="outside the cache"):
        ka.kv_append_uniform_q8(k8, k8, ks, ks, kn, kn, ksn, ksn, 256, 0)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
def test_engine_runs_long_prompts_on_the_card(gen, kv_dtype):
    """Prompts over one 512-token chunk (a continuation chunk per layer) in
    bf16 and INT8 KV, aligned and ragged, through the kernels of the path."""
    cfg = tiny_config(hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=2, head_dim=64)
    params = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(params, QuantConfig(bits=4, group_size=64))
    cfg = cfg.replace(act_bits=8)
    eng = Engine(cfg, params, max_batch=2, max_seq=1280, kv_dtype=kv_dtype,
                 sampling=SamplingParams(greedy=True))
    chunk = (ca.chunk_attention_contiguous_q8 if kv_dtype == torch.int8
             else ca.chunk_attention_contiguous)
    decode = ([da.decode_attention_contiguous_q8, ka.kv_append_uniform_q8]
              if kv_dtype == torch.int8 else
              [da.decode_attention_contiguous, da.decode_attention_appending])
    wrappers = [fa.flash_attention, chunk, *decode]
    before = [w.launches for w in wrappers]
    def prompt(n, first):
        return [(first + i) % (cfg.vocab_size - 2) + 2 for i in range(n)]

    ragged = eng.generate([prompt(598, 0), prompt(897, 1)], max_new_tokens=6)
    aligned = eng.generate([prompt(698, 0), prompt(698, 1)], max_new_tokens=6)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    for res in (ragged, aligned):
        assert all(0 <= t < cfg.vocab_size for row in res.token_ids for t in row)
