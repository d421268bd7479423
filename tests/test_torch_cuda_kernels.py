"""The port's CUDA kernels against their plain versions, on the card.

These tests need a GPU and the CUDA toolkit (marker ``cuda``); without a
card they skip (the decision is made in a fixture, never at import).  They
cover the edges the smoke run's Qwen2.5-7B shapes do not: ragged M, any T,
G in 1..8, D=64, B smaller than the cache batch, and the wrappers'
refusals.  On a GPU machine, from the repo root (this file imports no JAX,
so the JAX-pinning conftest can be skipped):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.models import qwen
from qwen_inference_engine_tpu_torch.ops import decode_attention as da
from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
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
