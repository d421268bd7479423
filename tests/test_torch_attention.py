"""Port of the attention and KV append kernels vs the JAX package.

The JAX Pallas kernels run in interpreter mode on the CPU, as in
tests/test_attention_kernels.py; the port's wrappers run their plain
versions for CPU tensors (the CUDA kernels are held against the same plain
versions by chip_smoke.py).  Tolerances as the JAX kernel tests use: 2e-3
for flash and bf16-cache decode, 4e-3 for the continuation chunk (its
Pallas kernel rounds probabilities to bf16), 2e-2 for the int8-cache
kernels; the INT8 append is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen_inference_engine_tpu.ops.chunk_attention as jca
import qwen_inference_engine_tpu.ops.decode_attention as jda
import qwen_inference_engine_tpu.ops.flash_attention as jfa
import qwen_inference_engine_tpu.ops.kv_append as jka
from qwen_inference_engine_tpu.ops.attention import gqa_attention_kmajor as j_kmajor
from qwen_inference_engine_tpu.quant.kv_quant import quantize_kv as j_quantize_kv
from qwen_inference_engine_tpu_torch.ops import chunk_attention as tca
from qwen_inference_engine_tpu_torch.ops import decode_attention as tda
from qwen_inference_engine_tpu_torch.ops import flash_attention as tfa
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.ops.attention import gqa_attention_kmajor
from tests.helpers import interpret_pallas


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T,Hq,Hk,D", [(32, 4, 2, 128), (64, 14, 2, 128),
                                       (48, 8, 8, 64), (1, 14, 2, 128),
                                       (130, 14, 2, 128), (130, 4, 4, 64),
                                       (65, 8, 1, 128)])
def test_flash_attention_plain_matches_pallas_interpret(T, Hq, Hk, D):
    """Includes G=7, D=128 (the Qwen2.5-7B group), a ragged T=48 edge, one
    token, T = 130 (the card kernel's two 64-key tiles and a ragged edge,
    its packed rows straddling tokens at G = 7), G = 1 and G = 8 at T =
    65; a T that 16 does not divide is one Pallas block."""
    B = 2
    rng = np.random.default_rng(T + Hq)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hk, D)).astype(np.float32)
    bq = T if T % 16 else 16 if T % 32 else 32
    with interpret_pallas(jfa):
        ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), block_q=bq,
                                             block_k=bq))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(_t(q), _t(k), _t(v))
    assert tfa.flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,G", [(3, 7), (4, 4)])
def test_decode_attention_contiguous_plain_matches_pallas_interpret(B, G):
    """Ragged per-row lengths over the stacked [L, B, Hk, S, D] cache."""
    L, Hk, D, S = 3, 2, 128, 256
    Hq = G * Hk
    rng = np.random.default_rng(7 + B)
    kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    lens = np.asarray([1, 100, 256, 37][:B], np.int32)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    layer = 1
    with interpret_pallas(jda):
        ref = np.asarray(jda.decode_attention_contiguous(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), layer,
            jnp.asarray(lens)))
    before = tda.decode_attention_contiguous.launches
    got = tda.decode_attention_contiguous(_t(q), _t(kc), _t(vc), layer,
                                          _t(lens))
    assert tda.decode_attention_contiguous.launches == before
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("pos", [0, 37, 128, 255])
def test_decode_attention_appending_plain_matches_pallas_interpret(pos):
    """Edge (0, 255) and mid-block (37, 128) positions: the output and the
    cache rows written in place must match the JAX kernel's."""
    L, B, Hk, G, D, S = 3, 4, 2, 7, 128, 256
    Hq = G * Hk
    rng = np.random.default_rng(11 + pos)
    kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    layer = 2
    with interpret_pallas(jda):
        ref, rk, rv = jda.decode_attention_appending(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), layer, pos)
    tk, tv = _t(kc), _t(vc)
    before = tda.decode_attention_appending.launches
    got, gk, gv = tda.decode_attention_appending(_t(q), tk, tv, _t(kn),
                                                 _t(vn), layer, pos)
    assert tda.decode_attention_appending.launches == before
    assert gk is tk and gv is tv  # written in place, same tensors back
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)


def test_gqa_oracle_matches_jax_oracle():
    B, T, Hq, Hk, S, D = 2, 3, 6, 2, 40, 32
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hk, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hk, S, D)).astype(np.float32)
    pos = np.asarray([[10, 11, 12], [30, 31, 32]], np.int32)
    ref = np.asarray(j_kmajor(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos)))
    got = gqa_attention_kmajor(_t(q), _t(k), _t(v), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _int8_cache(rng, shape):
    """An int8 cache and its scales, quantized by the JAX function."""
    kq, ks = j_quantize_kv(jnp.asarray(rng.normal(size=shape), jnp.float32))
    return np.asarray(kq), np.asarray(ks)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("T,start,G", [(16, 32, 4), (32, 0, 4), (8, 120, 4),
                                       (24, 72, 7)])
def test_chunk_attention_plain_matches_pallas_interpret(T, start, G, quant):
    """The continuation chunk over the stacked cache, causal by absolute
    position, in an f32 cache (the port's plain version computes in the
    input dtype) and an int8 cache with scales; G=7 is the Qwen2.5-7B
    group."""
    L, B, Hk, D, S = 2, 3, 2, 128, 256
    Hq = G * Hk
    rng = np.random.default_rng(23 + T + G)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    layer = 1
    if quant:
        kq, ks = _int8_cache(rng, (L, B, Hk, S, D))
        vq, vs = _int8_cache(rng, (L, B, Hk, S, D))
        with interpret_pallas(jca):
            ref = jca.chunk_attention_contiguous_q8(
                jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                jnp.asarray(ks), jnp.asarray(vs), layer, start)
        fn = tca.chunk_attention_contiguous_q8
        before = fn.launches
        got = fn(_t(q), _t(kq), _t(vq), _t(ks), _t(vs), layer, start)
        tol = 2e-2
    else:
        kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
        vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
        with interpret_pallas(jca):
            ref = jca.chunk_attention_contiguous(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), layer,
                start)
        fn = tca.chunk_attention_contiguous
        before = fn.launches
        got = fn(_t(q), _t(kc), _t(vc), layer, start)
        tol = 4e-3
    assert fn.launches == before
    assert got.shape == (B, T, Hq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("G", [7, 8])
@pytest.mark.parametrize("T", [5, 16])
def test_chunk_attention_plain_matches_pallas_interpret_per_row_starts(
        T, G, quant):
    """The contiguous verify's call: per-row starts ``[B]`` at 0, mid-tile
    (no multiple of the 64-key tile) and S - T (a window ending at the
    cache's end), in an f32 cache and an int8 cache with scales; G = 7
    (Qwen2.5-7B) and 8 (Qwen3-30B-A3B)."""
    L, B, Hk, D, S = 2, 3, 2, 128, 256
    Hq = G * Hk
    rng = np.random.default_rng(41 + T + G)
    starts = np.asarray([0, 100, S - T], np.int32)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    layer = 1
    if quant:
        kq, ks = _int8_cache(rng, (L, B, Hk, S, D))
        vq, vs = _int8_cache(rng, (L, B, Hk, S, D))
        with interpret_pallas(jca):
            ref = jca.chunk_attention_contiguous_q8(
                jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                jnp.asarray(ks), jnp.asarray(vs), layer, jnp.asarray(starts))
        fn = tca.chunk_attention_contiguous_q8
        before = fn.launches
        got = fn(_t(q), _t(kq), _t(vq), _t(ks), _t(vs), layer, _t(starts))
        tol = 2e-2
    else:
        kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
        vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
        with interpret_pallas(jca):
            ref = jca.chunk_attention_contiguous(
                jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), layer,
                jnp.asarray(starts))
        fn = tca.chunk_attention_contiguous
        before = fn.launches
        got = fn(_t(q), _t(kc), _t(vc), layer, _t(starts))
        tol = 4e-3
    assert fn.launches == before
    assert got.shape == (B, T, Hq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_kv_append_uniform_q8_plain_bit_exact_vs_pallas_interpret():
    """The row, its two scales and every untouched element, bit for bit."""
    L, B, Hk, S, D = 2, 3, 2, 256, 128
    rng = np.random.default_rng(12)
    kc = rng.integers(-100, 100, size=(L, B, Hk, S, D)).astype(np.int8)
    vc = rng.integers(-100, 100, size=(L, B, Hk, S, D)).astype(np.int8)
    ks = rng.normal(size=(L, B, Hk, S)).astype(np.float32)
    vs = rng.normal(size=(L, B, Hk, S)).astype(np.float32)
    kn = rng.integers(-127, 128, size=(B, 1, Hk, D)).astype(np.int8)
    vn = rng.integers(-127, 128, size=(B, 1, Hk, D)).astype(np.int8)
    ksn = rng.random(size=(B, 1, Hk)).astype(np.float32)
    vsn = rng.random(size=(B, 1, Hk)).astype(np.float32)
    pos, layer = 137, 1
    with interpret_pallas(jka):
        want = jka.kv_append_uniform_q8(
            jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ksn),
            jnp.asarray(vsn), jnp.int32(pos), layer)
    ins = [_t(a) for a in (kc, vc, ks, vs)]
    before = tka.kv_append_uniform_q8.launches
    got = tka.kv_append_uniform_q8(*ins, _t(kn), _t(vn), _t(ksn), _t(vsn),
                                   pos, layer)
    assert tka.kv_append_uniform_q8.launches == before
    assert all(g is i for g, i in zip(got, ins))  # in place, same tensors
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0].numpy() != kc).sum()) > 0


@pytest.mark.parametrize("lens", [[100, 256], [1, 37]])
def test_decode_attention_q8_plain_matches_pallas_interpret(lens):
    """INT8-KV decode, G=7, per-row lengths including a length of 1."""
    L, B, Hk, G, D, S = 2, 2, 2, 7, 128, 256
    Hq = G * Hk
    rng = np.random.default_rng(11 + lens[0])
    kq, ks = _int8_cache(rng, (L, B, Hk, S, D))
    vq, vs = _int8_cache(rng, (L, B, Hk, S, D))
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    layer = 1
    with interpret_pallas(jda):
        ref = jda.decode_attention_contiguous_q8(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
            jnp.asarray(vs), layer, jnp.asarray(lengths))
    before = tda.decode_attention_contiguous_q8.launches
    got = tda.decode_attention_contiguous_q8(_t(q), _t(kq), _t(vq), _t(ks),
                                             _t(vs), layer, _t(lengths))
    assert tda.decode_attention_contiguous_q8.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2,
                               atol=2e-2)


# the decode shapes of Qwen2.5-7B (Hk 4), Qwen2.5-14B (Hk 8) and
# Qwen3-30B-A3B (Hk 4): batch rows, cache lengths
DECODE_SPLIT_PRESETS = ("qwen2.5-7b", "qwen2.5-14b", "qwen3-30b-a3b")


@pytest.mark.parametrize("S", [256, 512, 576, 1024, 2304, 4096, 32768])
@pytest.mark.parametrize("B", [1, 4, 8, 32, 192])
@pytest.mark.parametrize("preset", DECODE_SPLIT_PRESETS)
def test_decode_split_plan_covers_each_key_once(preset, B, S):
    """plan_decode_split: spans of whole 64-key tiles whose splits cover
    every key of a row exactly once, and at least the target block count
    (2 x 132) where S has the tiles for it; a batch that fills the card
    alone gets one split."""
    from qwen_inference_engine_tpu_torch.config import PRESETS

    Hk = PRESETS[preset].num_kv_heads
    span, splits = tda.plan_decode_split(B, Hk, S)
    assert span > 0 and span % tda.SPLIT_KEYS == 0
    seen = np.zeros(S, np.int64)
    for s in range(splits):
        seen[s * span:min((s + 1) * span, S)] += 1
    assert (seen == 1).all() and (splits - 1) * span < S
    tiles = -(-S // tda.SPLIT_KEYS)
    blocks = B * Hk * splits
    assert blocks >= min(tda.SPLIT_TARGET_BLOCKS, B * Hk * tiles)
    if B * Hk >= tda.SPLIT_TARGET_BLOCKS:
        assert splits == 1
    tda.check_split_plan("plan", span, splits, S)  # the C guard's rule


def _split_merge(q, kd, vd, lengths, span, fresh=None):
    """The split kernel's math in plain f32: for each split of ``span``
    keys of a row's first ``n_b`` keys, the normalised output and the
    log-sum-exp of its scores (an empty split: 0 and -inf), merged in
    split order with weights exp(lse - max lse); 0 for a row of no key.
    q [B, 1, Hq, D]; kd / vd [B, Hk, S, D] dequantized.  Without
    ``fresh``, n_b = lengths[b]; with ``fresh = (k_new, v_new)`` ([B, 1,
    Hk, D], the bf16 decodes), n_b = lengths[b] + 1 and key lengths[b] is
    staged from the inputs by the split that holds it (the last split,
    which then holds span + 1 keys, where it lies at S past every
    split)."""
    B, _, Hq, D = q.shape
    Hk, S = kd.shape[1], kd.shape[2]
    G = Hq // Hk
    splits = -(-S // span)
    n_keys = [int(n) for n in lengths]
    if fresh is not None:
        kd = torch.nn.functional.pad(kd.float(), (0, 0, 0, 1))
        vd = torch.nn.functional.pad(vd.float(), (0, 0, 0, 1))
        for b in range(B):
            kd[b, :, n_keys[b]] = fresh[0][b, 0]
            vd[b, :, n_keys[b]] = fresh[1][b, 0]
        n_keys = [n + 1 for n in n_keys]
    scores = torch.einsum("bkgd,bksd->bkgs",
                          q[:, 0].float().reshape(B, Hk, G, D),
                          kd.float()) * D ** -0.5
    out = torch.zeros(B, Hk, G, D)
    for b in range(B):
        n = n_keys[b]
        parts, lses = [], []
        for s in range(splits):
            s0 = s * span
            e = n if s == splits - 1 else min(s0 + span, n)
            if e <= s0:
                parts.append(torch.zeros(Hk, G, D))
                lses.append(torch.full((Hk, G), -float("inf")))
                continue
            sc = scores[b, :, :, s0:e]
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            den = p.sum(-1, keepdim=True)
            parts.append(torch.einsum("kgs,ksd->kgd", p,
                                      vd[b, :, s0:e].float()) / den)
            lses.append((m + torch.log(den))[..., 0])
        mx = torch.stack(lses).amax(0)
        if not torch.isfinite(mx).all():
            continue  # every split empty: a row of length 0 gives 0
        acc, wsum = torch.zeros(Hk, G, D), torch.zeros(Hk, G)
        for part, lse in zip(parts, lses):  # in split order
            w = torch.exp(lse - mx)
            acc += w[..., None] * part
            wsum += w
        out[b] = acc / wsum[..., None]
    return out.reshape(B, 1, Hq, D)


@pytest.mark.parametrize("span", [None, 64, 128])
@pytest.mark.parametrize("lens", [[1, 63, 64, 65], [128, 129, 255, 256],
                                  [0, 200, 191, 192]])
def test_decode_q8_split_and_merge_matches_plain_and_pallas(lens, span):
    """The split-S kernel's arithmetic (partials and log-sum-exp a split,
    merged in order; written out above) equals
    decode_attention_contiguous_q8_plain (f32 queries: 1e-5) and the JAX
    kernel in interpret mode (2e-2, the int8 kernels' rule) at lengths on
    and around the split edges (plan_decode_split's span, 64 and 128), G
    7; a row of length 0 is 0 (the Pallas kernel and the plain version
    give other values there, so it is held to neither)."""
    L, B, Hk, G, D, S = 2, 4, 2, 7, 128, 256
    Hq = G * Hk
    rng = np.random.default_rng(sum(lens) + (span or 0))
    kq, ks = _int8_cache(rng, (L, B, Hk, S, D))
    vq, vs = _int8_cache(rng, (L, B, Hk, S, D))
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    layer = 1
    span = span or tda.plan_decode_split(B, Hk, S)[0]
    kd = _t(kq)[layer] * _t(ks)[layer][..., None]
    vd = _t(vq)[layer] * _t(vs)[layer][..., None]
    got = _split_merge(_t(q), kd, vd, lengths, span)
    plain = tda.decode_attention_contiguous_q8_plain(
        _t(q), _t(kq), _t(vq), _t(ks), _t(vs), layer, _t(lengths))
    live = lengths > 0
    np.testing.assert_allclose(got.numpy()[live], plain.numpy()[live],
                               rtol=1e-5, atol=1e-5)
    assert (got.numpy()[~live] == 0).all()
    with interpret_pallas(jda):
        ref = np.asarray(jda.decode_attention_contiguous_q8(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
            jnp.asarray(vs), layer, jnp.asarray(np.maximum(lengths, 1))))
    np.testing.assert_allclose(got.numpy()[live], ref[live], rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("span", [None, 128, 256])
@pytest.mark.parametrize("lens", [[0, 1, 64, 65], [256, 263, 191, 192],
                                  [63, 127, 128, 129]])
def test_ragged_decode_split_and_merge_matches_plain_and_pallas(lens, span):
    """The ragged bf16 decode's split arithmetic (``_split_merge`` with no
    fresh key, every key from the cache: the int8 decode's blocks over bf16
    tiles) equals decode_attention_contiguous_plain (f32: 1e-5) and the JAX
    kernel in interpret mode (2e-2) at lengths 0, 1, on each side of the
    64-key tile and of the split edges, S and past S (S + 7 attends all S
    keys), for the plan's span, 128 and one split; NaN at and past each
    length is never read; a row of length 0 is 0 (the Pallas kernel and
    the plain version give other values there, so it is held to
    neither)."""
    L, B, Hk, G, D, S, layer = 2, 4, 2, 7, 128, 256, 1
    kc, vc, q, _, _ = _fresh_inputs(7 + sum(lens))
    lengths = np.asarray(lens, np.int32)
    plain = tda.decode_attention_contiguous_plain(
        _t(q), _t(kc), _t(vc), layer, _t(lengths))
    with interpret_pallas(jda):
        ref = np.asarray(jda.decode_attention_contiguous(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), layer,
            jnp.asarray(lengths)))
    kbad, vbad = _t(kc)[layer].clone(), _t(vc)[layer].clone()
    for b, n in enumerate(lens):
        kbad[b, :, n:] = float("nan")
        vbad[b, :, n:] = float("nan")
    live = lengths > 0
    span = span or tda.plan_decode_split(B, Hk, S)[0]
    got = _split_merge(_t(q), kbad, vbad, lengths, span).numpy()
    np.testing.assert_allclose(got[live], plain.numpy()[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[live], ref[live], rtol=2e-2, atol=2e-2)
    assert (got[~live] == 0).all()


def _fresh_inputs(seed, L=2, B=4, Hk=2, G=7, D=128, S=256):
    rng = np.random.default_rng(seed)
    kc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    vc = rng.normal(size=(L, B, Hk, S, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, G * Hk, D)).astype(np.float32)
    kn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    vn = rng.normal(size=(B, 1, Hk, D)).astype(np.float32)
    return kc, vc, q, kn, vn


# the split spans the bf16 decodes' math is checked at: the plan's (64 at
# B 4, Hk 2, S 256), 128 and one split of all S keys
BF16_SPANS = (None, 128, 256)


@pytest.mark.parametrize("lens", [[0, 63, 64, 65], [127, 128, 129, 255],
                                  [256, 191, 192, 1]])
def test_fresh_decode_split_and_merge_matches_plain_and_pallas(lens):
    """The bf16 fresh decode's split arithmetic (``_split_merge`` with the
    fresh key staged from the inputs by the split that holds it, the last
    split taking it at S) equals decode_attention_contiguous_fresh_plain
    (f32 queries and cache: 1e-5) and the JAX kernel in interpret mode
    (2e-2, the decode kernels' rule) at old lengths 0, on each side of the
    64-key tile and of the split edges, S - 1 and S, for the plan's span,
    128 and one split."""
    L, B, Hk, G, D, S, layer = 2, 4, 2, 7, 128, 256, 1
    kc, vc, q, kn, vn = _fresh_inputs(sum(lens))
    old = np.asarray(lens, np.int32)
    plain = tda.decode_attention_contiguous_fresh_plain(
        _t(q), _t(kc), _t(vc), _t(kn), _t(vn), layer, _t(old))
    with interpret_pallas(jda):
        ref = np.asarray(jda.decode_attention_contiguous_fresh(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), layer, jnp.asarray(old)))
    for span in BF16_SPANS:
        span = span or tda.plan_decode_split(B, Hk, S)[0]
        got = _split_merge(_t(q), _t(kc)[layer], _t(vc)[layer], old, span,
                           fresh=(_t(kn), _t(vn)))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("pos", [0, 63, 64, 65, 128, 255])
def test_appending_decode_split_and_merge_matches_plain_and_pallas(pos):
    """The bf16 appending decode's split arithmetic (``_split_merge`` with
    the fresh key, at the shared position, staged from the inputs by the
    split that holds it) equals decode_attention_appending_plain (f32: 1e-5)
    and the JAX kernel in interpret mode (2e-2) at positions 0, on each
    side of the 64-key tile and of the split edges and S - 1, for the
    plan's span, 128 and one split; the split math reads no cache row at or
    past the position (NaN there changes nothing)."""
    L, B, Hk, G, D, S, layer = 2, 4, 2, 7, 128, 256, 1
    kc, vc, q, kn, vn = _fresh_inputs(100 + pos)
    plain, _, _ = tda.decode_attention_appending_plain(
        _t(q), _t(kc), _t(vc), _t(kn), _t(vn), layer, pos)
    with interpret_pallas(jda):
        ref, _, _ = jda.decode_attention_appending(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
            jnp.asarray(vn), layer, pos)
    kbad, vbad = _t(kc)[layer].clone(), _t(vc)[layer].clone()
    kbad[:, :, pos:] = float("nan")
    vbad[:, :, pos:] = float("nan")
    old = np.full(B, pos, np.int32)
    for span in BF16_SPANS:
        span = span or tda.plan_decode_split(B, Hk, S)[0]
        got = _split_merge(_t(q), kbad, vbad, old, span,
                           fresh=(_t(kn), _t(vn)))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2,
                                   atol=2e-2)
