"""The TP step on the card (marker ``cuda``; without a card they skip,
decided in a fixture, never at import).  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py -q

* an NCCL world of one: ``make_tp_decode_fn``'s step, its two all-reduces
  a layer inside, captured as a CUDA graph and replayed bit-equal to the
  eager step, the all-reduces counted in the graph's launches;
* two gloo ranks sharing the card: ``Engine.generate`` under a (1, 2)
  mesh, every rank's tokens equal, the first decode step's logits within
  twice the distance between the single-rank W4A8 and W4A16 runs (the
  row-parallel projections quantize their activations per token over the
  local K, as the JAX TP step does);
* the shard shapes no single-card path launched: Qwen2.5-7B at tp = 4
  (one KV head a rank, INT4 groups of 64 on o's K 896 and down's K 4736,
  k / v N 128) through the kernels against their plain versions;
* the expert-parallel layer (``chip_smoke.py``'s [ep moe]): gloo ranks
  sharing the card at ep 2 and 4 run ``ep_moe_layer`` of one Qwen3-30B-A3B
  layer (W4A8 gs 256) on 16 tokens each: the ragged and dense forms bit
  for bit, within 2^-6 of the largest output of ``moe_mlp`` over the whole
  batch on one rank, finite and bit-equal with every grouped output
  prefilled with NaN (the uncovered rows still NaN after each call), one
  all-gather, two all-to-alls and three grouped launches a layer; and the
  three grouped kernels at the shard shapes (e_loc 64 and 32 over the
  P * M-row receive buffer, the uncovered rows left as they were) against
  their plain versions.
"""

import os
import tempfile

import pytest
import torch

from qwen_inference_engine_tpu_torch.engine import step_graph
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.ops import decode_attention as da
from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm
from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
from qwen_inference_engine_tpu_torch.parallel import mesh as pmesh
from qwen_inference_engine_tpu_torch.parallel.tp_step import (
    make_tp_decode_fn,
    make_tp_prefill_fn,
)
from qwen_inference_engine_tpu_torch.utils.metrics import counted_wrappers

pytestmark = pytest.mark.cuda


def seven_b_w4a8(layers, device, seed=0):
    """Qwen2.5-7B's widths at ``layers`` layers, W4A8 with INT4 groups of
    64 (the tp = 4 shards' aligned size), drawn packed from a seeded
    generator on ``device``: the same params in every process."""
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
    )

    cfg = PRESETS["qwen2.5-7b"].replace(num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_quantized_params(cfg, gen, bits=4, group_size=64,
                                   device=device)
    return cfg.replace(act_bits=8), params


def first_step_and_tokens(eng, prompts, max_new):
    """The first decode step's logits (this rank's shard, on the host) and
    the greedy tokens of a whole ``generate``."""
    eng.start(prompts, max_new, SamplingParams(greedy=True))
    logits = eng.decode().float().cpu()
    return logits, eng.generate(prompts, max_new_tokens=max_new).token_ids


def card_tp_generate(rank, world_size, layers, prompts, max_new):
    """A rank of a pure-TP world on the card (cuda:{rank % count}):
    ``Engine.generate`` of the 7B-width W4A8 model; its first decode
    step's logits shard and tokens."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, params = seven_b_w4a8(layers, dev)
    eng = Engine(cfg, params, mesh=pmesh.make_mesh((1, world_size)),
                 max_batch=4, max_seq=1024,
                 sampling=SamplingParams(greedy=True), device=dev)
    assert not eng.graphs.capture   # gloo: eager steps
    return first_step_and_tokens(eng, prompts, max_new)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc for the first build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture
def nccl_world_of_one(gen):
    tmp = tempfile.mkdtemp(prefix="qie_rdv_")
    pmesh.init_distributed("nccl", "file://" + os.path.join(tmp, "rdv"), 0,
                           1, torch.device("cuda", 0))
    yield pmesh.make_mesh((1, 1))
    torch.distributed.destroy_process_group()


def test_nccl_tp_decode_step_is_captured_bit_equal(nccl_world_of_one):
    mesh = nccl_world_of_one
    assert mesh.capturable and mesh.model_group.backend == "nccl"
    L = 2
    cfg, params = seven_b_w4a8(L, "cuda")
    cache = KVCache.create(L, 4, 512, cfg.num_kv_heads, cfg.head_dim,
                           device="cuda")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, cfg.vocab_size, (4, 64), generator=g).cuda()
    lens = torch.tensor([20, 33, 64, 50], device="cuda")
    with torch.inference_mode():
        logits, _ = make_tp_prefill_fn(cfg, mesh)(params, toks, lens, cache)
        tok = logits.argmax(-1)
        pos = lens.clone()
        step = make_tp_decode_fn(cfg, mesh)
        snap = [t.clone() for t in (cache.k, cache.v, tok, pos)]

        def body():
            out, _ = step(params, tok, pos, cache)
            return out

        def reset():
            for dst, src in zip((cache.k, cache.v, tok, pos), snap):
                dst.copy_(src)

        with step_graph.eager_steps():
            want = body().clone()
        want_cache = cache.k.clone()
        graphs = step_graph.StepGraphs("cuda")
        wrappers = counted_wrappers()
        reset()
        graphs.run("tp", body)                 # the key's first step: eager
        reset()
        before = wrappers["all_reduce"].launches
        got = graphs.run("tp", body).clone()   # captured, then replayed
    assert graphs.captured == 1
    assert torch.equal(got, want) and torch.equal(cache.k, want_cache)
    delta = graphs._steps["tp"].delta
    assert delta["all_reduce"] == 2 * L, delta      # o and down a layer
    assert delta["quant_matmul4_a8"] == 7 * L, delta
    assert wrappers["all_reduce"].launches == before + 2 * L


def test_two_gloo_ranks_on_the_card_match_one_rank(gen):
    L, max_new = 2, 8
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(2, 152064, (n,), generator=g).tolist()
               for n in (37, 120, 300, 77)]
    ranks = pmesh.spawn(card_tp_generate, 2,
                        device_type="cuda", args=(L, prompts, max_new))
    assert ranks[0][1] == ranks[1][1]
    cfg, params = seven_b_w4a8(L, "cuda")
    one = Engine(cfg, params, max_batch=4, max_seq=1024,
                 sampling=SamplingParams(greedy=True))
    ref, _ = first_step_and_tokens(one, prompts, max_new)
    a16 = Engine(cfg.replace(act_bits=0), params, max_batch=4, max_seq=1024,
                 sampling=SamplingParams(greedy=True))
    ref16, _ = first_step_and_tokens(a16, prompts, max_new)
    tp = torch.cat([r[0] for r in ranks], dim=-1)
    assert tp.shape == ref.shape and bool(tp.isfinite().all())
    err = (tp - ref).abs().max().item()
    bound = 2 * (ref - ref16).abs().max().item()
    assert err <= bound, (err, bound)


SHARD_MATMULS = [  # (M, K, N, gs): 7B's tp = 4 projections at decode / prefill
    (4, 3584, 896, 64), (4, 3584, 128, 64), (4, 896, 3584, 64),
    (4, 3584, 4736, 64), (4, 4736, 3584, 64), (512, 4736, 3584, 64),
    (512, 896, 3584, 64)]


@pytest.mark.parametrize("M,K,N,gs", SHARD_MATMULS)
def test_tp4_matmul_shards_match_plain(gen, M, K, N, gs):
    q = torch.randint(-128, 128, (2, K // 2, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((2, K // gs, N), generator=gen, device="cuda") * 0.01
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    xq, sx = qm.quantize_activations(x)
    sx = sx.reshape(-1).contiguous()
    for got, ref in ((qm.quant_matmul4_a8(xq, sx, q, s, 1, gs),
                      qm.quant_matmul4_a8_plain(xq, sx, q, s, 1, gs)),
                     (qm.quant_matmul4(x, q, s, 1, gs),
                      qm.quant_matmul4_plain(x, q, s, 1, gs))):
        tol = 2 ** -6 * ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol


def test_tp4_attention_shards_match_plain(gen):
    """One KV head a rank, 7 query heads: flash, the ragged and appending
    decodes."""
    def bf16(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = bf16(4, 300, 7, 128), bf16(4, 300, 1, 128), bf16(4, 300, 1, 128)
    got, ref = fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    kc, vc = bf16(2, 4, 1, 1024, 128), bf16(2, 4, 1, 1024, 128)
    qd = bf16(4, 1, 7, 128)
    lengths = torch.tensor([69, 300, 1000, 512], device="cuda")
    got = da.decode_attention_contiguous(qd, kc, vc, 1, lengths)
    ref = da.decode_attention_contiguous_plain(qd, kc, vc, 1, lengths)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    kn, vn = bf16(4, 1, 1, 128), bf16(4, 1, 1, 128)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, _, _ = da.decode_attention_appending(qd, k1, v1, kn, vn, 1, 999)
    ref, _, _ = da.decode_attention_appending_plain(qd, k2, v2, kn, vn, 1,
                                                    999)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def card_ep_moe(rank, world_size, tokens):
    """A rank of an EP world on the card: ``ep_moe_layer`` of its
    ``tokens`` rows of a seeded batch over its experts of one 30B-A3B
    layer, ragged, dense and with NaN-prefilled grouped outputs; and the
    single-rank ``moe_mlp`` over the whole batch."""
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_quantized_params,
        moe_mlp,
    )
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm
    from qwen_inference_engine_tpu_torch.parallel.ep_moe import ep_moe_layer
    from qwen_inference_engine_tpu_torch.parallel.ep_step import (
        ep_param_shards,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = PRESETS["qwen3-30b-a3b"].replace(num_layers=1)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = init_quantized_params(cfg, gen, bits=4, group_size=256,
                                   device=dev)
    mesh = pmesh.make_ep_mesh()
    lyr = params["layers"]
    local = ep_param_shards(params, mesh)["layers"]
    h = torch.randn((world_size * tokens, cfg.hidden_size), generator=gen,
                    device=dev).to(torch.bfloat16)
    mine = slice(rank * tokens, (rank + 1) * tokens)
    args = (h[mine], lyr["router"].w[0], local["moe_gate"], local["moe_up"],
            local["moe_down"], cfg.num_experts_per_tok, cfg.norm_topk_prob,
            mesh.ep_group)
    wrappers = counted_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    ragged = ep_moe_layer(*args, ragged=True, act_bits=8)
    counts = {n: w.launches - before[n] for n, w in wrappers.items()
              if w.launches != before[n]}
    dense = ep_moe_layer(*args, ragged=False, act_bits=8)
    orig, tails = gm.grouped_matmul4_a8, []

    def poisoned(xq, sx, q, s, gsz, layer, gs):
        out = torch.full((xq.shape[0], q.shape[-1]), float("nan"),
                         dtype=torch.bfloat16, device=dev)
        y = orig(xq, sx, q, s, gsz, layer, gs, out=out)
        tails.append(bool(y[int(gsz.sum()):].isnan().all()))
        return y

    # the wrapper counts its launches on the module's name
    poisoned.launches = orig.launches
    gm.grouped_matmul4_a8 = poisoned
    try:
        nan_tail = ep_moe_layer(*args, ragged=True, act_bits=8)
    finally:
        gm.grouped_matmul4_a8 = orig
    ref = moe_mlp(h, lyr["router"].w[0], lyr["moe_gate"], lyr["moe_up"],
                  lyr["moe_down"], cfg.num_experts_per_tok,
                  cfg.norm_topk_prob, act_bits=8)[mine]
    return dict(ragged_eq_dense=bool(torch.equal(ragged, dense)),
                nan_tail_eq=bool(torch.equal(nan_tail, ragged)),
                finite=bool(nan_tail.isfinite().all()), tails=tails,
                counts=counts,
                err=(ragged.float() - ref.float()).abs().max().item(),
                ref_max=ref.float().abs().max().item())


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_moe_layer_on_gloo_ranks_matches_one_rank(gen, ep):
    for r, x in enumerate(pmesh.spawn(card_ep_moe, ep, device_type="cuda",
                                      args=(16,))):
        assert x["ragged_eq_dense"] and x["nan_tail_eq"] and x["finite"], r
        assert x["tails"] == [True] * 3, x["tails"]
        assert x["err"] <= 2 ** -6 * x["ref_max"], x
        assert x["counts"] == {"grouped_matmul4_a8": 3, "all_to_all": 2,
                               "all_gather": 1}, x["counts"]


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("proj", ["gate", "down"])
def test_ep_grouped_shard_shapes_match_plain(gen, ep, proj):
    """A rank's receive buffer at decode: P * 16 tokens x top-8 rows, the
    pairs routed to its e_loc = 128 / P experts covered, the rest left as
    the NaN ``out`` held them."""
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as gm

    e_loc, rows = 128 // ep, ep * 16 * 8
    K, N, gs = (2048, 768, 256) if proj == "gate" else (768, 2048, 128)
    ids = torch.rand((ep * 16, 128), generator=gen, device="cuda").topk(
        8, dim=-1).indices
    gsz = torch.bincount(ids.reshape(-1), minlength=128)[:e_loc].to(
        torch.int32)
    real = int(gsz.sum())
    x = torch.randn((rows, K), generator=gen, device="cuda").to(torch.bfloat16)
    xq, sx = qm.quantize_activations(x)
    sx = sx.reshape(-1).contiguous()
    q4 = torch.randint(-128, 128, (2, e_loc, K // 2, N), generator=gen,
                       device="cuda", dtype=torch.int8)
    s4 = torch.rand((2, e_loc, K // gs, N), generator=gen, device="cuda") \
        * (2 * K ** -0.5 / 7)
    q8 = torch.randint(-127, 128, (2, e_loc, K, N), generator=gen,
                       device="cuda", dtype=torch.int8)
    s8 = torch.rand((2, e_loc, K // 128, N), generator=gen, device="cuda") \
        * (2 * K ** -0.5 / 127)
    for name, args in (("grouped_matmul4_a8", (xq, sx, q4, s4, gsz, 1, gs)),
                       ("grouped_matmul4", (x, q4, s4, gsz, 1, gs)),
                       ("grouped_matmul8", (x, q8, s8, gsz, 1))):
        out = torch.full((rows, N), float("nan"), dtype=torch.bfloat16,
                         device="cuda")
        got = getattr(gm, name)(*args, out=out)
        ref = getattr(gm, name + "_plain")(*args)
        assert got is out and bool(got[real:].isnan().all()), name
        tol = 2 ** -6 * ref[:real].float().abs().max().item()
        err = (got[:real].float() - ref[:real].float()).abs().max().item()
        assert err <= tol and bool(got[:real].isfinite().all()), (name, err)
