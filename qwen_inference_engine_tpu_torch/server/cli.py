"""CLI of the port: ``generate``, ``serve`` and ``quantize``.

    python -m qwen_inference_engine_tpu_torch.server.cli generate \\
        --ckpt /path/to/Qwen2.5-7B --bits 4 --prompt "Hello" --greedy
    python -m qwen_inference_engine_tpu_torch.server.cli quantize \\
        --ckpt /path/to/Qwen2.5-7B --bits 4 --group-size 128 --out q7b
    python -m qwen_inference_engine_tpu_torch.server.cli serve \\
        --qckpt q7b --port 8000

Weights come from a sharded HF safetensors checkpoint (``--ckpt``,
quantized at load to ``--bits``), from a quantized checkpoint written by
``quantize`` in either package (``--qckpt``), or, with neither, from a
preset with random weights drawn from a seeded generator (in packed form
for ``--bits 4|8``; ``--model tiny-moe`` is a byte-vocab Qwen3-MoE of 8
experts).  Qwen3-MoE models (``--model qwen3-30b-a3b``, or such a
checkpoint) run like dense ones.  Weight formats:
bf16 (``--bits 16``), W4A16 and W8A16 (``--bits 4|8``), W4A8 and W8A8
(``--act-bits 8``).  ``serve`` is continuous batching over the paged KV
cache (bf16, or INT8 with ``--kv-bits 8``) behind HTTP
(``server/http.py``).  Speculative decoding: ``generate --speculative``
(greedy prompt lookup, ``--spec-k`` drafts a round, token-identical to
``--greedy``) and ``serve --speculative`` (prompt lookup with
``--spec-ngram``-token suffixes, or a draft model from ``--draft-model``
(a preset, random weights) or ``--draft-ckpt`` (HF safetensors), quantized
like the target).  ``generate --chat`` wraps each prompt in the tokenizer's
chat template, ``--stats`` prints the engine's metrics as JSON on stderr,
and ``--profile DIR`` writes a ``torch.profiler`` trace of generation into
DIR (``utils/profiling.trace``).  Everything runs on the card
(``--device cuda``, the default) unless ``--device cpu`` is given.

``--tp N --dp M`` (the JAX CLI's flags and defaults: ``--tp 0`` is every
card over ``--dp``) spawn ``N * M`` ranks over a ``(dp, tp)`` mesh
(``parallel/mesh.py``).  Rank ``r`` runs on ``cuda:{r % device_count}``
(or the CPU with ``--device cpu``); the backend is NCCL where every rank
has a card of its own, gloo where ranks share one or run on the CPU.  Each
rank builds the same seeded model and runs its share; rank 0 prints
(``generate``, ``generate --speculative`` included) or serves HTTP
(``serve``: data group ``g`` of ``M`` runs slots ``[g * S / M, (g + 1) *
S / M)`` of ``--max-slots`` ``S``, each group over ``N`` model ranks,
the prefix cache shared across groups).  Every model takes ``--tp``: one
that does not split evenly (KV or query heads that N does not divide,
INT4 groups that an even shard would cut, a row-parallel bias, fused
projections) runs in the layout ``parallel/tp_step.tp_layout`` chooses,
and rank 0 prints it (``[tp layout] ...``, on stderr for ``generate``).
``serve --ep N`` (overriding ``--tp`` / ``--dp``, as the JAX CLI) spawns
``N`` ranks over an expert-parallel ``("ep",)`` mesh for a Qwen3-MoE
model: slots and experts sharded, tokens routed by all-to-alls
(``parallel/ep_step.py``).
``generate --ep`` raises, as the JAX ``Engine`` does on that mesh, and so
does a model the EP step does not take (the JAX CLI ignores ``--ep`` for
a dense model).  ``serve --pp N`` (overriding ``--tp`` / ``--dp`` /
``--ep``, as the JAX CLI) spawns ``N`` ranks over a pipeline-parallel
``("stage",)`` mesh for a dense model and serves FIFO waves through
``engine/pp_scheduler.PPFifoScheduler`` (each rank its ``L / N`` layers;
``--max-slots`` a multiple of ``N``).  ``generate --pp`` raises: the JAX
CLI hands the stage mesh to ``Engine``, which has no pipeline branch and
raises on it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# the byte-vocab smoke models: a dense Qwen2, and a Qwen3-MoE of 8 experts
# (top-2) of width 64
TINY = {"tiny": {},
        "tiny-moe": dict(qk_norm=True, num_experts=8, num_experts_per_tok=2,
                         moe_intermediate_size=64)}


def build_model(args):
    """(cfg, params, tokenizer, device) for the generate, serve and quantize
    commands: the global model (every rank of a mesh builds the same one;
    the engines take their shards)."""
    import torch

    from qwen_inference_engine_tpu_torch.config import ModelConfig, tiny_config
    from qwen_inference_engine_tpu_torch.engine.engine import resolve_device
    from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
        load_checkpoint,
    )
    from qwen_inference_engine_tpu_torch.models.qwen import (
        init_params,
        init_quantized_params,
    )
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )
    from qwen_inference_engine_tpu_torch.tokenizer import load_tokenizer

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    quantized = bool(args.qckpt)
    if args.qckpt:
        from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
            load_quantized,
        )

        cfg, params = load_quantized(args.qckpt, device=device)
        tok = load_tokenizer(args.ckpt or args.qckpt)
    elif args.ckpt:
        cfg, params = load_checkpoint(args.ckpt, dtype=dtype, device=device)
        tok = load_tokenizer(args.ckpt)
    else:
        if args.model in TINY:
            # byte-vocab smoke models (they match the ByteTokenizer)
            cfg = tiny_config(vocab_size=512, **TINY[args.model])
        else:
            cfg = ModelConfig.from_pretrained(args.model)
            print("note: no --ckpt given; using RANDOM weights",
                  file=sys.stderr)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        if args.bits < 16:
            # drawn packed: a Qwen3-30B-A3B never exists in bf16
            params = init_quantized_params(cfg, gen, bits=args.bits,
                                           group_size=args.group_size,
                                           dtype=dtype, device=device)
            quantized = True
        else:
            params = init_params(cfg, gen, dtype=dtype, device=device)
        tok = load_tokenizer(None)
    print(f"tokenizer: {type(tok).__name__}", file=sys.stderr)
    if args.bits < 16 and not quantized:
        params = quantize_params(
            params, QuantConfig(bits=args.bits, group_size=args.group_size))
    if args.act_bits:
        if args.bits >= 16:
            print("error: --act-bits requires --bits 4 or 8", file=sys.stderr)
            raise SystemExit(2)
        cfg = cfg.replace(act_bits=args.act_bits)
    return cfg, params, tok, device


def build_draft_model(args, device):
    """The drafter of ``serve --speculative``: a same-vocab model from
    ``--draft-ckpt`` (a checkpoint) or ``--draft-model`` (a preset with
    random weights), quantized at the target's ``--bits``.  Returns
    (draft_cfg, draft_params), or (None, None) without either flag."""
    import torch

    from qwen_inference_engine_tpu_torch.config import ModelConfig
    from qwen_inference_engine_tpu_torch.loader.safetensors_loader import (
        load_checkpoint,
    )
    from qwen_inference_engine_tpu_torch.models.qwen import init_params
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if getattr(args, "draft_ckpt", None):
        dcfg, dparams = load_checkpoint(args.draft_ckpt, dtype=dtype,
                                        device=device)
    elif getattr(args, "draft_model", None):
        dcfg = ModelConfig.from_pretrained(args.draft_model)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        dparams = init_params(dcfg, gen, dtype=dtype, device=device)
        print("note: no --draft-ckpt given; the drafter uses RANDOM weights",
              file=sys.stderr)
    else:
        return None, None
    if args.bits < 16:
        dparams = quantize_params(
            dparams, QuantConfig(bits=args.bits, group_size=args.group_size))
    return dcfg, dparams


def mesh_shape(args):
    """The mesh's axes: ``{"stage": N}`` from ``--pp N`` (N > 1), else
    ``{"ep": N}`` from ``--ep N`` (N > 1), else ``{"data": dp, "model":
    tp}`` from ``--dp`` / ``--tp`` (``--tp 0``: every card over ``--dp``,
    as the JAX CLI)."""
    import torch

    if getattr(args, "pp", 0) > 1:
        return {"stage": args.pp}
    if getattr(args, "ep", 0) > 1:
        return {"ep": args.ep}
    n_dev = (torch.cuda.device_count() if str(args.device).startswith("cuda")
             else 1)
    dp = max(1, args.dp)
    return {"data": dp, "model": args.tp or max(1, n_dev // dp)}


def _rank_main(rank: int, world: int, args, shape, fn) -> int:
    from qwen_inference_engine_tpu_torch.parallel.mesh import (
        make_ep_mesh,
        make_mesh,
        make_pp_mesh,
        rank_device,
    )

    args.device = str(rank_device(rank, "cuda" if str(args.device)
                                  .startswith("cuda") else "cpu"))
    if "stage" in shape:
        mesh = make_pp_mesh(shape["stage"])
    elif "ep" in shape:
        mesh = make_ep_mesh()
    else:
        mesh = make_mesh((shape["data"], shape["model"]))
    return fn(args, mesh)


def run_ranks(args, fn) -> int:
    """``fn(args, mesh)`` on every rank of the mesh ``mesh_shape`` reads
    (spawned here), or ``fn(args, None)`` in this process for one rank."""
    import math

    from qwen_inference_engine_tpu_torch.parallel.mesh import spawn

    shape = mesh_shape(args)
    world = math.prod(shape.values())
    if world == 1:
        return fn(args, None)
    device_type = "cuda" if str(args.device).startswith("cuda") else "cpu"
    if device_type == "cuda":
        from qwen_inference_engine_tpu_torch.engine.engine import (
            resolve_device,
        )

        resolve_device(args.device)   # raises without a card
    return max(spawn(_rank_main, world, device_type=device_type,
                     args=(args, shape, fn)))


def cmd_generate(args) -> int:
    why = ("it builds NamedSharding(mesh, P(\"data\")) (JAX engine/"
           "engine.py:120) on a mesh that has no data axis")
    if getattr(args, "pp", 0) > 1:
        raise NotImplementedError(
            f"generate --pp: the JAX CLI hands the stage mesh to Engine, "
            f"which has no pipeline branch and raises on it ({why}); serve "
            f"--pp serves a pipeline (PPFifoScheduler)")
    if getattr(args, "ep", 0) > 1:
        raise NotImplementedError(
            f"generate --ep: the JAX Engine raises under an expert-parallel "
            f"mesh ({why}); serve --ep serves a MoE model over EP ranks")
    return run_ranks(args, _generate_rank)


def _generate_rank(args, mesh) -> int:
    """``generate`` on one rank; rank 0 prints."""
    from qwen_inference_engine_tpu_torch.engine.engine import Engine
    from qwen_inference_engine_tpu_torch.kvcache.cache import kv_dtype_from_bits
    from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
    from qwen_inference_engine_tpu_torch.utils.profiling import trace

    cfg, params, tok, device = build_model(args)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p,
                        repetition_penalty=args.repetition_penalty,
                        greedy=args.greedy)
    prompts_text = args.prompt or ["Hello"]
    if args.chat:
        prompts_text = [
            tok.apply_chat_template([{"role": "user", "content": t}])
            for t in prompts_text]
    prompt_ids = [tok.encode(t) for t in prompts_text]
    dp = 1 if mesh is None else mesh.dp
    eng = Engine(cfg, params, mesh=mesh,
                 max_batch=-(-len(prompt_ids) // dp) * dp,
                 max_seq=args.max_seq,
                 kv_dtype=kv_dtype_from_bits(args.kv_bits), sampling=sp,
                 seed=args.seed, device=device)
    del params   # the engine holds its shard
    t0 = time.perf_counter()
    with trace(args.profile):
        if args.speculative:
            ids_out = eng.generate_speculative(
                prompt_ids, max_new_tokens=args.max_new_tokens, k=args.spec_k)
            note = f"speculative k={args.spec_k}"
        else:
            res = eng.generate(prompt_ids, max_new_tokens=args.max_new_tokens)
            ids_out = res.token_ids
            note = (f"ttft {res.ttft_s * 1e3:.1f} ms | "
                    f"{res.decode_tokens_per_s:.1f} tok/s")
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return 0
    if eng.layout is not None:
        print(f"[tp layout] {eng.layout.summary()}", file=sys.stderr)
    for i, ids in enumerate(ids_out):
        print(f"--- sequence {i} ({len(ids)} tokens) ---")
        print(ids)
        print(tok.decode(ids))
    print(f"[device {device} | {note} | total {dt:.2f}s]", file=sys.stderr)
    if args.stats:
        print(json.dumps(eng.metrics.snapshot()), file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    from qwen_inference_engine_tpu_torch.server.http import serve

    return serve(args)


def cmd_quantize(args) -> int:
    """HF safetensors (or a preset) -> a quantized checkpoint directory."""
    from qwen_inference_engine_tpu_torch.loader.qcheckpoint import (
        save_quantized,
    )

    cfg, params, _, _ = build_model(args)
    save_quantized(args.out, cfg, params)
    print(f"wrote quantized checkpoint (INT{args.bits}, g={args.group_size}) "
          f"to {args.out}", file=sys.stderr)
    return 0


def _add_model_args(g) -> None:
    g.add_argument("--model", default="qwen2.5-7b",
                   help="preset name (random weights: drawn packed for "
                        "--bits 4|8) or 'tiny' / 'tiny-moe'")
    g.add_argument("--ckpt", default=None,
                   help="HF checkpoint dir with safetensors shards")
    g.add_argument("--qckpt", default=None,
                   help="quantized checkpoint dir (from `quantize`)")
    g.add_argument("--bits", type=int, default=16, choices=(4, 8, 16),
                   help="weight bits: 4 or 8 quantize at load (not with "
                        "--qckpt); 16 = bf16")
    g.add_argument("--group-size", type=int, default=128)
    g.add_argument("--act-bits", type=int, default=0, choices=(0, 8),
                   help="8 = W4A8 / W8A8: per-token int8 activations in the "
                        "block projections (requires --bits 4 or 8)")
    g.add_argument("--kv-bits", type=int, default=16, choices=(8, 16, 32),
                   help="16 = bf16 KV, 8 = INT8 KV (per-token-per-head "
                        "scales; the contiguous cache and the page pool); "
                        "32 = f32 (CPU only)")
    g.add_argument("--max-seq", type=int, default=2048)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    g.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ranks (0 = every card over --dp)")
    g.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (serve: each data group runs "
                        "its own share of --max-slots)")
    g.add_argument("--ep", type=int, default=0,
                   help="expert-parallel ranks for a MoE model (serve only: "
                        "slots and experts sharded over an ('ep',) mesh; "
                        "overrides --tp / --dp)")
    g.add_argument("--pp", type=int, default=0,
                   help="pipeline-parallel stages (serve only: layer-cut "
                        "weights and KV, FIFO wave serving with a 1F1B "
                        "decode; overrides --tp / --dp / --ep)")
    g.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of generation "
                        "(host ops and, on the card, its kernels) into DIR")


def _add_sampling_args(g) -> None:
    g.add_argument("--greedy", action="store_true")
    g.add_argument("--temperature", type=float, default=0.7)
    g.add_argument("--top-k", type=int, default=50)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--repetition-penalty", type=float, default=1.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="qie-torch", description="Qwen inference engine, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="batch text generation")
    _add_model_args(g)
    _add_sampling_args(g)
    g.add_argument("--prompt", action="append", default=None,
                   help="prompt text (repeatable for a batch)")
    g.add_argument("--max-new-tokens", type=int, default=128)
    g.add_argument("--chat", action="store_true",
                   help="wrap each prompt in the tokenizer's chat template")
    g.add_argument("--stats", action="store_true",
                   help="print the engine's metrics as JSON on stderr")
    g.add_argument("--speculative", action="store_true",
                   help="greedy prompt-lookup speculative decoding "
                        "(token-identical to --greedy, fewer forwards)")
    g.add_argument("--spec-k", type=int, default=8,
                   help="drafted tokens per speculation round")
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="HTTP server with continuous batching")
    _add_model_args(s)
    _add_sampling_args(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-slots", type=int, default=8)
    s.add_argument("--page-size", type=int, default=512,
                   help="KV page size in tokens (a multiple of 8)")
    s.add_argument("--num-pages", type=int, default=0,
                   help="KV page pool size (0 = sized from --max-slots x "
                        "--max-seq plus prefix-cache slack)")
    s.add_argument("--no-prefix-cache", action="store_true",
                   help="disable automatic prefix caching (page reuse "
                        "across requests sharing a prompt prefix)")
    s.add_argument("--step-ticks", type=int, default=8,
                   help="decode ticks chained on the device per host sync "
                        "in the serving loop (1 = sync every token)")
    s.add_argument("--speculative", action="store_true",
                   help="speculative decoding in the scheduler (1..k+1 "
                        "tokens per forward; greedy requests stay "
                        "token-identical): prompt lookup, or a draft model")
    s.add_argument("--spec-k", type=int, default=4,
                   help="drafted tokens per speculation round (1..15)")
    s.add_argument("--spec-ngram", type=int, default=3,
                   help="suffix length for prompt-lookup draft matching")
    s.add_argument("--draft-model", default=None,
                   help="small same-vocab preset (random weights) for "
                        "draft-model speculation")
    s.add_argument("--draft-ckpt", default=None,
                   help="HF checkpoint dir of the draft model")
    s.add_argument("--top-k-cap", type=int, default=None,
                   help="top-k selection width; per-request top_k above it "
                        "returns 400 (default: max(64, --top-k), or the "
                        "vocab when --top-k 0)")
    s.set_defaults(fn=cmd_serve)

    qz = sub.add_parser("quantize",
                        help="pack an HF checkpoint into a quantized checkpoint")
    _add_model_args(qz)
    qz.add_argument("--out", required=True, help="output checkpoint dir")
    qz.set_defaults(fn=cmd_quantize)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
