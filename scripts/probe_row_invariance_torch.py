"""Which op of the 7B forward gives a row other bits in a drafter's decode
step (8 slots, one token each: 8 rows) than in the target's verify of the
same token (8 slots, 5 tokens each: 40 rows), on the card.

    python3 scripts/probe_row_invariance_torch.py [LAYERS] [OUT.json]

Qwen2.5-7B widths, LAYERS layers (default 2) of seeded random weights, W4A8
gs 256 with a bf16 lm_head (``chip_smoke.py``'s serving weights), a bf16
page pool of 8 slots and pages of 512 holding random K/V.  One decode step
of token x at position p of every slot, then the verify of [x, d1..d4] at
p over the same pool: every call of ``rms_norm``, ``apply_linear``,
``apply_rope``, the paged attention and the logits is recorded in order,
and the decode's call is held against column 0 of the verify's (its input
and its output).  An op whose inputs agree and whose output does not gives
a row other bits at 40 rows than at 8.  Then the same per op on random
inputs (column 0 of a [8, 5, ...] input equal to the [8, 1, ...] one), and
the verify's logits computed a column at a time.  Prints one JSON object
(and writes it to OUT.json when given) with the card's name and power
limit.  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("probe_row_invariance_torch: no CUDA device", file=sys.stderr)
        return 2
    from qwen_inference_engine_tpu_torch.config import PRESETS
    from qwen_inference_engine_tpu_torch.kvcache.cache import PagedKVCache
    from qwen_inference_engine_tpu_torch.models import qwen
    from qwen_inference_engine_tpu_torch.quant.quantize import (
        QuantConfig,
        quantize_params,
    )

    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["qwen2.5-7b"].replace(num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = qwen.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = quantize_params(bf16, QuantConfig(bits=4, group_size=256))
    del bf16
    cfg = cfg.replace(act_bits=8)
    B, K, page, max_pages = 8, 4, 512, 4
    Hk, D = cfg.num_kv_heads, cfg.head_dim
    cache = PagedKVCache.create(layers, B * max_pages + 1, page, Hk, D,
                                device="cuda")
    for t in (cache.k_pages, cache.v_pages):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    tables = torch.arange(B * max_pages, device="cuda",
                          dtype=torch.int32).reshape(B, max_pages)
    pos = torch.tensor([150, 300, 511, 512, 700, 1000, 1300, 1400],
                       device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, K + 1), generator=gen,
                         device="cuda")

    record = []
    names = ("rms_norm", "apply_linear", "apply_rope", "_paged_attention",
             "compute_logits")
    built = {n: getattr(qwen, n) for n in names}

    def recorder(name):
        fn = built[name]

        def call(*args, **kw):
            out = fn(*args, **kw)
            x = args[2] if name == "_paged_attention" else args[
                1 if name == "compute_logits" else 0]   # q / hidden / x
            record.append((name, x.clone(), out.clone()))
            return out

        return call

    for n in names:
        setattr(qwen, n, recorder(n))
    logits_d, cache = qwen.decode_step(params, cfg, toks[:, 0], pos, cache,
                                       tables)
    dec, record[:] = list(record), []
    positions = pos[:, None] + torch.arange(K + 1, device="cuda")
    hidden, cache = qwen.forward_hidden(params, cfg, toks, positions, cache,
                                        block_tables=tables,
                                        ragged_multi=True)
    logits_v = qwen.compute_logits(params, hidden, cfg.act_bits_lm_head)
    ver = list(record)
    for n in names:
        setattr(qwen, n, built[n])

    def col0(v, d):
        return v[:, :1] if v.dim() == d.dim() else v[:, 0]

    ops, first = [], None
    for i, ((name, xd, yd), (_, xv, yv)) in enumerate(zip(dec, ver)):
        same_in = torch.equal(xd, col0(xv, xd))
        same_out = torch.equal(yd, col0(yv, yd))
        diff = (yd.float() - col0(yv, yd).float()).abs()
        ops.append(dict(i=i, op=name, same_in=same_in, same_out=same_out,
                        n_diff=int((diff != 0).sum()),
                        max_abs=float(diff.max())))
        if first is None and same_in and not same_out:
            first = ops[-1]
    print(f"in-forward: {len(dec)} / {len(ver)} recorded calls; first op "
          f"with equal inputs and other outputs: {first}", flush=True)
    for o in ops:
        print(f"  {o}", flush=True)

    # the same ops on random inputs, column 0 shared
    lyr = params["layers"]

    def pair(*shape):
        x1 = torch.randn((B, 1) + shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        x5 = torch.randn((B, K + 1) + shape, generator=gen,
                         device="cuda").to(torch.bfloat16)
        x5[:, :1] = x1
        return x1, x5

    iso = {}

    def hold(name, f, x1, x5):
        y1, y5 = f(x1), f(x5)
        d = (y1.float() - col0(y5, y1).float()).abs()
        iso[name] = dict(same=torch.equal(y1, col0(y5, y1)),
                         n_diff=int((d != 0).sum()), max_abs=float(d.max()))
        print(f"  isolated {name}: {iso[name]}", flush=True)

    E = cfg.hidden_size
    for rep in range(3):
        hold(f"rms_norm {rep}",
             lambda x: built["rms_norm"](x, lyr["input_norm"][0],
                                         cfg.rms_norm_eps), *pair(E))
        for w, kin in (("q", E), ("k", E), ("v", E), ("o", E),
                       ("gate", E), ("up", E),
                       ("down", cfg.intermediate_size)):
            hold(f"{w} {rep}",
                 lambda x, w=w: built["apply_linear"](x, lyr[w], 0, 8),
                 *pair(kin))
        hold(f"logits {rep}",
             lambda x: built["compute_logits"](params, x[:, 0] if x.shape[1]
                                               == 1 else x, 0), *pair(E))
    # the verify's logits a column at a time: each an 8-row product, as
    # the decode's
    cols = torch.stack([built["compute_logits"](
        params, hidden[:, j].contiguous(), cfg.act_bits_lm_head)
        for j in range(K + 1)], dim=1)
    col_same = torch.equal(cols, logits_v)
    dlog = dict(decode_vs_verify=torch.equal(logits_d, logits_v[:, 0]),
                decode_vs_column=torch.equal(logits_d, cols[:, 0]),
                columns_vs_one_product=col_same,
                argmax_decode_vs_verify=int(
                    (logits_d.argmax(-1) != logits_v[:, 0].argmax(-1)).sum()))
    print(f"logits: {dlog}", flush=True)
    out = dict(card=card, layers=layers, first=first, ops=ops, isolated=iso,
               logits=dlog)
    print(json.dumps(out))
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
