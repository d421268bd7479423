"""Time the PyTorch port's W4A16 matmul and fused INT4 MLP on the card.

    python3 scripts/time_w4a16_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``): its ``qwen_inference_engine_tpu_torch`` package is built
and timed, with its ``chip_smoke.py``'s timers (CUDA events around each
call; a CUDA graph of 20 calls replayed 5 times), so two commits compare in
one call to the card.  Shapes are Qwen2.5-7B's (K 3584, F 18944), weights
seeded random:

* ``quant_matmul4`` (gs 128): the seven projections of a layer at M = 4
  and 40, a call and in a CUDA graph, summed; the gate at M = 256 and
  2048;
* ``fused_mlp``: gs 256 / 128 (the pumped weights) at M = 4, 8 and 40, a
  call and in a CUDA graph; at M = 192 and 256 a call; gs 128 / 128 at
  M = 4.

Prints one JSON object (and writes it to OUT.json when given), with the
card's name and power limit.  Needs a CUDA device.
"""

import json
import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_w4a16_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs
    from qwen_inference_engine_tpu_torch.ops import quant_matmul as qm

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    K, F = 3584, 18944
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {"root": root, "card": card, "quant_matmul4": {}, "fused_mlp": {}}

    def int4(rows, n, gs):
        q = torch.randint(-128, 128, (1, rows // 2, n), generator=g,
                          device="cuda", dtype=torch.int8)
        s = torch.full((1, rows // gs, n), rows ** -0.5 / 7, device="cuda")
        return q, s

    proj = {"q": (K, K), "k": (K, 512), "v": (K, 512), "o": (K, K),
            "gate": (K, F), "up": (K, F), "down": (F, K)}
    w = {p: int4(k, n, 128) for p, (k, n) in proj.items()}
    for M in (4, 40):
        call = graph = 0.0
        for p, (k, _) in proj.items():
            x = torch.randn((M, k), generator=g, device="cuda").to(
                torch.bfloat16)
            fn = (lambda x=x, p=p: qm.quant_matmul4(x, *w[p], 0, 128))
            call += cs.time_ms(torch, fn)
            graph += cs.graph_ms(torch, fn)
        out["quant_matmul4"][f"layer_M{M}"] = {"ms": call, "graph_ms": graph}
    for M in (256, 2048):
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        out["quant_matmul4"][f"gate_M{M}"] = {"ms": cs.time_ms(
            torch, lambda: qm.quant_matmul4(x, *w["gate"], 0, 128))}
    del w
    for gs_gate, gs_down, ms in ((256, 128, (4, 8, 40, 192, 256)),
                                 (128, 128, (4,))):
        wm, _ = cs._mlp_stack(torch, g, K, F, gs_gate, gs_down)
        kw = dict(gs_gate=gs_gate, gs_down=gs_down)
        for M in ms:
            x = torch.randn((M, K), generator=g, device="cuda").to(
                torch.bfloat16)
            fn = (lambda: fs.fused_mlp(x, *wm, 1, **kw))
            rec = {"ms": cs.time_ms(torch, fn)}
            if M <= 64:
                rec["graph_ms"] = cs.graph_ms(torch, fn)
            out["fused_mlp"][f"M{M} gs {gs_gate}/{gs_down}"] = rec
        del wm
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
