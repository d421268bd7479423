"""Time the PyTorch port's decode attentions and fused attention + MLP on
the card, and fingerprint the flash, chunk and decode kernels' outputs.

    python3 scripts/time_decode_fused_torch.py ROOT [OUT.json]

ROOT is a checkout of the repository (this one, or an older commit's
``git archive``): its ``qwen_inference_engine_tpu_torch`` package is built
and timed with its ``chip_smoke.py``'s timers (CUDA events around each
call; a CUDA graph of 20 calls replayed 5 times), so two commits compare in
one call to the card.  Shapes are Qwen2.5-7B's, inputs seeded random:

* ``decode_attention_contiguous_q8``: B = 4 at lengths 69 / 700 / 1408 /
  2000 of S 2304 (``check_decode_q8``) and 37 / 120 / 300 / 500 of S 1024
  (run (c)'s decode), a call and in a CUDA graph, and the SHA-256 of the
  output;
* ``decode_attention_appending`` and ``decode_attention_contiguous_fresh``
  (old lengths = the position): B = 4 at position 999 of S 1024
  (``check_decode``) and B = 192 at 272 of S 512 (the batch-192 default
  dispatch), a call and in a CUDA graph, beside SDPA over the first
  position + 1 keys in a CUDA graph, and whether the two outputs are
  bit-equal; ``decode_attention_contiguous`` (the ragged decode) at
  ``check_decode``'s lengths 69 / 152 / 332 / 1000 of S 1024, a call and
  in a CUDA graph, beside SDPA masked to those lengths in a CUDA graph,
  and the SHA-256 of its output;
* ``fused_attn_mlp``: 96 rows from row 96 of a 192-row cache (lens 257,
  S 512) beside the pumped weights' MLP (gs 256 / 128) on Mb = 96 and 40
  rows, a call and in a CUDA graph;
* ``flash_attention`` (B 4, T 512) and ``chunk_attention_contiguous`` /
  ``_q8`` (B 4, T 512 at start 1536 of S 2048): a call's time and the
  SHA-256 of the output's bytes, equal between two commits whose kernels
  compute the same bits.

Prints one JSON object (and writes it to OUT.json when given), with the
card's name and power limit.  Needs a CUDA device.
"""

import hashlib
import json
import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("time_decode_fused_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.ops import chunk_attention as ca
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da
    from qwen_inference_engine_tpu_torch.ops import flash_attention as fa
    from qwen_inference_engine_tpu_torch.ops import fused_step as fs

    cuda_lib.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    Hq, Hk, D, K, F = 28, 4, 128, 3584, 18944
    g = torch.Generator(device="cuda").manual_seed(13)
    out = {"root": root, "card": card}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def timed(fn):
        return {"ms": cs.time_ms(torch, fn), "graph_ms": cs.graph_ms(torch, fn)}

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    for S, lens_list in ((2304, [69, 700, 1408, 2000]),
                         (1024, [37, 120, 300, 500])):
        k8, ks = cs._int8(torch, g, (2, 4, Hk, S, D))
        v8, vs = cs._int8(torch, g, (2, 4, Hk, S, D))
        q = rnd(4, 1, Hq, D)
        lens = torch.tensor(lens_list, device="cuda")
        rec = timed(lambda: da.decode_attention_contiguous_q8(
            q, k8, v8, ks, vs, 1, lens))
        rec["sha256"] = digest(da.decode_attention_contiguous_q8(
            q, k8, v8, ks, vs, 1, lens))
        out[f"decode_attention_contiguous_q8 S{S}"] = rec
        del k8, v8, ks, vs
    for B, S, pos in ((4, 1024, 999), (192, 512, 272)):
        kc, vc = rnd(2, B, Hk, S, D), rnd(2, B, Hk, S, D)
        q, kn, vn = rnd(B, 1, Hq, D), rnd(B, 1, Hk, D), rnd(B, 1, Hk, D)
        old = torch.full((B,), pos, dtype=torch.int32, device="cuda")
        sdpa = cs._sdpa(torch, q.transpose(1, 2), kc[1, :, :, :pos + 1],
                        vc[1, :, :, :pos + 1])
        sdpa_graph = cs.graph_ms(torch, sdpa)
        app = timed(lambda: da.decode_attention_appending(q, kc, vc, kn, vn,
                                                          1, pos))
        fresh = timed(lambda: da.decode_attention_contiguous_fresh(
            q, kc, vc, kn, vn, 1, old))
        a = da.decode_attention_appending(q, kc, vc, kn, vn, 1, pos)[0]
        f = da.decode_attention_contiguous_fresh(q, kc, vc, kn, vn, 1, old)
        out[f"decode_attention_appending B{B}"] = dict(
            app, sdpa_graph_ms=sdpa_graph, sha256=digest(a))
        out[f"decode_attention_contiguous_fresh B{B}"] = dict(
            fresh, sdpa_graph_ms=sdpa_graph, bit_equal_to_appending=bool(
                torch.equal(a, f)))
        if B == 4:
            lens = torch.tensor([69, 152, 332, 1000], device="cuda")
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            out["decode_attention_contiguous"] = dict(
                timed(lambda: da.decode_attention_contiguous(
                    q, kc, vc, 1, lens)),
                sdpa_graph_ms=cs.graph_ms(torch, cs._sdpa(
                    torch, q.transpose(1, 2), kc[1], vc[1], mask=mask)),
                sha256=digest(da.decode_attention_contiguous(
                    q, kc, vc, 1, lens)))
        del kc, vc
    Ba, Bc, S = 96, 192, 512
    kc, vc = rnd(2, Bc, Hk, S, D), rnd(2, Bc, Hk, S, D)
    w, _ = cs._mlp_stack(torch, g, K, F, 256, 128)
    lens = torch.full((Ba,), 257, dtype=torch.int32, device="cuda")
    q = rnd(Ba, 1, Hq, D)
    for Mb in (96, 40):
        x = rnd(Mb, K)
        out[f"fused_attn_mlp Mb{Mb}"] = timed(
            lambda: fs.fused_attn_mlp(lens, 1, 1, q, kc, vc, x, *w,
                                      gs_gate=256, gs_down=128, row0=Ba))
    del kc, vc, w
    qf, kf, vf = rnd(4, 512, Hq, D), rnd(4, 512, Hk, D), rnd(4, 512, Hk, D)
    out["flash_attention"] = {
        "ms": cs.time_ms(torch, lambda: fa.flash_attention(qf, kf, vf)),
        "sha256": digest(fa.flash_attention(qf, kf, vf))}
    kc, vc = rnd(2, 4, Hk, 2048, D), rnd(2, 4, Hk, 2048, D)
    k8, ks = cs._int8(torch, g, (2, 4, Hk, 2048, D))
    v8, vs = cs._int8(torch, g, (2, 4, Hk, 2048, D))
    out["chunk_attention_contiguous"] = {
        "ms": cs.time_ms(torch, lambda: ca.chunk_attention_contiguous(
            qf, kc, vc, 1, 1536)),
        "sha256": digest(ca.chunk_attention_contiguous(qf, kc, vc, 1, 1536))}
    out["chunk_attention_contiguous_q8"] = {
        "ms": cs.time_ms(torch, lambda: ca.chunk_attention_contiguous_q8(
            qf, k8, v8, ks, vs, 1, 1536)),
        "sha256": digest(ca.chunk_attention_contiguous_q8(
            qf, k8, v8, ks, vs, 1, 1536))}
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
