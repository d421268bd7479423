"""Time the bf16 split decodes of the PyTorch port at 1, 2 and 4 warps a
block on the card.

    python3 scripts/sweep_decode_warps_torch.py [OUT.json]

For each warp count, ``csrc/decode_attention.cu`` is copied with its
``kWarps`` set to it, compiled alone with the package's nvcc flags into
``qwen_inference_engine_tpu_torch/_build/sweep_warps<N>/`` and loaded in
place of the kernel library, then ``decode_attention_appending`` and
``decode_attention_contiguous_fresh`` (old lengths = the position) are
timed with ``chip_smoke.py``'s timers (CUDA events around a call; a CUDA
graph of 20 calls replayed 5 times) at B = 4, position 999 of S 1024
(``check_decode``) and B = 192, position 272 of S 512 (the batch-192
default dispatch), Qwen2.5-7B's heads, seeded random inputs (the int8
instance follows the same constant; only the bf16 calls are timed).  The
outputs' SHA-256 must agree across warp counts (only the staging
differs).  Prints one JSON object with the card's name and power limit,
each build's ptxas lines for the split kernel, and the times.  Needs a
CUDA device and nvcc.
"""

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_variant(cuda_lib, warps: int):
    """The decode library with kWarps = warps: (ctypes library, ptxas
    lines of the split kernel)."""
    out = os.path.join(cuda_lib.BUILD_DIR, f"sweep_warps{warps}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC_DIR, out)
    src = os.path.join(out, "decode_attention.cu")
    text = open(src).read()
    text, n = re.subn(r"constexpr int kWarps = \d+;",
                      f"constexpr int kWarps = {warps};", text)
    if n != 1:
        raise RuntimeError("kWarps not found in decode_attention.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libdecode.so")
    run = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                          "-o", lib, src], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(run.stdout + run.stderr)
    ptxas, take = [], 0
    for line in (run.stdout + run.stderr).splitlines():
        if "Compiling entry function" in line:
            take = 4 if "decode_split_kernel" in line else 0
        if take:
            ptxas.append(line.strip())
            take -= 1
    handle = ctypes.CDLL(lib)
    for name in ("qie_decode_attention_appending",
                 "qie_decode_attention_fresh"):
        fn = getattr(handle, name)
        fn.argtypes = cuda_lib.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_decode_warps_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import decode_attention as da

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    Hq, Hk, D = 28, 4, 128
    result = {"card": card}
    shapes = {}
    g = torch.Generator(device="cuda").manual_seed(14)
    for B, S, pos in ((4, 1024, 999), (192, 512, 272)):
        shapes[B] = [torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16) for shape in ((2, B, Hk, S, D), (2, B, Hk, S, D),
                                          (B, 1, Hq, D), (B, 1, Hk, D),
                                          (B, 1, Hk, D))] + [pos]
    digests = {}
    for warps in (1, 2, 4):
        lib, ptxas = build_variant(cuda_lib, warps)
        cuda_lib.library = lambda lib=lib: lib
        rec = {"ptxas": ptxas}
        for B, (kc, vc, q, kn, vn, pos) in shapes.items():
            old = torch.full((B,), pos, dtype=torch.int32, device="cuda")

            def app():
                return da.decode_attention_appending(q, kc, vc, kn, vn, 1,
                                                     pos)[0]

            def fresh():
                return da.decode_attention_contiguous_fresh(q, kc, vc, kn,
                                                            vn, 1, old)

            for name, fn in (("appending", app), ("fresh", fresh)):
                rec[f"{name} B{B}"] = {"ms": cs.time_ms(torch, fn),
                                       "graph_ms": cs.graph_ms(torch, fn)}
                digests.setdefault(f"{name} B{B}", set()).add(
                    hashlib.sha256(fn().view(torch.uint8).cpu().numpy()
                                   .tobytes()).hexdigest()[:16])
        result[f"warps {warps}"] = rec
    result["outputs_equal_across_warps"] = all(len(d) == 1
                                               for d in digests.values())
    text = json.dumps(result)
    print(text)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(text)
    return 0 if result["outputs_equal_across_warps"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
