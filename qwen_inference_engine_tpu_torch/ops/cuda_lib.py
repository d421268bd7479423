"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

At first use every ``.cu`` source is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
directory (``qwen_inference_engine_tpu_torch/_build/``, git-ignored) is
keyed on a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libqie_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (every function returns cudaGetLastError())
SIGNATURES = {
    # x, sx, q, scales, ws (split-K partials or null), out, M, Kp, N,
    # group_size, mt, splits, slice, layer, L, stream
    "qie_quant_matmul4_a8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # x, q, scales, ws (split-K partials or null), out, M, Kp, N,
    # group_size, mt, splits, slice, layer, L, stream
    "qie_quant_matmul4": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    # x, q, scales, ws (split-K partials or null), out, M, K, N, G (scale
    # groups; 1 = per column), mt, splits, slice, layer, L, stream
    "qie_quant_matmul8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    # xq, sx, q, scales, ws (split-K partials or null), out, M, K, N, G,
    # mt, splits, slice, layer, L, stream
    "qie_quant_matmul8_a8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # x, sx, q, scales, group_sizes, out, M, Kp, N, group_size, E, mt (the
    # m16 tiles a warp: 1 or 4), layer, L, stream
    "qie_grouped_matmul4_a8": [_P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, q, scales, group_sizes, out, M, Kp, N, group_size, E, mt, layer,
    # L, stream
    "qie_grouped_matmul4": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    # x, q, scales, group_sizes, out, M, K, N, G (scale groups; 1 = per
    # column), E, mt (the m16 tiles a warp: 1 or 4), layer, L, stream
    "qie_grouped_matmul8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    # q, k, v, out, B, T, Hq, Hk, D, scale, stream
    "qie_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k_cache, v_cache, lengths, ws (the splits' partials, or null for
    # one split), out, L, Bc, B, Hq, Hk, S, D, layer, row0, span, splits,
    # scale, stream
    "qie_decode_attention": [_P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                             _P],
    # q, k_cache, v_cache, k_new, v_new, position, ws (the splits'
    # partials, or null for one split), out, L, Bc, B, Hq, Hk, S, D, layer,
    # row0, span, splits, scale, stream
    "qie_decode_attention_appending": [_P, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _F, _P],
    # q, k_cache, v_cache, k_scale, v_scale, lengths, ws (the splits'
    # partials), out, L, Bc, B, Hq, Hk, S, D, layer, row0, span, splits,
    # scale, stream
    "qie_decode_attention_q8": [_P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _F, _P],
    # q, k_cache, v_cache, old_lengths, k_new, v_new, ws (as for
    # appending), out, L, Bc, B, Hq, Hk, S, D, layer, span, splits, scale,
    # stream
    "qie_decode_attention_fresh": [_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _F, _P],
    # q, k_cache, v_cache, k_scale, v_scale, starts, out,
    # L, Bc, B, T, Hq, Hk, S, D, layer, start, scale, stream
    "qie_chunk_attention": [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    # k_cache, v_cache, k_new, v_new, position, L, Bc, Bn, Hk, S, D,
    # elem_bytes, layer, row0, stream
    "qie_kv_append_uniform": [_P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # k_cache, v_cache, k_new, v_new, position, L, Bc, B, Hk, S, D,
    # elem_bytes, stream
    "qie_kv_append_all_uniform": [_P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P],
    # k_cache, v_cache, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
    # starts, L, Bc, B, T, Hk, S, D, elem_bytes, layer, vec, threads,
    # blocks (plan_paged_append), stream
    "qie_kv_append_ragged_t": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P],
    # x, wg, sg, wu, su, wd, sd, ws (partials, then h), y, M, K, F,
    # gs_gate, gs_down, mt1, splits1, slice1 (gate / up), mt2, splits2,
    # slice2 (down), layer, L, stream
    "qie_fused_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # q, k_cache, v_cache, lens, attn, x, wg, sg, wu, su, wd, sd, ws
    # (partials, then h), ws_bytes, y, Lc, Bc, Ba, Hq, Hk, S, layer_a, row0,
    # M, K, F, gs_gate, gs_down, mt1, splits1, slice1 (gate / up), mt2,
    # splits2, slice2 (down), layer_m, L, scale, stream
    "qie_fused_attn_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _F, _P],
    # q, k_cache, v_cache, lens, attn, x, w, scales, ws (the splits' f32
    # partials, or null for one split), ws_bytes, y, Lc, Bc, Ba, Hq, Hk, S,
    # row0, M, K, N, gs, mt, splits, slice, layer, L, scale, stream
    "qie_fused_attn_matmul": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _P],
    # k_cache, v_cache, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
    # position, L, Bc, B, Hk, S, D, layer, row0, vec, threads, blocks
    # (plan_paged_append), stream
    "qie_kv_append_q8": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_pages, v_pages, k_scale, v_scale, tables, lens, ws (the splits'
    # partials, or null for a bf16 call of one split), out, L, P, B, T, Hq,
    # Hk, page, max_pages, D, layer, span, splits, scale, stream
    "qie_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _F, _P],
    # q, k_pages, v_pages, k_scale, v_scale, tables, out,
    # L, P, B, T, Hq, Hk, page, max_pages, D, layer, start, scale, stream
    "qie_paged_chunk_attention": [_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _P],
    # k_pages, v_pages, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
    # starts, tables, L, P, B, T, Hk, page, D, max_pages, layer, vec,
    # threads, blocks (plan_paged_append), stream
    "qie_paged_append_ragged_t": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _P],
    # k_pages, v_pages, k_scale, v_scale, k_new, v_new, ks_new, vs_new,
    # table, L, P, T, Hk, page, D, max_pages, layer, start, vec, threads,
    # blocks, stream
    "qie_paged_append_prefill": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P],
}


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    cu = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cu")]
    hdr = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cuh")]
    return cu, hdr


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use on a GPU machine")
    return path


def build_key() -> str:
    cu, hdr = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + hdr:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside it."""
    out_dir = os.path.join(BUILD_DIR, build_key())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    tag = f"{os.getpid()}"
    procs = []
    t0 = time.perf_counter()
    for src in cu:
        obj = os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {os.path.basename(src)} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src)
    tmp_lib = lib_path + f".{tag}.tmp"
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_lib] + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    text = "\n".join(log)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(text + f"\nseconds {time.perf_counter() - t0:.1f}\n")
    for _, obj, _ in procs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        print(text)
        raise RuntimeError(f"nvcc failed for {failed}; see {out_dir}/build.log")
    os.replace(tmp_lib, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
