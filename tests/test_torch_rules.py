"""Rules of the port: no JAX in it, the card by default, no hidden fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu_torch.config import tiny_config
from qwen_inference_engine_tpu_torch.engine.engine import Engine
from qwen_inference_engine_tpu_torch.kvcache.cache import KVCache
from qwen_inference_engine_tpu_torch.models.qwen import init_params
from qwen_inference_engine_tpu_torch.ops import chunk_attention as tca
from qwen_inference_engine_tpu_torch.ops import decode_attention as tda
from qwen_inference_engine_tpu_torch.ops import flash_attention as tfa
from qwen_inference_engine_tpu_torch.ops import kv_append as tka
from qwen_inference_engine_tpu_torch.ops import paged_attention as tpa
from qwen_inference_engine_tpu_torch.ops import quant_matmul as tqmm
from qwen_inference_engine_tpu_torch.ops.linear import QuantLinear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import qwen_inference_engine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "qwen_inference_engine_tpu"
       or m.startswith("qwen_inference_engine_tpu.")
       or m.split(".")[0] in ("ml_dtypes", "safetensors", "transformers")]
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_import_in_port_sources():
    pkg = os.path.join(ROOT, "qwen_inference_engine_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, fs in os.walk(pkg):
        dirs[:] = [x for x in dirs if x != "_build"]  # build outputs only
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            src = f.read()
        for bad in ("import jax", "from jax", "import qwen_inference_engine_tpu\n",
                    "from qwen_inference_engine_tpu.", "import ml_dtypes",
                    "from ml_dtypes", "import safetensors", "from safetensors"):
            assert bad not in src, (path, bad)
        # transformers only inside HFTokenizer (tokenizer.py), never at
        # module level
        for line in src.splitlines():
            if "import transformers" in line or "from transformers" in line:
                assert path.endswith("tokenizer.py") and line.startswith(" "), \
                    (path, line)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_engine_defaults_to_the_card(device):
    cfg = tiny_config()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    if torch.cuda.is_available():
        eng = Engine(cfg, params, max_batch=1, max_seq=64, device=device)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(cfg, params, max_batch=1, max_seq=64, device=device)


def test_cli_defaults_to_the_card():
    from qwen_inference_engine_tpu_torch.server import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["generate", "--model", "tiny", "--max-new-tokens", "2"])


def test_cli_runs_on_cpu_when_asked(capsys):
    from qwen_inference_engine_tpu_torch.server import cli

    rc = cli.main(["generate", "--model", "tiny", "--bits", "4",
                   "--group-size", "64", "--act-bits", "8", "--kv-bits", "32",
                   "--device", "cpu", "--prompt", "hi", "--prompt", "there",
                   "--max-new-tokens", "4", "--greedy"])
    assert rc == 0
    out = capsys.readouterr()
    assert "sequence 1" in out.out and "device cpu" in out.err


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(0)
    counters = [tqmm.quant_matmul4_a8, tqmm.quant_matmul4, tqmm.quant_matmul8,
                tqmm.quant_matmul8_a8, tfa.flash_attention,
                tda.decode_attention_contiguous, tda.decode_attention_appending,
                tca.chunk_attention_contiguous,
                tca.chunk_attention_contiguous_q8,
                tka.kv_append_uniform_q8, tda.decode_attention_contiguous_q8]
    before = [f.launches for f in counters]

    xq = torch.from_numpy(rng.integers(-127, 128, size=(3, 256)).astype(np.int8))
    sx = torch.rand(3)
    q = torch.from_numpy(rng.integers(-128, 128, size=(2, 128, 128)).astype(np.int8))
    s = torch.rand(2, 4, 128)
    y = tqmm.quant_matmul4_a8(xq, sx, q, s, 1, 64)
    np.testing.assert_array_equal(
        y.float().numpy(),
        tqmm.quant_matmul4_a8_plain(xq, sx, q, s, 1, 64).float().numpy())
    xb = torch.randn(3, 256).to(torch.bfloat16)
    np.testing.assert_array_equal(
        tqmm.quant_matmul4(xb, q, s, 0, 64).float().numpy(),
        tqmm.quant_matmul4_plain(xb, q, s, 0, 64).float().numpy())
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(2, 256, 128)).astype(np.int8))
    for s8 in (torch.rand(2, 4, 128), torch.rand(2, 1, 128)):
        np.testing.assert_array_equal(
            tqmm.quant_matmul8(xb, q8, s8, 1).float().numpy(),
            tqmm.quant_matmul8_plain(xb, q8, s8, 1).float().numpy())
        np.testing.assert_array_equal(
            tqmm.quant_matmul8_a8(xq, sx, q8, s8, 1).float().numpy(),
            tqmm.quant_matmul8_a8_plain(xq, sx, q8, s8, 1).float().numpy())

    qq = torch.randn(2, 16, 4, 32)
    kk, vv = torch.randn(2, 16, 2, 32), torch.randn(2, 16, 2, 32)
    np.testing.assert_array_equal(
        tfa.flash_attention(qq, kk, vv).numpy(),
        tfa.flash_attention_plain(qq, kk, vv).numpy())

    kc, vc = torch.randn(2, 2, 2, 256, 32), torch.randn(2, 2, 2, 256, 32)
    qd = torch.randn(2, 1, 4, 32)
    lens = torch.tensor([3, 200])
    np.testing.assert_array_equal(
        tda.decode_attention_contiguous(qd, kc, vc, 1, lens).numpy(),
        tda.decode_attention_contiguous_plain(qd, kc, vc, 1, lens).numpy())
    kn, vn = torch.randn(2, 1, 2, 32), torch.randn(2, 1, 2, 32)
    a, _, _ = tda.decode_attention_appending(qd, kc.clone(), vc.clone(), kn,
                                             vn, 0, 9)
    b, _, _ = tda.decode_attention_appending_plain(qd, kc.clone(), vc.clone(),
                                                   kn, vn, 0, 9)
    np.testing.assert_array_equal(a.numpy(), b.numpy())

    qc = torch.randn(2, 5, 4, 32)
    np.testing.assert_array_equal(
        tca.chunk_attention_contiguous(qc, kc, vc, 1, 40).numpy(),
        tca.chunk_attention_contiguous_plain(qc, kc, vc, 1, 40).numpy())
    k8 = torch.randint(-127, 128, (2, 2, 2, 256, 32), dtype=torch.int8)
    v8 = torch.randint(-127, 128, (2, 2, 2, 256, 32), dtype=torch.int8)
    ks, vs = torch.rand(2, 2, 2, 256), torch.rand(2, 2, 2, 256)
    np.testing.assert_array_equal(
        tca.chunk_attention_contiguous_q8(qc, k8, v8, ks, vs, 0, 7).numpy(),
        tca.chunk_attention_contiguous_q8_plain(qc, k8, v8, ks, vs, 0,
                                                7).numpy())
    np.testing.assert_array_equal(
        tda.decode_attention_contiguous_q8(qd, k8, v8, ks, vs, 1, lens).numpy(),
        tda.decode_attention_contiguous_q8_plain(qd, k8, v8, ks, vs, 1,
                                                 lens).numpy())
    new = (torch.randint(-127, 128, (2, 1, 2, 32), dtype=torch.int8),
           torch.randint(-127, 128, (2, 1, 2, 32), dtype=torch.int8),
           torch.rand(2, 1, 2), torch.rand(2, 1, 2))
    got = tka.kv_append_uniform_q8(k8.clone(), v8.clone(), ks.clone(),
                                   vs.clone(), *new, 9, 1)
    want = tka.kv_append_uniform_q8_plain(k8.clone(), v8.clone(), ks.clone(),
                                          vs.clone(), *new, 9, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [f.launches for f in counters] == before


def test_unported_variants_raise_on_cuda_before_any_plain_path(monkeypatch):
    """The dispatch decisions that do not need a card to be made: row0 != 0
    (pipeline-parallel decode) raises in every decode-side wrapper; INT8
    weights with bf16 activations, unported until this slice, now reach
    their kernel's wrapper and never the plain path (a meta tensor stands in
    for the card; test_cuda_dispatcher_names_the_missing_kernel has every
    (bits, act_bits) pair)."""
    with pytest.raises(NotImplementedError, match="row0"):
        tda.decode_attention_contiguous(torch.zeros(1, 1, 2, 32),
                                        torch.zeros(1, 1, 1, 256, 32),
                                        torch.zeros(1, 1, 1, 256, 32), 0,
                                        torch.ones(1), row0=2)
    k8 = torch.zeros(1, 1, 1, 256, 32, dtype=torch.int8)
    s8 = torch.zeros(1, 1, 1, 256)
    with pytest.raises(NotImplementedError, match="row0"):
        tda.decode_attention_contiguous_q8(torch.zeros(1, 1, 2, 32), k8, k8,
                                           s8, s8, 0, torch.ones(1), row0=2)
    with pytest.raises(NotImplementedError, match="row0"):
        tka.kv_append_uniform_q8(k8, k8, s8, s8, k8[0, :, :, :1], k8[0, :, :, :1],
                                 s8[0, :, :, :1], s8[0, :, :, :1], 0, 0, row0=2)
    x = torch.empty(2, 128, device="meta")
    lin8 = QuantLinear(q=torch.empty(1, 128, 128, dtype=torch.int8),
                       scales=torch.empty(1, 1, 128), b=None, bits=8,
                       group_size=128)
    called = _record_wrappers(monkeypatch)
    monkeypatch.setattr(tqmm, "quant_matmul", None)  # no plain path
    y = tqmm.quant_matmul_stacked(x, lin8, 0, act_bits=0)
    assert called == ["quant_matmul8"] and y.shape == (2, 128)


def test_new_kernel_wrappers_refuse_before_any_launch():
    """On a non-CPU tensor the wrappers of this slice check shapes and types
    before they build or launch anything (a meta tensor stands in for the
    card): chunks of 1..512 tokens, G <= 8, D in {64, 128}, a chunk inside
    the cache, an int8 cache with f32 scales for the q8 variants."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    kc = meta(2, 2, 2, 1024, 128)
    with pytest.raises(ValueError, match="1..512"):
        tca.chunk_attention_contiguous(meta(2, 513, 4, 128), kc, kc, 0, 0)
    with pytest.raises(ValueError, match="G <= 8"):
        tca.chunk_attention_contiguous(meta(2, 8, 18, 128), kc, kc, 0, 0)
    with pytest.raises(ValueError, match="D in"):
        tca.chunk_attention_contiguous(meta(2, 8, 4, 32),
                                       meta(2, 2, 2, 1024, 32),
                                       meta(2, 2, 2, 1024, 32), 0, 0)
    with pytest.raises(IndexError, match="outside the cache"):
        tca.chunk_attention_contiguous(meta(2, 512, 4, 128), kc, kc, 0, 513)
    with pytest.raises(TypeError, match="int8 cache"):
        tca.chunk_attention_contiguous_q8(meta(2, 8, 4, 128), kc, kc,
                                          meta(2, 2, 2, 1024, dtype=torch.float32),
                                          meta(2, 2, 2, 1024, dtype=torch.float32),
                                          0, 0)
    k8 = meta(2, 2, 2, 1024, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="f32 scales"):
        tda.decode_attention_contiguous_q8(meta(2, 1, 4, 128), k8, k8,
                                           meta(2, 2, 2, 1024), meta(2, 2, 2, 1024),
                                           0, meta(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="int8 K/V"):
        tka.kv_append_uniform_q8(k8, k8, meta(2, 2, 2, 1024, dtype=torch.float32),
                                 meta(2, 2, 2, 1024, dtype=torch.float32),
                                 meta(2, 1, 2, 128), meta(2, 1, 2, 128),
                                 meta(2, 1, 2, dtype=torch.float32),
                                 meta(2, 1, 2, dtype=torch.float32), 3, 0)


def _record_wrappers(monkeypatch):
    """Replace the four matmul wrappers by recorders that return an empty
    bf16 output (nothing is built or launched)."""
    called = []

    def recorder(name):
        def fn(x, *args):
            called.append(name)
            q = args[1] if name.endswith("a8") else args[0]
            return torch.empty((x.shape[0], q.shape[-1]),
                               dtype=torch.bfloat16, device=x.device)
        return fn

    for name in ("quant_matmul4_a8", "quant_matmul4", "quant_matmul8",
                 "quant_matmul8_a8"):
        monkeypatch.setattr(tqmm, name, recorder(name))
    return called


@pytest.mark.parametrize("bits,act_bits,kernel", [
    (4, 8, "quant_matmul4_a8"), (4, 0, "quant_matmul4"),
    (8, 0, "quant_matmul8"), (8, 8, "quant_matmul8_a8")])
def test_cuda_dispatcher_names_the_missing_kernel(monkeypatch, bits,
                                                  act_bits, kernel):
    """On a non-CPU tensor the dispatcher routes each (bits, act_bits) pair
    to its kernel's wrapper, never to the plain path; a meta tensor stands
    in for the card.  x [3, 5, 96] is zero-padded to the weight's K=128."""
    x = torch.empty(3, 5, 96, device="meta")
    rows = 64 if bits == 4 else 128
    lin = QuantLinear(q=torch.empty(2, rows, 256, dtype=torch.int8,
                                    device="meta"),
                      scales=torch.empty(2, 2, 256, device="meta"), b=None,
                      bits=bits, group_size=64)
    called = _record_wrappers(monkeypatch)
    monkeypatch.setattr(tqmm, "quant_matmul", None)  # no plain path
    y = tqmm.quant_matmul_stacked(x, lin, 1, act_bits=act_bits)
    assert called == [kernel]
    assert y.shape == (3, 5, 256) and y.dtype == x.dtype
    with pytest.raises(ValueError, match="no kernel"):
        tqmm.quant_matmul_stacked(x, lin, 1, act_bits=4)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_BF, _I8 = torch.bfloat16, torch.int8
REFUSALS = {
    "w4a16 f32 x": (lambda: tqmm.quant_matmul4(
        _meta(2, 512), _meta(1, 256, 256, dtype=_I8), _meta(1, 4, 256), 0, 128),
        TypeError, "bfloat16 activations"),
    "w4a16 gs 16": (lambda: tqmm.quant_matmul4(
        _meta(2, 512, dtype=_BF), _meta(1, 256, 256, dtype=_I8),
        _meta(1, 32, 256), 0, 16), ValueError, "gs % 32"),
    "w4a16 scales": (lambda: tqmm.quant_matmul4(
        _meta(2, 512, dtype=_BF), _meta(1, 256, 256, dtype=_I8),
        _meta(1, 4, 128), 0, 128), ValueError, "shapes"),
    "w4a16 N 96": (lambda: tqmm.quant_matmul4(
        _meta(2, 512, dtype=_BF), _meta(1, 256, 96, dtype=_I8),
        _meta(1, 4, 96), 0, 128), ValueError, "N % 64"),
    "w4a16 uint8 weights": (lambda: tqmm.quant_matmul4(
        _meta(2, 512, dtype=_BF), _meta(1, 256, 256, dtype=torch.uint8),
        _meta(1, 4, 256), 0, 128), TypeError, "int8 weights"),
    "w4a16 K of one group": (lambda: tqmm.quant_matmul4(
        _meta(2, 384, dtype=_BF), _meta(1, 192, 256, dtype=_I8),
        _meta(1, 3, 256), 0, 128), ValueError, r"K % \(2\*gs\)"),
    "w4a16 layer": (lambda: tqmm.quant_matmul4(
        _meta(2, 512, dtype=_BF), _meta(1, 256, 256, dtype=_I8),
        _meta(1, 4, 256), 1, 128), IndexError, "layer 1"),
    "w4a16 decode passes its checks": (lambda: tqmm.quant_matmul4(
        _meta(2, 512, dtype=_BF), _meta(1, 256, 256, dtype=_I8),
        _meta(1, 4, 256), 0, 128), AssertionError, "library was asked for"),
    "w4a16 prefill N 192 passes its checks": (lambda: tqmm.quant_matmul4(
        _meta(100, 512, dtype=_BF), _meta(1, 256, 192, dtype=_I8),
        _meta(1, 16, 192), 0, 32), AssertionError, "library was asked for"),
    "w8a16 f16 scales": (lambda: tqmm.quant_matmul8(
        _meta(2, 512, dtype=_BF), _meta(1, 512, 256, dtype=_I8),
        _meta(1, 1, 256, dtype=torch.float16), 0), TypeError, "f32 scales"),
    "w8a16 gs 16": (lambda: tqmm.quant_matmul8(
        _meta(2, 512, dtype=_BF), _meta(1, 512, 256, dtype=_I8),
        _meta(1, 32, 256), 0), ValueError, "K/G % 32"),
    "w8a16 K": (lambda: tqmm.quant_matmul8(
        _meta(2, 384, dtype=_BF), _meta(1, 512, 256, dtype=_I8),
        _meta(1, 1, 256), 0), ValueError, "shapes"),
    "w8a16 layer": (lambda: tqmm.quant_matmul8(
        _meta(2, 512, dtype=_BF), _meta(1, 512, 256, dtype=_I8),
        _meta(1, 1, 256), 1), IndexError, "layer 1"),
    "w8a8 bf16 x": (lambda: tqmm.quant_matmul8_a8(
        _meta(2, 512, dtype=_BF), _meta(2), _meta(1, 512, 256, dtype=_I8),
        _meta(1, 1, 256), 0), TypeError, "int8 activations"),
    "w8a8 sx": (lambda: tqmm.quant_matmul8_a8(
        _meta(2, 512, dtype=_I8), _meta(3), _meta(1, 512, 256, dtype=_I8),
        _meta(1, 1, 256), 0), ValueError, "shapes"),
    "w8a8 N 192": (lambda: tqmm.quant_matmul8_a8(
        _meta(2, 512, dtype=_I8), _meta(2), _meta(1, 512, 192, dtype=_I8),
        _meta(1, 1, 192), 0), ValueError, "N % 128"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_new_matmul_wrappers_refuse_before_any_build(monkeypatch, case):
    """A wrong dtype, shape, group size or layer is refused before the
    library is built or a kernel launched (meta tensors stand in for the
    card; building would fail here, with no nvcc)."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    fn, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn()


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C function the wrappers call exists in csrc/ with as many
    parameters as its ctypes argtypes (a mismatch would pass garbage)."""
    import re

    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    cu, hdr = cuda_lib._sources()
    assert {os.path.basename(p) for p in cu} == {
        "quant_matmul.cu", "flash_attention.cu", "decode_attention.cu",
        "chunk_attention.cu", "kv_append.cu", "paged_attention.cu",
        "grouped_matmul.cu", "fused_step.cu"}
    assert [os.path.basename(p) for p in hdr] == ["attention_common.cuh",
                                                  "attention_mma.cuh",
                                                  "quant_matmul_core.cuh"]
    src = "".join(open(p).read() for p in cu)
    found = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(found) == set(cuda_lib.SIGNATURES)
    for name, params in found.items():
        assert len(params.split(",")) == len(cuda_lib.SIGNATURES[name]), name
    assert len(cuda_lib.build_key()) == 16


def test_paged_wrappers_refuse_before_any_launch():
    """On a non-CPU tensor the paged wrappers check shapes and types before
    they build or launch anything (a meta tensor stands in for the card):
    G <= 8, D in {64, 128}, pages of a multiple of 8 tokens, tables of one
    row per batch row, pieces of 1..512 tokens that start inside the table,
    bf16 pools and rows."""
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    pool = meta(2, 6, 2, 16, 128)
    tables = meta(2, 3, dtype=torch.int32)
    lens = meta(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="G <= 8"):
        tpa.paged_decode_attention_stacked(meta(2, 1, 18, 128), pool, pool,
                                           tables, lens, 16, 0)
    with pytest.raises(ValueError, match="D in"):
        tpa.paged_decode_attention_stacked(
            meta(2, 1, 4, 32), meta(2, 6, 2, 16, 32), meta(2, 6, 2, 16, 32),
            tables, lens, 16, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.paged_decode_attention_stacked(
            meta(2, 1, 4, 128), meta(2, 6, 2, 12, 128),
            meta(2, 6, 2, 12, 128), tables, lens, 12, 0)
    with pytest.raises(ValueError, match="block tables"):
        tpa.paged_decode_attention_stacked(meta(2, 1, 4, 128), pool, pool,
                                           tables[:1], lens, 16, 0)
    with pytest.raises(IndexError, match="layer"):
        tpa.paged_decode_attention_stacked(meta(2, 1, 4, 128), pool, pool,
                                           tables, lens, 16, 2)
    with pytest.raises(ValueError, match="1..512"):
        tca.paged_chunk_attention(meta(2, 513, 4, 128), pool, pool, tables,
                                  0, 0, 16)
    with pytest.raises(IndexError, match="outside the"):
        tca.paged_chunk_attention(meta(2, 8, 4, 128), pool, pool, tables, 0,
                                  48, 16)
    with pytest.raises(TypeError, match="bf16"):
        tka.paged_append_ragged(pool, pool, meta(2, 1, 2, 128).float(),
                                meta(2, 1, 2, 128), lens, tables, 0,
                                page_size=16)
    with pytest.raises(ValueError, match="new rows"):
        tka.paged_append_ragged(pool, pool, meta(2, 2, 2, 128),
                                meta(2, 2, 2, 128), lens, tables, 0,
                                page_size=16)
    with pytest.raises(ValueError, match="block tables"):
        tka.paged_append_prefill(pool, pool, meta(1, 8, 2, 128),
                                 meta(1, 8, 2, 128), 0, tables, 0,
                                 page_size=16)
    with pytest.raises(IndexError, match="start"):
        tka.paged_append_prefill(pool, pool, meta(1, 8, 2, 128),
                                 meta(1, 8, 2, 128), -1, tables[:1], 0,
                                 page_size=16)


def test_unported_paged_and_serving_variants_name_what_is_missing():
    """What stays unported raises NotImplementedError naming its slice, on
    the CPU as on the card: a device mesh (slice 6) in the serving
    engine."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )

    cfg = tiny_config()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    kw = dict(max_slots=1, page_size=8, num_pages=8, max_pages_per_seq=4,
              device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        ContinuousBatchingEngine(cfg, params, **kw, mesh=object())
    with pytest.raises(ValueError, match="draft_cfg"):
        ContinuousBatchingEngine(cfg, params, **kw, speculative=True,
                                 draft_params=params)


@pytest.mark.parametrize("case", ["moe target", "moe drafter", "moe params"])
def test_moe_serving_and_params_run_on_cpu(case):
    """The calls that raised before Qwen3-MoE was ported now run: an MoE
    target, an MoE drafter of a dense target (no mesh) and the MoE
    params."""
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        Request,
    )

    cfg = tiny_config()
    moe = cfg.replace(num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=64)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.float32)
    moe_params = init_params(moe, gen, dtype=torch.float32)
    if case == "moe params":
        assert moe_params["layers"]["moe_down"].shape == (2, 4, 64, 128)
        assert "gate" not in moe_params["layers"]
        return
    kw = dict(max_slots=1, page_size=8, num_pages=8, max_pages_per_seq=4,
              device="cpu", sampling=None)
    if case == "moe target":
        cb = ContinuousBatchingEngine(moe, moe_params, **kw)
    else:
        cb = ContinuousBatchingEngine(cfg, params, **kw, speculative=True,
                                      spec_k=2, draft_params=moe_params,
                                      draft_cfg=moe)
    cb.submit(Request(request_id=0, prompt=[3, 4, 5], max_new_tokens=4))
    out = cb.run_to_completion()
    assert len(out) == 1 and len(out[0].token_ids) == 4


def test_grouped_wrappers_run_plain_on_cpu_and_count_no_launch():
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as tgm

    rng = np.random.default_rng(1)
    counters = [tgm.grouped_matmul4_a8, tgm.grouped_matmul4,
                tgm.grouped_matmul8]
    before = [f.launches for f in counters]
    gsz = torch.tensor([2, 0, 3], dtype=torch.int32)
    xq = torch.from_numpy(rng.integers(-127, 128, size=(5, 256)).astype(np.int8))
    sx = torch.rand(5)
    xb = torch.randn(5, 256).to(torch.bfloat16)
    q4 = torch.from_numpy(rng.integers(-128, 128, size=(2, 3, 128, 128)).astype(np.int8))
    s4 = torch.rand(2, 3, 2, 128)
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(2, 3, 256, 128)).astype(np.int8))
    for got, want in (
            (tgm.grouped_matmul4_a8(xq, sx, q4, s4, gsz, 1, 128),
             tgm.grouped_matmul4_a8_plain(xq, sx, q4, s4, gsz, 1, 128)),
            (tgm.grouped_matmul4(xb, q4, s4, gsz, 0, 128),
             tgm.grouped_matmul4_plain(xb, q4, s4, gsz, 0, 128)),
            (tgm.grouped_matmul8(xb, q8, torch.rand(2, 3, 1, 128), gsz, 1),
             None)):
        assert got.dtype == torch.bfloat16 and got.shape == (5, 128)
        if want is not None:
            assert torch.equal(got, want)
    assert [f.launches for f in counters] == before


def test_kernel_registry_names_every_wrapper():
    """``utils/metrics.kernel_wrappers`` lists each kernel wrapper once, by
    its name, each with its launch count: the 20 dense ones, the three
    grouped MoE matmuls, the fused MLP, the fused attention + MLP and the
    uniform bf16 append of the double-pumped decode, and the last four
    Pallas sites' kernels (the ragged window append, the fresh-merge decode
    attention, the all-layer append, the fused attention + matmul): 30
    wrappers over the JAX package's 28 sites."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as tgm
    from qwen_inference_engine_tpu_torch.utils.metrics import kernel_wrappers

    wrappers = kernel_wrappers()
    assert len(wrappers) == 30
    assert all(isinstance(w.launches, int) and w.__name__ == n
               for n, w in wrappers.items())
    for w in (tgm.grouped_matmul4_a8, tgm.grouped_matmul4,
              tgm.grouped_matmul8, tqmm.quant_matmul4_a8,
              tpa.paged_verify_attention_stacked, tfs.fused_mlp,
              tfs.fused_attn_mlp, tka.kv_append_uniform,
              tka.kv_append_ragged_t, tda.decode_attention_contiguous_fresh,
              tka.kv_append_all_uniform, tfs.fused_attn_matmul):
        assert wrappers[w.__name__] is w


def _gmm_meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_I8M = torch.int8
GROUPED_REFUSALS = {
    "a8 bf16 activations": (lambda t: t.grouped_matmul4_a8(
        _gmm_meta(5, 256, dtype=torch.bfloat16), _gmm_meta(5),
        _gmm_meta(2, 3, 128, 128, dtype=_I8M), _gmm_meta(2, 3, 2, 128),
        _gmm_meta(3, dtype=torch.int32), 0, 128), TypeError, "int8"),
    "a8 N % 128": (lambda t: t.grouped_matmul4_a8(
        _gmm_meta(5, 256, dtype=_I8M), _gmm_meta(5),
        _gmm_meta(2, 3, 128, 64, dtype=_I8M), _gmm_meta(2, 3, 2, 64),
        _gmm_meta(3, dtype=torch.int32), 0, 128), ValueError, "N % 128"),
    "w4 group sizes of another E": (lambda t: t.grouped_matmul4(
        _gmm_meta(5, 256, dtype=torch.bfloat16),
        _gmm_meta(2, 3, 128, 128, dtype=_I8M), _gmm_meta(2, 3, 2, 128),
        _gmm_meta(4, dtype=torch.int32), 0, 128), ValueError, "shapes"),
    "w4 int64 group sizes": (lambda t: t.grouped_matmul4(
        _gmm_meta(5, 256, dtype=torch.bfloat16),
        _gmm_meta(2, 3, 128, 128, dtype=_I8M), _gmm_meta(2, 3, 2, 128),
        _gmm_meta(3, dtype=torch.int64), 0, 128), TypeError, "int32"),
    "w4 gs 16": (lambda t: t.grouped_matmul4(
        _gmm_meta(5, 256, dtype=torch.bfloat16),
        _gmm_meta(2, 3, 128, 128, dtype=_I8M), _gmm_meta(2, 3, 16, 128),
        _gmm_meta(3, dtype=torch.int32), 0, 16), ValueError, "gs % 32"),
    "w8 layer out of range": (lambda t: t.grouped_matmul8(
        _gmm_meta(5, 256, dtype=torch.bfloat16),
        _gmm_meta(2, 3, 256, 128, dtype=_I8M), _gmm_meta(2, 3, 1, 128),
        _gmm_meta(3, dtype=torch.int32), 2), IndexError, "out of range"),
    "w8 groups of 48 rows": (lambda t: t.grouped_matmul8(
        _gmm_meta(5, 192, dtype=torch.bfloat16),
        _gmm_meta(2, 3, 192, 128, dtype=_I8M), _gmm_meta(2, 3, 4, 128),
        _gmm_meta(3, dtype=torch.int32), 0), ValueError, "K/G % 32"),
}


@pytest.mark.parametrize("case", sorted(GROUPED_REFUSALS))
def test_grouped_wrappers_refuse_before_any_build(monkeypatch, case):
    """On a non-CPU tensor the grouped wrappers check types, shapes and the
    layer before the library is built (meta tensors stand in for the
    card)."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import grouped_matmul as tgm

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    fn, exc, match = GROUPED_REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn(tgm)


PAGED_REFUSALS = {
    "verify T 17": (lambda: tpa.paged_verify_attention_stacked(
        _meta(2, 17, 4, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_BF),
        _meta(2, 6, 2, 16, 128, dtype=_BF), _meta(2, 3, dtype=torch.int32),
        _meta(2, dtype=torch.int32), 16, 0), AssertionError,
        "library was asked for"),
    "verify T 1": (lambda: tpa.paged_verify_attention_stacked(
        _meta(2, 1, 4, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_BF),
        _meta(2, 6, 2, 16, 128, dtype=_BF), _meta(2, 3, dtype=torch.int32),
        _meta(2, dtype=torch.int32), 16, 0), ValueError, "T >= 2"),
    "decode T 5": (lambda: tpa.paged_decode_attention_stacked_q8(
        _meta(2, 5, 4, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16),
        _meta(2, 6, 2, 16), _meta(2, 3, dtype=torch.int32),
        _meta(2, dtype=torch.int32), 16, 0), ValueError,
        "paged_verify_attention_stacked"),
    "verify G 9": (lambda: tpa.paged_verify_attention_stacked_q8(
        _meta(2, 5, 18, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16),
        _meta(2, 6, 2, 16), _meta(2, 3, dtype=torch.int32),
        _meta(2, dtype=torch.int32), 16, 0), ValueError, "G <= 8"),
    "q8 verify bf16 pool": (lambda: tpa.paged_verify_attention_stacked_q8(
        _meta(2, 5, 4, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_BF),
        _meta(2, 6, 2, 16, 128, dtype=_BF), _meta(2, 6, 2, 16),
        _meta(2, 6, 2, 16), _meta(2, 3, dtype=torch.int32),
        _meta(2, dtype=torch.int32), 16, 0), TypeError, "f32 scales"),
    "q8 decode f16 scales": (lambda: tpa.paged_decode_attention_stacked_q8(
        _meta(2, 1, 4, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 6, 2, 16, dtype=torch.float16),
        _meta(2, 6, 2, 16, dtype=torch.float16),
        _meta(2, 3, dtype=torch.int32), _meta(2, dtype=torch.int32), 16, 0),
        ValueError, "f32 scales"),
    "q8 chunk T 513": (lambda: tca.paged_chunk_attention_q8(
        _meta(1, 513, 4, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16),
        _meta(2, 6, 2, 16), _meta(1, 3, dtype=torch.int32), 0, 0, 16),
        ValueError, "1..512"),
    "q8 chunk f32 queries": (lambda: tca.paged_chunk_attention_q8(
        _meta(1, 16, 4, 128), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16),
        _meta(2, 6, 2, 16), _meta(1, 3, dtype=torch.int32), 0, 0, 16),
        TypeError, "int8 pools"),
    "ragged_t T > page": (lambda: tka.paged_append_ragged_t(
        _meta(2, 6, 2, 16, 128, dtype=_BF), _meta(2, 6, 2, 16, 128, dtype=_BF),
        _meta(2, 17, 2, 128, dtype=_BF), _meta(2, 17, 2, 128, dtype=_BF),
        _meta(2, dtype=torch.int32), _meta(2, 3, dtype=torch.int32), 0,
        page_size=16), AssertionError, "library was asked for"),
    "ragged_t int8 without scales": (lambda: tka.paged_append_ragged_t(
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 5, 2, 128, dtype=_I8), _meta(2, 5, 2, 128, dtype=_I8),
        _meta(2, dtype=torch.int32), _meta(2, 3, dtype=torch.int32), 0,
        page_size=16), TypeError, "f32 scales"),
    "ragged_t bf16 rows into int8": (lambda: tka.paged_append_ragged_t(
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 5, 2, 128, dtype=_BF), _meta(2, 5, 2, 128, dtype=_BF),
        _meta(2, dtype=torch.int32), _meta(2, 3, dtype=torch.int32), 0,
        page_size=16, k_scale=_meta(2, 6, 2, 16), v_scale=_meta(2, 6, 2, 16),
        ks_new=_meta(2, 5, 2), vs_new=_meta(2, 5, 2)), TypeError, "int8"),
    "ragged int8 row scales": (lambda: tka.paged_append_ragged(
        _meta(2, 6, 2, 16, 128, dtype=_I8), _meta(2, 6, 2, 16, 128, dtype=_I8),
        _meta(2, 1, 2, 128, dtype=_I8), _meta(2, 1, 2, 128, dtype=_I8),
        _meta(2, dtype=torch.int32), _meta(2, 3, dtype=torch.int32), 0,
        page_size=16, k_scale=_meta(2, 6, 2, 16), v_scale=_meta(2, 6, 2, 16),
        ks_new=_meta(2, 1, 3), vs_new=_meta(2, 1, 3)), ValueError,
        "f32 scales"),
    "chunk starts shape": (lambda: tca.chunk_attention_contiguous(
        _meta(2, 5, 4, 128, dtype=_BF), _meta(2, 2, 2, 256, 128, dtype=_BF),
        _meta(2, 2, 2, 256, 128, dtype=_BF), 0,
        _meta(3, dtype=torch.int32)), ValueError, "per-row starts"),
}


@pytest.mark.parametrize("case", sorted(PAGED_REFUSALS))
def test_new_paged_wrappers_refuse_before_any_build(monkeypatch, case):
    """The INT8-pool and verify wrappers refuse a wrong dtype, a verify of
    T < 2, G > 8 or scales of the wrong shape before the library is built
    or a kernel launched (meta tensors stand in for the card); a verify of
    T = 17 and a window wider than its page pass every check and ask for
    the library."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    fn, exc, match = PAGED_REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn()


@pytest.mark.parametrize("device", [None, "cuda"])
def test_serving_engine_defaults_to_the_card(device):
    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )

    cfg = tiny_config()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    kw = dict(max_slots=1, page_size=8, num_pages=8, max_pages_per_seq=4)
    if torch.cuda.is_available():
        cb = ContinuousBatchingEngine(cfg, params, device=device, **kw)
        assert cb.device.type == "cuda" and cb.cache.k_pages.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousBatchingEngine(cfg, params, device=device, **kw)
    cb = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    assert cb.cache.k_pages.device.type == "cpu"


def test_cli_serve_defaults_to_the_card_and_runs_on_cpu_when_asked(
        monkeypatch, capsys):
    """``serve`` raises without a card unless ``--device cpu``; with it, the
    server is built on the CPU, binds, and shuts down cleanly (the serving
    loop is stopped at once here)."""
    from qwen_inference_engine_tpu_torch.server import cli
    from qwen_inference_engine_tpu_torch.server import http as thttp

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["serve", "--model", "tiny", "--port", "0"])
    built = []

    class Interrupted(thttp.ThreadingHTTPServer):
        def serve_forever(self, poll_interval=0.5):
            built.append(self.server_address)
            raise KeyboardInterrupt

    monkeypatch.setattr(thttp, "ThreadingHTTPServer", Interrupted)
    rc = cli.main(["serve", "--model", "tiny", "--bits", "4", "--group-size",
                   "64", "--act-bits", "8", "--kv-bits", "32", "--device",
                   "cpu", "--host", "127.0.0.1", "--port", "0",
                   "--max-slots", "2", "--page-size", "16", "--max-seq", "128",
                   "--step-ticks", "4", "--no-prefix-cache"])
    assert rc == 0 and built and built[0][0] == "127.0.0.1"
    out = capsys.readouterr().out
    assert "device cpu" in out and "slots=2" in out and "x16" in out


def test_fused_wrappers_run_plain_on_cpu_and_count_no_launch():
    """fused_mlp, fused_attn_mlp, fused_attn_matmul, kv_append_uniform,
    kv_append_all_uniform, kv_append_ragged_t and
    decode_attention_contiguous_fresh run their plain versions for CPU
    tensors (the same results) and count no launch."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    rng = np.random.default_rng(3)
    counters = [tfs.fused_mlp, tfs.fused_attn_mlp, tka.kv_append_uniform,
                tfs.fused_attn_matmul, tka.kv_append_all_uniform,
                tka.kv_append_ragged_t, tda.decode_attention_contiguous_fresh]
    before = [f.launches for f in counters]
    L, K, F = 2, 128, 512

    def i8(*shape):
        return torch.from_numpy(rng.integers(-128, 128, size=shape).astype(np.int8))

    w = (i8(L, K // 2, F), torch.rand(L, K // 64, F), i8(L, K // 2, F),
         torch.rand(L, K // 64, F), i8(L, F // 2, K), torch.rand(L, F // 128, K))
    x = torch.randn(5, K)
    kw = dict(gs_gate=64, gs_down=128)
    assert torch.equal(tfs.fused_mlp(x, *w, 1, **kw),
                       tfs.fused_mlp_plain(x, *w, 1, **kw))
    kc, vc = torch.randn(2, 6, 2, 256, 128), torch.randn(2, 6, 2, 256, 128)
    q = torch.randn(3, 1, 8, 128)
    lens = torch.tensor([4, 100, 256])
    got = tfs.fused_attn_mlp(lens, 1, 0, q, kc, vc, x, *w, row0=3, **kw)
    want = tfs.fused_attn_mlp_plain(lens, 1, 0, q, kc, vc, x, *w, row0=3,
                                    **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kn, vn = torch.randn(3, 1, 2, 128), torch.randn(3, 1, 2, 128)
    a = tka.kv_append_uniform(kc.clone(), vc.clone(), kn, vn, 7, 1, row0=3)
    b = tka.kv_append_uniform_plain(kc.clone(), vc.clone(), kn, vn, 7, 1, 3)
    assert all(torch.equal(g, h) for g, h in zip(a, b))
    got = tfs.fused_attn_matmul(lens, 1, q, kc, vc, x, w[0], w[1],
                                group_size=64, row0=3)
    want = tfs.fused_attn_matmul_plain(lens, 1, q, kc, vc, x, w[0], w[1],
                                       group_size=64, row0=3)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    new = torch.randn(2, 6, 2, 128)
    a = tka.kv_append_all_uniform(kc.clone(), vc.clone(), new, new, 9)
    b = tka.kv_append_all_uniform_plain(kc.clone(), vc.clone(), new, new, 9)
    assert all(torch.equal(g, h) for g, h in zip(a, b))
    starts = torch.tensor([-1, 0, 250, 30, 7, 100])
    new = torch.randn(6, 5, 2, 128)
    a = tka.kv_append_ragged_t(kc.clone(), vc.clone(), new, new, starts, 1)
    b = tka.kv_append_ragged_t_plain(kc.clone(), vc.clone(), new, new,
                                     starts, 1)
    assert all(torch.equal(g, h) for g, h in zip(a, b))
    qf, kn6 = torch.randn(6, 1, 8, 128), torch.randn(6, 1, 2, 128)
    old = torch.tensor([0, 3, 255, 256, 17, 100])
    assert torch.equal(
        tda.decode_attention_contiguous_fresh(qf, kc, vc, kn6, kn6, 0, old),
        tda.decode_attention_contiguous_fresh_plain(qf, kc, vc, kn6, kn6, 0,
                                                    old))
    assert [f.launches for f in counters] == before


def _fused_mlp_args(M=8, K=256, F=512, gs_gate=64, gs_down=128, L=2,
                    sg_dtype=torch.float32, w_dtype=_I8, dev="meta"):
    return ((_meta(M, K, dtype=_BF),
             torch.empty(L, K // 2, F, dtype=w_dtype, device=dev),
             _meta(L, K // gs_gate, F, dtype=sg_dtype),
             _meta(L, K // 2, F, dtype=_I8), _meta(L, K // gs_gate, F),
             _meta(L, F // 2, K, dtype=_I8), _meta(L, F // gs_down, K)),
            dict(gs_gate=gs_gate, gs_down=gs_down))


def _fused_mlp_call(layer=1, **kw):
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    args, gs = _fused_mlp_args(**kw)
    return tfs.fused_mlp(*args, layer, **gs)


def _fused_attn_call(Ba=4, Hq=8, Hk=2, D=128, Bc=8, row0=4, kv=_BF,
                     lens_n=None, layer_a=1):
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    args, gs = _fused_mlp_args()
    cache = _meta(2, Bc, Hk, 256, D, dtype=kv)
    return tfs.fused_attn_mlp(
        _meta(lens_n or Ba, dtype=torch.int32), layer_a, 0,
        _meta(Ba, 1, Hq, D, dtype=_BF), cache, cache, *args, row0=row0, **gs)


def _append_call(kv=_BF, Bn=4, row0=4, layer=1, position=9, new_dev="meta"):
    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    new = torch.empty(Bn, 1, 2, 128, dtype=_BF, device=new_dev)
    return tka.kv_append_uniform(cache, cache, new, new, position, layer,
                                 row0=row0)


def _attn_matmul_call(kv=_BF, gs=64, N=512, s_dtype=torch.float32, layer=1,
                      row0=4):
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    return tfs.fused_attn_matmul(
        _meta(4, dtype=torch.int32), layer, _meta(4, 1, 8, 128, dtype=_BF),
        cache, cache, _meta(8, 256, dtype=_BF),
        _meta(2, 128, N, dtype=_I8), _meta(2, 256 // gs, N, dtype=s_dtype),
        group_size=gs, row0=row0)


def _all_append_call(kv=_BF, B=8, position=9):
    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    new = _meta(2, B, 1, 2, 128, dtype=_BF)
    return tka.kv_append_all_uniform(cache, cache, new, new, position)


def _ragged_t_call(kv=_BF, new=_BF, scales=False, n_starts=4, layer=1):
    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    rows = _meta(4, 5, 2, 128, dtype=new)
    kw = {}
    if scales:
        kw = dict(k_scale=_meta(2, 8, 2, 256), v_scale=_meta(2, 8, 2, 256),
                  ks_new=_meta(4, 5, 2), vs_new=_meta(4, 5, 2))
    return tka.kv_append_ragged_t(cache, cache, rows, rows,
                                  _meta(n_starts, dtype=torch.int32), layer,
                                  **kw)


def _fresh_call(kv=_BF, Hq=8, new_T=1, n_lens=4):
    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    new = _meta(4, new_T, 2, 128, dtype=_BF)
    return tda.decode_attention_contiguous_fresh(
        _meta(4, 1, Hq, 128, dtype=_BF), cache, cache, new, new, 1,
        _meta(n_lens, dtype=torch.int32))


FUSED_REFUSALS = {
    "mlp f16 scales": (lambda: _fused_mlp_call(sg_dtype=torch.float16),
                       TypeError, "f32 scales"),
    "mlp int32 weights": (lambda: _fused_mlp_call(w_dtype=torch.int32),
                          TypeError, "int8"),
    "mlp M 257": (lambda: _fused_mlp_call(M=257), ValueError, "M <= 256"),
    "mlp gs 16": (lambda: _fused_mlp_call(gs_gate=16), ValueError,
                  "gs % 32"),
    "mlp layer 2": (lambda: _fused_mlp_call(layer=2), IndexError, "layer 2"),
    "mlp weights on the cpu": (lambda: _fused_mlp_call(dev="cpu"),
                               ValueError, "one device"),
    "mlp passes its checks": (lambda: _fused_mlp_call(), AssertionError,
                              "library was asked for"),
    "mlp gs_down 48": (lambda: _fused_mlp_call(gs_down=48), ValueError,
                       "gs % 32"),
    "mlp M 1 passes its checks": (lambda: _fused_mlp_call(M=1),
                                  AssertionError, "library was asked for"),
    "mlp M 192 passes its checks": (lambda: _fused_mlp_call(M=192),
                                    AssertionError, "library was asked for"),
    "attn f32 cache": (lambda: _fused_attn_call(kv=torch.float32), TypeError,
                       "bf16 caches"),
    "attn D 64": (lambda: _fused_attn_call(D=64), ValueError, "D == 128"),
    "attn G 9": (lambda: _fused_attn_call(Hq=18), ValueError, "G <= 8"),
    "attn rows past the cache": (lambda: _fused_attn_call(row0=5), ValueError,
                                 "rows inside"),
    "attn lens": (lambda: _fused_attn_call(lens_n=3), ValueError, "lens"),
    "attn layer 2": (lambda: _fused_attn_call(layer_a=2), IndexError,
                     "layer 2"),
    "attn passes its checks": (lambda: _fused_attn_call(), AssertionError,
                               "library was asked for"),
    "append int8 cache": (lambda: _append_call(kv=_I8), TypeError,
                          "bf16 or f32"),
    "append rows past the cache": (lambda: _append_call(row0=5), ValueError,
                                   "shapes"),
    "append layer 2": (lambda: _append_call(layer=2), IndexError, "layer 2"),
    "append position 256": (lambda: _append_call(position=256), IndexError,
                            "outside the cache"),
    "append rows on the cpu": (lambda: _append_call(new_dev="cpu"), TypeError,
                               "device"),
    "append passes its checks": (lambda: _append_call(), AssertionError,
                                 "library was asked for"),
    "attn matmul f32 cache": (lambda: _attn_matmul_call(kv=torch.float32),
                              TypeError, "bf16 caches"),
    "attn matmul gs 16": (lambda: _attn_matmul_call(gs=16), ValueError,
                          "gs % 32"),
    "attn matmul N 96": (lambda: _attn_matmul_call(N=96), ValueError,
                         "N % 64"),
    "attn matmul f16 scales": (lambda: _attn_matmul_call(
        s_dtype=torch.float16), TypeError, "f32 scales"),
    "attn matmul layer 2": (lambda: _attn_matmul_call(layer=2), IndexError,
                            "layer 2"),
    "attn matmul rows past the cache": (lambda: _attn_matmul_call(row0=5),
                                        ValueError, "rows inside"),
    "attn matmul passes its checks": (lambda: _attn_matmul_call(),
                                      AssertionError,
                                      "library was asked for"),
    "all append int8 cache": (lambda: _all_append_call(kv=_I8), TypeError,
                              "writes no scales"),
    "all append more rows than the cache": (
        lambda: _all_append_call(B=9), ValueError, "shapes"),
    "all append position 256": (lambda: _all_append_call(position=256),
                                IndexError, "outside the cache"),
    "all append passes its checks": (lambda: _all_append_call(),
                                     AssertionError, "library was asked for"),
    "ragged_t bf16 rows into int8": (lambda: _ragged_t_call(kv=_I8, scales=True),
                                     TypeError, "int8 K/V"),
    "ragged_t int8 without scales": (
        lambda: _ragged_t_call(kv=_I8, new=_I8), ValueError, "f32 scales"),
    "ragged_t scales into bf16": (lambda: _ragged_t_call(scales=True),
                                  ValueError, "int8 cache only"),
    "ragged_t starts shape": (lambda: _ragged_t_call(n_starts=3), ValueError,
                              "starts"),
    "ragged_t layer 2": (lambda: _ragged_t_call(layer=2), IndexError,
                         "layer 2"),
    "ragged_t passes its checks": (lambda: _ragged_t_call(), AssertionError,
                                   "library was asked for"),
    "ragged_t int8 passes its checks": (
        lambda: _ragged_t_call(kv=_I8, new=_I8, scales=True), AssertionError,
        "library was asked for"),
    "fresh int8 cache": (lambda: _fresh_call(kv=_I8), TypeError,
                         "no int8 form"),
    "fresh G 9": (lambda: _fresh_call(Hq=18), ValueError, "G <= 8"),
    "fresh new rows": (lambda: _fresh_call(new_T=2), ValueError, "k_new"),
    "fresh lengths": (lambda: _fresh_call(n_lens=3), ValueError, "lengths"),
    "fresh passes its checks": (lambda: _fresh_call(), AssertionError,
                                "library was asked for"),
}


@pytest.mark.parametrize("case", sorted(FUSED_REFUSALS))
def test_fused_wrappers_refuse_before_any_build(monkeypatch, case):
    """fused_mlp, fused_attn_mlp, kv_append_uniform and the last four
    sites' wrappers (fused_attn_matmul, kv_append_all_uniform,
    kv_append_ragged_t, decode_attention_contiguous_fresh) refuse a wrong
    dtype, shape, group size, layer, row window or device before the
    library is built or a kernel launched (meta tensors stand in for the
    card); a call that passes every check asks for the library."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    fn, exc, match = FUSED_REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn()
