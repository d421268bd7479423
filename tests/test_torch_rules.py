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


def test_row0_windows_and_int8_weights_dispatch_before_any_plain_path(
        monkeypatch):
    """The dispatch decisions that do not need a card to be made: the four
    row0 wrappers (the pipeline's 1F1B microbatch window) take any window
    inside the cache and refuse one past it with ValueError before any
    plain path or launch, on the CPU as on the card (a meta tensor stands
    in for it); INT8 weights with bf16 activations reach their kernel's
    wrapper and never the plain path
    (test_cuda_dispatcher_names_the_missing_kernel has every (bits,
    act_bits) pair)."""
    q, kc = torch.zeros(1, 1, 2, 32), torch.zeros(1, 3, 1, 256, 32)
    k8 = torch.zeros(1, 3, 1, 256, 32, dtype=torch.int8)
    s8 = torch.zeros(1, 3, 1, 256)
    new8 = (k8[0, :1, :, :1], k8[0, :1, :, :1], s8[0, :1, :, :1],
            s8[0, :1, :, :1])
    for dev in ("cpu", "meta"):
        for row0 in (-1, 3):
            with pytest.raises(ValueError, match="outside the cache"):
                tda.decode_attention_contiguous(
                    q.to(dev), kc.to(dev), kc.to(dev), 0,
                    torch.ones(1, device=dev), row0=row0)
            with pytest.raises(ValueError, match="outside the cache"):
                tda.decode_attention_appending(
                    q.to(dev), kc.to(dev), kc.to(dev), kc[0, :1, :, :1].to(dev),
                    kc[0, :1, :, :1].to(dev), 0, 0, row0=row0)
            with pytest.raises(ValueError, match="outside the cache"):
                tda.decode_attention_contiguous_q8(
                    q.to(dev), k8.to(dev), k8.to(dev), s8.to(dev), s8.to(dev),
                    0, torch.ones(1, device=dev), row0=row0)
            with pytest.raises(ValueError, match="outside the cache"):
                tka.kv_append_uniform_q8(
                    k8.to(dev), k8.to(dev), s8.to(dev), s8.to(dev),
                    *(t.to(dev) for t in new8), 0, 0, row0=row0)
    out = tda.decode_attention_contiguous(q, kc, kc, 0, torch.ones(1),
                                          row0=2)
    assert out.shape == q.shape
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


def test_slot_scheduler_names_the_pp_scheduler_and_needs_a_draft_cfg():
    """The slot scheduler refuses a pipeline-parallel mesh, naming the
    engine that serves it (``PPFifoScheduler``, tests/test_torch_pp_*.py;
    TP and EP meshes serve, tests/test_torch_parallel_tp.py and
    tests/test_torch_ep_serving.py), on the CPU as on the card; a drafter's
    params need its config."""
    import types

    from qwen_inference_engine_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
    )

    cfg = tiny_config()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    kw = dict(max_slots=1, page_size=8, num_pages=8, max_pages_per_seq=4,
              device="cpu")
    with pytest.raises(NotImplementedError, match="PPFifoScheduler"):
        ContinuousBatchingEngine(cfg, params, **kw, mesh=types.SimpleNamespace(
            shape={"stage": 2}, size=2))
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


def _chunk_call(q8, q_shape, pool_shape=(2, 6, 2, 16, 128), tables=(1, 3),
                start=0, page=16, pool_dtype=None):
    """A paged chunk call on meta tensors: bf16 queries over a bf16 pool,
    or (q8) an int8 pool with its f32 scales."""
    kv = pool_dtype or (_I8 if q8 else _BF)
    pools = (_meta(*pool_shape, dtype=kv), _meta(*pool_shape, dtype=kv))
    q, t = _meta(*q_shape, dtype=_BF), _meta(*tables, dtype=torch.int32)
    if q8:
        return lambda: tca.paged_chunk_attention_q8(
            q, *pools, _meta(*pool_shape[:-1]), _meta(*pool_shape[:-1]), t, 0,
            start, page)
    return lambda: tca.paged_chunk_attention(q, *pools, t, 0, start, page)


PAGED_CHUNK_REFUSALS = {
    "bf16 G 9": (_chunk_call(False, (1, 16, 18, 128)), ValueError, "G <= 8"),
    "q8 G 9": (_chunk_call(True, (1, 16, 18, 128)), ValueError, "G <= 8"),
    "q8 D 96": (_chunk_call(True, (1, 16, 4, 96), (2, 6, 2, 16, 96)),
                ValueError, "D in"),
    "bf16 D 256": (_chunk_call(False, (1, 16, 4, 256), (2, 6, 2, 16, 256)),
                   ValueError, "D in"),
    "bf16 page 12": (_chunk_call(False, (1, 16, 4, 128), (2, 6, 2, 12, 128),
                                 page=12), ValueError, "multiple of 8"),
    "q8 T 0": (_chunk_call(True, (1, 0, 4, 128)), ValueError, "1..512"),
    "q8 start past the table": (_chunk_call(True, (1, 8, 4, 128), start=48),
                                IndexError, "outside the"),
    "bf16 f32 pool": (_chunk_call(False, (1, 8, 4, 128),
                                  pool_dtype=torch.float32), TypeError,
                      "bf16 or int8 pools"),
    "bf16 G 8 passes its checks": (_chunk_call(False, (1, 256, 16, 128)),
                                   AssertionError, "library was asked for"),
    "q8 G 8 D 64 passes its checks": (
        _chunk_call(True, (1, 256, 16, 64), (2, 6, 2, 16, 64)),
        AssertionError, "library was asked for"),
    "bf16 T 512 past the table's end passes": (
        _chunk_call(False, (1, 512, 4, 128), start=40), AssertionError,
        "library was asked for"),
}


@pytest.mark.parametrize("case", sorted(PAGED_CHUNK_REFUSALS))
def test_paged_chunk_wrappers_refuse_what_the_kernel_does_not_take(
        monkeypatch, case):
    """The paged chunk wrappers take what the tensor-core kernel takes
    (G <= 8, D in {64, 128}, pages of a multiple of 8 tokens, pieces of
    1..512 tokens that start inside the table, bf16 or int8 pools) and
    refuse the rest before the library is built (meta tensors stand in for
    the card); a G = 8 piece and a piece that runs past the table's end
    pass every check and ask for the library."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    fn, exc, match = PAGED_CHUNK_REFUSALS[case]
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
                      row0=4, K=256):
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    return tfs.fused_attn_matmul(
        _meta(4, dtype=torch.int32), layer, _meta(4, 1, 8, 128, dtype=_BF),
        cache, cache, _meta(8, K, dtype=_BF),
        _meta(2, K // 2, N, dtype=_I8), _meta(2, K // gs, N, dtype=s_dtype),
        group_size=gs, row0=row0)


def _all_append_call(kv=_BF, B=8, position=9):
    cache = _meta(2, 8, 2, 256, 128, dtype=kv)
    new = _meta(2, B, 1, 2, 128, dtype=_BF)
    return tka.kv_append_all_uniform(cache, cache, new, new, position)


def _meta_at(offset, *shape, dtype):
    """A contiguous meta tensor ``offset`` bytes into its storage (meta
    data pointers count from 0)."""
    el = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    return _meta(n + offset // el, dtype=dtype)[offset // el:].view(shape)


def _ragged_t_call(kv=_BF, new=_BF, scales=False, n_starts=4, layer=1,
                   D=128, T=5, k_offset=0, cache_offset=0):
    """kv_append_ragged_t on meta tensors: caches [2, 8, 2, 256, D], rows
    [4, T, 2, D]; ``k_offset`` / ``cache_offset`` bytes into their
    storage."""
    cache = _meta_at(cache_offset, 2, 8, 2, 256, D, dtype=kv)
    rows = _meta_at(k_offset, 4, T, 2, D, dtype=new)
    kw = {}
    if scales:
        kw = dict(k_scale=_meta(2, 8, 2, 256), v_scale=_meta(2, 8, 2, 256),
                  ks_new=_meta(4, T, 2), vs_new=_meta(4, T, 2))
    return tka.kv_append_ragged_t(cache, _meta(2, 8, 2, 256, D, dtype=kv),
                                  rows, _meta(4, T, 2, D, dtype=new),
                                  _meta(n_starts, dtype=torch.int32), layer,
                                  **kw)


def _q8_append_call(B=4, layer=1, position=9, new=_I8, ks_dtype=torch.float32,
                    row0=0, k_offset=0, cache_offset=0):
    """kv_append_uniform_q8 on meta tensors: int8 caches [2, 8, 2, 256,
    128] with their scales, rows [B, 1, 2, 128]; ``k_offset`` /
    ``cache_offset`` bytes into their storage."""
    cache = _meta_at(cache_offset, 2, 8, 2, 256, 128, dtype=_I8)
    scales = _meta(2, 8, 2, 256)
    rows = _meta_at(k_offset, B, 1, 2, 128, dtype=new)
    ksn = _meta(B, 1, 2, dtype=ks_dtype)
    return tka.kv_append_uniform_q8(
        cache, _meta(2, 8, 2, 256, 128, dtype=_I8), scales, scales, rows,
        _meta(B, 1, 2, 128, dtype=new), ksn, ksn, position, layer, row0=row0)


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
    "ragged_t f32 passes its checks": (
        lambda: _ragged_t_call(kv=torch.float32, new=torch.float32),
        AssertionError, "library was asked for"),
    "ragged_t int8 rows of 6 bytes": (
        lambda: _ragged_t_call(kv=_I8, new=_I8, scales=True, D=6),
        ValueError, "does not cover"),
    "ragged_t cache 2 bytes off": (lambda: _ragged_t_call(cache_offset=2),
                                   ValueError, "4-byte aligned"),
    "ragged_t int8 cache 1 byte off": (
        lambda: _ragged_t_call(kv=_I8, new=_I8, scales=True, cache_offset=1),
        ValueError, "4-byte aligned"),
    "ragged_t rows 4 bytes off pass their checks": (
        lambda: _ragged_t_call(T=17, k_offset=4), AssertionError,
        "library was asked for"),
    "ragged_t int8 rows 1 byte off are copied and pass their checks": (
        lambda: _ragged_t_call(kv=_I8, new=_I8, scales=True, T=1,
                               k_offset=1), AssertionError,
        "library was asked for"),
    "q8 append bf16 rows": (lambda: _q8_append_call(new=_BF), TypeError,
                            "int8 K/V"),
    "q8 append f16 scales": (
        lambda: _q8_append_call(ks_dtype=torch.float16), TypeError,
        "f32 new scales"),
    "q8 append more rows than the cache": (lambda: _q8_append_call(B=9),
                                           ValueError, "shapes"),
    "q8 append layer 2": (lambda: _q8_append_call(layer=2), IndexError,
                          "layer 2"),
    "q8 append position 256": (lambda: _q8_append_call(position=256),
                               IndexError, "outside the cache"),
    "q8 append row0 4": (lambda: _q8_append_call(row0=4), AssertionError,
                         "library was asked for"),
    "q8 append row0 5": (lambda: _q8_append_call(row0=5), ValueError,
                         "outside the cache"),
    "q8 append cache 1 byte off": (lambda: _q8_append_call(cache_offset=1),
                                   ValueError, "4-byte aligned"),
    "q8 append passes its checks": (lambda: _q8_append_call(),
                                    AssertionError, "library was asked for"),
    "q8 append every row passes its checks": (
        lambda: _q8_append_call(B=8), AssertionError,
        "library was asked for"),
    "q8 append rows 1 byte off are copied and pass their checks": (
        lambda: _q8_append_call(k_offset=1), AssertionError,
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
    """fused_mlp, fused_attn_mlp, kv_append_uniform, kv_append_uniform_q8
    and the last four sites' wrappers (fused_attn_matmul,
    kv_append_all_uniform, kv_append_ragged_t,
    decode_attention_contiguous_fresh) refuse a wrong dtype, shape, group
    size, layer, row window, device or a contiguous cache that is not
    4-byte aligned (or a head row the row kernel's plan cannot cover)
    before the library is built or a kernel launched (meta tensors stand
    in for the card); a call that passes every check asks for the library
    (new rows a few bytes off are copied first)."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    fn, exc, match = FUSED_REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn()


def _q8_decode_call(B=4, S=256):
    cache = _meta(2, 8, 2, S, 128, dtype=_I8)
    scales = _meta(2, 8, 2, S)
    return tda.decode_attention_contiguous_q8(
        _meta(B, 1, 14, 128, dtype=_BF), cache, cache, scales, scales, 1,
        _meta(B, dtype=torch.int32))


def _bf16_decode_call(kind="appending", B=4, S=256, offset=0):
    """A bf16 split decode call on meta tensors (Hk 2, G 7, D 128); k_new
    ``offset`` elements into its storage (2 bytes each)."""
    cache = _meta(2, max(8, B), 2, S, 128, dtype=_BF)
    n = B * 2 * 128
    new = _meta(n + offset, dtype=_BF)[offset:].view(B, 1, 2, 128)
    q = _meta(B, 1, 14, 128, dtype=_BF)
    if kind == "appending":
        return tda.decode_attention_appending(q, cache, cache, new, new, 1,
                                              _meta(1, dtype=torch.int32))
    return tda.decode_attention_contiguous_fresh(
        q, cache, cache, new, new, 1, _meta(B, dtype=torch.int32))


def _paged_append_call(kind="ragged", T=1, quant=False, k_offset=0,
                       pool_offset=0):
    """A paged append on meta tensors (pools [2, 6, 2, 16, 128], Hk 2, D
    128, B 2 or the prefill's 1 row): ``k_offset`` / ``pool_offset`` bytes
    into their storage (meta data pointers count from 0)."""
    kv = _I8 if quant else _BF
    pools = (_meta_at(pool_offset, 2, 6, 2, 16, 128, dtype=kv),
             _meta(2, 6, 2, 16, 128, dtype=kv))
    B = 1 if kind == "prefill" else 2
    kn, vn = (_meta_at(k_offset, B, T, 2, 128, dtype=kv),
              _meta(B, T, 2, 128, dtype=kv))
    kw = {}
    if quant:
        kw = dict(k_scale=_meta(2, 6, 2, 16), v_scale=_meta(2, 6, 2, 16),
                  ks_new=_meta(B, T, 2), vs_new=_meta(B, T, 2))
    tables = _meta(B, 3, dtype=torch.int32)
    if kind == "prefill":
        return lambda: tka.paged_append_prefill(*pools, kn, vn, 5, tables,
                                                1, page_size=16, **kw)
    fn = tka.paged_append_ragged if kind == "ragged" \
        else tka.paged_append_ragged_t
    return lambda: fn(*pools, kn, vn, _meta(B, dtype=torch.int32), tables, 1,
                      page_size=16, **kw)


def _plan(fn):
    """fn with its K/2 and F/2 row counts of _fused_attn_call's MLP (K 256,
    F 512): the two plans it returns."""
    return lambda M, K, F, gs_gate, gs_down: fn(K // 2, F // 2)


# (patched name, its stand-in, call, exception, message)
PLAN_REFUSALS = {
    "attn mlp mt 0": ("fs.plan_fused_mlp",
                      _plan(lambda kh, fh: ((0, 1, kh), (4, 1, fh))),
                      lambda: _fused_attn_call(), ValueError, "mt 1 or 4"),
    "attn mlp gate / up slices short": (
        "fs.plan_fused_mlp", _plan(lambda kh, fh: ((4, 1, kh - 32),
                                                    (4, 1, fh))),
        lambda: _fused_attn_call(), ValueError, "does not cover"),
    "attn mlp down slices past the rows": (
        "fs.plan_fused_mlp", _plan(lambda kh, fh: ((4, 1, kh),
                                                    (4, 3, fh // 2))),
        lambda: _fused_attn_call(), ValueError, "does not cover"),
    "attn mlp slice of 48": (
        "fs.plan_fused_mlp", _plan(lambda kh, fh: ((1, 3, 48), (4, 1, fh))),
        lambda: _fused_attn_call(), ValueError, "does not cover"),
    "attn mlp workspace too small": (
        "fs._fused_mlp_workspace",
        lambda M, K, F, plans, device: torch.empty(
            2 * M * F, dtype=torch.uint8, device=device),
        lambda: _fused_attn_call(), ValueError, "workspace"),
    "attn mlp split plan passes its checks": (
        "fs.plan_fused_mlp", _plan(lambda kh, fh: ((1, 2, kh // 2),
                                                    (4, 2, fh // 2))),
        lambda: _fused_attn_call(), AssertionError, "library was asked for"),
    "q8 span 96": ("tda.plan_decode_split", lambda B, Hk, S: (96, 3),
                   lambda: _q8_decode_call(), ValueError, "multiple of 64"),
    "q8 splits short of S": ("tda.plan_decode_split",
                             lambda B, Hk, S: (64, 3),
                             lambda: _q8_decode_call(), ValueError,
                             "covering S"),
    "q8 a split past S": ("tda.plan_decode_split", lambda B, Hk, S: (64, 5),
                          lambda: _q8_decode_call(), ValueError,
                          "covering S"),
    "q8 one split passes its checks": (
        "tda.plan_decode_split", lambda B, Hk, S: (256, 1),
        lambda: _q8_decode_call(), AssertionError, "library was asked for"),
    "q8 planned split passes its checks": (
        None, None, lambda: _q8_decode_call(B=1, S=1024), AssertionError,
        "library was asked for"),
    "q8 workspace unaligned": (
        "tda.decode_workspace",
        lambda splits, B, Hq, D, device: torch.empty(
            splits * B * Hq * (D + 1) + 1, device=device)[1:],
        lambda: _q8_decode_call(), ValueError, "16-byte aligned"),
    "appending span 96": ("tda.plan_decode_split", lambda B, Hk, S: (96, 3),
                          lambda: _bf16_decode_call(), ValueError,
                          "multiple of 64"),
    "appending splits short of S": (
        "tda.plan_decode_split", lambda B, Hk, S: (64, 3),
        lambda: _bf16_decode_call(), ValueError, "covering S"),
    "fresh a split past S": ("tda.plan_decode_split",
                             lambda B, Hk, S: (128, 3),
                             lambda: _bf16_decode_call("fresh"), ValueError,
                             "covering S"),
    "fresh span 0": ("tda.plan_decode_split", lambda B, Hk, S: (0, 1),
                     lambda: _bf16_decode_call("fresh"), ValueError,
                     "multiple of 64"),
    "appending workspace unaligned": (
        "tda.decode_workspace",
        lambda splits, B, Hq, D, device: torch.empty(
            splits * B * Hq * (D + 1) + 1, device=device)[1:],
        lambda: _bf16_decode_call(), ValueError, "16-byte aligned"),
    "fresh workspace too small": (
        "tda.decode_workspace",
        lambda splits, B, Hq, D, device: torch.empty(
            splits * B * Hq * D, device=device),
        lambda: _bf16_decode_call("fresh"), ValueError, "workspace"),
    "fresh workspace in bf16": (
        "tda.decode_workspace",
        lambda splits, B, Hq, D, device: torch.empty(
            2 * splits * B * Hq * (D + 1), dtype=_BF, device=device),
        lambda: _bf16_decode_call("fresh"), ValueError, "workspace"),
    "appending k_new unaligned": (
        None, None, lambda: _bf16_decode_call(offset=1), ValueError,
        "16-byte aligned"),
    "fresh k_new unaligned": (
        None, None, lambda: _bf16_decode_call("fresh", offset=4), ValueError,
        "16-byte aligned"),
    "appending k_new aligned at an offset passes its checks": (
        None, None, lambda: _bf16_decode_call(offset=8), AssertionError,
        "library was asked for"),
    "appending planned split passes its checks": (
        None, None, lambda: _bf16_decode_call(), AssertionError,
        "library was asked for"),
    "fresh planned split passes its checks": (
        None, None, lambda: _bf16_decode_call("fresh", B=1, S=1024),
        AssertionError, "library was asked for"),
    "appending one split asks for no workspace": (
        "tda.decode_workspace", None,
        lambda: _bf16_decode_call(B=192, S=512), AssertionError,
        "library was asked for"),
    # the paged appends (_paged_append_call: 2 x T head rows of 256 bytes,
    # or 128 int8; plan_paged_append's (vec, threads, blocks))
    "paged append vec 8": ("tka.plan_paged_append",
                           lambda B, T, Hk, D, e, a: (8, 128, 1),
                           _paged_append_call(), ValueError,
                           "does not cover"),
    "paged append blocks of 256": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 256, 1),
        _paged_append_call(), ValueError, "does not cover"),
    "paged append blocks short": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (4, 128, 2),
        _paged_append_call("ragged_t", T=5), ValueError, "does not cover"),
    "paged append a block past the vectors": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 128, 3),
        _paged_append_call("prefill", T=8), ValueError, "does not cover"),
    "paged append 16-byte vectors of rows 4 bytes off": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 128, 1),
        _paged_append_call(k_offset=4), ValueError, "16-byte aligned"),
    "paged append pool 2 bytes off": (
        None, None, _paged_append_call(pool_offset=2), ValueError,
        "4-byte aligned"),
    "paged append int8 pool 1 byte off": (
        None, None, _paged_append_call("ragged_t", T=5, quant=True,
                                       pool_offset=1), ValueError,
        "4-byte aligned"),
    "paged append rows 4 bytes off pass their checks": (
        None, None, _paged_append_call("ragged_t", T=17, k_offset=4),
        AssertionError, "library was asked for"),
    "paged append rows 2 bytes off are copied and pass their checks": (
        None, None, _paged_append_call(k_offset=2), AssertionError,
        "library was asked for"),
    "paged append int8 prefill passes its checks": (
        None, None, _paged_append_call("prefill", T=40, quant=True),
        AssertionError, "library was asked for"),
    # the contiguous row appends (_ragged_t_call: 4 x 5 x 2 head rows of
    # 256 bytes; _q8_append_call: 4 x 2 of 128 bytes), the same plan
    "ragged_t vec 8": ("tka.plan_paged_append",
                       lambda B, T, Hk, D, e, a: (8, 128, 7),
                       lambda: _ragged_t_call(), ValueError,
                       "does not cover"),
    "ragged_t blocks short": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 128, 4),
        lambda: _ragged_t_call(), ValueError, "does not cover"),
    "ragged_t 16-byte vectors of rows 4 bytes off": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 128, 5),
        lambda: _ragged_t_call(k_offset=4), ValueError, "16-byte aligned"),
    "q8 append blocks of 256": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 256, 1),
        lambda: _q8_append_call(), ValueError, "does not cover"),
    "q8 append a block past the vectors": (
        "tka.plan_paged_append", lambda B, T, Hk, D, e, a: (16, 128, 2),
        lambda: _q8_append_call(), ValueError, "does not cover"),
    # fused_attn_matmul (_attn_matmul_call: M 8, K 256, N 512, gs 64, its
    # own plan one slice of the 128 packed rows; at K 2048, gs 128 four
    # slices of 256)
    "attn matmul mt 0": ("fs.plan_fused_attn_matmul",
                         lambda M, K, N, gs: (0, 1, K // 2),
                         lambda: _attn_matmul_call(), ValueError,
                         "mt 1 or 4"),
    "attn matmul slices short": ("fs.plan_fused_attn_matmul",
                                 lambda M, K, N, gs: (4, 1, K // 2 - 32),
                                 lambda: _attn_matmul_call(), ValueError,
                                 "does not cover"),
    "attn matmul a slice past the rows": (
        "fs.plan_fused_attn_matmul", lambda M, K, N, gs: (1, 3, K // 4),
        lambda: _attn_matmul_call(), ValueError, "does not cover"),
    "attn matmul slice of 48": ("fs.plan_fused_attn_matmul",
                                lambda M, K, N, gs: (1, 3, 48),
                                lambda: _attn_matmul_call(), ValueError,
                                "does not cover"),
    "attn matmul split plan without a workspace": (
        "fs._workspace", lambda splits, M, N, device, dtype: None,
        lambda: _attn_matmul_call(K=2048, gs=128), ValueError,
        "workspace"),
    "attn matmul workspace too small": (
        "fs._workspace", lambda splits, M, N, device, dtype: torch.empty(
            (splits, M, N - 4), dtype=dtype, device=device),
        lambda: _attn_matmul_call(K=2048, gs=128), ValueError,
        "workspace"),
    "attn matmul workspace in bf16": (
        "fs._workspace", lambda splits, M, N, device, dtype: torch.empty(
            (2 * splits, M, N), dtype=_BF, device=device),
        lambda: _attn_matmul_call(K=2048, gs=128), ValueError,
        "workspace"),
    "attn matmul split plan passes its checks": (
        "fs.plan_fused_attn_matmul", lambda M, K, N, gs: (1, 2, K // 4),
        lambda: _attn_matmul_call(), AssertionError,
        "library was asked for"),
    "attn matmul planned split passes its checks": (
        None, None, lambda: _attn_matmul_call(K=2048, gs=128),
        AssertionError, "library was asked for"),
}


@pytest.mark.parametrize("case", sorted(PLAN_REFUSALS))
def test_split_plans_and_workspaces_refused_before_any_build(monkeypatch,
                                                             case):
    """The C guards' rules for the plans the two split kernels take, held
    by the wrappers before the library is built (meta tensors stand in for
    the card): fused_attn_mlp's gate / up pass and fused_attn_matmul's
    matmul only at mt 1 or 4 (their blocks run beside the attention
    blocks), each pass's slices covering its packed rows once, a workspace
    as large as the plans need (fused_attn_matmul: f32, at more than one
    slice); the
    three split decodes' (q8, appending, fresh) spans a multiple of 64
    keys, their splits covering S once, an f32 workspace as large as the
    plan needs, their operands 16-byte aligned; a bf16 decode of one split
    (B 192 x Hk 2) takes no workspace; the row appends' (paged, and the
    contiguous kv_append_ragged_t and kv_append_uniform_q8) vectors of 4
    or 16 bytes dividing every data pointer (new rows a few bytes off are
    copied; pools and caches are not), 128-thread blocks covering the
    vectors once.  A plan that passes asks for the library."""
    from qwen_inference_engine_tpu_torch.ops import cuda_lib
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    def no_build():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(cuda_lib, "library", no_build)
    target, stand_in, fn, exc, match = PLAN_REFUSALS[case]
    if target is not None:
        mod, name = target.split(".")
        monkeypatch.setattr({"fs": tfs, "tda": tda, "tka": tka}[mod], name,
                            stand_in)
    with pytest.raises(exc, match=match):
        fn()


# projections fused_attn_matmul may carry beside the attention: (K, N, gs)
ATTN_MM_PLAN_SHAPES = {"7b gate": (3584, 18944, 128),
                       "7b down": (18944, 3584, 128),
                       "14b gate": (5120, 13824, 128),
                       "14b down": (13824, 5120, 128),
                       "probe": (3584, 18944, 256)}


@pytest.mark.parametrize("shape", sorted(ATTN_MM_PLAN_SHAPES))
def test_fused_attn_matmul_plans_the_dense_matmul_up_to_64_rows(shape):
    """At every Mb of 1..64 fused_attn_matmul's plan is quant_matmul4's
    (the same body, plan and reduce give y quant_matmul4's bits), at mt 1
    or 4 (the decode stream's tiles run beside the attention blocks at 128
    threads), and passes the C guard's rules with the workspace the
    wrapper makes; the probe's 56 rows take 4 slices of 512 packed rows."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    K, N, gs = ATTN_MM_PLAN_SHAPES[shape]
    for M in range(1, 65):
        plan = tfs.plan_fused_attn_matmul(M, K, N, gs)
        assert plan == tqmm.plan_quant_matmul4(M, K, N, gs), M
        assert plan[0] == (1 if M <= 16 else 4), M
        ws = tqmm._workspace(plan[1], M, N, "meta", torch.float32)
        tfs._check_attn_matmul_plan("t", plan, ws, M, K, N)
    if shape == "probe":
        assert tfs.plan_fused_attn_matmul(56, K, N, gs) == (4, 4, 512)


@pytest.mark.parametrize("M", [65, 96, 192, 256])
@pytest.mark.parametrize("shape", sorted(ATTN_MM_PLAN_SHAPES))
def test_fused_attn_matmul_plans_64_row_tiles_above_64_rows(shape, M):
    """Above 64 rows the dense matmul takes 128-row tiles of 256 threads;
    fused_attn_matmul's matmul blocks stay at the attention blocks' 128
    (mt 4, 64-row tiles) over all of K, as fused_mlp's gate / up pass:
    one slice, no workspace, and the C guard's rules hold."""
    from qwen_inference_engine_tpu_torch.ops import fused_step as tfs

    K, N, gs = ATTN_MM_PLAN_SHAPES[shape]
    assert tqmm.plan_quant_matmul4(M, K, N, gs)[0] == 0
    plan = tfs.plan_fused_attn_matmul(M, K, N, gs)
    assert plan == (4, 1, K // 2)
    assert plan[:2] == tfs.plan_fused_mlp(M, K, 2 * 256, 128, 128)[0][:2]
    tfs._check_attn_matmul_plan("t", plan, None, M, K, N)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "4 off"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("elem", [2, 1, 4], ids=["bf16", "int8", "f32"])
def test_plan_paged_append_vector_widths(elem, D, aligned):
    """16-byte vectors where every data pointer is 16-byte aligned (the head
    rows of 64-512 bytes always allow them), else 4-byte words: 16 vectors
    a bf16 head row of D 128, 8 for int8 D 128 or bf16 D 64, 4 for int8 D
    64, 32 and 16 for the contiguous cache's f32 rows of D 128 and 64;
    four times as many words."""
    vec, threads, blocks = tka.plan_paged_append(8, 5, 4, D, elem, aligned)
    assert vec == (16 if aligned else 4)
    assert threads == tka.PAGED_APPEND_THREADS == 128
    assert D * elem // vec == {(2, 128): 16, (1, 128): 8, (2, 64): 8,
                               (1, 64): 4, (4, 128): 32,
                               (4, 64): 16}[elem, D] * (16 // vec)
    tka.check_paged_append_plan("plan", (vec, threads, blocks), 8 * 5 * 4,
                                D * elem, 4096 if aligned else 4100)


@pytest.mark.parametrize("B,T,Hk", [(1, 1, 1), (2, 1, 2), (8, 1, 4),
                                    (8, 5, 4), (8, 17, 4), (1, 256, 4),
                                    (1, 512, 8), (64, 9, 8), (3, 7, 5),
                                    (4, 1, 4), (4, 5, 4), (4, 17, 4)])
@pytest.mark.parametrize("elem,D,aligned", [(2, 128, True), (1, 64, True),
                                            (2, 64, False), (1, 128, False),
                                            (4, 128, True), (4, 64, False)])
def test_plan_paged_append_covers_every_vector_once(B, T, Hk, elem, D,
                                                    aligned):
    """One thread a vector: the blocks' threads cover the B * T * Hk * W
    vectors, and the last block holds at least one (the C guard's rule)."""
    plan = tka.plan_paged_append(B, T, Hk, D, elem, aligned)
    vec, threads, blocks = plan
    total = B * T * Hk * (D * elem // vec)
    assert (blocks - 1) * threads < total <= blocks * threads
    tka.check_paged_append_plan("plan", plan, B * T * Hk, D * elem,
                                0 if aligned else 4)


# the main paths at Qwen2.5-7B widths (Hk 4, D 128): serving's decode of
# 8 slots, its verify window of 5 (and 17), a 256-token prefill piece;
# Engine.generate's ragged decode and contiguous verify at B 4 (T 1, 5,
# 17; T 1 int8 is also the INT8 uniform append's one block); blocks of
# 128 threads, bf16 / int8 rows
SERVING_APPEND_BLOCKS = {"decode": ((8, 1), 4, 2),
                         "verify T 5": ((8, 5), 20, 10),
                         "verify T 17": ((8, 17), 68, 34),
                         "prefill piece": ((1, 256), 128, 64),
                         "contiguous decode B 4": ((4, 1), 2, 1),
                         "contiguous verify B 4 T 5": ((4, 5), 10, 5),
                         "contiguous verify B 4 T 17": ((4, 17), 34, 17)}


@pytest.mark.parametrize("shape", sorted(SERVING_APPEND_BLOCKS))
def test_plan_paged_append_at_the_serving_shapes(shape):
    (B, T), bf16_blocks, int8_blocks = SERVING_APPEND_BLOCKS[shape]
    assert tka.plan_paged_append(B, T, 4, 128, 2, True) == (16, 128,
                                                            bf16_blocks)
    assert tka.plan_paged_append(B, T, 4, 128, 1, True) == (16, 128,
                                                            int8_blocks)
    assert tka.plan_paged_append(B, T, 4, 128, 2, False) == (
        4, 128, 4 * bf16_blocks)
    # the contiguous cache's f32 rows: twice the bf16 vectors
    assert tka.plan_paged_append(B, T, 4, 128, 4, True) == (
        16, 128, 2 * bf16_blocks)


# the bodies a captured decode step runs (engine/step_graph.py): nothing in
# them may read back from the device or copy host data to it
STEP_BODIES = [
    ("engine/engine.py", "Engine._decode_body"),
    ("engine/scheduler.py", "ContinuousBatchingEngine._tick_body"),
    ("engine/scheduler.py", "ContinuousBatchingEngine._decode_tick"),
    ("models/qwen.py", "decode_step"),
    ("models/qwen.py", "decode_step_pumped"),
    ("models/qwen.py", "forward_hidden"),
    ("models/qwen.py", "moe_mlp"),
    ("models/qwen.py", "_expert_matmul"),
    ("models/qwen.py", "_paged_attention"),
    ("models/qwen.py", "_append_rows"),
    ("models/qwen.py", "compute_logits"),
    ("ops/sampling.py", "sample"),
    ("ops/sampling.py", "sample_rows"),
    ("ops/sampling.py", "apply_repetition_penalty"),
    ("ops/sampling.py", "_mask_top_p"),
    ("ops/sampling.py", "_categorical"),
    ("ops/sampling.py", "_divide_by_temperature"),
    ("ops/sampling.py", "update_seen_mask"),
]


def _function(path: str, qualname: str):
    import ast

    with open(os.path.join(ROOT, "qwen_inference_engine_tpu_torch",
                           path)) as f:
        tree = ast.parse(f.read())
    *outer, name = qualname.split(".")
    scope = tree.body
    for cls in outer:
        scope = next(n for n in scope
                     if isinstance(n, ast.ClassDef) and n.name == cls).body
    return next(n for n in scope
                if isinstance(n, ast.FunctionDef) and n.name == name)


@pytest.mark.parametrize("path,qualname", STEP_BODIES,
                         ids=[q for _, q in STEP_BODIES])
def test_step_bodies_hold_no_host_round_trip(path, qualname):
    """No ``.item()``, ``.cpu()``, ``.tolist()``, ``torch.tensor(`` or
    ``torch.as_tensor(`` in a step body (nested functions included)."""
    import ast

    bad = []
    for node in ast.walk(_function(path, qualname)):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        attr, owner = node.func.attr, node.func.value
        if attr in ("item", "cpu", "tolist") or (
                attr in ("tensor", "as_tensor")
                and isinstance(owner, ast.Name) and owner.id == "torch"):
            bad.append(f"{attr} at line {node.lineno}")
    assert not bad, (qualname, bad)
