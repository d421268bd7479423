"""The profiling and debug hooks and the CLI's ``--chat`` / ``--stats`` /
``--profile``: the port against the JAX package on the CPU.

* ``utils/profiling.trace`` writes a Chrome trace of its block (host ops
  on the CPU) and is a no-op for ``None`` or ``""``; ``time_fn`` returns
  the JAX function's keys;
* ``utils/debug``: each hook returns its input, prints nothing while
  disabled, and once enabled prints the line the JAX hook prints for the
  same f32 input (a KV window past the end moved back inside, as
  ``dynamic_slice_in_dim`` moves it); an enabled hook raises under a CUDA
  graph capture (naming ``eager_steps()``), a disabled one does not;
* ``generate --chat`` wraps each prompt in the byte tokenizer's chat
  template (the JAX tokenizer's string), ``--stats`` prints the metrics
  snapshot with the JAX package's keys, ``--profile DIR`` writes a trace
  into DIR, on ``--device cpu``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen_inference_engine_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from qwen_inference_engine_tpu.utils import debug as jdebug
from qwen_inference_engine_tpu.utils import profiling as jprofiling
from qwen_inference_engine_tpu.utils.metrics import Metrics as JMetrics
from qwen_inference_engine_tpu_torch.server import cli
from qwen_inference_engine_tpu_torch.tokenizer import ByteTokenizer
from qwen_inference_engine_tpu_torch.utils import debug, profiling


@pytest.fixture
def hooks_on():
    """Both packages' hooks enabled for one test, disabled after it."""
    debug.enable(True)
    jdebug.enable(True)
    yield
    debug.enable(False)
    jdebug.enable(False)


# ------------------------------------------------------------- profiling

def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    out = tmp_path / "prof"
    a = torch.randn(64, 64)
    with profiling.trace(str(out)):
        (a @ a).sum()
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("trace_dir", [None, ""], ids=["none", "empty"])
def test_trace_is_a_no_op_without_a_directory(tmp_path, trace_dir):
    before = set(os.listdir(tmp_path))
    ran = []
    with profiling.trace(trace_dir):
        ran.append(1)
    assert ran == [1] and set(os.listdir(tmp_path)) == before


def test_time_fn_keys_match_jax():
    """The same keys and iteration count as the JAX function; each call
    ends in a host copy of the smallest output tensor."""
    x = torch.randn(32, 32)
    got = profiling.time_fn(lambda a: {"big": a @ a, "small": a[0, :1]}, x,
                            iters=5, warmup=1)
    want = jprofiling.time_fn(lambda a: a @ a, jnp.ones((8, 8)), iters=5,
                              warmup=1)
    assert set(got) == set(want) and got["iters"] == want["iters"] == 5
    assert 0 < got["min_s"] <= got["median_s"] and got["mean_s"] > 0


# ----------------------------------------------------------------- debug

def _input(kind):
    rng = np.random.default_rng(0)
    if kind == "kv":
        return rng.normal(size=(2, 2, 8, 6)).astype(np.float32)
    return rng.normal(size=(3, 7)).astype(np.float32)


# hook name, input kind, (package module -> call on an array)
HOOKS = {
    "activation": ("x", lambda m, a: m.dump_activation("act", a)),
    "top logits": ("x", lambda m, a: m.dump_top_logits("lg", a, k=3)),
    "kv rows": ("kv", lambda m, a: m.dump_kv_rows("kv", a, 1, 0, 2, 3)),
    "kv rows past the end": ("kv", lambda m, a: m.dump_kv_rows("kv", a, 0, 1,
                                                               7, 3)),
}


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_disabled_hooks_are_identity_no_ops(hook, capsys):
    kind, call = HOOKS[hook]
    x = torch.from_numpy(_input(kind))
    assert call(debug, x) is x
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_enabled_hooks_print_the_jax_line(hook, hooks_on, capsys):
    kind, call = HOOKS[hook]
    a = _input(kind)
    x = torch.from_numpy(a.copy())
    assert call(debug, x) is x
    got = capsys.readouterr().out
    call(jdebug, jnp.asarray(a))
    jax.effects_barrier()
    want = capsys.readouterr().out
    assert got == want and got.startswith(("act:", "lg:", "kv:"))


@pytest.mark.parametrize("on", [True, False], ids=["enabled", "disabled"])
def test_hooks_under_a_cuda_graph_capture(monkeypatch, capsys, on):
    """An enabled hook cannot print from a replayed graph: it raises,
    naming ``eager_steps()``; a disabled one passes its input through."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    debug.enable(on)
    try:
        x = torch.ones(4)
        if on:
            for call in (lambda: debug.dump_activation("a", x),
                         lambda: debug.dump_top_logits("l", x, k=2),
                         lambda: debug.dump_kv_rows("k", x.view(1, 1, 4, 1),
                                                    0, 0, 0, 1)):
                with pytest.raises(RuntimeError, match=r"eager_steps\(\)"):
                    call()
        else:
            assert debug.dump_activation("a", x) is x
    finally:
        debug.enable(False)
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------- CLI

GEN = ["generate", "--model", "tiny", "--device", "cpu", "--greedy",
       "--kv-bits", "32", "--max-new-tokens", "4", "--prompt", "hi"]


def _ids(out: str):
    lines = out.splitlines()
    return [json.loads(lines[i + 1]) for i, line in enumerate(lines)
            if line.startswith("--- sequence")]


def test_chat_template_is_the_jax_tokenizers():
    msgs = [{"role": "user", "content": "hi"}]
    assert (ByteTokenizer().apply_chat_template(msgs)
            == JByteTokenizer().apply_chat_template(msgs)
            == "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n")


def test_cli_generate_chat_wraps_the_prompt(capsys):
    """``--chat`` generates what the templated prompt text generates."""
    assert cli.main([*GEN, "--chat"]) == 0
    chat = _ids(capsys.readouterr().out)
    text = ByteTokenizer().apply_chat_template(
        [{"role": "user", "content": "hi"}])
    assert cli.main([*GEN[:-1], text]) == 0
    assert chat == _ids(capsys.readouterr().out) and len(chat[0]) == 4
    assert cli.main(GEN) == 0   # the bare prompt is another input
    assert len(_ids(capsys.readouterr().out)[0]) == 4


def test_cli_generate_stats_and_profile(tmp_path, capsys):
    """``--stats``: the last stderr line is the metrics snapshot, with the
    JAX package's keys and this run's request and tokens; ``--profile
    DIR``: one trace of the generation in DIR."""
    prof = tmp_path / "prof"
    assert cli.main([*GEN, "--stats", "--profile", str(prof)]) == 0
    err = capsys.readouterr().err.strip().splitlines()
    stats = json.loads(err[-1])
    assert set(stats) == set(JMetrics().snapshot())
    assert stats["requests"] == 1 and stats["ttft_p50_s"] > 0
    assert stats["decode_tokens"] == 3 and stats["prefill_tokens"] == 2
    files = os.listdir(prof)
    assert len(files) == 1
    with open(prof / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_cli_profile_flag_is_a_model_argument(capsys):
    """``--profile`` sits with the model arguments, as in the JAX CLI, so
    every subcommand parses it; without it generate writes no trace."""
    assert cli.main(GEN) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        cli.main(["serve", "--profile"])
    assert "expected one argument" in capsys.readouterr().err
