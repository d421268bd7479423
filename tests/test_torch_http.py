"""The port's HTTP server over its ContinuousBatchingEngine, on the CPU.

Mirrors tests/test_http.py (without its EP and PP mesh tests) with the
byte tokenizer: /generate (sync and SSE), /stats, /health, the
OpenAI-style /v1/completions and /v1/chat/completions (streamed, with stop
strings), /v1/models, bad requests and the streaming detokenizer.  The
model is the tiny Qwen2 W4A8 with a byte vocabulary (260 ids, so every
generated id decodes to text or a special), params built in JAX and
carried over; the JAX package's server answers the same greedy requests
with the same token ids.
"""

import http.client
import json
import threading
import types
from http.server import ThreadingHTTPServer

import pytest
import torch

from qwen_inference_engine_tpu.server import http as jhttp
from qwen_inference_engine_tpu.tokenizer import ByteTokenizer as JByteTokenizer
from qwen_inference_engine_tpu.tokenizer import StreamDecoder as JStreamDecoder
from qwen_inference_engine_tpu_torch.server.http import Server, _make_handler
from qwen_inference_engine_tpu_torch.tokenizer import (
    ByteTokenizer,
    StreamDecoder,
)
from tests.test_torch_model import _build

VOCAB = 260   # the byte tokenizer's: 4 specials + 256 bytes


def _args(**kw):
    base = dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
                greedy=True, max_slots=2, page_size=8, num_pages=64,
                max_seq=64, kv_bits=32, seed=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _start(server, handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


@pytest.fixture(scope="module")
def models():
    return _build(False, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def http_server(models):
    _, _, tcfg, tparams = models
    server = Server(tcfg, tparams, ByteTokenizer(), None, _args(device="cpu"))
    httpd, t = _start(server, _make_handler)
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    t.join(timeout=10)
    assert not t.is_alive() and not server._thread.is_alive()


def _post_path(port, path, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn.getresponse()


def _post(port, body, timeout=120):
    return _post_path(port, "/generate", body, timeout)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _events(r):
    """The raw SSE events of a response, read byte by byte."""
    events, buf = [], b""
    while True:
        chunk = r.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            raw, buf = buf.split(b"\n\n", 1)
            events.append(raw.decode())
    return events


def test_generate_and_stats(http_server):
    port = http_server
    r = _post(port, {"prompt": [5, 9, 17], "max_new_tokens": 6})
    assert r.status == 200
    out = json.loads(r.read())
    assert 1 <= len(out["token_ids"]) <= 6
    assert out["finish_reason"] in ("eos", "length")
    assert out["text"] == ByteTokenizer().decode(out["token_ids"])

    status, snap = _get(port, "/stats")
    assert status == 200 and snap["requests"] >= 1
    assert snap["decode_tokens_per_s"] > 0 or snap["decode_tokens"] == 0
    for key in ("ttft_p50_s", "ttft_p99_s", "prefill_tokens",
                "prefix_hit_tokens", "spec_rounds", "spec_tokens_per_forward"):
        assert key in snap
    assert _get(port, "/health") == (200, {"status": "ok"})


def test_generate_streaming_sse(http_server):
    r = _post(http_server, {"prompt": [7, 8, 9], "max_new_tokens": 5,
                            "stream": True})
    assert r.status == 200
    assert r.getheader("Content-Type") == "text/event-stream"
    events = _events(r)
    assert events and all(e.startswith("data: ") for e in events)
    events = [json.loads(e[6:]) for e in events]
    final = events[-1]
    assert final["finish_reason"] in ("eos", "length")
    streamed = [e["token_id"] for e in events[:-1]]
    assert streamed == final["token_ids"][: len(streamed)]
    assert len(streamed) >= 1


def test_bad_requests(http_server):
    port = http_server
    assert _post(port, {}).status == 400
    assert _post(port, {"prompt": 42}).status == 400
    assert _post(port, {"prompt": ""}).status == 400
    assert _post(port, {"prompt": [5], "top_k": True}).status == 400
    assert _post(port, {"prompt": [5], "top_k": 10 ** 6}).status == 400
    assert _post(port, {"prompt": [5], "greedy": 1}).status == 400
    assert _post(port, {"prompt": [5], "stop_token_ids": "x"}).status == 400
    assert _post_path(port, "/nowhere", {"prompt": [5]}).status == 404
    assert _get(port, "/nowhere")[0] == 404


def test_v1_completions(http_server):
    port = http_server
    body = {"prompt": [5, 9, 17], "max_tokens": 6, "temperature": 0}
    r = _post_path(port, "/v1/completions", body)
    assert r.status == 200
    out = json.loads(r.read())
    assert out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    assert isinstance(out["choices"][0]["text"], str)
    assert out["usage"]["prompt_tokens"] == 3
    assert 1 <= out["usage"]["completion_tokens"] <= 6
    # temperature 0 is greedy (OpenAI semantics): deterministic
    again = json.loads(_post_path(port, "/v1/completions", body).read())
    assert again["choices"][0]["text"] == out["choices"][0]["text"]


def test_v1_chat_completions_and_models(http_server, models):
    port = http_server
    r = _post_path(port, "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "abc"}],
                    "max_tokens": 5, "temperature": 0})
    assert r.status == 200
    out = json.loads(r.read())
    assert out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    chat = ByteTokenizer().apply_chat_template(
        [{"role": "user", "content": "abc"}])
    assert out["usage"]["prompt_tokens"] == len(ByteTokenizer().encode(chat))

    status, listing = _get(port, "/v1/models")
    assert status == 200 and listing["data"][0]["id"] == models[2].name
    assert _post_path(port, "/v1/chat/completions", {}).status == 400
    assert _post_path(port, "/v1/completions",
                      {"prompt": [1], "n": 2}).status == 400
    assert _post_path(port, "/v1/completions",
                      {"prompt": [1], "stop": [3]}).status == 400


def test_v1_completions_stream_and_stop(http_server):
    conn = http.client.HTTPConnection("127.0.0.1", http_server, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": [5, 9, 17], "max_tokens": 8,
                             "temperature": 0, "stream": True}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    assert "text/event-stream" in r.getheader("Content-Type", "")
    events = _events(r)
    assert events[-1] == "data: [DONE]"
    payloads = [json.loads(e[6:]) for e in events[:-1]]
    assert all(p["object"] == "text_completion" for p in payloads)
    assert payloads[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    text = "".join(p["choices"][0]["text"] or "" for p in payloads)
    whole = json.loads(_post_path(
        http_server, "/v1/completions",
        {"prompt": [5, 9, 17], "max_tokens": 8, "temperature": 0}).read())
    assert text == whole["choices"][0]["text"]


def test_stream_decoder_multibyte_utf8():
    """Byte tokens of one character span pushes: no U+FFFD mid stream, and
    the deltas equal the JAX package's decoder's."""
    tok = ByteTokenizer()
    text = "héllo 世界 🙂"
    ids = tok.encode(text)
    dec, jdec = StreamDecoder(tok), JStreamDecoder(JByteTokenizer())
    deltas = [dec.push(i) for i in ids]
    assert deltas == [jdec.push(i) for i in ids]
    assert "".join(deltas) + dec.flush() == text
    naive = "".join(tok.decode([i]) for i in ids)
    assert "�" in naive and naive != text


def test_stream_decoder_long_stream_window_reset_lossless():
    tok = ByteTokenizer()
    text = "word aé 世🙂 " * 200
    ids = tok.encode(text)
    assert len(ids) > 3 * StreamDecoder._WINDOW
    dec = StreamDecoder(tok)
    assert "".join(dec.push(i) for i in ids) + dec.flush() == text
    assert dec._start > 0   # the window restarted


def _plain_text(port, max_tokens):
    r = _post_path(port, "/v1/completions",
                   {"prompt": [5, 9, 17], "max_tokens": max_tokens,
                    "temperature": 0})
    return json.loads(r.read())["choices"][0]["text"]


def _needle(text, start, width):
    """The first ``width`` characters of ``text`` from ``start`` on that hold
    no replacement character (random bytes are often invalid UTF-8)."""
    for i in range(start, len(text) - width + 1):
        if "�" not in text[i:i + width]:
            return text[i:i + width]
    raise AssertionError(f"no clean {width}-character window in {text!r}")


def test_v1_completions_stop_string_cancels_early(http_server):
    """A stop string cancels generation when it appears (not at
    max_tokens); the text ends before it; finish_reason is 'stop'."""
    port = http_server
    probe = _needle(_plain_text(port, 8), 0, 1)
    r = _post_path(port, "/v1/completions",
                   {"prompt": [5, 9, 17], "max_tokens": 48, "temperature": 0,
                    "stop": [probe]})
    out = json.loads(r.read())
    assert out["choices"][0]["finish_reason"] == "stop"
    assert probe not in out["choices"][0]["text"]
    assert out["usage"]["completion_tokens"] < 48


def test_v1_stream_never_leaks_stop_prefix(http_server):
    """A stop string spanning tokens never leaks its prefix into the stream:
    the streamed text equals the non-stream result of the same request."""
    port = http_server
    full = _plain_text(port, 12)
    needle = _needle(full, 1, 2)
    body = {"prompt": [5, 9, 17], "max_tokens": 12, "temperature": 0,
            "stop": [needle]}
    expect = json.loads(_post_path(port, "/v1/completions",
                                   body).read())["choices"][0]["text"]
    assert needle not in expect and full.startswith(expect)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    payloads = [json.loads(e[6:]) for e in _events(conn.getresponse())[:-1]]
    text = "".join(p["choices"][0]["text"] or "" for p in payloads)
    assert text == expect, (text, expect)
    assert payloads[-1]["choices"][0]["finish_reason"] == "stop"


def test_generate_token_identical_to_the_jax_server(models, http_server):
    """The same greedy requests (token ids, a string, a chat prompt) to both
    packages' servers give the same tokens and finish reasons."""
    jcfg, jparams, _, _ = models
    jserver = jhttp.Server(jcfg, jparams, JByteTokenizer(), None, _args())
    httpd, t = _start(jserver, jhttp._make_handler)
    bodies = [{"prompt": [5, 9, 17], "max_new_tokens": 6},
              {"prompt": list(range(30, 51)), "max_new_tokens": 9},
              {"prompt": "Hello there", "max_new_tokens": 5},
              {"prompt": "hi", "chat": True, "max_new_tokens": 4}]
    try:
        for body in bodies:
            want = json.loads(_post(httpd.server_address[1], body).read())
            got = json.loads(_post(http_server, body).read())
            assert (got["token_ids"], got["finish_reason"], got["text"]) == \
                (want["token_ids"], want["finish_reason"], want["text"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        jserver.shutdown()


def test_server_routes_a_stage_mesh_to_pp_fifo_and_defaults_to_the_card(
        models, monkeypatch):
    """A pipeline-parallel mesh gets ``PPFifoScheduler`` with the JAX
    server's arguments (JAX server/http.py:74-87: max_batch from
    --max-slots, max_seq, the KV type of --kv-bits, the default sampling,
    the seed); tests/test_torch_pp_scheduler.py serves over one.  Without
    a card the default device raises."""
    from qwen_inference_engine_tpu_torch.engine import pp_scheduler

    class Routed(Exception):
        pass

    def route(cfg, params, **kw):
        raise Routed(kw)

    monkeypatch.setattr(pp_scheduler, "PPFifoScheduler", route)
    _, _, tcfg, tparams = models
    args = _args(device="cpu", max_slots=4, kv_bits=8)
    with pytest.raises(Routed) as got:
        Server(tcfg, tparams, ByteTokenizer(),
               types.SimpleNamespace(shape={"stage": 2}, size=1), args)
    kw = got.value.args[0]
    assert (kw["max_batch"], kw["max_seq"], kw["kv_dtype"], kw["seed"],
            kw["device"]) == (4, args.max_seq, torch.int8, args.seed, "cpu")
    assert kw["sampling"].greedy == args.greedy and kw["mesh"].shape == \
        {"stage": 2}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(tcfg, tparams, ByteTokenizer(), None, _args())


def test_speculative_int8_server_reports_spec_stats(models):
    """``serve --speculative --kv-bits 8``: prompt lookup over an INT8 pool
    answers a request, and /stats reports its speculation rounds (one row
    per verify forward) and tokens per forward."""
    _, _, tcfg, tparams = models
    server = Server(tcfg, tparams, ByteTokenizer(), None,
                    _args(device="cpu", kv_bits=8, speculative=True,
                          spec_k=3, spec_ngram=2))
    assert server.engine.cache.quantized and server.engine.speculative
    httpd, t = _start(server, _make_handler)
    try:
        r = _post(httpd.server_address[1], {"prompt": "abcabcabcabcabc",
                                            "max_new_tokens": 8})
        out = json.loads(r.read())
        status, snap = _get(httpd.server_address[1], "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        t.join(timeout=10)
    assert r.status == 200 and status == 200
    assert out["finish_reason"] in ("eos", "length") and out["token_ids"]
    assert snap["spec_rounds"] > 0 and snap["spec_tokens_per_forward"] >= 1
