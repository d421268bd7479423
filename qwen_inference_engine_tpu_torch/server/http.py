"""HTTP serving front end over the continuous-batching engine.

The port of the JAX package's ``server/http.py``, on the stdlib
``http.server`` (no extra dependencies): a background scheduler thread
drives ``ContinuousBatchingEngine.step_batch`` whenever work is queued;
request threads block on a per-request event, or stream the tokens as
the engine's ``on_token`` hook delivers them.

Endpoints:
  POST /generate   {"prompt": str | [ids], "max_new_tokens": int,
                    "temperature"?, "top_k"?, "top_p"?,
                    "repetition_penalty"?, "presence_penalty"?, "greedy"?,
                    "chat"?: bool, "stream"?: bool, "timeout_s"?: float,
                    "stop_token_ids"?: [int]}
                → {"request_id", "text", "token_ids", "finish_reason"}
                  (stream=true: text/event-stream of
                   data: {"token_id", "text"} events, the final event
                   carrying {"finish_reason", "token_ids"})
  POST /v1/completions, /v1/chat/completions   the OpenAI-style surface
  GET  /v1/models  the served model
  GET  /stats      metrics snapshot (tok/s, TTFT percentiles, prefix hits)
  GET  /health     {"status": "ok"}

``--speculative`` serves with speculative decoding (prompt lookup, or a
draft model from ``--draft-model`` / ``--draft-ckpt``; ``/stats`` reports
``spec_rounds`` and ``spec_tokens_per_forward``), ``--kv-bits 8`` over an
INT8 page pool.  The engine runs on the card unless ``--device cpu`` is
given.

Under a ``(data, model)`` mesh (``serve --tp N --dp M``) every rank
builds a ``Server``; rank 0 alone runs the HTTP front end.  Before each
tick rank 0 broadcasts that tick's admissions, cancellations and expired deadlines (by its own
clock) to every rank (``broadcast_object`` on the world group, at least
twenty times a second while idle), and every rank then applies them and
runs the same tick, so every rank's engine holds the same state.  The
other ranks run ``follow()`` until rank 0 shuts down.  An expert-parallel
mesh (``serve --ep N``) is served the same way: every rank runs the EP
step on its own slots and experts (``engine/scheduler.py``).  A
pipeline-parallel mesh (``serve --pp N``) is served by the FIFO wave
scheduler (``engine/pp_scheduler.PPFifoScheduler``, as the JAX server
routes it) with ``--max-slots`` rows a wave over a contiguous cache of
``--max-seq``, the same way: rank 0 broadcasts each tick's control
message, and every rank runs its stage of the same waves.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict


def _earliest_stop(text: str, stop) -> int:
    """Index of the EARLIEST occurrence of any stop string, or -1."""
    hits = [text.find(x) for x in stop]
    hits = [h for h in hits if h >= 0]
    return min(hits) if hits else -1


def _stop_holdback(text: str, stop) -> int:
    """Longest suffix of ``text`` that is a proper prefix of a stop
    string — a stream must hold it back in case the next tokens complete
    the stop sequence."""
    hold = 0
    for x in stop:
        for k in range(min(len(x) - 1, len(text)), 0, -1):
            if text.endswith(x[:k]):
                hold = max(hold, k)
                break
    return hold


class _Waiter:
    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.tokens: "queue.Queue" = queue.Queue()  # live token stream


class Server:
    def __init__(self, cfg, params, tok, mesh, args):
        from qwen_inference_engine_tpu_torch.engine.pp_scheduler import (
            PPFifoScheduler,
        )
        from qwen_inference_engine_tpu_torch.kvcache.cache import (
            kv_dtype_from_bits,
        )
        from qwen_inference_engine_tpu_torch.ops.sampling import SamplingParams
        from qwen_inference_engine_tpu_torch.parallel.mesh import is_pp_mesh

        self.tok = tok
        self.cfg = cfg
        self.default_sp = SamplingParams(
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            repetition_penalty=args.repetition_penalty, greedy=args.greedy)
        # rank 0 takes the requests and broadcasts each tick's control
        # message; None without a mesh of several ranks
        self._world = (mesh.world_group if mesh is not None and mesh.size > 1
                       else None)
        self._outbox = {"submit": [], "cancel": []}
        if is_pp_mesh(mesh):
            # the pipeline's layer-cut weights and KV: the FIFO wave
            # scheduler (the slot scheduler assumes every rank holds every
            # layer), the same engine contract
            self.engine = PPFifoScheduler(
                cfg, params, mesh=mesh, on_token=self._on_token,
                max_batch=args.max_slots, max_seq=args.max_seq,
                kv_dtype=kv_dtype_from_bits(args.kv_bits),
                sampling=self.default_sp, seed=args.seed,
                device=getattr(args, "device", None))
        else:
            self.engine = self._slot_engine(cfg, params, mesh, args)
        self._step_ticks = max(1, getattr(args, "step_ticks", 8))
        self._lock = threading.Lock()
        self._waiters: Dict[int, _Waiter] = {}
        self._next_id = 0
        self._wake = threading.Event()
        self._stop = False
        self._thread = None
        if self._world is None or self._world.rank == 0:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _slot_engine(self, cfg, params, mesh, args):
        """The continuous-batching engine over the page pool."""
        from qwen_inference_engine_tpu_torch.engine.scheduler import (
            ContinuousBatchingEngine,
        )
        from qwen_inference_engine_tpu_torch.kvcache.cache import (
            kv_dtype_from_bits,
        )

        pages_per_seq = max(4, -(-args.max_seq // args.page_size))
        num_pages = (args.num_pages or
                     args.max_slots * pages_per_seq
                     + max(8, args.max_slots * pages_per_seq // 4))
        return ContinuousBatchingEngine(
            cfg, params, on_token=self._on_token,
            max_slots=args.max_slots, page_size=args.page_size,
            num_pages=num_pages, max_pages_per_seq=pages_per_seq,
            kv_dtype=kv_dtype_from_bits(args.kv_bits),
            sampling=self.default_sp, seed=args.seed,
            prefix_cache=not getattr(args, "no_prefix_cache", False),
            speculative=getattr(args, "speculative", False),
            spec_k=getattr(args, "spec_k", 4),
            spec_ngram=getattr(args, "spec_ngram", 3),
            draft_params=getattr(args, "_draft_params", None),
            draft_cfg=getattr(args, "_draft_cfg", None),
            top_k_cap=getattr(args, "top_k_cap", None),
            device=getattr(args, "device", None), mesh=mesh)

    def follow(self) -> None:
        """A rank other than 0: run the ticks rank 0 broadcasts until it
        shuts down."""
        self._loop()

    def _control(self) -> bool:
        """Rank 0 sends this tick's control message (the requests admitted
        since the last, the cancellations, whether to stop); every rank
        applies it.  Returns False to stop.  The engine's step decides the
        deadlines."""
        from qwen_inference_engine_tpu_torch.parallel.mesh import (
            broadcast_object,
        )

        msg = None
        if self._world.rank == 0:
            with self._lock:
                msg = dict(self._outbox, stop=self._stop)
                self._outbox = {"submit": [], "cancel": []}
        msg = broadcast_object(msg, self._world)
        with self._lock:
            for req in msg["submit"]:
                self.engine.submit(req)
            for rid in msg["cancel"]:
                self.engine.cancel(rid)
        return not msg["stop"]

    # ------------------------------------------------------------------
    def _on_token(self, request_id: int, token_id: int) -> None:
        w = self._waiters.get(request_id)
        if w is not None:
            w.tokens.put(token_id)

    def _loop(self):
        while True:
            if self._world is not None:
                if not self._control():
                    break
            elif self._stop:
                break
            with self._lock:
                has_work = self.engine.has_work()
            if not has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                with self._lock:
                    # chain decode ticks on device, one host sync per batch
                    # (engine.step_batch; it degrades to a single step()
                    # whenever admissions/prefills need host decisions, so
                    # a freshly submitted request is admitted within one
                    # batch window)
                    finished = self.engine.step_batch(self._step_ticks)
                    for f in finished:
                        w = self._waiters.pop(f.request_id, None)
                        if w is not None:
                            w.result = f
                            w.event.set()
            except Exception:
                # a dead scheduler thread would leave every client hanging
                # until its timeout: fail the waiters loudly instead
                import traceback

                from qwen_inference_engine_tpu_torch.engine.types import (
                    FinishedRequest,
                )

                traceback.print_exc()
                with self._lock:
                    for rid, w in list(self._waiters.items()):
                        w.result = FinishedRequest(rid, [], "error")
                        w.event.set()
                    self._waiters.clear()

    def submit(self, prompt_ids, max_new_tokens, sampling,
               timeout_s=None, stop_token_ids=None):
        from qwen_inference_engine_tpu_torch.engine.types import Request

        w = _Waiter()
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._waiters[rid] = w
            req = Request(request_id=rid, prompt=list(prompt_ids),
                          max_new_tokens=max_new_tokens, sampling=sampling,
                          timeout_s=timeout_s, stop_token_ids=stop_token_ids)
            if self._world is None:
                self.engine.submit(req)
            else:   # every rank admits it at the next tick
                self._outbox["submit"].append(req)
        self._wake.set()
        return w, rid

    def cancel(self, request_id: int) -> None:
        with self._lock:
            if self._world is None:
                self.engine.cancel(request_id)
            else:
                self._outbox["cancel"].append(request_id)
            self._waiters.pop(request_id, None)

    def shutdown(self):
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2 if self._world is None else 60)


def _make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"status": "ok"})
            if self.path == "/stats":
                return self._json(200, server.engine.metrics.snapshot())
            if self.path == "/v1/models":
                return self._json(200, {
                    "object": "list",
                    "data": [{"id": server.cfg.name, "object": "model",
                              "owned_by": "qie"}]})
            return self._json(404, {"error": "not found"})

        def _stream(self, w, rid, timeout_s):
            from qwen_inference_engine_tpu_torch.tokenizer import StreamDecoder

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            deadline = time.monotonic() + timeout_s + 30
            dec = StreamDecoder(server.tok)  # multi-byte chars span tokens
            try:
                while not w.event.is_set() or not w.tokens.empty():
                    try:
                        tok = w.tokens.get(timeout=0.1)
                    except queue.Empty:
                        if time.monotonic() > deadline:
                            server.cancel(rid)
                            break
                        continue
                    ev = {"token_id": tok, "text": dec.push(tok)}
                    self.wfile.write(
                        f"data: {json.dumps(ev)}\n\n".encode())
                    self.wfile.flush()
                f = w.result
                final = ({"finish_reason": f.finish_reason,
                          "token_ids": f.token_ids,
                          "request_id": f.request_id}
                         if f is not None else {"finish_reason": "timeout"})
                tail = dec.flush()  # held-back partial code point, if any
                if tail:
                    final["text"] = tail
                self.wfile.write(
                    f"data: {json.dumps(final)}\n\n".encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                server.cancel(rid)  # client went away: stop generating

        # ------------------------------------------------------------------
        # OpenAI-compatible surface (/v1/completions, /v1/chat/completions):
        # the drop-in path for clients already speaking the de-facto API —
        # the native /generate endpoint stays the richer surface (token-id
        # prompts, greedy flag, repetition penalty).
        # ------------------------------------------------------------------
        def _v1(self, req, chat: bool):
            if req.get("n", 1) != 1:
                return self._json(400, {"error": "n > 1 is not supported"})
            if chat:
                msgs = req.get("messages")
                if not isinstance(msgs, list) or not msgs:
                    return self._json(400, {"error": "missing 'messages'"})
                try:
                    text = server.tok.apply_chat_template(msgs)
                except Exception as e:
                    return self._json(400, {"error": f"bad messages: {e}"})
                ids = server.tok.encode(text)
            else:
                prompt = req.get("prompt")
                if isinstance(prompt, str):
                    ids = server.tok.encode(prompt)
                elif (isinstance(prompt, list)
                      and all(type(x) is int for x in prompt)):
                    ids = prompt
                else:
                    return self._json(400, {
                        "error": "'prompt' must be str or [int]"})
            if not ids:
                return self._json(400, {"error": "empty prompt"})

            import dataclasses

            sp = server.default_sp
            try:
                overrides = {}
                if "temperature" in req:
                    t = req["temperature"]
                    # OpenAI semantics: temperature 0 means deterministic
                    if t == 0:
                        overrides["greedy"] = True
                    else:
                        overrides["temperature"] = float(t)
                if "top_p" in req:
                    overrides["top_p"] = float(req["top_p"])
                if "presence_penalty" in req:
                    overrides["presence_penalty"] = float(
                        req["presence_penalty"])
                max_new = int(req.get("max_tokens", 16 if not chat else 512))
                timeout_s = float(req.get("timeout_s", 600))
            except (TypeError, ValueError) as e:
                return self._json(400, {"error": f"bad parameter: {e}"})
            if overrides:
                sp = dataclasses.replace(sp, **overrides)
            stop = req.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            if not (isinstance(stop, list)
                    and all(isinstance(s, str) for s in stop)):
                return self._json(400, {"error": "stop must be str or [str]"})
            w, rid = server.submit(ids, max_new, sp, timeout_s=timeout_s)
            oid = f"{'chatcmpl' if chat else 'cmpl'}-{rid}"
            if req.get("stream"):
                return self._v1_stream(w, rid, oid, chat, stop, timeout_s)
            n_completion = None
            if stop:
                # watch the live token stream so a stop-string hit CANCELS
                # generation instead of letting it run to max_tokens and
                # truncating post-hoc
                from qwen_inference_engine_tpu_torch.tokenizer import StreamDecoder

                dec = StreamDecoder(server.tok)
                acc, n_toks = "", 0
                deadline = time.monotonic() + timeout_s + 30
                stopped_early = False
                while not w.event.is_set() or not w.tokens.empty():
                    try:
                        acc += dec.push(w.tokens.get(timeout=0.1))
                        n_toks += 1
                    except queue.Empty:
                        if time.monotonic() > deadline:
                            server.cancel(rid)
                            return self._json(
                                504, {"error": "generation timed out"})
                        continue
                    if _earliest_stop(acc, stop) >= 0:
                        server.cancel(rid)  # pops the waiter: keep acc
                        stopped_early = True
                        break
                if stopped_early:
                    acc += dec.flush()
                    text, finish, n_completion = acc, "stop", n_toks
            if n_completion is None:
                if not w.event.wait(timeout=timeout_s + 30):
                    server.cancel(rid)
                    return self._json(504, {"error": "generation timed out"})
                f = w.result
                if f.finish_reason in ("timeout", "cancelled"):
                    return self._json(504, {"error": f.finish_reason})
                text = server.tok.decode(f.token_ids)
                finish = {"eos": "stop", "length": "length"}.get(
                    f.finish_reason, f.finish_reason)
                n_completion = len(f.token_ids)
            i = _earliest_stop(text, stop)
            if i >= 0:
                text, finish = text[:i], "stop"
            choice = ({"index": 0, "finish_reason": finish,
                       "message": {"role": "assistant", "content": text}}
                      if chat else
                      {"index": 0, "finish_reason": finish, "text": text})
            return self._json(200, {
                "id": oid,
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()),
                "model": server.cfg.name,
                "choices": [choice],
                "usage": {
                    "prompt_tokens": len(ids),
                    "completion_tokens": n_completion,
                    "total_tokens": len(ids) + n_completion,
                },
            })

        def _v1_stream(self, w, rid, oid, chat, stop, timeout_s):
            from qwen_inference_engine_tpu_torch.tokenizer import StreamDecoder

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            obj = "chat.completion.chunk" if chat else "text_completion"
            deadline = time.monotonic() + timeout_s + 30
            dec = StreamDecoder(server.tok)  # multi-byte chars span tokens
            acc = ""

            def chunk(delta, finish=None):
                c = ({"index": 0, "finish_reason": finish,
                      "delta": ({"content": delta} if delta else {})}
                     if chat else
                     {"index": 0, "finish_reason": finish, "text": delta})
                return {"id": oid, "object": obj,
                        "created": int(time.time()),
                        "model": server.cfg.name, "choices": [c]}

            try:
                stopped = False
                emitted = 0        # chars of acc already sent

                def send(upto):
                    nonlocal emitted
                    if upto > emitted:
                        self.wfile.write(
                            f"data: "
                            f"{json.dumps(chunk(acc[emitted:upto]))}\n\n"
                            .encode())
                        self.wfile.flush()
                        emitted = upto

                while not w.event.is_set() or not w.tokens.empty():
                    try:
                        tok = w.tokens.get(timeout=0.1)
                    except queue.Empty:
                        if time.monotonic() > deadline:
                            server.cancel(rid)
                            break
                        continue
                    acc += dec.push(tok)
                    i = _earliest_stop(acc, stop)
                    if i >= 0:
                        # emit up to the stop string, then cancel
                        send(i)
                        server.cancel(rid)
                        stopped = True
                        break
                    # hold back any suffix that might complete a stop
                    # string on the next token (never leak stop prefixes)
                    send(len(acc) - _stop_holdback(acc, stop))
                if not stopped:
                    # release held-back text + the decoder's tail
                    acc += dec.flush()
                    i = _earliest_stop(acc, stop)
                    stopped = i >= 0
                    send(i if stopped else len(acc))
                f = w.result
                finish = ("stop" if stopped else
                          {"eos": "stop", "length": "length"}.get(
                              f.finish_reason, f.finish_reason)
                          if f is not None else "timeout")
                self.wfile.write(
                    f"data: {json.dumps(chunk('', finish))}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                server.cancel(rid)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad json: {e}"})
            if self.path == "/v1/completions":
                return self._v1(req, chat=False)
            if self.path == "/v1/chat/completions":
                return self._v1(req, chat=True)
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})

            prompt = req.get("prompt")
            if prompt is None:
                return self._json(400, {"error": "missing 'prompt'"})
            if isinstance(prompt, str):
                text = prompt
                if req.get("chat"):
                    text = server.tok.apply_chat_template(
                        [{"role": "user", "content": text}])
                ids = server.tok.encode(text)
            elif isinstance(prompt, list) and all(isinstance(x, int) for x in prompt):
                ids = prompt
            else:
                return self._json(400, {"error": "'prompt' must be str or [int]"})
            if not ids:
                return self._json(400, {"error": "empty prompt"})

            import dataclasses

            sp = server.default_sp
            overrides = {k: req[k] for k in
                         ("temperature", "top_p", "repetition_penalty",
                          "presence_penalty")
                         if k in req}
            meta = {k: req[k] for k in ("top_k", "greedy") if k in req}
            if "top_k" in meta:
                # the decode step's top-k selection width is compiled once
                # (engine.k_cap); per-row top_k masks within it, so any
                # value in [0, k_cap] is served exactly (0 → k_cap)
                k_cap = server.engine.k_cap
                # type(...) is int: JSON true/false are Python bools,
                # which subclass int and would otherwise pass as 1/0
                if type(meta["top_k"]) is not int or \
                        not 0 <= meta["top_k"] <= k_cap:
                    return self._json(400, {
                        "error": f"top_k must be an int in [0, {k_cap}]"})
            if "greedy" in meta and not isinstance(meta["greedy"], bool):
                return self._json(400, {"error": "greedy must be a bool"})
            if overrides or meta:
                sp = dataclasses.replace(sp, **overrides, **meta)
            max_new = int(req.get("max_new_tokens", 128))
            stop_ids = req.get("stop_token_ids")
            if stop_ids is not None and not (
                    isinstance(stop_ids, list)
                    and all(type(x) is int for x in stop_ids)):
                return self._json(400, {"error": "stop_token_ids: [int]"})

            timeout_s = float(req.get("timeout_s", 600))
            w, rid = server.submit(ids, max_new, sp, timeout_s=timeout_s,
                                   stop_token_ids=stop_ids)
            if req.get("stream"):
                return self._stream(w, rid, timeout_s)
            if not w.event.wait(timeout=timeout_s + 30):
                # the scheduler's own deadline should have fired first;
                # belt-and-braces: cancel so the request stops consuming
                # slots/pages instead of running on after the client left
                server.cancel(rid)
                return self._json(504, {"error": "generation timed out"})
            if w.result.finish_reason in ("timeout", "cancelled"):
                return self._json(504, {"error": w.result.finish_reason})
            f = w.result
            return self._json(200, {
                "request_id": f.request_id,
                "token_ids": f.token_ids,
                "text": server.tok.decode(f.token_ids),
                "finish_reason": f.finish_reason,
            })

    return Handler


def serve(args) -> int:
    from qwen_inference_engine_tpu_torch.server.cli import (
        build_draft_model,
        build_model,
    )

    from qwen_inference_engine_tpu_torch.server.cli import run_ranks

    return run_ranks(args, _serve_rank)


def _serve_rank(args, mesh) -> int:
    """``serve`` on one rank (every rank without a mesh is rank 0): rank 0
    serves HTTP, the others follow its ticks."""
    from qwen_inference_engine_tpu_torch.server.cli import (
        build_draft_model,
        build_model,
    )

    cfg, params, tok, device = build_model(args)
    args.device = device
    args._draft_cfg, args._draft_params = build_draft_model(args, device)
    server = Server(cfg, params, tok, mesh, args)
    if mesh is not None and mesh.rank != 0:
        server.follow()
        return 0
    httpd = ThreadingHTTPServer((args.host, args.port), _make_handler(server))
    eng = server.engine
    if getattr(eng, "stages", 1) > 1:
        kv = (f"pipeline stages={eng.stages}, FIFO waves, contiguous "
              f"cache {str(eng.cache.k.dtype).split('.')[-1]}")
    else:
        spec = (f", speculative k={eng.spec_k} "
                + (f"draft {args._draft_cfg.name}" if eng._model_draft
                   else f"prompt lookup ngram={eng.spec_ngram}")
                if eng.speculative else "")
        kv = (f"pages={eng.num_pages}x{args.page_size} "
              f"{str(eng.cache.k_pages.dtype).split('.')[-1]}{spec}")
    print(f"qie serving {cfg.name} on http://{args.host}:{args.port} "
          f"(device {device}, slots={args.max_slots}, {kv})", flush=True)
    if getattr(eng, "layout", None) is not None:
        print(f"[tp layout] {eng.layout.summary()}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        httpd.server_close()
    return 0
