"""OpenAI-compatible HTTP serving front end over the batching engines: the
counterpart of chatglm_q_tpu/serving/api_server.py (``GLMAPIServer``).

A dependency-free HTTP server (stdlib ``http.server``) exposing
``/v1/chat/completions``, ``/v1/completions``, ``/v1/models``, ``/health``
and ``/metrics``, with Server-Sent-Events streaming, stop strings and ``n``
choices, multiplexing many concurrent HTTP clients onto ONE
continuous-batching engine (``ServingEngine``, ``PagedServingEngine`` or a
distributed one, served from rank 0 while the other ranks ``follow``).
Routes, bodies and SSE framing are the JAX package's.

* **One device thread.**  All engine and device work happens on a single
  ``EngineWorker`` thread (the engine's state and its captured decode
  programs belong to one thread and one stream); HTTP handler threads
  communicate with it only through queues.
* **Continuous batching end to end.**  Requests arriving while others
  decode are admitted between chunks by the engine itself: the server adds
  no batching logic of its own, it only routes token events (``req_id`` →
  per-request queue) back to the waiting handler.
* **Incremental detokenization** suppresses trailing partial-UTF-8
  replacement chars exactly like the streaming decoder (decoder.py: yield
  only when the text does not end in U+FFFD).
"""
from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
import itertools
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import distributed as dist_utils
from .chat import chat_template, process_response

_DONE = object()  # sentinel closing a per-request event stream
_EVENT_TIMEOUT = 600  # seconds a handler waits on the next token event


class EngineWorker(threading.Thread):
    """Owns the engine; the only thread that touches the device.

    HTTP threads call :meth:`submit` / :meth:`cancel`; the worker loop
    drains those mailboxes between engine steps and fans decoded tokens
    out to per-request queues.
    """

    def __init__(self, engine, poll_interval: float = 0.02):
        super().__init__(daemon=True, name="engine-worker")
        self.engine = engine
        self._mail: queue.Queue = queue.Queue()
        self._events: dict[int, queue.Queue] = {}
        self._finish_reason: dict[int, str] = {}
        self._wake = threading.Event()
        self._stopping = False
        self._poll = poll_interval
        # high-water mark into engine.finished: entries below it are routed
        # (the worker clears the list after consuming — a long-running
        # server must not accumulate every Request ever served)
        self._consumed = 0

    # -- called from HTTP handler threads ------------------------------

    def submit(self, prompt_ids: list, **sampling) -> tuple[int, queue.Queue]:
        """Queue a request; returns (req_id, token-event queue).  The queue
        yields lists of token ids and finally the _DONE sentinel."""
        if not self.is_alive():
            raise RuntimeError("engine worker is not running")
        out: queue.Queue = queue.Queue()
        done = threading.Event()
        box: dict = {}
        self._mail.put(("submit", (prompt_ids, sampling, out, box, done)))
        self._wake.set()
        waited = 0.0
        while not done.wait(timeout=1.0):
            waited += 1.0
            # fail fast when the worker died instead of stalling the client
            if not self.is_alive():
                raise RuntimeError("engine worker died before accepting "
                                   "the request")
            if waited >= 300.0:
                raise RuntimeError("engine worker did not accept the request "
                                   "(device stalled)")
        return box["req_id"], out

    def cancel(self, req_id: int):
        self._mail.put(("cancel", req_id))
        self._wake.set()

    def shutdown(self):
        self._stopping = True
        self._wake.set()

    def finish_reason(self, req_id: int) -> str:
        # read-once: the handler consumes it right after _DONE; popping
        # keeps the dict from growing with the server's lifetime
        return self._finish_reason.pop(req_id, "stop")

    # -- worker loop ----------------------------------------------------

    def _drain_mail(self, stop: bool = False) -> bool:
        """Apply the mailbox's submissions and cancels, in order, through
        the engine's ``sync_events`` (on a distributed engine it hands them,
        and ``stop``, to every rank: one broadcast a turn of the loop,
        whether the mailbox holds anything or not, as ``follow`` expects).
        Returns whether to stop."""
        mail = []
        while not stop:
            try:
                mail.append(self._mail.get_nowait())
            except queue.Empty:
                break
        events = [("submit", [int(t) for t in p[0]], p[1]) if kind == "submit"
                  else ("cancel", p) for kind, p in mail]
        applied, stop = self.engine.sync_events(events, stop)
        for (kind, payload), (_, rid) in zip(mail, applied):
            if kind == "submit":
                _, _, out, box, done = payload
                self._events[rid] = out
                box["req_id"] = rid
                done.set()
        return stop

    def _route_finished(self):
        fin = self.engine.finished
        while self._consumed < len(fin):
            req = fin[self._consumed]
            self._consumed += 1
            rid = req.req_id
            # the engine strips a trailing eos from .generated before
            # retiring, so detect an eos/early finish by the unused budget
            if len(req.generated) >= req.max_new_tokens:
                self._finish_reason[rid] = "length"
            else:
                self._finish_reason[rid] = "stop"
            q = self._events.pop(rid, None)
            if q is not None:
                q.put(_DONE)
        if self._consumed:
            # the worker is the engine's only consumer: drop routed Requests
            # so a long-running server does not hold every prompt ever served
            del fin[: self._consumed]
            self._consumed = 0

    def run(self):
        stop = False
        try:
            while True:
                stop = self._drain_mail(self._stopping)
                # a cancel can retire a request without a further step (and
                # may leave the engine with no work at all) — route its
                # _DONE now, not only after the next step
                self._route_finished()
                if stop:
                    break
                if not self.engine.has_work:
                    # idle: block until a submission (or shutdown) arrives
                    self._wake.wait(timeout=1.0)
                    self._wake.clear()
                    continue
                for rid, toks in self.engine.step():
                    q = self._events.get(rid)
                    if q is not None and toks:
                        q.put(list(toks))
                self._route_finished()
        finally:
            # worker exiting (shutdown or a device/engine exception): close
            # every open event stream so no HTTP client hangs to timeout
            for rid, q in list(self._events.items()):
                self._finish_reason.setdefault(rid, "error")
                q.put(_DONE)
            self._events.clear()
            if not stop:
                # an exception: the ranks that follow wait on this loop's next
                # broadcast, so send them the stop (best effort: a failure
                # inside a collective leaves them to the process group's
                # timeout)
                with contextlib.suppress(Exception):
                    self.engine.sync_events([], True)


def follow(engine) -> list:
    """The loop of a mesh rank other than 0 while rank 0's ``GLMAPIServer``
    serves the distributed ``engine``: each turn takes rank 0's mailbox
    (``sync_events``: the same submissions and cancels, in the same order),
    then steps the engine if it has work, as rank 0's worker does, so every
    collective meets its peers.  Opens no socket.  Returns, when rank 0's
    server shuts down, the events applied here with their results."""
    log = []
    while True:
        applied, stop = engine.sync_events()
        log += applied
        if stop:
            return log
        if engine.has_work:
            engine.step()
        engine.finished.clear()  # rank 0's worker routes the finished requests


# chars process_response may rewrite when the NEXT char turns out CJK
_PUNCT_HOLD = ",!:;?"
_PLACEHOLDER = "[[训练时间]]"


class _StreamState:
    """Per-request incremental detokenizer with stop-sequence scanning.

    Both the SSE and the non-stream paths build their text EXCLUSIVELY from
    push()/flush() deltas, so the two are equal by construction.  A delta is
    only emitted once no future token can rewrite it: ``process_response``
    is not monotonic (a halfwidth punctuation converts to fullwidth when the
    following char arrives and is CJK; the training-time placeholder is an
    8→5-char replacement), so a volatile suffix is held back along with
    potential stop-string prefixes and the partial-UTF8 U+FFFD tail
    (decoder.py:93-95 semantics)."""

    def __init__(self, tokenizer, eos_token_id: int, stop: list[str]):
        self.tokenizer = tokenizer
        self.eos = eos_token_id
        self.stop = stop
        self.ids: list[int] = []
        self.emitted = 0  # chars of processed text already sent
        self.stopped = False
        self.text = ""    # authoritative final text (valid after flush)

    def _processed(self) -> str:
        return process_response(self.tokenizer.decode(self.ids))

    def _find_stop(self, text: str) -> Optional[int]:
        hits = [h for h in (text.find(s) for s in self.stop) if h >= 0]
        return min(hits) if hits else None

    def _stable_len(self, text: str) -> int:
        """Prefix length that no future token can change."""
        n = len(text)
        while n and text[n - 1] == "�":       # partial UTF-8, may complete
            n -= 1
        while n and text[n - 1].isspace():    # a final strip() removes these
            n -= 1
        while n and text[n - 1] in _PUNCT_HOLD:  # may convert to fullwidth
            n -= 1
        for k in range(min(len(_PLACEHOLDER) - 1, n), 0, -1):
            if text[:n].endswith(_PLACEHOLDER[:k]):
                n -= k
                break
        for s in self.stop:                   # may complete across boundary
            for k in range(min(len(s) - 1, n), 0, -1):
                if text[:n].endswith(s[:k]):
                    n -= k
                    break
        return n

    def push(self, toks: list[int]) -> Optional[str]:
        """Absorb decoded tokens; return the stable new text delta (None
        when everything new is still volatile)."""
        self.ids.extend(t for t in toks if t != self.eos)
        if self.stopped:
            return None
        text = self._processed()
        hit = self._find_stop(text)
        if hit is not None:
            self.stopped = True
            self.text = text[:hit]
            delta = text[self.emitted:hit]
            self.emitted = hit
            return delta or None
        n = self._stable_len(text)
        if n <= self.emitted:
            return None
        delta = text[self.emitted:n]
        self.emitted = n
        return delta

    def flush(self) -> Optional[str]:
        """End of generation: emit the held-back tail (the trailing U+FFFD
        of a truncated multi-byte sequence included — the reference's final
        response keeps it; only mid-stream yields suppress it)."""
        if self.stopped:
            return None
        text = self._processed()
        hit = self._find_stop(text)
        if hit is not None:
            self.stopped = True
            text = text[:hit]
        self.text = text
        if len(text) <= self.emitted:
            return None
        delta = text[self.emitted:]
        self.emitted = len(text)
        return delta


def _messages_to_prompt(messages: list[dict]) -> str:
    """Map OpenAI chat messages onto the ChatGLM2 [Round n] template.

    ChatGLM2 has no system role: system content is prepended to the first
    user turn (the convention its own web demos use)."""
    system = "\n".join(m["content"] for m in messages if m.get("role") == "system")
    turns = [m for m in messages if m.get("role") in ("user", "assistant")]
    if not turns or turns[-1].get("role") != "user":
        raise ValueError("last non-system message must be role=user")
    history: list[tuple[str, str]] = []
    i = 0
    while i < len(turns) - 1:
        if turns[i]["role"] == "user" and turns[i + 1]["role"] == "assistant":
            history.append((turns[i]["content"], turns[i + 1]["content"]))
            i += 2
        else:
            i += 1
    current = turns[-1]["content"]
    if system:
        current = system + "\n" + current
    return chat_template(history, current)


class GLMAPIServer:
    """Binds an engine + tokenizer to an HTTP port.

    ``server = GLMAPIServer(engine); server.start()`` — or ``serve()`` to
    block.  ``engine`` is any of the serving engines (dense / paged / dist),
    built WITH a tokenizer.  A distributed engine runs one process a rank:
    the server runs on rank 0, whose worker hands every submission and
    cancel to all ranks each turn (``sync_events``), and every other rank
    runs ``follow(engine)``.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 model_name: str = "chatglm2-6b", default_max_tokens: int = 256):
        if engine.tokenizer is None:
            raise ValueError("API server needs an engine built with a tokenizer")
        if not dist_utils.is_primary():
            raise ValueError("the API server runs on rank 0 of a mesh; the other ranks run "
                             "api_server.follow(engine)")
        self.engine = engine
        self.tokenizer = engine.tokenizer
        self.model_name = model_name
        self.default_max_tokens = default_max_tokens
        self.worker = EngineWorker(engine)
        self._counter = itertools.count(1)
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]

    def start(self):
        if not self.worker.is_alive():
            self.worker.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="http-accept").start()

    def serve(self):
        if not self.worker.is_alive():
            self.worker.start()
        try:
            self.httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()  # release the listening socket fd
        self.worker.shutdown()

    # -- request execution (called from handler threads) ----------------

    def _sampling_kwargs(self, body: dict) -> dict:
        kw = {"max_new_tokens": int(body.get("max_tokens")
                                    or self.default_max_tokens)}
        temp = float(body.get("temperature", 1.0))
        kw["temperature"] = temp
        kw["top_p"] = float(body.get("top_p", 0.8))
        if "top_k" in body:
            kw["top_k"] = int(body["top_k"])
        return kw

    @staticmethod
    def _stop_list(body: dict) -> list[str]:
        stop = body.get("stop") or []
        return [stop] if isinstance(stop, str) else list(stop)

    def generate(self, prompt_text: str, body: dict):
        """Returns (req_id, prompt_len, _StreamState, event queue)."""
        prompt_ids = self.tokenizer.encode(prompt_text)
        rid, events = self.worker.submit(prompt_ids, **self._sampling_kwargs(body))
        state = _StreamState(self.tokenizer, self.engine.eos_token_id,
                             self._stop_list(body))
        return rid, len(prompt_ids), state, events


def _make_handler(server: GLMAPIServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # -- plumbing ---------------------------------------------------

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code: int, message: str, etype: str = "invalid_request_error"):
            self._json(code, {"error": {"message": message, "type": etype,
                                        "param": None, "code": None}})

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            body = json.loads(raw)
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body

        # -- routes -----------------------------------------------------

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": server.model_name, "object": "model",
                     "created": int(time.time()), "owned_by": "chatglm_q_tpu"}]})
            elif self.path in ("/health", "/healthz"):
                if server.worker.is_alive():
                    self._json(200, {"status": "ok"})
                else:
                    self._json(503, {"status": "error",
                                     "detail": "engine worker is not running"})
            elif self.path == "/metrics":
                self._metrics()
            else:
                self._error(404, f"unknown path {self.path}")

        def do_POST(self):
            try:
                body = self._read_body()
            except (ValueError, json.JSONDecodeError):
                return self._error(400, "invalid JSON body")
            try:
                if self.path == "/v1/chat/completions":
                    return self._completions(body, chat=True)
                if self.path == "/v1/completions":
                    return self._completions(body, chat=False)
            except ValueError as e:
                return self._error(400, str(e))
            except RuntimeError as e:  # worker dead / device stalled
                return self._error(503, str(e), etype="server_error")
            self._error(404, f"unknown path {self.path}")

        def _metrics(self):
            """Prometheus text exposition of the engine counters.  Reads are
            unlocked: metrics tolerate a torn view of monotonically growing
            ints."""
            eng = server.engine
            lines = ["# TYPE glm_engine_total counter"]
            for k, v in eng.stats.items():
                lines.append(f'glm_engine_total{{stat="{k}"}} {v}')
            lines += [
                "# TYPE glm_engine_gauge gauge",
                f'glm_engine_gauge{{stat="queued"}} {len(eng.queue)}',
                f'glm_engine_gauge{{stat="active_slots"}} '
                f'{sum(1 for s in eng.slots if s.request is not None)}',
                f'glm_engine_gauge{{stat="max_batch"}} {eng.max_batch}',
            ]
            data = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # -- completions --------------------------------------------

        def _completions(self, body: dict, chat: bool):
            if chat:
                prompt = _messages_to_prompt(body.get("messages") or [])
            else:
                p = body.get("prompt", "")
                if isinstance(p, list):
                    if len(p) != 1:
                        raise ValueError("only a single prompt is supported")
                    p = p[0]
                prompt = str(p)
            n_choices = int(body.get("n", 1) or 1)
            if n_choices < 1:
                raise ValueError("n must be >= 1")
            oid = (f"chatcmpl-{next(server._counter)}" if chat
                   else f"cmpl-{next(server._counter)}")
            if body.get("stream"):
                if n_choices != 1:
                    raise ValueError("streaming supports n=1")
                rid, n_prompt, state, events = server.generate(prompt, body)
                return self._stream(body, chat, oid, rid, state, events,
                                    n_prompt)

            # n samples = n engine requests; the continuous-batching engine
            # decodes them together (per-slot RNG streams make them distinct
            # when sampling).  Submit all up-front, then gather.
            gens = [server.generate(prompt, body) for _ in range(n_choices)]
            n_prompt = gens[0][1]
            choices = []
            total_completion = 0
            for i, (rid, _, state, events) in enumerate(gens):
                try:
                    self._gather(rid, state, events)
                except queue.Empty:
                    for r, _, _, _ in gens:
                        server.worker.cancel(r)
                    return self._error(504, "generation timed out",
                                       etype="server_error")
                text = state.text  # same delta machinery as the SSE path
                reason = ("stop" if state.stopped
                          else server.worker.finish_reason(rid))
                total_completion += len(state.ids)
                if chat:
                    choices.append({"index": i, "finish_reason": reason,
                                    "message": {"role": "assistant",
                                                "content": text}})
                else:
                    choices.append({"index": i, "finish_reason": reason,
                                    "text": text})
            usage = {"prompt_tokens": n_prompt * n_choices,
                     "completion_tokens": total_completion,
                     "total_tokens": n_prompt * n_choices + total_completion}
            obj = "chat.completion" if chat else "text_completion"
            self._json(200, {"id": oid, "object": obj,
                             "created": int(time.time()),
                             "model": server.model_name,
                             "choices": choices, "usage": usage})

        def _gather(self, rid, state, events):
            """Drain one request's event stream into its _StreamState."""
            while True:
                ev = events.get(timeout=_EVENT_TIMEOUT)
                if ev is _DONE:
                    break
                state.push(ev)
                if state.stopped:
                    server.worker.cancel(rid)
                    # drain to the sentinel so the queue is not leaked
                    while events.get(timeout=_EVENT_TIMEOUT) is not _DONE:
                        pass
                    break
            state.flush()

        def _stream(self, body, chat, oid, rid, state, events, n_prompt):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            obj = "chat.completion.chunk" if chat else "text_completion"

            def chunk(delta_obj: dict, reason=None):
                if chat:
                    choice = {"index": 0, "delta": delta_obj,
                              "finish_reason": reason}
                else:
                    choice = {"index": 0, "text": delta_obj.get("content", ""),
                              "finish_reason": reason}
                payload = json.dumps({"id": oid, "object": obj,
                                      "created": int(time.time()),
                                      "model": server.model_name,
                                      "choices": [choice]})
                self._write_chunk(f"data: {payload}\n\n")

            try:
                if chat:
                    chunk({"role": "assistant", "content": ""})
                try:
                    while True:
                        ev = events.get(timeout=_EVENT_TIMEOUT)
                        if ev is _DONE:
                            break
                        delta = state.push(ev)
                        if delta:
                            chunk({"content": delta})
                        if state.stopped:
                            server.worker.cancel(rid)
                            while events.get(timeout=_EVENT_TIMEOUT) is not _DONE:
                                pass
                            break
                except queue.Empty:
                    # device stalled mid-stream: cancel and terminate the
                    # SSE stream cleanly so the client does not hang
                    server.worker.cancel(rid)
                    chunk({}, reason="error")
                    self._write_chunk("data: [DONE]\n\n")
                    self._write_chunk("")
                    return
                tail = state.flush()
                if tail:
                    chunk({"content": tail})
                reason = "stop" if state.stopped else server.worker.finish_reason(rid)
                chunk({}, reason=reason)
                if (body.get("stream_options") or {}).get("include_usage"):
                    usage = {"prompt_tokens": n_prompt,
                             "completion_tokens": len(state.ids),
                             "total_tokens": n_prompt + len(state.ids)}
                    payload = json.dumps({"id": oid, "object": obj,
                                          "created": int(time.time()),
                                          "model": server.model_name,
                                          "choices": [], "usage": usage})
                    self._write_chunk(f"data: {payload}\n\n")
                self._write_chunk("data: [DONE]\n\n")
                self._write_chunk("")  # terminal zero-length chunk
            except (BrokenPipeError, ConnectionResetError):
                server.worker.cancel(rid)  # client went away mid-stream

        def _write_chunk(self, text: str):
            data = text.encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

    return Handler
