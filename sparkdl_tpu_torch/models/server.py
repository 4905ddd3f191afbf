"""HTTP front-end for the continuous-batching engine: token-id JSON in,
token-id JSON (or an SSE token stream) out.

The engine is a ``ContinuousBatchingEngine`` or, unchanged, a
``SpeculativeBatchingEngine`` (its progress hook runs after each
speculation round, and its worst case counts the k-token scratch). The
API takes no ``adapter_id``, as the JAX one takes none: a multi-LoRA
engine behind it serves adapter 0.

Counterpart of ``sparkdl_tpu/models/server.py``, on the standard
library only. Tokenization is out of scope: the wire format is token
ids, the model's native interface.

Threading model: every engine method runs on ONE engine thread; HTTP
handler threads only enqueue work and wait. The engine thread drains
arrivals into ``engine.submit`` and calls ``run()``. The run's progress
hook, called after every decode chunk, posts each request finished so
far (``engine.take_finished()``) to its mailbox, so a blocking client
is answered, and a stream sent its ``done``, as soon as its request
ends, not when the burst drains (the JAX frontend answers at the
drain); then it pulls new arrivals in mid-burst (``_poll_queue``).
What ``run()`` returns at the end is posted the same way. ``run()``
enters ``torch.no_grad()`` on that thread (grad mode is thread-local),
and each kernel launches on the engine thread's current stream.

API::

    POST /generate  {"tokens": [...], "max_new_tokens": 32,
                     "stop": [[...]], "stream": false}
      -> {"tokens": [...], "finish_reason": "...", "logprobs": [...]}
      stream=true  -> text/event-stream, one ``data: {"token": t}``
      event per generated token, then ``data: {"done": ...}``.
    GET /health -> {"status": "ok", "queued": N}
    GET /healthz -> 200 {"status": "ok", "queue_depth": N,
                         "engine_alive": true}; 503 with
      {"status": "unavailable", ...} when the engine loop is dead or
      the server is shutting down
    GET /metrics -> Prometheus text format

Metrics (``self.metrics``, always on): ``server_requests_total{code}``
(200/400/500/503, or "disconnect"), ``server_queue_depth`` (sampled at
scrape), ``server_request_seconds{code}`` (arrival → response) and
``server_first_token_seconds`` (arrival → first generated token), plus
``build_info``. The JAX frontend's per-request span tree
(``ServingTelemetry``, opted in by an environment variable) is not
ported: ``request_telemetry`` stays ``None``.

Error classification: request-validation failures are **400**; an
engine ``run()`` fault on admitted requests is **500** (the engine then
aborts its requests, so the next burst is served); shutdown or a dead
engine loop fails outstanding waiters with **503**. The SSE path has
committed 200 by the time the engine can fault, so stream errors ride a
terminal ``data: {"error": ...}`` event instead.
"""

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from sparkdl_tpu_torch.observe.metrics import Registry, ensure_build_info


def _status_safe(message):
    """One latin-1 line, bounded — the only shape ``send_error`` can
    put on an HTTP status line without corrupting the response."""
    message = " ".join(str(message).split())[:400]
    return message.encode("latin-1", "replace").decode("latin-1")


def parse_generate(raw, engine):
    """Parse + validate one ``/generate`` body against ``engine``'s
    capacity contract. Returns ``(req, parsed)``; raises ``KeyError``,
    ``TypeError``, ``ValueError`` or ``json.JSONDecodeError`` on
    anything a 400 should answer — one definition for the streamed and
    the blocking path."""
    req = json.loads(raw)
    parsed = {
        "tokens": [int(t) for t in req["tokens"]],
        "max_new_tokens": int(req.get("max_new_tokens", 32)),
        "stop": req.get("stop"),
    }
    if parsed["max_new_tokens"] < 1:
        raise ValueError("max_new_tokens must be >= 1")
    worst = engine._worst_case_tokens(
        len(parsed["tokens"]), parsed["max_new_tokens"])
    if worst > engine.cfg.max_cache_len:
        raise ValueError(
            f"prompt + budget ({worst}) exceeds max_cache_len "
            f"({engine.cfg.max_cache_len})")
    return req, parsed


def send_json(handler, code, obj):
    """One JSON response with correct framing."""
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def deliver_blocking(handler, box, record):
    """Answer a non-streamed request from its finished mailbox.
    ``record(outcome, t0)`` accounts the response (outcome = HTTP code,
    or "disconnect" when the client hung up mid-write)."""
    if box.error is not None:
        record(box.error_code, box.t0)
        handler.send_error(box.error_code, box.error)
        return
    outcome = "disconnect"
    try:
        toks, reason, lps = box.result
        send_json(handler, 200, {
            "tokens": [int(t) for t in toks],
            "finish_reason": reason,
            "logprobs": [float(v) for v in lps],
        })
        outcome = 200
    finally:
        record(outcome, box.t0)


def deliver_stream(handler, box, record):
    """Drain a mailbox's token stream to the client as SSE. The 200
    commits up front; the metric records the request's real outcome (a
    500 that rode a terminal error event counts as 500, a client that
    hung up mid-stream as "disconnect")."""
    outcome = "disconnect"
    try:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.end_headers()
        while True:
            tok = box.tokens.get()
            if tok is None:          # engine says done
                break
            handler.wfile.write(
                b"data: " + json.dumps({"token": tok}).encode() + b"\n\n")
            handler.wfile.flush()
        if box.error is not None:
            tail = {"error": box.error}
        else:
            tail = {"done": box.result[1]}
        handler.wfile.write(b"data: " + json.dumps(tail).encode() + b"\n\n")
        handler.wfile.flush()
        outcome = box.error_code if box.error is not None else 200
    finally:
        record(outcome, box.t0)


class _Mailbox:
    """Per-request rendezvous between the engine thread and one HTTP
    handler thread: a token stream and a final-result event."""

    def __init__(self):
        self.tokens = queue.Queue()
        self.done = threading.Event()
        self.result = None           # (tokens, finish_reason, logprobs)
        self.error = None
        self.error_code = 500        # set by fail(); 500 = engine fault
        self.t0 = time.perf_counter()  # arrival (latency metrics)
        self.first_token_seen = False

    def fail(self, code, message):
        """Fail the waiter with the HTTP status that says whose fault it
        was: 400 the request's, 500 the engine's, 503 the server's
        lifecycle (retry elsewhere). The message rides the status line,
        so it is collapsed to one bounded latin-1 line."""
        self.error_code = code
        self.error = _status_safe(message)
        self.tokens.put(None)
        self.done.set()


class ServingFrontend:
    """Run an engine behind an HTTP server.

    ``engine``: a :class:`~sparkdl_tpu_torch.models.serving.
    ContinuousBatchingEngine`, constructed by the caller (model, paging,
    quantization and sampling live there). ``start()`` spawns the engine
    and HTTP threads; ``close()`` stops both.
    """

    def __init__(self, engine, host="127.0.0.1", port=0):
        self.engine = engine
        self.metrics = Registry()
        # the JAX frontend's opt-in span tree is not ported
        self.request_telemetry = None
        self._arrivals = queue.Queue()   # (parsed request, _Mailbox)
        self._live = {}                  # rid -> _Mailbox
        self._shutdown = threading.Event()
        self._wake = threading.Event()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="sparkdl-torch-engine",
            daemon=True)
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet by default
                pass

            def _send(self, code, content_type, body):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    ensure_build_info(frontend.metrics)
                    frontend.metrics.gauge("server_queue_depth").set(
                        frontend._arrivals.qsize())
                    self._send(200, "text/plain; version=0.0.4; "
                               "charset=utf-8",
                               frontend.metrics.to_prometheus().encode())
                    return
                if self.path == "/healthz":
                    engine_alive = frontend._engine_thread.is_alive()
                    ok = engine_alive and not frontend._shutdown.is_set()
                    body = json.dumps({
                        "status": "ok" if ok else "unavailable",
                        "queue_depth": frontend._arrivals.qsize(),
                        "engine_alive": engine_alive,
                    }).encode()
                    self._send(200 if ok else 503, "application/json",
                               body)
                    return
                if self.path != "/health":
                    self.send_error(404)
                    return
                self._send(200, "application/json", json.dumps({
                    "status": "ok",
                    "queued": frontend._arrivals.qsize(),
                }).encode())

            def do_POST(self):
                if self.path != "/generate":
                    self.send_error(404)
                    return
                t0 = time.perf_counter()
                # parse and validate once, before any status line: the
                # streamed and blocking paths reject the same inputs
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req, parsed = parse_generate(
                        self.rfile.read(n), frontend.engine)
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    frontend._record_request(400, t0)
                    self.send_error(400, _status_safe(e))
                    return
                box = _Mailbox()
                frontend._arrivals.put((parsed, box))
                frontend._wake.set()
                if req.get("stream"):
                    deliver_stream(self, box, frontend._record_request)
                else:
                    box.done.wait()
                    deliver_blocking(self, box, frontend._record_request)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address

    def _record_request(self, code, t0):
        """One response accounted: class counter + latency histogram
        (labeled by code, so fast 400s do not pollute the p99s)."""
        code = str(code)
        self.metrics.counter("server_requests_total", code=code).inc()
        self.metrics.histogram("server_request_seconds", code=code).observe(
            time.perf_counter() - t0)

    # -- engine thread -----------------------------------------------

    def _poll_queue(self, _engine):
        """Pull arrivals into engine.submit — between bursts AND from
        run()'s progress hook, so a request arriving mid-burst is
        admitted as soon as a slot frees."""
        while True:
            try:
                req, box = self._arrivals.get_nowait()
            except queue.Empty:
                return
            try:
                rid = self.engine.submit(req["tokens"],
                                         req["max_new_tokens"],
                                         stop=req["stop"])
                self._live[rid] = box
            except (ValueError, TypeError) as e:
                # backstop: the handler pre-validates, but the engine
                # may still refuse the request (an empty prompt) — that
                # refusal is about the REQUEST, hence 400
                box.fail(400, str(e))

    def _engine_loop(self):
        try:
            self._serve_bursts()
        finally:
            # shutdown (or a loop crash) must not strand handler threads
            # on untimed waits: 503, retry against another replica
            self._poll_queue(self.engine)
            for box in self._live.values():
                box.fail(503, "server shutting down")
            self._live.clear()

    def _serve_bursts(self):
        def on_token(rid, tok):
            box = self._live.get(rid)
            if box is not None:
                if not box.first_token_seen:
                    box.first_token_seen = True
                    self.metrics.histogram(
                        "server_first_token_seconds").observe(
                            time.perf_counter() - box.t0)
                box.tokens.put(int(tok))

        while not self._shutdown.is_set():
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            self._poll_queue(self.engine)
            if not self._live and self._arrivals.empty():
                continue
            try:
                results = self.engine.run(progress=self._progress,
                                          on_token=on_token)
            except Exception as e:  # engine fault: fail the waiters
                for box in self._live.values():
                    box.fail(500, f"engine error: {e}")
                self._live.clear()
                # the engine still holds the poison request (queued or
                # mid-slot): drop it, or a deterministic fault re-fires
                # on every later burst
                self.engine.abort_requests()
                continue
            self._post({rid: (toks,
                              self.engine.finish_reasons.get(rid, "length"),
                              self.engine.logprobs.get(rid, []))
                        for rid, toks in results.items()})

    def _progress(self, engine):
        """``run()``'s progress hook: answer every request finished so
        far, then admit arrivals."""
        self._post(engine.take_finished())
        self._poll_queue(engine)

    def _post(self, finished):
        """Hand each finished request ``{rid: (tokens, finish reason,
        logprobs)}`` to its mailbox: the result, the stream's end, the
        blocking waiter's wake-up."""
        for rid, (toks, reason, lps) in finished.items():
            box = self._live.pop(rid, None)
            if box is None:
                continue
            box.result = (toks.tolist(), reason, lps)
            box.tokens.put(None)
            box.done.set()

    # -- lifecycle ----------------------------------------------------

    def start(self):
        self._engine_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="sparkdl-torch-http",
            daemon=True)
        self._http_thread.start()
        return self

    def close(self):
        self._shutdown.set()
        self._wake.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._engine_thread.join(timeout=30)
