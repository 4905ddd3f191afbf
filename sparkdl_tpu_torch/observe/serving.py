"""Request-level serving telemetry: each request's span tree through the
continuous-batching engine, the SLO histograms, and the run dir a
serving box leaves behind.

Counterpart of ``sparkdl_tpu/observe/serving.py``; the class is the JAX
package's code. One :class:`ServingTelemetry` rides a
:class:`~sparkdl_tpu_torch.models.server.ServingFrontend`, which makes
it only when the telemetry switch (``observe.TELEMETRY_DIR``) is on;
otherwise ``frontend.request_telemetry`` and ``engine.telemetry`` stay
None and every hook site is one ``is not None`` test.

**Span tree** (``cat="serving"``), one track a request (``tid = rid``),
its instants ordered ``request.submit <= request.admit <=
request.first_token <= request.done``::

    request                  X  arrival -> generation done
      request.queue_wait     X  arrival -> slot admission
      request.submit         i  handed to engine.submit
      request.admit          i  the engine started its prefill
      request.first_token    i  first generated token (args: ttft_s)
      request.done           i  finished (args: code, tokens,
                                tokens_per_sec)
    request.reject           i  refused before admission

The port's frontend answers each request when it ends, not when the
burst drains, so ``request.done`` falls at that request's own end.

**SLO metrics**, in the frontend's own registry (its ``GET /metrics``):
``server_ttft_seconds``, ``server_inter_token_seconds``,
``server_queue_wait_seconds``, ``server_tokens_per_sec``,
``server_generated_tokens_total``,
``server_admission_rejections_total{reason}``; and the engine's:
``engine_batch_utilization``, ``engine_active_slots``,
``engine_slot_occupancy``, ``engine_kv_page_occupancy`` (and its
``_high_water``), ``engine_request_kv_pages``,
``engine_decode_chunks_total``, ``engine_decode_tokens_total``,
``engine_admission_deferrals_total{reason}``.

**Run dir**: :meth:`ServingTelemetry.write` leaves ``timeline.json``
(one "server" lane), ``metrics.prom`` and ``metrics.json`` (series
labeled ``rank="server"``) in a fresh run dir under the telemetry root,
and every event is mirrored into a flight-recorder ring there, so a
SIGKILLed server's request tail is recoverable. :data:`WRITE_S` (the
periodic write) and :data:`MAX_EVENTS` (the retained trace) are
constants (the defaults of the JAX package's ``SPARKDL_TPU_SERVING_*``
variables).
"""

import json
import os
import socket
import threading
import time

from sparkdl_tpu_torch.observe.metrics import render_json, render_prometheus
from sparkdl_tpu_torch.observe.timeline import chrome_trace

SERVER_LABEL = "server"

# seconds between periodic run-dir writes (<= 0: only close() writes)
WRITE_S = 30.0
# events the re-rendered trace keeps (the newest; the rest are counted)
MAX_EVENTS = 100_000

# Per-request decode rates span small CPU rigs (a few tok/s) through
# batched card serving (thousands).
RATE_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                500.0, 1000.0, 2500.0, 5000.0, 10000.0)

# utilization lives in [0, 1]: sixteenths resolve a slot at n_slots <= 16
UTIL_BUCKETS = tuple(i / 16 for i in range(1, 17))

# per-request KV-page footprints, a one-page prompt to a pool-filler
PAGE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                512.0)


class ServingTelemetry:
    """One serving run's request instrumentation + artifact writer.

    ``registry`` is the frontend's own (always-on) metrics registry —
    SLO series land next to the request-class counters on the same
    ``GET /metrics``. The timeline is this instance's OWN
    :class:`~sparkdl_tpu_torch.observe.timeline.Timeline` (not the
    process-global one): a frontend hosted inside a telemetry-enabled
    gang worker must not steal events the worker's flusher would ship
    to the driver, and two frontends in one process must not drain
    each other — the serving run dir owns exactly its own story. The
    flight-recorder mirror hangs off this private timeline's
    ``observer`` hook, so no process-global observer is touched
    either.

    Threading: per-request state (``_req``) is touched only on the
    engine thread (submit/admit/token/done all run there — the
    frontend's ``_poll_queue`` and result loop included); arrival and
    rejection hooks run on handler threads but touch only the
    thread-safe registry/timeline and the request's own mailbox.
    """

    def __init__(self, registry, run_dir=None, max_events=None):
        from sparkdl_tpu_torch import observe
        from sparkdl_tpu_torch.observe.flightrec import (
            FlightRecorder,
            ring_path,
        )
        from sparkdl_tpu_torch.observe.timeline import Timeline

        self.registry = registry
        self.timeline = Timeline()
        self.run_dir = run_dir or observe.new_run_dir()
        self._events = []        # drained-but-retained (rewrites render all)
        self._closed = False
        self.max_events = int(MAX_EVENTS if max_events is None
                              else max_events)
        self._dropped = 0
        self._pool_high_water = 0.0   # worst KV-page occupancy seen
        self._write_lock = threading.Lock()  # writer thread vs close()
        self._writer = None
        self._writer_stop = None
        # Crash story: mirror every event into an mmap ring in the run
        # dir — a SIGKILLed server never reaches write(), but the
        # kernel writes the MAP_SHARED pages back anyway and the
        # doctor recovers the request tail from the ring alone. The
        # mirror rides THIS timeline's observer hook (private, never
        # the global observe.set_flight_recorder — a gang worker's own
        # ring must stay untouched).
        self._flight = FlightRecorder(ring_path(self.run_dir, 0))
        self.timeline.observer = self._flight.record
        self._req = {}           # rid -> lifecycle state

    # -- frontend hooks (HTTP side) -----------------------------------

    def request_arrived(self, box, prompt_len, max_new, stream):
        """Stamp the mailbox with the request's wall-clock arrival
        (its ``t0`` perf stamp already exists) — queue wait and TTFT
        measure from here, 400s included."""
        box.obs_wall0 = time.time()
        box.obs_meta = (int(prompt_len), int(max_new), bool(stream))

    def request_rejected(self, code, reason):
        """Refused before admission (validation 400, engine-specific
        submit refusal): no rid, no span tree — one instant + the
        rejection counter the doctor breaks down by reason."""
        self.registry.counter(
            "server_admission_rejections_total", reason=reason).inc()
        self.timeline.instant("request.reject", cat="serving",
                              code=int(code), reason=reason)

    def request_submitted(self, rid, box):
        """The engine thread handed the request to ``engine.submit``
        — the span tree's root opens here (engine thread only)."""
        wall0 = getattr(box, "obs_wall0", None) or time.time()
        meta = getattr(box, "obs_meta", (0, 0, False))
        self._req[rid] = {
            "wall0": wall0, "perf0": box.t0,
            "prompt_len": meta[0], "max_new": meta[1],
            "stream": meta[2],
            "admit_wall": None, "admit_perf": None,
            "first_perf": None, "last_perf": None, "tokens": 0,
        }
        self.timeline.instant("request.submit", cat="serving", tid=rid,
                              rid=rid, prompt_len=meta[0],
                              max_new=meta[1])

    def token(self, rid):
        """One generated token reached the frontend: first token
        observes TTFT, every later one the inter-token gap."""
        st = self._req.get(rid)
        if st is None:
            return
        now = time.perf_counter()
        st["tokens"] += 1
        self.registry.counter("server_generated_tokens_total").inc()
        if st["first_perf"] is None:
            st["first_perf"] = now
            ttft = now - st["perf0"]
            self.registry.histogram("server_ttft_seconds").observe(ttft)
            self.timeline.instant("request.first_token", cat="serving",
                                  tid=rid, rid=rid,
                                  ttft_s=round(ttft, 6))
        else:
            self.registry.histogram(
                "server_inter_token_seconds"
            ).observe(now - st["last_perf"])
        st["last_perf"] = now

    def request_done(self, rid, code=200):
        """Generation finished (or the request was failed): close the
        span tree and observe the per-request rate."""
        st = self._req.pop(rid, None)
        if st is None:
            return
        now_perf = time.perf_counter()
        total_s = now_perf - st["perf0"]
        ttft = (st["first_perf"] - st["perf0"]
                if st["first_perf"] is not None else None)
        queue_wait = (st["admit_perf"] - st["perf0"]
                      if st["admit_perf"] is not None else None)
        # Decode rate over the request's whole residency (admission
        # included): tokens / (arrival -> done). Failed requests that
        # never produced a token observe nothing.
        tps = None
        if st["tokens"] and total_s > 0:
            tps = st["tokens"] / total_s
            self.registry.histogram(
                "server_tokens_per_sec", buckets=RATE_BUCKETS
            ).observe(tps)
        self.timeline.instant(
            "request.done", cat="serving", tid=rid, rid=rid,
            code=int(code), tokens=st["tokens"],
            tokens_per_sec=round(tps, 3) if tps else None,
        )
        if queue_wait is not None:
            self.timeline.complete(
                "request.queue_wait", st["wall0"], queue_wait,
                cat="serving", tid=rid, rid=rid,
            )
        self.timeline.complete(
            "request", st["wall0"], total_s, cat="serving", tid=rid,
            rid=rid, code=int(code), tokens=st["tokens"],
            ttft_s=round(ttft, 6) if ttft is not None else None,
            queue_wait_s=(round(queue_wait, 6)
                          if queue_wait is not None else None),
            tokens_per_sec=round(tps, 3) if tps else None,
            stream=st["stream"], prompt_len=st["prompt_len"],
        )

    # -- engine hooks (models/serving.py, behind `telemetry is not
    # -- None` on the engine side) ------------------------------------

    def request_admitted(self, rid):
        """The engine pulled the request off its queue and is starting
        its prefill — queue wait ends here."""
        st = self._req.get(rid)
        if st is None:
            return
        st["admit_wall"] = time.time()
        st["admit_perf"] = time.perf_counter()
        self.registry.histogram("server_queue_wait_seconds").observe(
            st["admit_perf"] - st["perf0"])
        self.timeline.instant("request.admit", cat="serving", tid=rid,
                              rid=rid)

    def decode_chunk(self, active, n_slots, n_tokens,
                     free_pages=None, n_pages=None):
        """Once per decode chunk (or speculation round): the batch
        shape that explains WHY latency moved."""
        util = active / max(1, n_slots)
        self.registry.histogram(
            "engine_batch_utilization", buckets=UTIL_BUCKETS
        ).observe(util)
        self.registry.gauge("engine_active_slots").set(active)
        self.registry.gauge("engine_slot_occupancy").set(util)
        self.registry.counter("engine_decode_chunks_total").inc()
        # tokens DISPATCHED (active slots x chunk steps) vs the
        # accepted server_generated_tokens_total: the delta is
        # host-discarded overshoot (mid-chunk eos/budget) — decode
        # compute the chunk granularity wastes
        self.registry.counter("engine_decode_tokens_total").inc(
            active * n_tokens)
        if n_pages:
            # page 0 is the reserved junk dump, never allocatable
            pool = max(1, n_pages - 1)
            occupancy = (pool - free_pages) / pool
            self.registry.gauge("engine_kv_page_occupancy").set(
                occupancy)
            if occupancy > self._pool_high_water:
                self._pool_high_water = occupancy
                self.registry.gauge(
                    "engine_kv_page_occupancy_high_water"
                ).set(occupancy)

    def request_pages(self, rid, pages):
        """Admission computed this request's worst-case KV-page
        footprint (prompt + max_new, shared prefix pages excluded) —
        the per-request memory cost distribution pool sizing is done
        against."""
        self.registry.histogram(
            "engine_request_kv_pages", buckets=PAGE_BUCKETS
        ).observe(pages)

    def admission_deferred(self, reason):
        """Capacity admission control kicked in (request left queued,
        not refused) — e.g. the paged pool can't cover the queue
        head's worst case yet."""
        self.registry.counter(
            "engine_admission_deferrals_total", reason=reason).inc()

    # -- artifacts -----------------------------------------------------

    def write(self):
        """Write the run-dir artifacts (same shapes as a training
        gang's: ``timeline.json`` + ``metrics.prom`` +
        ``metrics.json``), atomically. Idempotent — a later write
        re-renders everything retained so far. A serving box runs
        indefinitely, so the retained trace is BOUNDED: beyond
        ``max_events`` the oldest events are dropped and counted in
        the trace's ``dropped_events`` (metrics are cumulative and
        lose nothing). Returns the paths."""
        with self._write_lock:
            self._events.extend(self.timeline.drain())
            if len(self._events) > self.max_events:
                drop = len(self._events) - self.max_events
                del self._events[:drop]
                self._dropped += drop
            host = socket.gethostname()
            trace = chrome_trace(
                [(0, f"{SERVER_LABEL} @ {host}", self._events)])
            if self._dropped:
                trace["dropped_events"] = self._dropped
            labeled = [({"rank": SERVER_LABEL}, self.registry.snapshot())]
            files = [
                ("timeline.json", json.dumps(trace)),
                ("metrics.prom", render_prometheus(labeled)),
                ("metrics.json", render_json(labeled, indent=2)),
            ]
            paths = {}
            for name, text in files:
                path = os.path.join(self.run_dir, name)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, path)
                paths[name] = path
            self._flight.flush()
            return paths

    def start_writer(self, interval=None):
        """Periodic :meth:`write` on a daemon thread: a long-running
        server keeps its run dir current (the artifacts are readable
        mid-run, not only after close) and its in-memory event buffer
        drained. Idempotent; ``interval <= 0`` disables (returns
        None) — the close-time write still happens."""
        if self._writer is not None and self._writer.is_alive():
            return self._writer
        interval = float(WRITE_S if interval is None else interval)
        if interval <= 0:
            return None
        self._writer_stop = stop = threading.Event()

        def loop():
            while not stop.wait(interval):
                try:
                    self.write()
                except Exception:
                    pass  # telemetry never takes down the server

        self._writer = threading.Thread(
            target=loop, name="sparkdl-torch-serving-write",
            daemon=True)
        self._writer.start()
        return self._writer

    def stop_writer(self):
        if self._writer_stop is not None:
            self._writer_stop.set()
        if self._writer is not None:
            self._writer.join(timeout=5.0)
        self._writer = None
        self._writer_stop = None

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.stop_writer()
        self.timeline.observer = None
        self._flight.close()
