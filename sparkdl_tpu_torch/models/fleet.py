"""One serving fleet: N continuous-batching engine replicas behind ONE
admission-controlled HTTP front-end.

Counterpart of ``sparkdl_tpu/models/fleet.py``. A single
:class:`~sparkdl_tpu_torch.models.server.ServingFrontend` is one engine
on one engine thread. This module adds the tier above it:

- :class:`EngineWorker` — one replica: an engine (built by the fleet's
  ``engine_factory``, so a replica can be REPLACED with a fresh one) on
  its own engine thread, draining its own arrival queue into
  ``engine.submit`` as the single front-end does. Replicas on one card
  may share one weight dict (the engine does not copy tensors already
  on its device, so only the KV caches are per replica); the weights
  stay read-only.
- :class:`GangWorker` — one tensor-parallel replica, spelled
  ``FleetFrontend(GangReplica(rank_factory, np=m), ...)``: a gang of
  ``m`` ranks started through the port's launcher
  (:func:`~sparkdl_tpu_torch.horovod.launcher.launch_gang`), each rank
  building its engine with ``rank_factory()`` (an engine with a
  ``mesh``). The JAX fleet takes an engine with a mesh from a
  zero-argument factory in its own process, as GSPMD drives all of it
  from there; the port's TP engine is one process a rank, so the fleet
  process builds none, and an engine with a mesh handed to
  :class:`EngineWorker` is refused by name. The gang's first rank takes
  the replica's arrivals over the gang's control plane (frame
  SERVE_REQ, JSON); before each engine step it broadcasts the step's
  admissions (and the replica's stop) to every rank, which all
  ``submit`` the same requests in the same order and step in lockstep
  (the engine broadcasts each sampled token); it sends each token and
  each finished or refused request back (SERVE_OUT), and the fleet
  delivers them through the same mailboxes, so admission control,
  routing, ``/fleet``, ``/metrics`` and ``/statusz`` see one replica.
  The death of any rank, the gang's hang verdict (telemetry on) and a
  replica with work but no token for ``hang_seconds`` are the
  replica's: its in-flight requests fail with 500, every rank of the
  gang is killed and a new gang is started. An engine fault in a rank
  ends the gang too (the ranks could not stay in lockstep past it).
  The engine-side hooks of :class:`_WorkerTelemetry` (queue wait,
  batch utilization, pages) run in the ranks and are not recorded.
- :class:`FleetFrontend` — the single public HTTP surface, with the SAME
  wire contract as ``ServingFrontend`` (the parse/deliver plumbing is
  imported from :mod:`~sparkdl_tpu_torch.models.server`), plus:

  * **Admission control**: total queued + in-flight work is bounded by
    ``max_queue``; arrivals above it are refused with **503** and a
    ``Retry-After`` header instead of queueing without bound
    (``server_admission_rejections_total{reason="overload"}``).
  * **Load-aware routing**: each request goes to the live replica with
    the smallest queue depth.
  * **Replica supervision**: a replica whose engine thread dies fails
    its in-flight requests with **500**, and a replica with work but no
    progress for ``hang_seconds`` (default 60 s) is declared hung,
    drained the same way, and REPLACED with a fresh engine from the
    factory (``server_replica_restarts_total{cause=...}``).

A started fleet registers with :mod:`~sparkdl_tpu_torch.observe.statusz`
(weakly; ``close`` unregisters it): any status server of the process shows
its replica table, and the alert engine's ``server_ttft`` and
``queue_depth_growth`` rules read it.

Each request is answered as soon as it finishes: the worker's progress
hook posts what ``engine.take_finished()`` hands over after every decode
chunk (the JAX worker answers its blocking clients only when ``run()``
returns).

Failure taxonomy (the single front-end's): 400 = the request's fault;
500 = the engine's or its replica's (engine fault, replica death,
replica hang); 503 = the fleet's lifecycle (admission refusal, no live
replicas, shutdown) — "retry later / elsewhere".

The fleet records its SLO histograms (``server_first_token_seconds``,
``server_ttft_seconds``, ``server_service_first_token_seconds``,
``server_inter_token_seconds``, ``server_queue_wait_seconds``) on its
own always-on registry through the engine's telemetry hooks
(:class:`_WorkerTelemetry`).
"""

import json
import os
import queue
import threading
import time
import types

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sparkdl_tpu_torch.models.server import (
    _Mailbox,
    _status_safe,
    deliver_blocking,
    deliver_stream,
    parse_generate,
    send_json,
)
from sparkdl_tpu_torch.observe.metrics import Registry, ensure_build_info

DEFAULT_HANG_S = 60.0

# engine_batch_utilization buckets, the JAX ServingTelemetry's
_UTIL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class _WorkerTelemetry:
    """The minimal engine-side telemetry adapter: implements exactly
    the hooks :class:`ContinuousBatchingEngine` calls behind its
    ``telemetry is not None`` test (``request_admitted`` /
    ``decode_chunk`` / ``request_pages`` / ``admission_deferred``),
    recording onto the
    fleet's shared registry: arrival→admission (queue wait) apart from
    admission→first-token (service)."""

    def __init__(self, worker):
        self._worker = worker
        self._metrics = worker._metrics

    def request_admitted(self, rid):
        box = self._worker._live.get(rid)
        if box is None:
            return
        box.admit_t = time.perf_counter()
        self._metrics.histogram("server_queue_wait_seconds").observe(
            box.admit_t - box.t0)

    def decode_chunk(self, active, n_slots, n_tokens,
                     free_pages=None, n_pages=None):
        # every chunk is liveness evidence — the hang detector keys
        # off this stamp, so a slow-but-moving replica is never killed
        self._worker._touch_progress()
        self._metrics.histogram(
            "engine_batch_utilization", buckets=_UTIL_BUCKETS
        ).observe(active / max(1, n_slots))

    def request_pages(self, rid, pages):
        # per-request KV-page footprint: the fleet-wide histogram sizes
        # the pools across replicas
        self._metrics.histogram(
            "engine_request_kv_pages",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0)).observe(pages)

    def admission_deferred(self, reason):
        self._metrics.counter(
            "engine_admission_deferrals_total", reason=reason).inc()


class _Server(ThreadingHTTPServer):
    # a burst of clients above max_queue is answered 503, so the listen
    # backlog must hold the burst (the standard library's 5 resets
    # connections past it)
    request_queue_size = 256


class EngineWorker:
    """One replica: an engine on its own thread. The threading
    contract is the single frontend's (every engine method runs on ONE
    thread; handler threads only enqueue and wait), replicated per
    worker — N workers give the fleet N independent engine threads."""

    def __init__(self, replica, engine_factory, metrics):
        self.replica = int(replica)
        engine = engine_factory()
        if getattr(engine, "mesh", None) is not None:
            raise NotImplementedError(
                "an engine with a mesh (a tensor-parallel rank) built in "
                "the fleet's process cannot serve alone: the JAX spelling "
                "(one GSPMD process) is not ported; a tensor-parallel "
                "replica is a gang, FleetFrontend(GangReplica(rank_factory,"
                " np=m))")
        self.engine = engine
        self._metrics = metrics
        self._arrivals = queue.Queue()   # (parsed request, _Mailbox)
        self._live = {}                  # engine rid -> _Mailbox
        self._lock = threading.Lock()    # guards _live + dead flag + last_progress
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._crash = None
        self.dead = False
        self.restart_cause = None        # set by the fleet supervisor
        self.last_progress = time.monotonic()
        # engine-side hooks: queue-wait stamps + liveness evidence
        self.engine.telemetry = _WorkerTelemetry(self)
        self._thread = threading.Thread(
            target=self._loop, name=f"sparkdl-engine-{replica}",
            daemon=True)

    # -- handler-thread surface ---------------------------------------

    @property
    def queued(self):
        """Arrivals not yet handed to the engine."""
        return self._arrivals.qsize()

    @property
    def inflight(self):
        """Requests the engine has admitted and not yet finished."""
        return len(self._live)

    @property
    def depth(self):
        """Queued + in-flight work (the load-aware routing signal)."""
        return self._arrivals.qsize() + len(self._live)

    @property
    def alive(self):
        return self._thread.is_alive() and not self.dead

    def start(self):
        self._thread.start()
        return self

    def submit(self, parsed, box):
        """Enqueue one request; raises RuntimeError when the worker is
        (or just went) dead so the router can pick a survivor."""
        with self._lock:
            if self.dead or self._stop.is_set():
                raise RuntimeError(f"replica {self.replica} is dead")
            # an IDLE worker's first arrival resets the hang clock
            # ("no progress" only means something once the engine has
            # work) — but never on a busy worker: sustained traffic
            # to a wedged replica must not keep deferring the hang
            # verdict while its clients wait
            if not self._live and self._arrivals.empty():
                self.last_progress = time.monotonic()
            # enqueue INSIDE the lock: declare_dead sets the flag
            # under it, so a box is either refused here or visible to
            # its drain — never parked on a dead worker forever
            self._arrivals.put((parsed, box))
        self._wake.set()

    def stop(self):
        self._stop.set()
        self._wake.set()

    def discard(self):
        """Drop a worker that was never started."""
        self.stop()

    def _touch_progress(self):
        """Liveness stamp, written under the lock: the engine thread
        (chunks, tokens, queue polls), handler threads (idle-arrival
        reset in submit) and the supervisor's hung() read all touch
        it — one guarded writer path keeps the updates ordered."""
        with self._lock:
            self.last_progress = time.monotonic()

    def join(self, timeout=None):
        self._thread.join(timeout)

    # -- supervision ---------------------------------------------------

    # the restart cause of a worker found dead
    death_cause = "death"

    def declare_dead(self, code, message):
        """Called by the fleet supervisor (hang verdict) OR by the
        engine thread's own epilogue: mark the worker dead and fail
        every in-flight and queued request so no client ever hangs on
        a wedged replica. Idempotent — whoever gets there first wins."""
        with self._lock:
            if self.dead:
                return
            self.dead = True
            failed = list(self._live.values())
            self._live.clear()
        while True:
            try:
                _, box = self._arrivals.get_nowait()
            except queue.Empty:
                break
            failed.append(box)
        for box in failed:
            box.fail(code, message)

    def hung(self, hang_seconds, now=None):
        """True when the replica holds work but its engine has shown
        no liveness (no chunk, no token, no burst iteration) for
        ``hang_seconds``."""
        if self.dead or not self.depth:
            return False
        now = time.monotonic() if now is None else now
        with self._lock:
            last = self.last_progress
        return now - last > hang_seconds

    # -- engine thread -------------------------------------------------

    def _loop(self):
        try:
            self._serve_bursts()
        except BaseException as e:   # loop death, not an engine fault
            self._crash = e
        finally:
            if self._stop.is_set() and self._crash is None:
                self.declare_dead(503, "server shutting down")
            else:
                # the replica DIED under admitted traffic: 500 — the
                # client sent nothing wrong, and unlike shutdown there
                # are surviving replicas to absorb the retry
                self.declare_dead(
                    500,
                    f"replica {self.replica} died: "
                    f"{self._crash or 'engine loop exited'}")

    def _poll_queue(self, _engine):
        """Drain arrivals into engine.submit — between bursts AND from
        run()'s progress hook (mid-burst admission)."""
        self._touch_progress()
        while True:
            try:
                parsed, box = self._arrivals.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                if self.dead:
                    # a hung replica that resumed after the supervisor
                    # drained it must not quietly adopt new work — the
                    # box would miss both the drain and the results map
                    box.fail(500,
                             f"replica {self.replica} was drained")
                    continue
            try:
                rid = self.engine.submit(
                    parsed["tokens"], parsed["max_new_tokens"],
                    stop=parsed["stop"],
                )
                with self._lock:
                    if self.dead:
                        self._live.pop(rid, None)
                        box.fail(500,
                                 f"replica {self.replica} was drained")
                    else:
                        self._live[rid] = box
            except (ValueError, TypeError) as e:
                # backstop: the handler pre-validates, but
                # engine-specific constraints can still refuse — that
                # refusal is about the REQUEST, hence 400
                box.fail(400, str(e))

    def _on_token(self, rid, tok):
        box = self._live.get(rid)
        if box is None or self.dead:
            # a supervisor-drained replica may limp on inside run();
            # its tokens go nowhere (the client already got its 500)
            return
        now = time.perf_counter()
        self._touch_progress()
        self._metrics.counter("server_generated_tokens_total").inc()
        if not box.first_token_seen:
            box.first_token_seen = True
            # BOTH existing names: server_first_token_seconds is the
            # single frontend's always-on series,
            # server_ttft_seconds its telemetry SLO twin — dashboards
            # written against either keep working on a fleet
            ttft = now - box.t0
            self._metrics.histogram(
                "server_first_token_seconds").observe(ttft)
            self._metrics.histogram(
                "server_ttft_seconds").observe(ttft)
            # service time = admission -> first token; falls back to
            # arrival when the engine admitted before the adapter saw
            # the box (sub-ms window)
            self._metrics.histogram(
                "server_service_first_token_seconds"
            ).observe(now - getattr(box, "admit_t", box.t0))
        else:
            last = getattr(box, "last_token_t", None)
            if last is not None:
                self._metrics.histogram(
                    "server_inter_token_seconds").observe(now - last)
        box.last_token_t = now
        box.tokens.put(int(tok))

    def _serve_bursts(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            self._poll_queue(self.engine)
            if not self._live and self._arrivals.empty():
                continue
            try:
                results = self.engine.run(progress=self._progress,
                                          on_token=self._on_token)
            except Exception as e:
                # engine FAULT (not death): fail this burst's waiters
                # with 500, abort the poison request out of the engine,
                # and keep the replica serving — the single front-end's
                # recovery contract
                with self._lock:
                    failed = list(self._live.values())
                    self._live.clear()
                for box in failed:
                    box.fail(500, f"engine error: {e}")
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
        logprobs)}`` to its mailbox."""
        for rid, (toks, reason, lps) in finished.items():
            with self._lock:
                box = self._live.pop(rid, None)
            if box is None:
                continue
            box.result = (toks.tolist(), reason, lps)
            box.tokens.put(None)
            box.done.set()


# how long a gang replica's first rank waits for arrivals before it
# steps the (idle) gang anyway: the broadcast that keeps every rank's
# loop in step, and how soon a stop reaches an idle gang
GANG_IDLE_S = 0.05
# how long the fleet waits for a new gang's engines (the launch, the
# weights, the engine) before it gives the gang up
GANG_START_S = 600.0


class GangReplica:
    """The spelling of a tensor-parallel fleet replica:
    ``FleetFrontend(GangReplica(rank_factory, np=m), replicas=N)``.

    Each replica is a gang started through
    :func:`~sparkdl_tpu_torch.horovod.launcher.launch_gang` with ``np``
    as ``HorovodRunner`` takes it (``np=m``: one rank a card, or a core
    under ``launcher.WORKER_DEVICE = "cpu"``, claiming slots; ``np=-m``:
    ``m`` local ranks, which may share a card). Every rank calls
    ``rank_factory()`` after ``hvd.init()``; it returns that rank's
    engine, built with ``mesh=make_mesh(...)`` over the gang (cloudpickled
    to the ranks with what it closes on)."""

    def __init__(self, rank_factory, *, np):
        if int(np) in (-1, 0, 1):
            raise ValueError(
                f"a gang replica has at least two ranks: np={np} (a "
                "single-process replica takes a zero-argument factory)")
        self.rank_factory = rank_factory
        self.np = int(np)


def _bcast_json(obj):
    """Rank 0's JSON-able ``obj`` on every rank of the gang: its length,
    then its bytes, over the gang's process group."""
    import torch

    from sparkdl_tpu_torch import hvd

    data = json.dumps(obj).encode("utf-8") if hvd.rank() == 0 else b""
    n = int(hvd.broadcast(torch.tensor([len(data)], dtype=torch.int64),
                          root_rank=0)[0])
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
           if hvd.rank() == 0 else torch.zeros(n, dtype=torch.uint8))
    buf = hvd.broadcast(buf, root_rank=0)
    return json.loads(bytes(buf.numpy()).decode("utf-8"))


class _RankLoop:
    """The serving loop of every rank of a gang replica. The first rank
    (``lead``) takes the fleet's SERVE_REQ frames from ``inbox`` and
    answers with SERVE_OUT; every rank steps its engine in lockstep."""

    def __init__(self, engine, lead, client, inbox):
        self.engine, self.lead = engine, lead
        self._client, self._inbox = client, inbox
        self._ids = {}     # engine rid -> the fleet's request id
        self._tokens = []  # (request id, token) not yet sent
        self._ticks = 0
        self.stopping = False

    def _collect(self, wait):
        """The lead's arrivals and stop since the last step."""
        submit, stop = [], False
        try:
            msg = (self._inbox.get(timeout=GANG_IDLE_S) if wait
                   else self._inbox.get_nowait())
            while True:
                submit.extend(msg.get("submit", ()))
                stop = stop or bool(msg.get("stop"))
                msg = self._inbox.get_nowait()
        except queue.Empty:
            pass
        return {"submit": submit, "stop": stop}

    def _step_in(self, wait):
        """One lockstep point: the lead's admissions broadcast, submitted
        by every rank in order (a request the engine refuses is refused
        on every rank alike); returns how many were admitted."""
        from sparkdl_tpu_torch import observe

        if observe.enabled():
            from sparkdl_tpu_torch.observe import health

            self._ticks += 1
            health.note_step(self._ticks)  # progress, idle or not
        msg = _bcast_json(self._collect(wait) if self.lead else None)
        admitted, refused = 0, []
        for req in msg["submit"]:
            try:
                rid = self.engine.submit(req["tokens"],
                                         req["max_new_tokens"],
                                         stop=req.get("stop"))
            except (ValueError, TypeError) as e:
                refused.append([req["id"], str(e)])
                continue
            self._ids[rid] = req["id"]
            admitted += 1
        if refused and self.lead:
            self._client.send_serve({"refused": refused})
        if msg["stop"]:
            self.stopping = True
            # in-flight work ends here; the fleet answers it 503
            self.engine.abort_requests()
        return admitted

    def _on_token(self, rid, tok):
        self._tokens.append([self._ids[rid], int(tok)])

    def _send(self, finished):
        """The lead's tokens so far and ``finished`` ({rid: (tokens,
        reason, logprobs)}) to the fleet, in one frame."""
        done = [[self._ids.pop(rid), [int(t) for t in toks], reason,
                 [float(v) for v in lps]]
                for rid, (toks, reason, lps) in finished.items()]
        if self._tokens or done:
            self._client.send_serve({"tokens": self._tokens, "done": done})
        self._tokens = []

    def _progress(self, engine):
        finished = engine.take_finished()
        if self.lead:
            self._send(finished)
        else:
            for rid in finished:
                self._ids.pop(rid, None)
        self._step_in(wait=False)

    def serve(self):
        while not self.stopping:
            if not self._step_in(wait=True) or self.stopping:
                continue
            results = self.engine.run(
                progress=self._progress,
                on_token=self._on_token if self.lead else None)
            finished = {rid: (toks, self.engine.finish_reasons[rid],
                              self.engine.logprobs[rid])
                        for rid, toks in results.items()}
            if self.lead:
                self._send(finished)
            else:
                for rid in finished:
                    self._ids.pop(rid, None)


def _serve_rank(rank_factory):
    """Every rank of a gang replica: join the gang, build this rank's
    engine, tell the fleet the engine's contract and the ranks' pids
    (the lead), then serve until the fleet's stop."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod.control_plane import get_worker_client

    hvd.init()
    engine = rank_factory()
    lead = hvd.rank() == 0
    client = get_worker_client() if lead else None
    inbox = queue.Queue()
    if lead:
        client.set_serve_handler(inbox.put)
    pids = hvd.allgather_object(os.getpid())
    if lead:
        client.send_serve({"hello": {
            "max_cache_len": int(engine.cfg.max_cache_len),
            "worst_extra": int(engine._worst_case_tokens(0, 0)),
            "n_slots": int(engine.n_slots), "pids": pids}})
    _RankLoop(engine, lead, client, inbox).serve()


class _Contract:
    """What the fleet validates a request against, as a gang replica's
    first rank reported its engine: ``cfg.max_cache_len`` and the worst
    case of rows a request touches."""

    def __init__(self, hello):
        self.cfg = types.SimpleNamespace(max_cache_len=hello["max_cache_len"])
        self._extra = hello["worst_extra"]
        self.n_slots = hello["n_slots"]

    def _worst_case_tokens(self, p_len, max_new):
        return p_len + max_new + self._extra


class GangWorker(EngineWorker):
    """One gang replica (:class:`GangReplica`): the gang is launched at
    construction (the ranks build their engines then, as a factory
    would), which returns once the first rank has reported its engine.
    The mailboxes, hang clock and failure paths are
    :class:`EngineWorker`'s; arrivals go to the gang at once (``queued``
    stays 0), tokens and results come back on the control plane's
    thread."""

    def __init__(self, replica, spec, metrics):
        self.replica = int(replica)
        self._spec = spec
        self._metrics = metrics
        self._arrivals = queue.Queue()  # unused: arrivals go to the gang
        self._live = {}                 # the fleet's request id -> _Mailbox
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._cancel = threading.Event()  # kills the gang's workers
        self._hello = threading.Event()
        self._server = None
        self._crash = None
        self._next_id = 0
        self.dead = False
        self.restart_cause = None
        self.last_progress = time.monotonic()
        self.engine = None
        self.pids = []         # the gang's ranks' processes, in rank order
        self.start_s = None    # seconds from the launch to the engines
        t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name=f"sparkdl-gang-{replica}", daemon=True)
        self._thread.start()
        deadline = time.monotonic() + GANG_START_S
        while not self._hello.wait(0.05):
            if not self._thread.is_alive():
                raise RuntimeError(
                    f"gang replica {replica} failed to start: "
                    f"{self._crash}") from self._crash
            if time.monotonic() > deadline:
                self._cancel.set()
                self._thread.join(30)
                raise RuntimeError(
                    f"gang replica {replica} built no engine within "
                    f"{GANG_START_S:g}s")
        self.start_s = time.monotonic() - t0

    @property
    def death_cause(self):
        kind = getattr(self._crash, "kind", None)
        return "hang" if kind == "hang" else "death"

    def start(self):
        return self  # the gang serves from its construction

    def discard(self):
        self.stop()
        self.join(10)

    def submit(self, parsed, box):
        with self._lock:
            if self.dead or self._stop.is_set():
                raise RuntimeError(f"replica {self.replica} is dead")
            if not self._live:
                self.last_progress = time.monotonic()
            rid = self._next_id
            self._next_id += 1
            self._live[rid] = box
        req = {"id": rid, "tokens": parsed["tokens"],
               "max_new_tokens": parsed["max_new_tokens"],
               "stop": parsed["stop"]}
        if not self._server.send_serve(0, {"submit": [req]}):
            with self._lock:
                self._live.pop(rid, None)
            raise RuntimeError(f"replica {self.replica}'s gang is gone")

    def stop(self):
        self._stop.set()
        if self._server is not None:
            self._server.send_serve(0, {"stop": True})

    def join(self, timeout=None):
        """Wait for the gang to end; past ``timeout`` kill it and reap
        its workers."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            self._cancel.set()
            self._thread.join(timeout)

    def declare_dead(self, code, message):
        super().declare_dead(code, message)
        self._cancel.set()  # every rank of the gang goes with it

    def _attach(self, server):
        self._server = server
        server.on_serve = self._on_serve

    def _serve_bursts(self):
        from sparkdl_tpu_torch.horovod import launcher, supervisor

        try:
            launcher.launch_gang(
                self._spec.np, _serve_rank,
                {"rank_factory": self._spec.rank_factory},
                "log_callback_only", policy=supervisor.RetryPolicy(),
                attach=self._attach, cancel=self._cancel)
        except supervisor.GangFailure as e:
            # a gang killed because it did not stop in time was stopped
            if not (self._stop.is_set() and e.kind == "cancelled"):
                raise

    def _on_serve(self, rank, msg):
        if rank != 0:
            return
        if "hello" in msg:
            self.engine = _Contract(msg["hello"])
            self.pids = list(msg["hello"]["pids"])
            self._hello.set()
        for rid, tok in msg.get("tokens", ()):
            self._on_token(rid, tok)
        if msg.get("done"):
            self._post({rid: (np.asarray(toks, np.int64), reason, lps)
                        for rid, toks, reason, lps in msg["done"]})
        for rid, error in msg.get("refused", ()):
            with self._lock:
                box = self._live.pop(rid, None)
            if box is not None:
                box.fail(400, error)


class FleetFrontend:
    """N engine replicas behind one admission-controlled HTTP server.

    ``engine_factory``: zero-arg callable building ONE engine (model,
    params, paging and the per-engine ``quant=`` mode all live in the
    closure) — called once per replica at start and again whenever the
    supervisor replaces a dead or hung replica; or a
    :class:`GangReplica`, whose every replica is a tensor-parallel gang
    (started, and started anew, likewise).

    ``max_queue``: total queued+in-flight bound; arrivals above it get
    503 + ``Retry-After``. ``None`` disables admission control.
    ``hang_seconds``: no-progress window before a replica with work is
    declared hung (default 60 s; size it above the longest prefill or
    decode chunk). ``respawn``: replace dead/hung replicas with fresh
    engines (metric ``server_replica_restarts_total{cause=...}``).

    API: ``POST /generate`` (identical wire contract to
    :class:`~sparkdl_tpu_torch.models.server.ServingFrontend`, streaming
    included), ``GET /health``, ``GET /healthz`` (200 while ≥1 replica
    lives, 503 draining), ``GET /fleet`` (per-replica states), and
    ``GET /metrics`` (Prometheus, always on).
    """

    def __init__(self, engine_factory, *, replicas=2, host="127.0.0.1",
                 port=0, max_queue=64, hang_seconds=None, respawn=True,
                 poll_seconds=0.25):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None), got {max_queue}")
        self._factory = engine_factory
        self.max_queue = max_queue
        self.respawn = bool(respawn)
        self.hang_seconds = (
            float(hang_seconds) if hang_seconds is not None
            else DEFAULT_HANG_S)
        self._poll_seconds = float(poll_seconds)
        self.metrics = Registry()
        self._workers = [self._make_worker(i) for i in range(replicas)]
        self._next_replica = replicas
        self._restarts = 0
        self._shutdown = threading.Event()
        self._workers_lock = threading.Lock()
        self._admission_lock = threading.Lock()
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="sparkdl-fleet-monitor",
            daemon=True)
        fleet = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet by default
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    fleet._sample_gauges()
                    body = fleet.metrics.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path == "/healthz":
                    states = fleet.replica_states()
                    n_alive = sum(s["alive"] for s in states)
                    ok = n_alive > 0 and not fleet._shutdown.is_set()
                    send_json(self, 200 if ok else 503, {
                        "status": "ok" if ok else "unavailable",
                        "replicas_alive": n_alive,
                        "replicas": len(states),
                        "queue_depth": fleet.queue_depth(),
                    })
                    return
                if self.path == "/fleet":
                    send_json(self, 200, {
                        "replicas": fleet.replica_states(),
                        "restarts": fleet._restarts,
                        "max_queue": fleet.max_queue,
                        "queue_depth": fleet.queue_depth(),
                    })
                    return
                if self.path != "/health":
                    self.send_error(404)
                    return
                send_json(self, 200, {
                    "status": "ok", "queued": fleet.queue_depth()})

            def do_POST(self):
                if self.path != "/generate":
                    self.send_error(404)
                    return
                t0 = time.perf_counter()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                    # replicas are homogeneous (one factory), so any
                    # engine's capacity contract validates
                    req, parsed = parse_generate(
                        raw, fleet._validation_engine())
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    fleet._record_request(400, t0)
                    self.send_error(400, _status_safe(e))
                    return
                # Admission control AFTER validation (a malformed
                # request is a 400 even on a saturated fleet) and
                # BEFORE enqueueing: above the bound the fleet answers
                # a fast 503 instead of growing an unbounded queue.
                # Depth check, ROUTING, and enqueue all happen under
                # ONE lock: N handler threads passing the check
                # together must not overshoot the bound by the burst
                # width, and routing must see each other's enqueues
                # or a simultaneous burst all ties onto replica 0
                # (the lock is held for queue bookkeeping only —
                # microseconds, never across engine work or waits).
                box = _Mailbox()
                with fleet._admission_lock:
                    if (fleet.max_queue is not None
                            and fleet.queue_depth()
                            >= fleet.max_queue):
                        admitted = None
                    else:
                        admitted = fleet._dispatch(parsed, box)
                if admitted is None:
                    fleet._reject(
                        self, t0, "overload",
                        f"queue full ({fleet.max_queue} in flight) — "
                        "retry later")
                    return
                if not admitted:
                    fleet._reject(self, t0, "no_live_replicas",
                                  "no live replicas")
                    return
                if req.get("stream"):
                    deliver_stream(self, box, fleet._record_request)
                else:
                    box.done.wait()
                    deliver_blocking(self, box,
                                     fleet._record_request)

        self._httpd = _Server((host, port), Handler)
        self.address = self._httpd.server_address

    def _make_worker(self, replica):
        if isinstance(self._factory, GangReplica):
            return GangWorker(replica, self._factory, self.metrics)
        return EngineWorker(replica, self._factory, self.metrics)

    # -- routing + admission -------------------------------------------

    def _validation_engine(self):
        """An engine for request validation (capacity contract only —
        replicas are homogeneous). Resolved at call time so a retired
        replica's engine (params, KV cache) is not pinned in memory
        for the frontend's lifetime."""
        with self._workers_lock:
            return self._workers[0].engine

    def queue_depth(self):
        """Total queued + in-flight across live replicas."""
        with self._workers_lock:
            return sum(w.depth for w in self._workers if w.alive)

    def replica_states(self):
        with self._workers_lock:
            return [{
                "replica": w.replica,
                "alive": bool(w.alive),
                "depth": w.depth,
                "queued": w.queued,
                "inflight": w.inflight,
                "restart_cause": w.restart_cause,
            } for w in self._workers]

    def _dispatch(self, parsed, box):
        """Route to the live replica with the least work and submit,
        falling over to survivors when it dies between routing and
        submit. False = nobody left. The tried-set is keyed by worker
        IDENTITY, not replica number — a respawned replica reuses its
        number, and skipping the fresh worker would 503 a request a
        live replica could serve."""
        tried = set()
        while True:
            with self._workers_lock:
                live = [w for w in self._workers
                        if w.alive and id(w) not in tried]
            if not live:
                return False
            worker = min(live, key=lambda w: w.depth)
            try:
                worker.submit(parsed, box)
                return True
            except RuntimeError:
                tried.add(id(worker))

    def _reject(self, handler, t0, reason, message):
        self.metrics.counter(
            "server_admission_rejections_total", reason=reason).inc()
        self._record_request(503, t0)
        handler.send_response(503, _status_safe(message))
        handler.send_header("Retry-After", "1")
        handler.send_header("Content-Length", "0")
        handler.end_headers()

    def _record_request(self, code, t0):
        code = str(code)
        self.metrics.counter("server_requests_total", code=code).inc()
        self.metrics.histogram(
            "server_request_seconds", code=code
        ).observe(time.perf_counter() - t0)

    def _sample_gauges(self):
        ensure_build_info(self.metrics)
        states = self.replica_states()
        self.metrics.gauge("server_queue_depth").set(
            sum(s["depth"] for s in states if s["alive"]))
        self.metrics.gauge("server_replicas_alive").set(
            sum(s["alive"] for s in states))
        for s in states:
            replica = str(s["replica"])
            self.metrics.gauge(
                "server_replica_queue_depth", replica=replica
            ).set(s["depth"])
            # the live split per replica: waiting vs admitted
            self.metrics.gauge(
                "fleet_replica_queue_depth", replica=replica
            ).set(s["queued"])
            self.metrics.gauge(
                "fleet_replica_inflight", replica=replica
            ).set(s["inflight"])

    # -- supervision ---------------------------------------------------

    def _monitor(self):
        """The serving twin of the gang hang detector: poll replicas,
        drain the wedged or dead ones (their waiters get 500 — retry
        against a survivor), and replace them with fresh engines."""
        while not self._shutdown.wait(self._poll_seconds):
            with self._workers_lock:
                workers = list(enumerate(self._workers))
            for i, w in workers:
                if self._shutdown.is_set():
                    return
                cause = None
                if not w._thread.is_alive() or w.dead:
                    cause = w.death_cause
                elif w.hung(self.hang_seconds):
                    cause = "hang"
                    w.declare_dead(
                        500,
                        f"replica {w.replica} hung (no progress for "
                        f"{self.hang_seconds:g}s)")
                if cause is None or w.restart_cause is not None:
                    continue
                w.restart_cause = cause
                self.metrics.counter(
                    "server_replica_restarts_total", cause=cause).inc()
                if not self.respawn:
                    continue
                # respawn on its OWN thread: engine construction can
                # take seconds (model init, quantization), and the
                # monitor must keep polling the OTHER replicas — a
                # second wedge during a respawn still gets drained
                # within its own hang window
                threading.Thread(
                    target=self._respawn, args=(w,),
                    name=f"sparkdl-fleet-respawn-{w.replica}",
                    daemon=True).start()

    def _respawn(self, old):
        """Build a fresh replica and install it in the dead worker's
        place (the wedged thread, if any, is left to die a daemon's
        death; the REPLICA identity moves to the fresh engine). Keyed
        by worker IDENTITY, not list index — an elastic ``scale_to``
        can reorder or drop slots while the factory runs, and
        installing over the wrong slot would orphan a live replica. A
        failing factory must not shrink the fleet forever: the slot is
        re-armed so the monitor retries on its poll cadence, with
        every attempt counted."""
        try:
            fresh = self._make_worker(old.replica)
        except Exception:
            self.metrics.counter(
                "server_replica_respawn_failures_total").inc()
            with self._workers_lock:
                # clearing restart_cause re-triggers the monitor's
                # death path next poll — paced retry, never a silent
                # permanent shrink (a broken factory shows up as this
                # failure counter climbing alongside restarts)
                if old in self._workers:
                    old.restart_cause = None
            return
        # install under the workers lock with a shutdown re-check:
        # close() snapshots the worker list under this same lock
        # after setting the flag, so a fresh replica is either seen
        # by close() (and stopped) or never started at all
        with self._workers_lock:
            if self._shutdown.is_set():
                fresh.discard()
                return
            try:
                slot = self._workers.index(old)
            except ValueError:
                # scaled away mid-respawn — the fleet no longer wants
                # this slot; the unstarted fresh worker is dropped
                fresh.discard()
                return
            fresh.start()
            self._restarts += 1
            self._workers[slot] = fresh

    # -- elastic scaling -----------------------------------------------

    def replica_count(self):
        """Current replica slot count (alive or respawning)."""
        with self._workers_lock:
            return len(self._workers)

    def scale_to(self, n):
        """Resize the fleet to ``n`` replica slots. Grow appends fresh
        engines with new replica numbers; shrink retires the
        highest-numbered slots, stopping them OUTSIDE the workers lock
        (drain can take an inference's worth of time). Returns the new
        slot count. No-op (returning the current count) after
        shutdown."""
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        grown = []
        while True:
            with self._workers_lock:
                need = n - len(self._workers)
            if need <= 0:
                break
            # build outside the lock — engine construction can take
            # seconds and request dispatch must keep flowing
            w = self._make_worker(self._next_replica)
            with self._workers_lock:
                if self._shutdown.is_set() or len(self._workers) >= n:
                    w.discard()
                    if self._shutdown.is_set():
                        return len(self._workers)
                    break
                self._next_replica += 1
                w.start()
                self._workers.append(w)
                grown.append(w.replica)
        retired = []
        with self._workers_lock:
            if self._shutdown.is_set():
                return len(self._workers)
            while len(self._workers) > n:
                retired.append(self._workers.pop())
        for w in retired:
            w.stop()
        for w in retired:
            w.join(timeout=10)
        if grown or retired:
            self.metrics.counter(
                "server_fleet_scalings_total",
                direction="grow" if grown else "shrink").inc()
        return self.replica_count()

    # -- lifecycle ----------------------------------------------------

    def start(self):
        from sparkdl_tpu_torch.observe.statusz import register_fleet

        # any status server of this process renders its replica table, and
        # the alert engine's fleet rules read it (weakly held)
        register_fleet(self)
        for w in self._workers:
            w.start()
        self._monitor_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="sparkdl-fleet-http",
            daemon=True)
        self._http_thread.start()
        return self

    def close(self):
        from sparkdl_tpu_torch.observe.statusz import unregister_fleet

        unregister_fleet(self)  # a closed fleet leaves the table at once
        self._shutdown.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        # snapshot under the lock AFTER setting shutdown: a racing
        # _respawn either installed first (snapshotted here) or sees
        # the flag and never starts
        with self._workers_lock:
            workers = list(self._workers)
        for w in workers:
            w.stop()
        for w in workers:
            w.join(timeout=10)
        self._monitor_thread.join(timeout=10)
