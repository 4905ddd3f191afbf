"""``sparkdl_tpu_torch.observe``: gang-wide metrics and a merged event
timeline riding the control plane, step attribution and MFU, gang
health, memory accounting and serving telemetry.

Counterpart of ``sparkdl_tpu/observe/__init__.py``, the instrumentation
facade the rest of the port calls:

- :mod:`~sparkdl_tpu_torch.observe.metrics`: the per-process registry;
- :mod:`~sparkdl_tpu_torch.observe.timeline`: spans and instants as
  Chrome trace events;
- :mod:`~sparkdl_tpu_torch.observe.aggregate`: the driver's merge of
  its ranks' telemetry into one run dir;
- :mod:`~sparkdl_tpu_torch.observe.perf`, ``health``, ``mem``,
  ``flightrec`` and ``serving``;
- the live tier: :mod:`~sparkdl_tpu_torch.observe.statusz` (the gang's
  ``/statusz``, ``/metrics``, ``/events`` and ``/capturez``),
  :mod:`~sparkdl_tpu_torch.observe.alerts` (the streaming rules),
  :mod:`~sparkdl_tpu_torch.observe.forensics` and
  :mod:`~sparkdl_tpu_torch.observe.capture` (alert-triggered
  ``torch.profiler`` windows over PROFILE_REQ / PROFILE_DONE);
- the readers of a run dir, a ledger or a live page:
  :mod:`~sparkdl_tpu_torch.observe.doctor`, ``compare``, ``trend`` and
  ``top``.

**Off by default.** The switch is the module setting
:data:`TELEMETRY_DIR` (None: off), read at call time; no environment
variable is read. With it None every helper is one test of that setting:
no thread starts, no CUDA call is made, nothing is allocated. The
:class:`~sparkdl_tpu_torch.observe.metrics.Registry` class itself is
always live when made explicitly (the serving frontend's ``/metrics``).

A gang's driver ships the worker-side settings (:func:`worker_settings`:
this module's, ``health.HEARTBEAT_S``, ``mem.SAMPLE_S``,
``flightrec.EVENTS`` and the capture service's ``capture.STEPS`` and
``capture.AT_STEP``) to each rank on its command line, or in a Spark
barrier task's closure; the rank applies them for the length of its run
(:func:`applied_settings`) and never reads them from its environment.

Worker-to-driver transport: in a gang worker the bootstrap registers the
control-plane client as the *sink* (:func:`set_sink`) and starts a
flusher (:func:`start_flusher`) that ships the cumulative metric
snapshot and the timeline events drained since the last flush as a
TELEMETRY frame every :data:`FLUSH_S` seconds, and once more before BYE.
"""

import contextlib
import itertools
import os
import socket
import sys
import threading

from sparkdl_tpu_torch.observe.metrics import Registry
from sparkdl_tpu_torch.observe.timeline import Timeline

# the switch: the root under which each run writes its run dir (None: off)
TELEMETRY_DIR = None
# seconds between a worker's telemetry flushes (<= 0: only the last one)
FLUSH_S = 5.0

__all__ = [
    "enabled", "telemetry_dir", "metrics", "timeline",
    "inc", "set_gauge", "observe_value", "span", "host_span",
    "instant", "complete",
    "set_sink", "flush", "start_flusher", "stop_flusher",
    "snapshot_payload", "new_run_dir", "Registry", "Timeline",
    "set_flight_recorder",
]

_registry = Registry()
_timeline = Timeline()
_sink = None                       # callable(payload dict) or None
_sink_lock = threading.Lock()      # serializes flush() payloads
_flusher = None
_flusher_stop = None
_run_seq = itertools.count()


def enabled():
    """True when :data:`TELEMETRY_DIR` is set."""
    return TELEMETRY_DIR is not None


def telemetry_dir():
    return TELEMETRY_DIR


def new_run_dir():
    """A fresh run dir under the telemetry root (``run-<pid>-<n>``):
    one gang launch, across its supervised attempts, writes one."""
    d = os.path.join(telemetry_dir(), f"run-{os.getpid()}-{next(_run_seq)}")
    os.makedirs(d, exist_ok=True)
    return d


def metrics():
    """This process's global registry (driver or worker side)."""
    return _registry


def timeline():
    """This process's global timeline."""
    return _timeline


# -- the settings a gang's driver ships to its ranks -------------------------


def _setting_owners():
    from sparkdl_tpu_torch.observe import capture, flightrec, health, mem

    return {"observe": sys.modules[__name__], "health": health, "mem": mem,
            "flightrec": flightrec, "capture": capture}


_WORKER_SETTINGS = (("observe", "TELEMETRY_DIR"), ("observe", "FLUSH_S"),
                    ("health", "HEARTBEAT_S"), ("mem", "SAMPLE_S"),
                    ("flightrec", "EVENTS"), ("capture", "STEPS"),
                    ("capture", "AT_STEP"))


def worker_settings():
    """The worker-side settings as they stand here (``{"module.NAME":
    value}``), or None with telemetry off: what a driver ships to its
    ranks."""
    if not enabled():
        return None
    owners = _setting_owners()
    return {f"{m}.{name}": getattr(owners[m], name)
            for m, name in _WORKER_SETTINGS}


def applied_settings(settings):
    """The driver's :func:`worker_settings` in force in this process for
    the length of the block (None: nothing changes), then the previous
    values back: a process that runs one rank after another (a reused
    Spark worker) takes each job's own."""
    return applied_module_settings(settings, _setting_owners)


@contextlib.contextmanager
def applied_module_settings(settings, owners):
    """``settings`` (``{"module.NAME": value}``) set on the modules that
    ``owners()`` names (``{"module": module}``) for the block, the
    previous values back after it; None or empty: nothing changes."""
    if not settings:
        yield
        return
    owners = owners()
    prev = {}
    for key, value in settings.items():
        m, name = key.split(".", 1)
        prev[key] = getattr(owners[m], name)
        setattr(owners[m], name, value)
    try:
        yield
    finally:
        for key, value in prev.items():
            m, name = key.split(".", 1)
            setattr(owners[m], name, value)


# -- recording helpers (no-ops when telemetry is off) ------------------------


def inc(name, value=1, **labels):
    if enabled():
        _registry.counter(name, **labels).inc(value)


def set_gauge(name, value, **labels):
    if enabled():
        _registry.gauge(name, **labels).set(value)


def observe_value(name, value, buckets=None, **labels):
    if enabled():
        _registry.histogram(name, buckets=buckets, **labels).observe(value)


class _NoopSpan:
    """The shared do-nothing context manager of the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


def span(name, cat="", **args):
    if not enabled():
        return _NOOP_SPAN
    return _timeline.span(name, cat=cat, **args)


def host_span(name, **args):
    """A ``cat="host"`` span: host work inside the step window (a
    checkpoint's host snapshot), attributed to the ``host_callback``
    component of :mod:`~sparkdl_tpu_torch.observe.perf`."""
    return span(name, cat="host", **args)


def instant(name, cat="", **args):
    if enabled():
        _timeline.instant(name, cat=cat, **args)


def complete(name, start, dur, cat="", tid=None, **args):
    """A complete event of explicit wall-clock start and duration
    (seconds), for blocks whose ends the caller timed."""
    if enabled():
        _timeline.complete(name, start, dur, cat=cat, tid=tid, **args)


# -- worker flush machinery ---------------------------------------------------


def set_sink(sink):
    """Where :func:`flush` ships payloads (a gang worker passes
    ``client.send_telemetry``); None unregisters."""
    global _sink
    _sink = sink


def set_flight_recorder(rec):
    """Mirror every timeline event into ``rec`` (a
    :class:`~sparkdl_tpu_torch.observe.flightrec.FlightRecorder`); None
    unregisters (the caller closes the recorder)."""
    _timeline.observer = rec.record if rec is not None else None


def snapshot_payload():
    """One flush: host and pid, the cumulative metric snapshot and the
    timeline events drained since the last flush."""
    return {
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "metrics": _registry.snapshot(),
        "events": _timeline.drain(),
    }


def flush(lock_timeout=5.0):
    """Ship a payload to the sink now; False without a sink, with
    telemetry off, or when another flush holds the lock past
    ``lock_timeout`` (a wedged send must not hold up BYE)."""
    sink = _sink
    if sink is None or not enabled():
        return False
    if not _sink_lock.acquire(timeout=lock_timeout):
        return False
    try:
        try:
            sink(snapshot_payload())
        except Exception:
            return False  # telemetry never takes the process down
    finally:
        _sink_lock.release()
    return True


def start_flusher(interval=None):
    """The periodic flush thread (worker side), every ``interval``
    seconds (None: :data:`FLUSH_S`); idempotent. An interval <= 0 starts
    none (the last flush still goes)."""
    global _flusher, _flusher_stop
    if _flusher is not None and _flusher.is_alive():
        return _flusher
    interval = float(FLUSH_S if interval is None else interval)
    if interval <= 0:
        return None
    _flusher_stop = stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            flush()

    _flusher = threading.Thread(target=loop, name="sparkdl-torch-flush",
                                daemon=True)
    _flusher.start()
    return _flusher


def stop_flusher():
    global _flusher, _flusher_stop
    if _flusher_stop is not None:
        _flusher_stop.set()
    if _flusher is not None:
        _flusher.join(timeout=5.0)
    _flusher = None
    _flusher_stop = None


def _reset_for_tests():
    """Fresh state: empty registry and timeline (no flight-recorder
    mirror), no sink or flusher, health, perf and mem state cleared.
    The settings are the caller's."""
    global _registry, _timeline, _sink
    stop_flusher()
    _registry = Registry()
    _timeline = Timeline()
    _sink = None
    from sparkdl_tpu_torch.observe import health, mem, perf

    health._reset_for_tests()
    perf._reset_for_tests()
    mem._reset_for_tests()
