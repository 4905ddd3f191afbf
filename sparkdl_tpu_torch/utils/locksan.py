"""Opt-in runtime lock-order sanitizer ("tsan-lite").

Counterpart of ``sparkdl_tpu/utils/locksan.py``. The static twin
(:mod:`sparkdl_tpu_torch.analysis.concur`) reasons about the lock graph
it can see lexically; this module *observes* the real one. With
:data:`ENABLED` set (the JAX package's ``SPARKDL_TPU_CONCUR_SAN``; no
environment variable is read) the ``threading.Lock`` /
``threading.RLock`` factories are replaced with thin instrumented
wrappers that record, per thread, the stack of locks currently held and
the Python stack at each acquisition. From that it maintains the
observed lock-order graph — an edge A→B for every acquisition of B
while A is held — and reports:

- **inversions**: acquiring B-after-A when A-after-B was already
  witnessed (the classic ABBA shape, caught even when the two threads
  never actually overlap — that is the whole point of order-based
  detection), with BOTH acquisition stacks;
- **long holds**: a lock held at least :data:`HOLD_WARN_S` seconds;
- the full edge set, for offline comparison with the static graph.

Every event lands on the observability timeline (``concur.*`` instants,
when telemetry is on) and in a ``concur_report.json`` artifact written
at interpreter exit to :data:`REPORT` (or
``<observe.TELEMETRY_DIR>/concur_report.json`` when only telemetry is
configured), suffixed ``-rank-N`` in a gang rank. The supervisor and
every worker call :func:`maybe_install` at boot, and a driver ships the
four settings to its ranks with its rank settings, so a gang run with
``ENABLED`` doubles as a sanitizer run.

Locks are named by construction site (``file:line``); all instances
born at one site share a graph node, which is what makes the order
graph meaningful across per-object locks. The flip side: nesting two
*instances* from the same site is indistinguishable from a self-cycle,
so same-site edges are ignored for inversion purposes.
"""

import atexit
import json
import os
import threading
import time
import traceback

# the module settings that replace the JAX package's environment knobs
# (SPARKDL_TPU_CONCUR_SAN, _HOLD_WARN_S, _REPORT, _STACK_DEPTH), read at
# call time: the switch of maybe_install
ENABLED = False
# a lock held at least this many seconds lands in the report
HOLD_WARN_S = 1.0
# the report's path (None: <observe.TELEMETRY_DIR>/concur_report.json
# with the telemetry on, else no file)
REPORT = None
# frames kept of each recorded acquisition stack
STACK_DEPTH = 12
# what a driver ships to its ranks when they are set
SETTINGS = ("ENABLED", "HOLD_WARN_S", "REPORT", "STACK_DEPTH")

REPORT_SCHEMA = "sparkdl_tpu.concur_report/1"

# The real factories, captured at import so install/uninstall always
# round-trips even if someone reorders calls.
_real_lock = threading.Lock
_real_rlock = threading.RLock

_installed = False
_rank = None  # a gang rank's: its report's suffix
_state_lock = _real_lock()
_tls = threading.local()

# site -> instance counter (naming), (a_site, b_site) -> edge record
_sites = {}
_edges = {}
_inversions = []
_long_holds = []
_MAX_RECORDS = 200


def settings():
    """The four settings, ``{"NAME": value}``, when :data:`ENABLED` is
    set (else ``{}``): what a driver ships to its ranks."""
    if not ENABLED:
        return {}
    return {name: globals()[name] for name in SETTINGS}


def _site_name():
    """file:line of the frame that called threading.Lock()/RLock(),
    skipping this module and threading internals."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename.replace("\\", "/")
        if fn.endswith("utils/locksan.py") or "/threading.py" in fn \
                or "/logging/" in fn:
            continue
        short = "/".join(fn.split("/")[-3:])
        return f"{short}:{frame.lineno}"
    return "<unknown>"


def _stack_text():
    depth = int(STACK_DEPTH)
    frames = traceback.extract_stack()
    # drop locksan + threading frames from the tail
    while frames and (
            frames[-1].filename.replace("\\", "/").endswith(
                "utils/locksan.py")
            or "/threading.py" in frames[-1].filename.replace(
                "\\", "/")):
        frames.pop()
    return "".join(traceback.format_list(frames[-depth:]))


def _held():
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _emit_instant(name, **kw):
    try:
        from sparkdl_tpu_torch import observe

        if observe.enabled():
            observe.instant(name, cat="concur", **kw)
    except Exception:
        pass


def _on_acquired(site, instance_id):
    """Record edges + detect inversions. Returns the held-list entry.
    Re-entrancy guarded: acquisitions made while reporting (observe's
    own locks) are not recorded."""
    if getattr(_tls, "in_callback", False):
        return None
    _tls.in_callback = True
    try:
        now = time.monotonic()
        stack = _stack_text()
        held = _held()
        events = []
        with _state_lock:
            for h in held:
                a, b = h["site"], site
                if a == b:
                    continue
                if (a, b) not in _edges:
                    _edges[(a, b)] = {
                        "held_stack": h["stack"],
                        "acq_stack": stack,
                        "thread": threading.current_thread().name,
                        "count": 1,
                    }
                    rev = _edges.get((b, a))
                    if rev is not None and len(_inversions) < \
                            _MAX_RECORDS:
                        inv = {
                            "locks": [a, b],
                            "first": {
                                "order": f"{b} -> {a}",
                                "held_stack": rev["held_stack"],
                                "acquiring_stack": rev["acq_stack"],
                                "thread": rev["thread"],
                            },
                            "second": {
                                "order": f"{a} -> {b}",
                                "held_stack": h["stack"],
                                "acquiring_stack": stack,
                                "thread":
                                    threading.current_thread().name,
                            },
                        }
                        _inversions.append(inv)
                        events.append(("concur.inversion",
                                       {"locks": [a, b]}))
                else:
                    _edges[(a, b)]["count"] += 1
        entry = {"site": site, "id": instance_id, "stack": stack,
                 "t": now}
        held.append(entry)
        for name, kw in events:
            _emit_instant(name, **kw)
        return entry
    finally:
        _tls.in_callback = False


def _on_released(entry):
    if entry is None:
        return
    if getattr(_tls, "in_callback", False):
        return
    _tls.in_callback = True
    try:
        held = _held()
        if entry in held:
            held.remove(entry)
        dt = time.monotonic() - entry["t"]
        if dt >= float(HOLD_WARN_S):
            with _state_lock:
                if len(_long_holds) < _MAX_RECORDS:
                    _long_holds.append({
                        "lock": entry["site"],
                        "held_s": round(dt, 4),
                        "thread": threading.current_thread().name,
                        "stack": entry["stack"],
                    })
            _emit_instant("concur.long_hold", lock=entry["site"],
                          held_s=round(dt, 4))
    finally:
        _tls.in_callback = False


class _SanLockBase:
    """Common instrumentation. Subclasses pick the inner primitive."""

    def __init__(self):
        with _state_lock:
            n = _sites.get(self._site, 0)
            _sites[self._site] = n + 1
        self._instance = f"{self._site}#{n}"
        self._entries = {}  # thread id -> held entry (outermost)

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self):
        self._note_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _at_fork_reinit(self):
        # CPython's fork-reinit protocol: stdlib modules register
        # their module-level locks with os.register_at_fork (e.g.
        # concurrent.futures.thread's _global_shutdown_lock) — a
        # wrapper without this dies at first import under install().
        self._inner._at_fork_reinit()
        self._entries.clear()

    def __repr__(self):
        return f"<SanLock {self._instance} wrapping {self._inner!r}>"


class SanLock(_SanLockBase):
    def __init__(self):
        self._site = _site_name()
        self._inner = _real_lock()
        super().__init__()

    def _note_acquired(self):
        tid = threading.get_ident()
        self._entries[tid] = _on_acquired(self._site, self._instance)

    def _note_released(self):
        tid = threading.get_ident()
        _on_released(self._entries.pop(tid, None))

    def locked(self):
        return self._inner.locked()


class SanRLock(_SanLockBase):
    def __init__(self):
        self._site = _site_name()
        self._inner = _real_rlock()
        self._owner = None
        self._count = 0
        super().__init__()

    def _note_acquired(self):
        tid = threading.get_ident()
        if self._owner == tid:
            self._count += 1
            return
        self._owner = tid
        self._count = 1
        self._entries[tid] = _on_acquired(self._site, self._instance)

    def _note_released(self):
        tid = threading.get_ident()
        if self._owner != tid:
            return
        self._count -= 1
        if self._count == 0:
            self._owner = None
            _on_released(self._entries.pop(tid, None))

    def _is_owned(self):
        return self._owner == threading.get_ident()

    def _at_fork_reinit(self):
        self._inner._at_fork_reinit()
        self._entries.clear()
        self._owner = None
        self._count = 0

    # Condition.wait over a recursively-held RLock must fully release
    # it; the real RLock exposes these and so must the wrapper.
    def _release_save(self):
        tid = threading.get_ident()
        entry = self._entries.pop(tid, None)
        count, self._count = self._count, 0
        self._owner = None
        _on_released(entry)
        return (self._inner._release_save(), count)

    def _acquire_restore(self, state):
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        tid = threading.get_ident()
        self._owner = tid
        self._count = count
        self._entries[tid] = _on_acquired(self._site, self._instance)


def installed():
    return _installed


def install():
    """Swap the ``threading`` lock factories for the instrumented
    wrappers. Idempotent; locks created before install stay raw."""
    global _installed
    if _installed:
        return
    threading.Lock = SanLock
    threading.RLock = SanRLock
    _installed = True
    atexit.register(_atexit_report)


def uninstall():
    """Restore the real factories. Already-created wrapped locks keep
    working (and keep recording); state survives for report()."""
    global _installed
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    _installed = False


def reset():
    """Drop all recorded state (test isolation)."""
    with _state_lock:
        _sites.clear()
        _edges.clear()
        del _inversions[:]
        del _long_holds[:]


def maybe_install(rank=None):
    """Install when :data:`ENABLED` is set; ``rank`` (a gang rank's)
    suffixes its report. Called from the supervisor and the worker boot
    path, so any supervised run doubles as a sanitizer run."""
    global _rank
    if not ENABLED:
        return False
    _rank = rank
    install()
    return True


def _cycles():
    """SCCs of the observed edge graph with >1 node — the multi-lock
    generalization of the pairwise inversion check."""
    adj = {}
    with _state_lock:
        for (a, b) in _edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
    from sparkdl_tpu_torch.analysis.concur import _tarjan

    return sorted(
        sorted(c) for c in _tarjan(adj) if len(c) > 1)


def report():
    """The machine-readable sanitizer verdict."""
    with _state_lock:
        edges = [
            {"from": a, "to": b, "count": rec["count"]}
            for (a, b), rec in sorted(_edges.items())
        ]
        inversions = [dict(i) for i in _inversions]
        long_holds = [dict(h) for h in _long_holds]
        sites = dict(_sites)
    return {
        "schema": REPORT_SCHEMA,
        "installed": _installed,
        "lock_sites": len(sites),
        "edges": edges,
        "cycles": _cycles(),
        "inversions": inversions,
        "long_holds": long_holds,
    }


def _rank_suffixed(path):
    """A gang rank's report beside its peers' and the driver's (the
    flightrec-rank-N idiom), never last-writer-wins."""
    if _rank is None:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}-rank-{_rank}{ext}"


def _report_path():
    if REPORT:
        return _rank_suffixed(REPORT)
    from sparkdl_tpu_torch import observe

    d = observe.telemetry_dir()
    if d:
        return _rank_suffixed(os.path.join(d, "concur_report.json"))
    return None


def write_report(path=None):
    """Write ``concur_report.json``; returns the path or None when no
    destination is configured."""
    path = path or _report_path()
    if not path:
        return None
    doc = report()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)
    return path


def _atexit_report():
    if not _installed:
        return
    try:
        write_report()
    except Exception:
        pass
