"""Structured event timeline: typed spans and instants, exported as
Chrome trace-event JSON.

Counterpart of ``sparkdl_tpu/observe/timeline.py``, the same event
shape so that either package's readers read the other's traces:

- spans:    ``{"ph": "X", "name", "cat", "ts", "dur", "tid", "args"}``
- instants: ``{"ph": "i", "name", "cat", "ts", "s": "p", "tid", "args"}``

``ts`` and ``dur`` are integer microseconds. ``ts`` is the wall clock
(``time.time``), so events of the gang's processes merge onto one axis;
``dur`` is measured with the monotonic ``perf_counter``, so a span never
goes negative under clock slew. ``pid`` is absent: the driver's merger
(:mod:`sparkdl_tpu_torch.observe.aggregate`) gives each rank a lane
(lane 0 the driver, lane ``rank + 1`` each rank).

Events are recorded per process (thread-safe, append-only) and drained
in batches: a gang worker ships them to the driver over the control
plane. Each recorded event is also handed to :attr:`Timeline.observer`
when one is set (the flight recorder's mirror).
"""

import contextlib
import threading
import time


def _tid():
    # Chrome trace tids are int32-ish; Python thread idents can exceed
    # that on 64-bit Linux. Fold, keeping one value a thread.
    return threading.get_ident() & 0x7FFFFFFF


class Timeline:
    """Append-only per-process event buffer."""

    def __init__(self, clock=time.time, perf=time.perf_counter):
        self._clock = clock
        self._perf = perf
        self._lock = threading.Lock()
        self._events = []
        # optional per-event mirror (the flight recorder): called with
        # each recorded event outside the buffer's lock; must not raise
        self.observer = None

    def _record(self, ev):
        with self._lock:
            self._events.append(ev)
        obs = self.observer
        if obs is not None:
            try:
                obs(ev)
            except Exception:
                pass  # the mirror never breaks recording
        return ev

    def instant(self, name, cat="", tid=None, **args):
        """A point event (``ph: "i"``, process-scoped). ``tid`` replaces
        the recording thread's: a lifecycle that crosses threads (a
        served request) keys its events on a logical id, one track
        each."""
        return self._record({
            "name": name, "cat": cat or "event", "ph": "i",
            "ts": int(self._clock() * 1e6), "s": "p",
            "tid": _tid() if tid is None else int(tid), "args": args,
        })

    def complete(self, name, start, dur, cat="", tid=None, **args):
        """A complete event (``ph: "X"``) of explicit wall-clock
        ``start`` and ``dur`` (seconds), for spans whose ends were
        measured elsewhere."""
        return self._record({
            "name": name, "cat": cat or "span", "ph": "X",
            "ts": int(start * 1e6), "dur": max(0, int(dur * 1e6)),
            "tid": _tid() if tid is None else int(tid), "args": args,
        })

    @contextlib.contextmanager
    def span(self, name, cat="", **args):
        """A complete event (``ph: "X"``) around the block."""
        t0 = self._clock()
        p0 = self._perf()
        try:
            yield
        finally:
            self._record({
                "name": name, "cat": cat or "span", "ph": "X",
                "ts": int(t0 * 1e6),
                "dur": max(0, int((self._perf() - p0) * 1e6)),
                "tid": _tid(), "args": args,
            })

    def drain(self):
        """Pop and return every buffered event (the flush unit)."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def __len__(self):
        with self._lock:
            return len(self._events)


def chrome_trace(groups):
    """One Chrome trace document of per-process event lists.

    ``groups``: ``(pid, label, events)`` triples, one trace process lane
    each. Metadata events come first, then every event by ``ts``."""
    out = []
    for pid, label, events in groups:
        out.append({"name": "process_name", "ph": "M", "pid": int(pid),
                    "tid": 0, "ts": 0, "args": {"name": str(label)}})
        for ev in events:
            ev = dict(ev)
            ev["pid"] = int(pid)
            out.append(ev)
    out.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0)))
    return {"traceEvents": out, "displayTimeUnit": "ms"}
