"""A rank's perf-forensics capture service, and the manual trigger's CLI.

Counterpart of ``sparkdl_tpu/observe/capture.py``, the worker half of
the forensics round trip (:mod:`~sparkdl_tpu_torch.observe.forensics` is
the driver's): when the driver sends PROFILE_REQ down this rank's control
socket (a perf alert fired, or ``POST /capturez``), the service captures
a bounded window into the job dir and answers PROFILE_DONE.

One window leaves:

- ``trace-rank-<N>-<seq>.json``: a ``torch.profiler`` Chrome trace of
  the window, CPU activity and, on a rank bound to a card, CUDA activity
  (the card's kernels by name), in place of the JAX package's
  ``xprof-rank-<N>-<seq>/`` directory;
- ``profile_report-rank-<N>-<seq>.json``: the window's per-step
  attribution, uncapped (``perf.json`` keeps 200 rows), the bound card's
  memory (``torch.cuda.memory_stats``; ``{}`` before ``hvd.init()``
  binds it and on a CPU rank) and the trigger, under the JAX module's
  keys;
- the instants ``profile.capture.start`` and ``profile.capture.done``.

The window is :data:`STEPS` instrumented train steps, or what a wall
clock cap (:data:`DEFAULT_MAX_WINDOW_S`) leaves of them, whichever ends first;
one capture runs at a time (a trigger during one is dropped with a
``profile.capture.skipped`` instant). :data:`AT_STEP` triggers a capture
after that many steps, with no driver involved.

The service taps the timeline's observer slot, chained to the flight
recorder already there; it never drains the timeline. ``torch.profiler``
records a thread's CPU operators only from the thread that started it,
so the window opens and closes on the training thread, inside the tap,
at step boundaries: the profiler starts when the first step after the
trigger has ended and stops when the window's last step has, so the
trace holds exactly the window's steps (the JAX module opens its window
at the trigger and runs xprof beside it on the capture thread). If the
wall cap passes inside a step, the report is written without a trace
and the profiler stops at the rank's next step. A profiler that fails
to start or export leaves the PROFILE_DONE meta an ``error``; there is
no silent fallback.

With telemetry off, no service exists: the worker bootstrap starts one
(:func:`maybe_start_capture_service`) only with telemetry on and a job
dir.

CLI (the manual trigger)::

    python -m sparkdl_tpu_torch.observe.capture http://driver:port [rank]

POSTs ``/capturez`` on the driver's status server and prints the reply.
"""

import json
import os
import threading
import time

from sparkdl_tpu_torch import observe

CAPTURE_SCHEMA = "sparkdl_tpu.observe.capture/1"

# instrumented train steps a window (the JAX module's
# SPARKDL_TPU_PROFILE_STEPS) and the step count after which the rank
# captures by itself (SPARKDL_TPU_PROFILE_AT_STEP; None: never): read
# when a service is made
STEPS = 20
AT_STEP = None
# the wall-clock cap of a window, seconds
DEFAULT_MAX_WINDOW_S = 120.0


def report_name(rank, seq):
    return f"profile_report-rank-{rank}-{seq}.json"


def trace_name(rank, seq):
    return f"trace-rank-{rank}-{seq}.json"


def _is_step(ev):
    return (ev.get("ph") == "X" and ev.get("cat") == "train"
            and (ev.get("args") or {}).get("phase") != "compile")


class CaptureService:
    """Answers the driver's PROFILE_REQ frames (and :data:`AT_STEP`) with
    bounded windows written into ``job_dir``."""

    def __init__(self, client, rank, job_dir, *, steps=None,
                 max_window_s=DEFAULT_MAX_WINDOW_S):
        self._client = client
        self._rank = int(rank)
        self._job_dir = job_dir
        self._default_steps = int(STEPS if steps is None else steps)
        self._at_step = None if AT_STEP is None else int(AT_STEP)
        self._at_fired = False
        self._max_window_s = float(max_window_s)
        self._lock = threading.Lock()
        self._capturing = False
        self._thread = None
        self._seq = 0
        self._prev_observer = None
        self._installed = False
        self._steps_total = 0
        self._done = threading.Event()
        # the window, shared by the tap and the capture thread: a request
        # waiting for the next step boundary, the open window's events
        # (None: closed) and steps, and its profiler
        self._pending = None
        self._buf = None
        self._window = None  # the events of a window the tap closed
        self._buf_steps = 0
        self._want_steps = 0
        self._prof = None
        self._prof_thread = None
        self._prof_running = False
        self._prof_error = None
        self._stop_at_next_step = False

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        """Install the timeline tap (chained over the flight recorder's
        mirror) and take the driver's PROFILE_REQ frames."""
        tl = observe.timeline()
        self._prev_observer = tl.observer
        tl.observer = self._tap
        self._installed = True
        if self._client is not None:
            self._client.set_profile_handler(self._on_request)
        return self

    def stop(self, join_timeout=5.0):
        """Stop taking requests, put the previous observer back and end a
        capture in flight (it reports what it has). Called before the
        flight recorder is closed."""
        if self._client is not None:
            self._client.set_profile_handler(None)
        tl = observe.timeline()
        if self._installed and tl.observer == self._tap:
            tl.observer = self._prev_observer
        self._installed = False
        self._done.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=join_timeout)
        self._stop_profiler()  # a window the cap left open

    # -- the profiler (started and stopped on the training thread) ----------

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        from sparkdl_tpu_torch.observe.health import bound_card

        activities = [ProfilerActivity.CPU]
        if bound_card() is not None:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as e:  # noqa: BLE001 - reported, not hidden
            self._prof_error = f"torch.profiler failed to start: {e}"
            return
        with self._lock:
            self._prof = prof
            self._prof_thread = threading.get_ident()
            self._prof_running = True

    def _stop_profiler(self):
        """Stop a running profiler, from the thread that started it."""
        if (not self._prof_running
                or self._prof_thread != threading.get_ident()):
            return
        self._prof_running = False
        try:
            self._prof.stop()
        except Exception as e:  # noqa: BLE001
            self._prof_error = f"torch.profiler failed to stop: {e}"
            with self._lock:
                self._prof = None

    # -- the timeline tap (runs on recording threads) -----------------------

    def _tap(self, ev):
        prev = self._prev_observer
        if prev is not None:
            try:
                prev(ev)
            except Exception:
                pass  # the chained mirror never breaks the tap
        is_step = _is_step(ev)
        if is_step:
            self._steps_total += 1
            if (self._at_step is not None and not self._at_fired
                    and self._steps_total >= self._at_step):
                self._at_fired = True
                self.trigger(reason="at_step")
        if (self._buf is None and self._pending is None
                and not self._stop_at_next_step):
            return  # no window: the fast path
        if not is_step:
            with self._lock:
                if self._buf is not None:
                    self._buf.append(ev)
            return
        with self._lock:
            stop_now, self._stop_at_next_step = self._stop_at_next_step, False
        if stop_now:
            self._stop_profiler()
            return
        opening = closing = False
        with self._lock:
            if self._buf is not None:
                self._buf.append(ev)
                self._buf_steps += 1
                closing = self._buf_steps >= self._want_steps
            elif self._pending is not None:
                opening = True
                self._want_steps = self._pending
                self._pending = None
        if opening:
            # this step has ended: the window holds the steps after it
            self._prof_error = None
            self._start_profiler()
            with self._lock:
                self._buf_steps = 0
                self._buf = []
        elif closing:
            self._stop_profiler()
            with self._lock:
                self._window = self._buf
                self._buf = None
            self._done.set()

    # -- triggers ------------------------------------------------------------

    def _on_request(self, req):
        """PROFILE_REQ, on the client's watchdog thread: only spawns."""
        if not isinstance(req, dict):
            req = {}
        self.trigger(reason=req.get("reason") or "alert",
                     rule=req.get("rule"), steps=req.get("steps"))

    def trigger(self, reason="manual", rule=None, steps=None):
        """Start one capture unless one is in flight (a trigger during
        one is dropped with an instant, never queued); True when one
        started."""
        with self._lock:
            busy = self._capturing
            if not busy:
                self._capturing = True
                seq = self._seq
                self._seq += 1
        if busy:
            # outside the lock: the instant passes through the tap
            observe.instant(
                "profile.capture.skipped", cat="profile",
                rank=self._rank, reason=reason,
                **({"rule": rule} if rule else {}))
            return False
        t = threading.Thread(
            target=self._capture, args=(reason, rule, steps, seq),
            name="sparkdl-torch-profile-capture", daemon=True)
        self._thread = t
        t.start()
        return True

    # -- the capture (its own thread) ----------------------------------------

    def _capture(self, reason, rule, steps, seq):
        try:
            want = max(1, int(steps) if steps else self._default_steps)
            rank = self._rank
            observe.instant(
                "profile.capture.start", cat="profile", rank=rank,
                reason=reason, steps=want,
                **({"rule": rule} if rule else {}))
            t0 = time.time()
            self._done.clear()
            with self._lock:
                self._window = None
                self._pending = want
            self._done.wait(self._max_window_s)
            with self._lock:  # the wall cap, or a stop
                self._pending = None
                events = self._window
                if events is None:
                    events = self._buf if self._buf is not None else []
                    self._buf = None
                steps_captured = self._buf_steps if events else 0
            window_s = time.time() - t0
            error = self._prof_error
            trace = None
            with self._lock:
                running, prof = self._prof_running, self._prof
                if running:
                    # the cap passed inside a step: the rank's next step
                    # stops the profiler, and this window has no trace
                    self._stop_at_next_step = True
                else:
                    self._prof = None
            if running:
                error = error or ("the wall cap passed inside a step; "
                                  "no trace")
            elif prof is not None:
                try:
                    prof.export_chrome_trace(
                        os.path.join(self._job_dir, trace_name(rank, seq)))
                    trace = trace_name(rank, seq)
                except Exception as e:  # noqa: BLE001
                    error = f"torch.profiler trace export failed: {e}"
            from sparkdl_tpu_torch.observe import health, perf

            report = {
                "schema": CAPTURE_SCHEMA,
                "rank": rank,
                "reason": reason,
                "rule": rule,
                "ts": t0,
                "window_s": window_s,
                "requested_steps": want,
                "steps_captured": steps_captured,
                "attribution": perf.attribution_report(list(events)),
                "device_memory": health.device_memory_stats(),
                "trace_dir": trace,
            }
            fname = report_name(rank, seq)
            path = os.path.join(self._job_dir, fname)
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(report, f, indent=2, sort_keys=True)
                os.replace(tmp, path)
            except OSError:
                fname = None  # an unwritable dir: DONE goes all the same
            observe.instant(
                "profile.capture.done", cat="profile", rank=rank,
                reason=reason, steps=steps_captured,
                window_s=round(window_s, 3),
                **({"rule": rule} if rule else {}))
            if self._client is not None:
                meta = {"rank": rank, "reason": reason, "rule": rule,
                        "report": fname, "trace_dir": trace,
                        "steps_captured": steps_captured,
                        "window_s": window_s}
                if error:
                    meta["error"] = error
                self._client.send_profile_done(meta)
        finally:
            with self._lock:
                self._capturing = False


def maybe_start_capture_service(client, rank, job_dir):
    """A started :class:`CaptureService` when telemetry is on and the
    rank has a job dir to write into; None otherwise."""
    if client is None or not observe.enabled() or not job_dir:
        return None
    return CaptureService(client, rank, job_dir).start()


# -- the manual trigger's CLI ------------------------------------------------


def main(argv=None):
    import sys
    import urllib.error
    import urllib.request

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m sparkdl_tpu_torch.observe.capture "
              "http://driver:port [rank]", file=sys.stderr)
        return 2
    url = argv[0].rstrip("/") + "/capturez"
    if len(argv) > 1:
        url += f"?rank={int(argv[1])}"
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            body = resp.read().decode("utf-8", "replace")
            code = resp.status
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", "replace")
        code = e.code
    except OSError as e:
        print(f"capture request failed: {e}", file=sys.stderr)
        return 1
    print(body)
    return 0 if 200 <= code < 300 else 1


if __name__ == "__main__":
    raise SystemExit(main())
