"""The driver's perf forensics: alert-triggered and manual captures, and
the differential step attribution of a regression.

Counterpart of ``sparkdl_tpu/observe/forensics.py``, the driver half of
the round trip (:mod:`~sparkdl_tpu_torch.observe.capture` is the
rank's). A perf alert produces its own evidence:

- **why**: ``perf.diff_attribution`` between the alert rule's own
  calibration window (the healthy past the engine calibrated its
  baseline from) and the window that fired, an entry of
  ``regression_report.json`` beside ``alerts.json``;
- **what it looked like**: PROFILE_REQ down the rank's control socket,
  which its capture service answers with a ``torch.profiler`` trace of
  the next steps and their uncapped attribution (PROFILE_DONE), both
  recovered into the run dir when it is written.

The triggers: the alert hook (:meth:`ForensicsManager.on_alerts`, fed
each poll's firings by the launcher's monitor loop, inert unless
:data:`ON_ALERT` is set), and ``POST /capturez?rank=N`` on the status
server (:meth:`ForensicsManager.request_capture`). A per-(rule, rank)
cooldown (:data:`COOLDOWN_S`) gates the alert path, and each rank has at
most one capture in flight on every path, until its PROFILE_DONE.

The manager exists only with gang telemetry on
(:func:`maybe_make_forensics`), spans a launch's attempts like the alert
engine, and is bound to each attempt's control plane
(:meth:`ForensicsManager.bind_server`). Its settings are module settings
read when it is made (the JAX module's ``SPARKDL_TPU_PROFILE_ON_ALERT``
and ``SPARKDL_TPU_PROFILE_COOLDOWN_S``); no environment variable is read.
"""

import threading
import time

# the alert hook's switch, and the per-(rule, rank) cooldown, seconds
ON_ALERT = False
COOLDOWN_S = 300.0

# The alert rules whose firings are *perf* regressions — the ones a
# profile window can explain. Liveness/memory rules have their own
# forensic artifacts (stack dumps, oom/leak reports).
PERF_RULES = ("step_time_regression", "mfu_drop", "overlap_drop")


def maybe_make_forensics(telemetry, alert_engine=None):
    """A :class:`ForensicsManager` when gang telemetry is live; None
    otherwise. :data:`ON_ALERT` gates only the alert hook: the manual
    ``/capturez`` path works on any telemetry-on gang."""
    if telemetry is None:
        return None
    return ForensicsManager(telemetry, alert_engine=alert_engine)


class ForensicsManager:
    """Driver-side capture orchestration + regression-report builder.

    Thread-safety: ``on_alerts`` runs on the monitor loop,
    ``request_capture`` on statusz handler threads, and the
    PROFILE_DONE callback on control-plane connection threads — one
    lock covers the in-flight/cooldown/report state."""

    def __init__(self, telemetry, alert_engine=None,
                 clock=time.monotonic, wall=time.time):
        self._telemetry = telemetry
        self._engine = alert_engine
        self._clock = clock
        self._wall = wall
        self.on_alert_enabled = bool(ON_ALERT)
        self.cooldown_s = float(COOLDOWN_S)
        self._lock = threading.Lock()
        self._server = None
        self._inflight = {}    # rank -> trigger info
        self._cooldowns = {}   # (rule, rank) -> monotonic ok-after
        self._completed = []   # PROFILE_DONE metas, arrival order
        self._entries = {}     # rank -> newest regression entry

    # -- attempt wiring -----------------------------------------------

    def bind_server(self, server):
        """Rebind to this attempt's control plane: PROFILE_REQ frames
        go out through it, and its PROFILE_DONE callback clears the
        per-rank in-flight latch. An attempt's workers dying with a
        capture outstanding also clears it (the dead rank can never
        answer; the next attempt's rank N must be capturable)."""
        with self._lock:
            self._server = server
            self._inflight.clear()
        if server is not None:
            server.on_profile_done = self._on_profile_done

    # -- trigger paths ------------------------------------------------

    def on_alerts(self, records):
        """The monitor-loop hook: fired alert records from one
        ``AlertEngine.poll`` pass. Perf-rule firings on a concrete
        rank request a capture (cooldown + in-flight gated) and write
        a regression entry; everything else is ignored. Inert unless
        :data:`ON_ALERT` is set. Returns the (rule, rank) pairs that
        started a capture."""
        if not self.on_alert_enabled:
            return []
        started = []
        for rec in records or ():
            rule = rec.get("rule")
            rank = rec.get("rank")
            if rule not in PERF_RULES or not isinstance(rank, int):
                continue
            if self._trigger(rank, "alert", rule, alert=rec):
                started.append((rule, rank))
        return started

    def request_capture(self, rank, reason="manual", rule=None):
        """The manual path (``POST /capturez``): request a capture on
        ``rank`` now. In-flight gated but cooldown-exempt — an
        operator asking twice means it. Returns (ok, why)."""
        try:
            rank = int(rank)
        except (TypeError, ValueError):
            return False, "bad rank"
        with self._lock:
            if rank in self._inflight:
                return False, f"capture already in flight on rank {rank}"
            if self._server is None:
                return False, "no control plane bound"
        ok = self._trigger(rank, reason, rule)
        return (ok, "requested" if ok
                else f"rank {rank} has no control connection")

    def _trigger(self, rank, reason, rule, alert=None):
        now = self._clock()
        with self._lock:
            server = self._server
            if server is None or rank in self._inflight:
                return False
            if alert is not None:
                key = (rule, rank)
                if now < self._cooldowns.get(key, 0.0):
                    return False
                self._cooldowns[key] = now + self.cooldown_s
            self._inflight[rank] = {
                "rank": rank, "reason": reason, "rule": rule,
                "ts": self._wall(),
            }
        entry = self._build_entry(rank, reason, rule, alert)
        if entry is not None:
            with self._lock:
                self._entries[rank] = entry
            self._telemetry.add_regression_report(entry)
        ok = server.request_profile(rank, reason=reason, rule=rule)
        if not ok:
            # No control connection for the rank (already dead, or a
            # pre-READY attempt): release the latch so a later trigger
            # can retry. The regression entry stays — the driver-side
            # diff is evidence even without a worker capture.
            with self._lock:
                self._inflight.pop(rank, None)
        return ok

    # -- the differential report --------------------------------------

    def _build_entry(self, rank, reason, rule, alert):
        """One ``regression_report.json`` entry: the per-component
        diff between the rank's calibration window and the window that
        fired, plus the trigger metadata. ``diff`` is None when either
        window is unattributable (explicit/ledger baselines carry no
        event window) — the entry still records the firing and, later,
        the capture artifact names."""
        from sparkdl_tpu_torch.observe import perf

        engine = self._engine
        baseline = (engine.baseline_window(rank)
                    if engine is not None else [])
        window_s = engine.window_s if engine is not None else 60.0
        regressed = (self._telemetry.recent_events(window_s)
                     or {}).get(rank) or []
        diff = None
        if baseline and regressed:
            try:
                diff = perf.diff_attribution(baseline, regressed)
            except Exception:
                diff = None
        if alert is None and diff is None:
            # A manual capture with nothing to diff produces only the
            # worker-side artifacts; no empty entry.
            return None
        return {
            "rule": rule,
            "rank": rank,
            "reason": reason,
            "ts": self._wall(),
            "severity": (alert or {}).get("severity"),
            "alert_detail": dict((alert or {}).get("detail") or {})
            or None,
            "diff": diff,
            "capture": None,
        }

    # -- worker answers -----------------------------------------------

    def _on_profile_done(self, rank, meta):
        """PROFILE_DONE landed (control-plane connection thread):
        clear the rank's in-flight latch, record the capture, and
        attach its artifact names to the rank's regression entry. The
        entry's diff stays the one of the window that fired."""
        meta = dict(meta) if isinstance(meta, dict) else {}
        with self._lock:
            self._inflight.pop(rank, None)
            info = {
                "rank": rank,
                "reason": meta.get("reason"),
                "rule": meta.get("rule"),
                "report": meta.get("report"),
                "trace_dir": meta.get("trace_dir"),
                "steps_captured": meta.get("steps_captured"),
                "window_s": meta.get("window_s"),
                "ts": self._wall(),
            }
            if meta.get("error"):
                # a profiler that failed on the rank: said, not hidden
                info["error"] = meta["error"]
            self._completed.append(info)
            entry = self._entries.get(rank)
            if entry is not None and entry.get("capture") is None:
                entry["capture"] = {
                    k: info[k] for k in
                    ("report", "trace_dir", "steps_captured",
                     "window_s", "error") if k in info
                }

    # -- status surface (statusz `captures` block) --------------------

    def captures_status(self):
        """The statusz ``captures`` block: live in-flight and
        completed captures plus the trigger config — what
        ``observe.top`` renders."""
        with self._lock:
            return {
                "on_alert": self.on_alert_enabled,
                "cooldown_s": self.cooldown_s,
                "in_flight": [dict(self._inflight[r])
                              for r in sorted(self._inflight)],
                "completed": [dict(c) for c in self._completed],
            }


__all__ = [
    "ForensicsManager", "maybe_make_forensics", "PERF_RULES",
]
