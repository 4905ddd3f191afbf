"""The driver's merge of a gang's telemetry into one run dir.

Counterpart of ``sparkdl_tpu/observe/aggregate.py``. Workers flush
TELEMETRY frames (cumulative metric snapshots and drained timeline
events); the control-plane server hands each to
:meth:`GangTelemetry.ingest`. At the end of a supervised launch, however
it ends, the launcher calls :meth:`GangTelemetry.write`, which folds in
the driver's own registry and timeline (supervisor attempts, backoff,
hang verdicts) and writes the JAX package's artifacts:

- ``timeline.json``: Chrome trace events, lane 0 the driver and lane
  ``rank + 1`` each rank (labeled with its host);
- ``metrics.prom`` and ``metrics.json``: every series labeled
  ``rank="N"`` (``rank="driver"`` for the driver's). A rank's counters
  and histograms sum over its process incarnations; gauges take the
  newest;
- ``perf.json``: each rank's step attribution
  (:func:`~sparkdl_tpu_torch.observe.perf.attribution_report`, schema
  ``sparkdl_tpu.perf.breakdown/1``), when a rank recorded step spans;
- ``health.json``: each attempt's hang-detector summary;
- ``stack-rank-<r>.txt``: the stack dumps a hang diagnosis asked for;
- ``flightrec-rank-<r>.json``: each rank's flight-recorder tail,
  recovered from every attempt's job dir (a rank SIGKILLed between
  flushes leaves only this), and any ``oom_report*.json`` found there;
- ``alerts.json``: the alert engine's report of every attempt, merged
  (the newest configuration, every attempt's firings), written for a
  clean run too (:meth:`GangTelemetry.add_alert_report`);
- ``regression_report.json``: the perf forensics' entries
  (:meth:`GangTelemetry.add_regression_report`), and the captures'
  ``profile_report-rank-<r>-<seq>.json`` and
  ``trace-rank-<r>-<seq>.json`` (a ``torch.profiler`` Chrome trace, in
  place of the JAX package's ``xprof-rank-*`` directories) recovered
  from the job dirs;
- ``comms_report.json`` and ``fixit_report.json``: only when reports
  are handed to :meth:`GangTelemetry.add_comms_reports` /
  :meth:`GangTelemetry.add_fixit_reports` (the JAX launcher's pre-flight
  over HLO and jaxpr, their producer, has no counterpart in the port).

``ingest`` runs on control-plane connection threads while ``write`` runs
on the driver's main thread: one lock covers both.
"""

import collections
import glob
import json
import os
import threading

from sparkdl_tpu_torch.observe.metrics import (
    ensure_build_info,
    merge_snapshots,
    render_json,
    render_prometheus,
    snapshot_delta,
)
from sparkdl_tpu_torch.observe.timeline import chrome_trace

TIMELINE_FILE = "timeline.json"
PROM_FILE = "metrics.prom"
JSON_FILE = "metrics.json"
HEALTH_FILE = "health.json"
PERF_FILE = "perf.json"
COMMS_FILE = "comms_report.json"
FIXIT_FILE = "fixit_report.json"
ALERTS_FILE = "alerts.json"
REGRESSION_FILE = "regression_report.json"

# the live event journal is a ring: live readers want the recent past
# only, while write() reads every rank's full event list
JOURNAL_CAP = 8192

# perf.json keeps the newest per-step rows up to this many (the summed
# components cover the whole run either way)
PERF_MAX_STEP_ROWS = 200

DRIVER_LABEL = "driver"


class GangTelemetry:
    """One gang launch's telemetry, over every supervised attempt."""

    def __init__(self):
        from sparkdl_tpu_torch import observe

        self._lock = threading.Lock()
        self._snaps = {}    # (rank, pid) -> latest cumulative snapshot
        self._events = {}   # rank -> [event, ...]
        self._hosts = {}    # rank -> host
        self._stack_dumps = {}      # rank -> [(reason, dump), ...]
        self._job_dirs = []         # one per attempt (flight-recorder scan)
        self._health_summaries = []  # one HangDetector summary an attempt
        self._comms_reports = []    # static comms budgets, when handed
        self._fixit_reports = []    # fixit reports, when handed
        self._alert_reports = []    # one alert-engine report an attempt
        self._regression_reports = []  # perf-forensics entries
        self._journal = collections.deque(maxlen=JOURNAL_CAP)
        self._journal_seq = 0
        # the driver's registry outlives launches: baseline it now, so
        # write() reports this launch's driver-side movement only
        self._driver_base = observe.metrics().snapshot()

    def ingest(self, rank, payload):
        """Absorb one worker flush (thread-safe; latest snapshot from
        a given (rank, pid) supersedes its previous one — snapshots
        are cumulative — while events only ever append)."""
        rank = int(rank)
        metrics = payload.get("metrics")
        if metrics:
            self._validate_snapshot(metrics)
        events = payload.get("events") or ()
        with self._lock:
            if metrics:
                self._snaps[(rank, payload.get("pid"))] = metrics
            if events:
                fresh = [e for e in events if isinstance(e, dict)]
                self._events.setdefault(rank, []).extend(fresh)
                for e in fresh:
                    self._journal_seq += 1
                    self._journal.append((self._journal_seq, rank, e))
            host = payload.get("host")
            if host:
                self._hosts[rank] = str(host)

    def add_stack_dump(self, rank, dump, reason=None):
        """A worker answered a hang-diagnosis dump request: keep the
        text for the run dir (``stack-rank-<r>.txt``), the evidence
        that names the stalled frame."""
        with self._lock:
            self._stack_dumps.setdefault(int(rank), []).append(
                (str(reason or "requested"), str(dump))
            )

    def note_job_dir(self, job_dir):
        """Register one attempt's job dir so ``write`` can recover
        flight-recorder tails from it — including from ranks that were
        SIGKILLed before their final telemetry flush."""
        with self._lock:
            if job_dir and job_dir not in self._job_dirs:
                self._job_dirs.append(job_dir)

    def add_health_summary(self, summary):
        """One attempt's :meth:`HangDetector.summary` (written to
        ``health.json``, what the verdicts are read back from)."""
        if summary:
            with self._lock:
                self._health_summaries.append(summary)

    def add_comms_reports(self, reports):
        """Static comms budgets, written to ``comms_report.json`` for the
        doctor to set against the measured collective bytes."""
        with self._lock:
            self._comms_reports.extend(
                r for r in reports if isinstance(r, dict))

    def add_fixit_reports(self, reports):
        """Fixit reports, written to ``fixit_report.json`` for the
        doctor's fixit section."""
        with self._lock:
            self._fixit_reports.extend(
                r for r in reports if isinstance(r, dict))

    def add_alert_report(self, report):
        """One alert-engine report (:meth:`~sparkdl_tpu_torch.observe.
        alerts.AlertEngine.report`). Reports accumulate: ``write`` merges
        them into ``alerts.json``, the newest configuration and every
        firing, and writes it when nothing fired too (a clean run's file
        says the rules ran)."""
        if isinstance(report, dict):
            with self._lock:
                self._alert_reports.append(report)

    def add_regression_report(self, entry):
        """One perf-forensics entry (:mod:`sparkdl_tpu_torch.observe.
        forensics`): the ``diff_attribution`` of a fired perf alert with
        its trigger and capture, written to ``regression_report.json``."""
        if isinstance(entry, dict):
            with self._lock:
                self._regression_reports.append(entry)

    # -- live views -------------------------------------------------------------

    def events_since(self, seq=0, limit=None):
        """Journal entries newer than ``seq``: ``(newest_seq,
        [(seq, rank, event), ...])``, at most ``limit`` of them: a live
        reader's poll. The scan walks from the newest entry and stops
        at the first one already seen, so an idle poll is O(1) under
        the lock every flush takes."""
        out = []
        with self._lock:
            newest = self._journal_seq
            for entry in reversed(self._journal):
                if entry[0] <= seq:
                    break
                out.append(entry)
        out.reverse()
        if limit is not None:
            out = out[:int(limit)]
        return newest, out

    def recent_events(self, window_s, now=None):
        """``{rank: [event, ...]}`` for journal events whose wall-clock
        ``ts`` falls inside the trailing ``window_s`` seconds (a live
        attribution's rolling window)."""
        import time as _time

        now = _time.time() if now is None else now
        cutoff = (now - float(window_s)) * 1e6
        out = {}
        with self._lock:
            entries = list(self._journal)
        for _seq, rank, e in entries:
            ts = e.get("ts")
            if isinstance(ts, (int, float)) and ts >= cutoff:
                out.setdefault(rank, []).append(e)
        return out

    def live_labeled(self):
        """The labeled merged snapshots as they stand NOW — the same
        shape ``write`` renders, driver series included (delta'd
        against the construction baseline), but non-destructive: no
        timeline drain, no file writes."""
        from sparkdl_tpu_torch import observe

        registry = observe.metrics()
        ensure_build_info(registry)
        driver_snap = snapshot_delta(
            self._driver_base, registry.snapshot())
        return self._merged(driver_snap)

    @staticmethod
    def _validate_snapshot(snap):
        # Frames come off the wire: shape-check EVERYTHING the merge
        # and render math will touch, before any of it is stored — a
        # malformed frame must cost one frame (control plane logs and
        # drops it), never detonate later in write() and cost every
        # rank's artifacts.
        num = (int, float)
        for key in ("counters", "gauges", "histograms"):
            for s in snap.get(key, ()):
                if not isinstance(s.get("name"), str) or not isinstance(
                    s.get("labels", {}), dict
                ):
                    raise ValueError(f"malformed metric series: {s!r}")
                if key != "histograms":
                    if not isinstance(s.get("value"), num):
                        raise ValueError(
                            f"malformed metric series: {s!r}")
                    continue
                buckets, counts = s.get("buckets"), s.get("counts")
                if (
                    not isinstance(buckets, list)
                    or not isinstance(counts, list)
                    or len(counts) != len(buckets) + 1
                    or not all(isinstance(b, num) for b in buckets)
                    or not all(isinstance(c, num) for c in counts)
                    or not isinstance(s.get("sum"), num)
                    or not isinstance(s.get("count"), num)
                ):
                    raise ValueError(f"malformed histogram: {s!r}")

    # -- merged views --------------------------------------------------------

    def _merged(self, driver_snapshot=None):
        """``[(extra_labels, merged_snapshot), ...]`` — one entry per
        rank plus the driver's."""
        with self._lock:
            by_rank = {}
            for (rank, _pid), snap in sorted(self._snaps.items()):
                by_rank.setdefault(rank, []).append(snap)
        out = []
        if driver_snapshot is not None:
            out.append(({"rank": DRIVER_LABEL}, driver_snapshot))
        for rank in sorted(by_rank):
            out.append(
                ({"rank": str(rank)}, merge_snapshots(by_rank[rank]))
            )
        return out

    def chrome(self, driver_events=()):
        with self._lock:
            ranks = sorted(self._events)
            groups = [(0, DRIVER_LABEL, list(driver_events))] + [
                (
                    rank + 1,
                    f"rank {rank}"
                    + (f" @ {self._hosts[rank]}"
                       if rank in self._hosts else ""),
                    list(self._events[rank]),
                )
                for rank in ranks
            ]
        return chrome_trace(groups)

    def write(self, out_dir, driver_registry=None, driver_timeline=None):
        """Write the merged artifacts into ``out_dir``, each atomically
        (temp file, rename). Defaults to the driver's global registry and
        timeline (draining the timeline). Returns ``{file name: path}``."""
        from sparkdl_tpu_torch import observe
        from sparkdl_tpu_torch.observe import perf
        from sparkdl_tpu_torch.observe.flightrec import recover_job_dir

        if driver_registry is None:
            registry = observe.metrics()
            ensure_build_info(registry)
            driver_snap = snapshot_delta(self._driver_base,
                                         registry.snapshot())
        else:
            driver_snap = driver_registry.snapshot()
        if driver_timeline is None:
            driver_timeline = observe.timeline()
        os.makedirs(out_dir, exist_ok=True)
        labeled = self._merged(driver_snap)
        files = [
            (TIMELINE_FILE, json.dumps(self.chrome(driver_timeline.drain()))),
            (PROM_FILE, render_prometheus(labeled)),
            (JSON_FILE, render_json(labeled, indent=2)),
        ]
        with self._lock:
            rank_events = {r: list(evs) for r, evs in self._events.items()}
            dumps = {r: list(d) for r, d in self._stack_dumps.items()}
            job_dirs = list(self._job_dirs)
            health = list(self._health_summaries)
            comms = list(self._comms_reports)
            fixit = list(self._fixit_reports)
            alert_reports = list(self._alert_reports)
            regression_reports = list(self._regression_reports)
        perf_ranks = {}
        for rank in sorted(rank_events):
            report = perf.attribution_report(rank_events[rank])
            if not report.get("steps"):
                continue
            per_step = report.get("per_step") or []
            if len(per_step) > PERF_MAX_STEP_ROWS:
                report["per_step"] = per_step[-PERF_MAX_STEP_ROWS:]
                report["per_step_truncated"] = (len(per_step)
                                                - PERF_MAX_STEP_ROWS)
            perf_ranks[str(rank)] = report
        if perf_ranks:
            files.append((PERF_FILE, json.dumps(
                {"schema": perf.BREAKDOWN_SCHEMA, "ranks": perf_ranks},
                indent=2)))
        if alert_reports:
            merged = dict(alert_reports[-1])
            merged["alerts"] = [a for rep in alert_reports
                                for a in rep.get("alerts", ())]
            merged["attempts"] = len(alert_reports)
            files.append((ALERTS_FILE, json.dumps(merged, indent=2)))
        if regression_reports:
            files.append((REGRESSION_FILE, json.dumps(
                {"schema": perf.REGRESSION_SCHEMA,
                 "reports": regression_reports}, indent=2)))
        if comms:
            files.append((COMMS_FILE, json.dumps({"reports": comms},
                                                 indent=2)))
        if fixit:
            files.append((FIXIT_FILE, json.dumps({"reports": fixit},
                                                 indent=2)))
        for rank in sorted(dumps):
            files.append((f"stack-rank-{rank}.txt", "\n".join(
                f"==== stack dump (reason: {reason}) ====\n{dump}"
                for reason, dump in dumps[rank])))
        # flight-recorder tails and OOM reports of every attempt's job
        # dir: recovery never fails the write
        tails = {}
        for job_dir in job_dirs:
            for rank, events in recover_job_dir(job_dir).items():
                tails.setdefault(rank, []).extend(events)
        for rank in sorted(tails):
            files.append((f"flightrec-rank-{rank}.json",
                          json.dumps({"rank": rank, "events": tails[rank]})))
        # OOM reports, and the captures' reports and Chrome traces
        for job_dir in job_dirs:
            for src in sorted(
                    glob.glob(os.path.join(job_dir, "oom_report*.json"))
                    + glob.glob(os.path.join(job_dir,
                                             "profile_report*.json"))
                    + glob.glob(os.path.join(job_dir, "trace-rank-*.json"))):
                try:
                    with open(src) as f:
                        files.append((os.path.basename(src), f.read()))
                except OSError:
                    continue
        if health:
            files.append((HEALTH_FILE,
                          json.dumps({"attempts": health}, indent=2)))
        paths = {}
        for name, text in files:
            path = os.path.join(out_dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
            paths[name] = path
        return paths
