"""The streaming alert engine: declarative rules over a running gang's
live telemetry.

Counterpart of ``sparkdl_tpu/observe/alerts.py``. :class:`AlertEngine`'s
:meth:`~AlertEngine.poll` runs in the launcher's monitor loop beside the
hang detector's pass, throttled to :data:`CHECK_S`, over three live
inputs: the :class:`~sparkdl_tpu_torch.observe.aggregate.GangTelemetry`
journal (a rolling window of execute-phase step spans: the median step
time, the overlap efficiency), the merged live metric snapshots (``mfu``,
``server_queue_depth``) and the
:class:`~sparkdl_tpu_torch.observe.health.HangDetector`'s per-rank live
state (beat ages, the heartbeat's card memory, the mem sampler's
beacon). Each rule latches once per (rule, rank) per launch: a sustained
condition is one alert.

:data:`RULES`, in evaluation order (severity):

``step_time_regression`` (critical)
    The window's median execute step time exceeds :data:`STEP_FACTOR` x
    the baseline: :data:`STEP_BASELINE_S` when set, else the newest
    ledger record with a step-time metric
    (:func:`~sparkdl_tpu_torch.observe.perf.read_history`), else the
    smallest window median this run has shown (self-calibrated).
``heartbeat_gap`` (warning)
    A progressing rank's last beat is older than
    :data:`HEARTBEAT_GAP_FRAC` x the detector's stall window.
``hbm_high_water`` (critical)
    A rank's card memory in use crossed :data:`HBM_FRAC` of the card's
    ``total_memory`` (:func:`~sparkdl_tpu_torch.observe.perf.
    hbm_capacity_bytes`; dormant on the CPU).
``hbm_leak`` / ``host_rss_growth`` (critical / warning)
    A rank's card memory / host RSS grows faster than
    :data:`HBM_LEAK_BYTES_PER_STEP` / :data:`RSS_GROWTH_BYTES_PER_STEP`
    bytes per unit progress (the median of the per-interval slopes over
    the window); dormant unless set.
``queue_depth_growth`` (warning)
    The serving queue depth (the merged ``server_queue_depth`` gauges
    and every fleet registered with :mod:`~sparkdl_tpu_torch.observe.
    statusz`) grows faster than :data:`QUEUE_GROWTH` a second; dormant
    unless set.
``server_ttft`` (warning)
    A registered fleet's p99 time to first token (its
    ``server_ttft_seconds`` buckets) exceeds :data:`TTFT_P99_S`; dormant
    unless set.
``mfu_drop`` / ``overlap_drop`` (warning)
    A rank's ``mfu`` gauge / the window's overlap efficiency fell below
    :data:`MFU_MIN` / :data:`OVERLAP_MIN`; dormant unless set.

A firing emits an ``alert.<rule>`` instant (``cat="alert"``, on the
driver's lane), a ``gang_alerts_total{rule,severity}`` counter and a
record of :meth:`~AlertEngine.report`, which the launcher hands to
``GangTelemetry.add_alert_report`` (``alerts.json``, written for a clean
run too).

**Off by default.** The switch is the module setting :data:`ENABLED`;
with it False, or with telemetry off, :func:`maybe_make_engine` returns
None: no engine, no evaluation, no thread. Each ``SPARKDL_TPU_ALERT*``
knob of the JAX module is a module setting here, read when an engine is
made; no environment variable is read.
"""

import collections
import time

# the switch (the JAX module's SPARKDL_TPU_ALERTS)
ENABLED = False
# the rolling window and the poll cadence, seconds
WINDOW_S = 60.0
CHECK_S = 5.0
# step_time_regression: the factor over the baseline, the steps a window
# needs, and an explicit baseline (seconds; None: ledger, else the run's)
STEP_FACTOR = 2.0
MIN_STEPS = 5
STEP_BASELINE_S = None
# heartbeat_gap: the fraction of the detector's stall window
HEARTBEAT_GAP_FRAC = 0.5
# hbm_high_water: the fraction of the card's memory
HBM_FRAC = 0.9
# the dormant rules' bounds (None: the rule never fires)
QUEUE_GROWTH = None
TTFT_P99_S = None
HBM_LEAK_BYTES_PER_STEP = None
RSS_GROWTH_BYTES_PER_STEP = None
MFU_MIN = None
OVERLAP_MIN = None

DEFAULT_WINDOW_S = 60.0

ALERTS_SCHEMA = "sparkdl_tpu.observe.alerts/1"

SEV_WARNING = "warning"
SEV_CRITICAL = "critical"

# ledger metrics accepted as a step-time baseline (seconds)
LEDGER_STEP_METRICS = ("step_time_s", "train_step_seconds_mean")

# (rule, severity, evaluator method, one line for the docs and statusz),
# in evaluation order; an evaluator returns [(latch key, detail), ...]
RULES = (
    ("step_time_regression", SEV_CRITICAL, "_check_step_time",
     "rolling median step time exceeds factor x baseline"),
    ("heartbeat_gap", SEV_WARNING, "_check_heartbeat_gap",
     "beat age beyond the warn fraction of the stall window"),
    ("hbm_high_water", SEV_CRITICAL, "_check_hbm",
     "device HBM in use approaching the per-chip capacity budget"),
    ("hbm_leak", SEV_CRITICAL, "_check_hbm_leak",
     "device memory growing per unit progress beyond the bound"),
    ("host_rss_growth", SEV_WARNING, "_check_rss_growth",
     "host RSS growing per unit progress beyond the bound"),
    ("queue_depth_growth", SEV_WARNING, "_check_queue_growth",
     "server_queue_depth growing faster than the configured rate"),
    ("server_ttft", SEV_WARNING, "_check_server_ttft",
     "fleet p99 time-to-first-token above the configured bound"),
    ("mfu_drop", SEV_WARNING, "_check_mfu",
     "live MFU gauge below the configured floor"),
    ("overlap_drop", SEV_WARNING, "_check_overlap",
     "rolling overlap efficiency below the configured floor"),
)


def alerts_enabled():
    """:data:`ENABLED` as it stands."""
    return bool(ENABLED)


def _setting(name):
    v = globals()[name]
    return None if v is None else float(v)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return None
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def _histogram_quantile(buckets, counts, q):
    """Upper-bound quantile estimate from cumulative-style histogram
    buckets (``buckets`` are the finite upper bounds, ``counts`` the
    per-bucket observation counts, one trailing overflow count
    allowed). Returns the smallest bucket bound whose cumulative count
    reaches ``q`` of the total — the standard Prometheus-style
    conservative estimate — or None when the histogram is empty or
    the quantile lands in the overflow bucket with no finite bound."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            if i < len(buckets):
                return float(buckets[i])
            # Overflow bucket: the best upper bound we have is "beyond
            # the largest finite bucket" — report that bound so the
            # rule still fires when the tail blew past every bucket.
            return float(buckets[-1]) if buckets else None
    return float(buckets[-1]) if buckets else None


def maybe_make_engine(telemetry, detector=None, num_workers=None):
    """An :class:`AlertEngine` when telemetry is live (``telemetry`` a
    GangTelemetry) and :data:`ENABLED` is set; None otherwise."""
    if telemetry is None or not alerts_enabled():
        return None
    return AlertEngine(telemetry, detector=detector,
                       num_workers=num_workers)


class AlertEngine:
    """Streaming rule evaluation over the live gang. ``poll`` runs on the
    monitor loop's thread (throttled to ``check_s``); firings append
    from that thread only, so ``records`` and ``report`` take no lock.
    The settings are read here, once an engine."""

    def __init__(self, telemetry, detector=None, num_workers=None,
                 clock=time.monotonic, wall=time.time):
        self._telemetry = telemetry
        self._detector = detector
        self.num_workers = num_workers
        self._clock = clock
        self._wall = wall
        self.window_s = _setting("WINDOW_S")
        self.check_s = _setting("CHECK_S")
        self.step_factor = _setting("STEP_FACTOR")
        self.min_steps = int(_setting("MIN_STEPS"))
        self.hbm_frac = _setting("HBM_FRAC")
        self.heartbeat_gap_frac = _setting("HEARTBEAT_GAP_FRAC")
        self.mfu_min = _setting("MFU_MIN")
        self.overlap_min = _setting("OVERLAP_MIN")
        self.queue_growth = _setting("QUEUE_GROWTH")
        self.ttft_p99_s = _setting("TTFT_P99_S")
        self.hbm_leak_bps = _setting("HBM_LEAK_BYTES_PER_STEP")
        self.rss_growth_bps = _setting("RSS_GROWTH_BYTES_PER_STEP")
        # baseline: the explicit setting, the ledger, else self-calibrated
        # (the smallest window median a rank has shown)
        explicit = _setting("STEP_BASELINE_S")
        # "env": the JAX schema's name for an explicit baseline
        self._baseline_source = "env" if explicit is not None else None
        self._baselines = {}          # rank -> baseline seconds
        # rank -> the events of the window that calibrated its baseline:
        # the healthy side of the forensics' diff_attribution
        self._baseline_windows = {}
        self._explicit_baseline = explicit
        if explicit is None:
            ledger = self._ledger_baseline()
            if ledger is not None:
                self._explicit_baseline = ledger
                self._baseline_source = "ledger"
        self._fired = {}              # (rule, rank) -> record
        self._records = []
        self._queue_samples = collections.deque(maxlen=256)
        # rank -> deque of (progress, hbm, rss, categories): the leak
        # rules' window, fed from each poll's beacon samples
        self._mem_samples = {}
        self._next_check = 0.0

    # -- world changes ------------------------------------------------------

    def set_world(self, num_workers, detector=None):
        """Rebind the engine to this attempt's gang: one engine spans
        the attempts of a launch, and a resize would change both
        the rank universe and each rank's workload share. Always swap
        in the new attempt's detector; on an actual world-size change,
        drop the self-calibrated per-rank step-time baselines and the
        per-rank alert latches for ranks that no longer exist —
        rank k's data shard after a resize is a different rank k, so
        its old healthy floor would fire false regressions (and a
        departed rank's latch would suppress a future real one)."""
        if detector is not None:
            self._detector = detector
        if num_workers is None or num_workers == self.num_workers:
            return
        self.num_workers = num_workers
        # Self-calibrated baselines are per-(rank, shard); all stale.
        # Explicit env / ledger baselines are world-independent and
        # survive untouched (``_explicit_baseline`` is not cleared).
        self._baselines.clear()
        self._baseline_windows.clear()
        if self._baseline_source == "self":
            self._baseline_source = None
        for latch in [k for k in self._fired
                      if isinstance(k[1], int) and k[1] >= num_workers]:
            del self._fired[latch]
        # Leak windows for departed ranks are stale the same way: a
        # relaunched rank k after a resize is a different workload.
        for rank in [r for r in self._mem_samples if r >= num_workers]:
            del self._mem_samples[rank]

    # -- baseline ------------------------------------------------------------

    @staticmethod
    def _ledger_baseline():
        """Newest committed ledger entry carrying a recognized
        step-time metric (seconds), or None. Best-effort: an absent
        or malformed ledger must never break a launch."""
        try:
            from sparkdl_tpu_torch.observe.perf import read_history

            for entry in reversed(read_history()):
                for name in LEDGER_STEP_METRICS:
                    m = (entry.get("metrics") or {}).get(name)
                    if isinstance(m, dict):
                        m = m.get("value")
                    if isinstance(m, (int, float)) and m > 0:
                        return float(m)
        except Exception:
            pass
        return None

    def baseline_for(self, rank):
        if self._explicit_baseline is not None:
            return self._explicit_baseline
        return self._baselines.get(rank)

    def baseline_window(self, rank):
        """The telemetry events the rank's current self-calibrated
        baseline was computed from — the healthy-past side that
        ``perf.diff_attribution`` compares a regressed window against.
        Empty when the baseline came from env/ledger (no window)."""
        return list(self._baseline_windows.get(rank) or ())

    # -- the poll ------------------------------------------------------------

    def poll(self):
        """One throttled evaluation pass; returns the records fired
        by THIS pass (empty between check intervals)."""
        now = self._clock()
        if now < self._next_check:
            return []
        self._next_check = now + self.check_s
        ctx = self._build_context()
        fired = []
        for rule, severity, method, _doc in RULES:
            try:
                firings = getattr(self, method)(ctx) or []
            except Exception:
                # A rule must never take down the monitor loop — a
                # broken evaluator silently skips its pass (the other
                # rules still run) rather than killing the gang watch.
                continue
            for key, detail in firings:
                rec = self._fire(rule, severity, key, detail)
                if rec is not None:
                    fired.append(rec)
        return fired

    def _build_context(self):
        events = self._telemetry.recent_events(self.window_s,
                                               now=self._wall())
        events = self._drop_stale_ranks(events)
        # Execute-phase step durations per rank (seconds), window-
        # scoped — compile spans excluded exactly like observe.perf.
        step_durs = {}
        for rank, evs in events.items():
            durs = [
                float(e.get("dur", 0) or 0) / 1e6
                for e in evs
                if e.get("ph") == "X" and e.get("cat") == "train"
                and (e.get("args") or {}).get("phase") == "execute"
            ]
            if durs:
                step_durs[rank] = durs
        gauges = {}
        try:
            for extra, snap in self._telemetry.live_labeled():
                rank = extra.get("rank")
                for g in snap.get("gauges", ()):
                    gauges.setdefault(g["name"], []).append(
                        (rank, g.get("labels") or {}, g.get("value")))
        except Exception:
            pass
        live = self._detector.live_state() if self._detector else {}
        return {"events": events, "step_durs": step_durs,
                "gauges": gauges, "live": self._drop_stale_ranks(live)}

    def _drop_stale_ranks(self, by_rank):
        """Filter a rank-keyed mapping down to the CURRENT world: after
        an elastic shrink the telemetry window still holds the departed
        ranks' trailing events, and alerting on a rank that was
        deliberately resized away is noise, not signal."""
        world = self.num_workers
        if world is None:
            return by_rank
        return {r: v for r, v in by_rank.items()
                if not (isinstance(r, int) and r >= world)}

    # -- rule evaluators -----------------------------------------------------

    def _check_step_time(self, ctx):
        out = []
        for rank, durs in sorted(ctx["step_durs"].items()):
            if len(durs) < self.min_steps:
                continue
            med = _median(durs)
            base = self.baseline_for(rank)
            if base is None:
                # First qualifying window calibrates; later windows
                # only ever lower it (the run's healthy floor).
                self._baselines[rank] = med
                self._baseline_windows[rank] = list(
                    ctx["events"].get(rank) or ())
                if self._baseline_source is None:
                    self._baseline_source = "self"
                continue
            if self._explicit_baseline is None and med < base:
                self._baselines[rank] = med
                self._baseline_windows[rank] = list(
                    ctx["events"].get(rank) or ())
                continue
            if med > self.step_factor * base:
                out.append((rank, {
                    "rank": rank,
                    "median_step_s": round(med, 6),
                    "baseline_step_s": round(base, 6),
                    "factor": round(med / base, 3),
                    "threshold_factor": self.step_factor,
                    "baseline_source": self._baseline_source,
                    "steps_in_window": len(durs),
                }))
        return out

    def _check_heartbeat_gap(self, ctx):
        detector = self._detector
        if detector is None:
            return []
        warn_at = self.heartbeat_gap_frac * detector.stall_s
        out = []
        for rank, info in sorted(ctx["live"].items()):
            age = info.get("beat_age_s")
            if (info.get("state") == "progressing"
                    and isinstance(age, (int, float))
                    and age > warn_at):
                out.append((rank, {
                    "rank": rank,
                    "beat_age_s": age,
                    "warn_at_s": round(warn_at, 3),
                    "stall_s": detector.stall_s,
                }))
        return out

    def _check_hbm(self, ctx):
        from sparkdl_tpu_torch.observe.perf import hbm_capacity_bytes

        try:
            capacity = hbm_capacity_bytes()
        except Exception:
            capacity = None
        if not capacity:
            return []
        out = []
        for rank, info in sorted(ctx["live"].items()):
            hbm = info.get("hbm") or {}
            used = hbm.get("in_use", hbm.get("peak"))
            if (isinstance(used, (int, float))
                    and used > self.hbm_frac * capacity):
                out.append((rank, {
                    "rank": rank,
                    "hbm_bytes": used,
                    "capacity_bytes": capacity,
                    "fraction": round(used / capacity, 4),
                    "threshold_fraction": self.hbm_frac,
                }))
        return out

    def _ingest_mem_samples(self, ctx):
        """Fold each live rank's beacon mem sample into its rolling
        leak window. Idempotent within a poll (an unchanged
        progress/value pair is not re-appended), so both leak rules
        may call it without double-counting — and samples accumulate
        even while the thresholds are unset, like the queue rule's."""
        for rank, info in ctx["live"].items():
            if not isinstance(rank, int):
                continue
            mem = info.get("mem") or {}
            progress = info.get("progress")
            if not mem or not isinstance(progress, (int, float)):
                continue
            cats = dict(mem.get("categories") or {})
            if mem.get("unattributed") is not None:
                cats["unattributed"] = mem["unattributed"]
            sample = (float(progress), mem.get("hbm"), mem.get("rss"),
                      cats)
            dq = self._mem_samples.setdefault(
                rank, collections.deque(maxlen=256))
            if dq and dq[-1][:3] == sample[:3]:
                continue
            dq.append(sample)

    @staticmethod
    def _robust_slope(points):
        """Median of per-interval slopes over ``[(progress, value)]``
        — one outlier sample (a GC pause, a transient spike) cannot
        fake or mask a trend the way a first-vs-last delta could.
        None when fewer than two progress-advancing intervals carry
        values."""
        slopes = [
            (v1 - v0) / (p1 - p0)
            for (p0, v0), (p1, v1) in zip(points, points[1:])
            if p1 > p0 and v0 is not None and v1 is not None
        ]
        return _median(slopes) if len(slopes) >= 2 else None

    def _mem_growth_firings(self, ctx, idx, threshold):
        """Shared leak evaluator body: per-rank robust slope of sample
        field ``idx`` (1=hbm, 2=rss) per unit progress, fired against
        ``threshold`` bytes/step. Returns (rank, slope, span, window)
        tuples for ranks over the bound."""
        self._ingest_mem_samples(ctx)
        if threshold is None:
            return []
        out = []
        for rank, dq in sorted(self._mem_samples.items()):
            window = list(dq)
            if len(window) < 2:
                continue
            span = window[-1][0] - window[0][0]
            if span < self.min_steps:
                continue   # not enough progress to call a trend
            slope = self._robust_slope(
                [(s[0], s[idx]) for s in window])
            if slope is not None and slope > threshold:
                out.append((rank, slope, span, window))
        return out

    @staticmethod
    def _growing_category(window, span):
        """The fastest-growing category over the window — the leak
        suspect the doctor names. Falls back to 'unattributed' when
        the table is empty (nothing registered = everything leaks
        outside the trees)."""
        first, last = window[0][3] or {}, window[-1][3] or {}
        best, best_rate = None, 0.0
        for cat in set(first) | set(last):
            rate = (last.get(cat, 0) - first.get(cat, 0)) / max(span, 1)
            if rate > best_rate:
                best, best_rate = cat, rate
        return best or "unattributed"

    def _check_hbm_leak(self, ctx):
        out = []
        for rank, slope, span, window in self._mem_growth_firings(
                ctx, 1, self.hbm_leak_bps):
            out.append((rank, {
                "rank": rank,
                "slope_bytes_per_step": round(slope, 1),
                "threshold_bytes_per_step": self.hbm_leak_bps,
                "progress_span": round(span, 1),
                "category": self._growing_category(window, span),
                "hbm_bytes": window[-1][1],
            }))
        return out

    def _check_rss_growth(self, ctx):
        out = []
        for rank, slope, span, window in self._mem_growth_firings(
                ctx, 2, self.rss_growth_bps):
            out.append((rank, {
                "rank": rank,
                "slope_bytes_per_step": round(slope, 1),
                "threshold_bytes_per_step": self.rss_growth_bps,
                "progress_span": round(span, 1),
                # host-side growth has no HBM category table; the
                # category the doctor names IS the host heap
                "category": "host_rss",
                "rss_bytes": window[-1][2],
            }))
        return out

    def _check_queue_growth(self, ctx):
        # Two live sources: the merged server_queue_depth gauge (a
        # worker that exports one through gang telemetry) and any
        # FleetFrontend registered IN-PROCESS with the statusz module
        # — the fleet's own registry is private and never crosses the
        # control plane, so without this the rule could not see the
        # colocated serving tier at all.
        depths = ctx["gauges"].get("server_queue_depth") or []
        total = sum(v for _r, _l, v in depths
                    if isinstance(v, (int, float)))
        have_source = bool(depths)
        try:
            from sparkdl_tpu_torch.observe.statusz import fleet_status

            for fleet in fleet_status() or ():
                d = fleet.get("queue_depth")
                if isinstance(d, (int, float)):
                    total += d
                    have_source = True
        except Exception:
            pass
        if not have_source:
            return []
        now = self._clock()
        self._queue_samples.append((now, total))
        if self.queue_growth is None:
            return []
        cutoff = now - self.window_s
        window = [(t, v) for t, v in self._queue_samples if t >= cutoff]
        if len(window) < 2:
            return []
        (t0, v0), (t1, v1) = window[0], window[-1]
        span = t1 - t0
        if span < self.window_s / 4:
            return []   # not enough history to call a trend yet
        rate = (v1 - v0) / span
        if rate > self.queue_growth:
            return [(None, {
                "depth": v1,
                "growth_per_s": round(rate, 4),
                "threshold_per_s": self.queue_growth,
                "window_s": round(span, 1),
            })]
        return []

    def _check_server_ttft(self, ctx):
        # Fleet-level SLO, not a rank-level one: every FleetFrontend
        # registered in-process with the statusz module exports a
        # server_ttft_seconds histogram; estimate p99 from its buckets
        # (conservative upper bound) and fire once per fleet index
        # when the bound is configured and exceeded.
        if self.ttft_p99_s is None:
            return []
        try:
            from sparkdl_tpu_torch.observe.statusz import live_fleets
        except Exception:
            return []
        out = []
        for idx, fleet in enumerate(live_fleets() or ()):
            metrics = getattr(fleet, "metrics", None)
            if metrics is None:
                continue
            try:
                snap = metrics.snapshot()
            except Exception:
                continue
            for h in snap.get("histograms", ()):
                if h.get("name") != "server_ttft_seconds":
                    continue
                count = h.get("count") or sum(h.get("counts") or ())
                if count < self.min_steps:
                    continue
                p99 = _histogram_quantile(
                    h.get("buckets") or (), h.get("counts") or (), 0.99)
                if p99 is not None and p99 > self.ttft_p99_s:
                    out.append((f"fleet{idx}", {
                        "fleet": idx,
                        "ttft_p99_s": round(p99, 6),
                        "threshold_s": self.ttft_p99_s,
                        "requests": count,
                    }))
        return out

    def _check_mfu(self, ctx):
        if self.mfu_min is None:
            return []
        out = []
        for rank, labels, v in ctx["gauges"].get("mfu", ()):
            # merged-snapshot rank labels are STRINGS ("0", "driver");
            # normalize worker ranks to ints so the record carries the
            # same rank shape as the event-based rules (the doctor and
            # top render ' rank N' from it)
            if isinstance(rank, str) and rank.isdigit():
                rank = int(rank)
            if isinstance(v, (int, float)) and v < self.mfu_min:
                out.append((rank, {
                    "rank": rank if isinstance(rank, int) else None,
                    "mfu": round(v, 6),
                    "threshold": self.mfu_min,
                    "fn": labels.get("fn"),
                }))
        return out

    def _check_overlap(self, ctx):
        if self.overlap_min is None:
            return []
        from sparkdl_tpu_torch.observe.perf import attribution_report

        out = []
        for rank, evs in sorted(ctx["events"].items()):
            rep = attribution_report(evs)
            eff = rep.get("overlap_efficiency")
            if (rep.get("steps", 0) >= self.min_steps
                    and isinstance(eff, (int, float))
                    and eff < self.overlap_min):
                out.append((rank, {
                    "rank": rank,
                    "overlap_efficiency": round(eff, 4),
                    "threshold": self.overlap_min,
                    "steps_in_window": rep["steps"],
                }))
        return out

    # -- firing + report -----------------------------------------------------

    def _fire(self, rule, severity, key, detail):
        """Latch-once per (rule, key): emit the timeline instant and
        counter, append the record. Returns the record, or None when
        this (rule, key) already fired this launch."""
        latch = (rule, key)
        if latch in self._fired:
            return None
        from sparkdl_tpu_torch import observe

        record = {
            "rule": rule,
            "severity": severity,
            "rank": key if isinstance(key, int) else None,
            "ts": self._wall(),
            "detail": dict(detail),
        }
        self._fired[latch] = record
        self._records.append(record)
        observe.instant(f"alert.{rule}", cat="alert",
                        severity=severity, **detail)
        observe.inc("gang_alerts_total", rule=rule, severity=severity)
        return record

    def records(self):
        return list(self._records)

    def report(self):
        """The ``alerts.json`` payload: catalog + config + firings.
        Written by :meth:`GangTelemetry.write` even when ``alerts``
        is empty — a clean run's artifact says the rules ran."""
        return {
            "schema": ALERTS_SCHEMA,
            "enabled": True,
            "window_s": self.window_s,
            "check_s": self.check_s,
            "rules": [
                {"rule": r, "severity": s, "doc": doc}
                for r, s, _m, doc in RULES
            ],
            "baseline_step_s": (
                self._explicit_baseline
                if self._explicit_baseline is not None
                else ({str(r): round(b, 6)
                       for r, b in sorted(self._baselines.items())}
                      or None)),
            "baseline_source": self._baseline_source,
            "alerts": self.records(),
        }


def format_alert_line(record):
    """The one human rendering of a firing record —
    ``[severity] rule rank N: k=v, ...`` — shared by
    the doctor and ``top`` so the two surfaces can
    never render the same ``alerts.json`` differently."""
    where = (f" rank {record['rank']}"
             if record.get("rank") is not None else "")
    detail = record.get("detail") or {}
    extras = ", ".join(f"{k}={v}" for k, v in sorted(detail.items())
                       if k != "rank")
    return (f"[{record.get('severity')}] {record.get('rule')}{where}"
            + (f": {extras}" if extras else ""))


__all__ = [
    "AlertEngine", "maybe_make_engine", "alerts_enabled",
    "format_alert_line",
    "RULES", "ALERTS_SCHEMA", "SEV_WARNING", "SEV_CRITICAL",
]
