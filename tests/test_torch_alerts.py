"""The port's streaming alert engine against the JAX package's: each of
the nine rules over the same scripted frames (TELEMETRY flushes into a
``GangTelemetry``, HEARTBEAT payloads into a ``HangDetector``, fleets
registered with statusz) under one injected clock, fed to the JAX
engine with its environment and to the port's with its module settings:
the same records and the same ``alerts.json``, floats to rel 1e-9. Also
the latch once per (rule, rank), ``set_world``, and the off contract (no
engine, no thread, no setting read from the environment)."""

import json
import math
import threading

import pytest
import torch

from sparkdl_tpu import observe as jobs
from sparkdl_tpu.observe import aggregate as jaggregate
from sparkdl_tpu.observe import alerts as jalerts
from sparkdl_tpu.observe import health as jhealth
from sparkdl_tpu.observe import statusz as jstatusz
from sparkdl_tpu.observe.metrics import Registry as JRegistry
from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.observe import aggregate, alerts, health, perf
from sparkdl_tpu_torch.observe import statusz
from sparkdl_tpu_torch.observe.metrics import Registry

torch.set_num_threads(2)

T0 = 1_700_000_000.0  # the injected wall clock at t = 0

# the JAX engine's environment and the port's settings, knob for knob
BASE_ENV = {"SPARKDL_TPU_ALERTS": "1", "SPARKDL_TPU_ALERT_CHECK_S": "0",
            "SPARKDL_TPU_ALERT_MIN_STEPS": "3",
            "SPARKDL_TPU_ALERT_STEP_FACTOR": "2.0",
            "SPARKDL_TPU_ALERT_WINDOW_S": "60"}
BASE_SETTINGS = {"ENABLED": True, "CHECK_S": 0.0, "MIN_STEPS": 3,
                 "STEP_FACTOR": 2.0, "WINDOW_S": 60.0}
ENV_OF = {"STEP_BASELINE_S": "SPARKDL_TPU_ALERT_STEP_BASELINE_S",
          "MIN_STEPS": "SPARKDL_TPU_ALERT_MIN_STEPS",
          "QUEUE_GROWTH": "SPARKDL_TPU_ALERT_QUEUE_GROWTH",
          "TTFT_P99_S": "SPARKDL_TPU_ALERT_TTFT_P99_S",
          "HBM_LEAK_BYTES_PER_STEP":
              "SPARKDL_TPU_ALERT_HBM_LEAK_BYTES_PER_STEP",
          "RSS_GROWTH_BYTES_PER_STEP":
              "SPARKDL_TPU_ALERT_RSS_GROWTH_BYTES_PER_STEP",
          "MFU_MIN": "SPARKDL_TPU_ALERT_MFU_MIN",
          "OVERLAP_MIN": "SPARKDL_TPU_ALERT_OVERLAP_MIN"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    """Both packages' registries, timelines and fleet tables fresh, the
    JAX telemetry switch off and its ledger empty (as the port's is),
    the port's settings restored after."""
    monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV, raising=False)
    monkeypatch.setenv("SPARKDL_TPU_PERF_HISTORY",
                       str(tmp_path / "no-ledger.jsonl"))
    for name in ("ENABLED", "CHECK_S", "MIN_STEPS", "STEP_FACTOR",
                 "WINDOW_S", *ENV_OF):
        monkeypatch.setattr(alerts, name, getattr(alerts, name))
    jobs._reset_for_tests()
    observe._reset_for_tests()
    jstatusz._reset_fleets_for_tests()
    statusz._reset_fleets_for_tests()
    yield
    jstatusz._reset_fleets_for_tests()
    statusz._reset_fleets_for_tests()
    jobs._reset_for_tests()
    observe._reset_for_tests()


def _steps(t0, durs, rank_tid=1, collective=False):
    """Execute-phase step spans from wall time ``t0`` (and, with
    ``collective``, an allreduce span inside each on the step thread)."""
    out, t = [], t0
    for i, d in enumerate(durs):
        out.append({"name": "train_step", "cat": "train", "ph": "X",
                    "ts": int(t * 1e6), "dur": int(d * 1e6),
                    "tid": rank_tid, "args": {"step": i,
                                              "phase": "execute"}})
        if collective:
            out.append({"name": "reduce", "cat": "collective", "ph": "X",
                        "ts": int((t + d / 4) * 1e6),
                        "dur": int(d / 2 * 1e6), "tid": rank_tid,
                        "args": {}})
        t += d
    return out


def _mem(progress, hbm, rss, cats=None):
    return {"progress": progress, "step": int(progress),
            "mem": {"hbm": hbm, "rss": rss, "categories": dict(cats or {}),
                    "unattributed": 0}}


# Each case: the rule that must fire alone, its extra settings, and the
# script: ("t", seconds) advances both clocks; ("ingest", rank, pid,
# {"events": [...] | "gauges": [(name, value, labels)]}) is a TELEMETRY
# flush (event times are offsets from the clock); ("beat", rank,
# payload) a HEARTBEAT; ("fleet", ttfts) registers a fleet whose
# server_ttft_seconds saw ``ttfts``; ("depth", n) sets its queue depth;
# ("poll",) polls the engine.
CASES = {
    "step_time_regression": ({}, [
        ("ingest", 0, 100, {"steps": (-10, [0.01, 0.011, 0.009])}),
        ("poll",),
        ("ingest", 0, 100, {"steps": (-5, [0.05] * 6)}), ("poll",),
        ("poll",)]),
    "heartbeat_gap": ({}, [
        ("beat", 0, {"progress": 3, "step": 3}),
        ("beat", 1, {"progress": 3, "step": 3}), ("poll",), ("t", 60),
        ("beat", 1, {"progress": 4, "step": 4}), ("poll",), ("poll",)]),
    "hbm_high_water": ({}, [
        ("beat", 0, {"progress": 1, "hbm": {"in_use": 950}}),
        ("beat", 1, {"progress": 1, "hbm": {"in_use": 100}}),
        ("poll",), ("poll",)]),
    "hbm_leak": ({"HBM_LEAK_BYTES_PER_STEP": 1000}, [
        op for i in range(5) for op in (
            ("beat", 0, _mem(i * 2.0, 10**6 + 10**6 * i, 5 * 10**6,
                             {"params": 10**6, "kv_pages": 10**6 * i})),
            ("poll",), ("t", 1))]),
    "host_rss_growth": ({"RSS_GROWTH_BYTES_PER_STEP": 1000}, [
        op for i in range(5) for op in (
            ("beat", 0, _mem(i * 2.0, 10**6, 10**7 + 10**6 * i)),
            ("poll",), ("t", 1))]),
    "queue_depth_growth": ({"QUEUE_GROWTH": 1.0}, [
        op for tick in range(8) for op in (
            ("ingest", 0, 100 + tick,
             {"gauges": [("server_queue_depth", 50 * tick, {})]}),
            ("poll",), ("t", 10))]),
    "server_ttft": ({"TTFT_P99_S": 0.05}, [
        ("fleet", [0.2] * 10), ("poll",), ("poll",)]),
    "mfu_drop": ({"MFU_MIN": 0.2}, [
        ("ingest", 0, 100, {"gauges": [
            ("mfu", 0.05, {"fn": "train_step", "device_kind": "cpu"})]}),
        ("ingest", 1, 101, {"gauges": [
            ("mfu", 0.5, {"fn": "train_step", "device_kind": "cpu"})]}),
        ("poll",), ("poll",)]),
    "overlap_drop": ({"OVERLAP_MIN": 0.5}, [
        ("ingest", 0, 100, {"steps": (-8, [0.1] * 5),
                            "collective": True}),
        ("poll",), ("poll",)]),
}


class _Fleet:
    """A registered fleet: its own package's registry, a queue depth."""

    address = ("127.0.0.1", 1)
    max_queue = None
    _restarts = 0

    def __init__(self, registry, ttfts):
        self.metrics = registry
        self.depth = 0
        for v in ttfts:
            registry.histogram("server_ttft_seconds").observe(v)

    def replica_states(self):
        return []

    def queue_depth(self):
        return self.depth


def _replay(pkg, script, extra, monkeypatch):
    """Run ``script`` through one package's telemetry, detector and
    engine; (records, report, alerts.json as written)."""
    jax = pkg == "jax"
    clock = {"t": 0.0}
    mono = lambda: clock["t"]  # noqa: E731
    wall = lambda: T0 + clock["t"]  # noqa: E731
    if jax:
        env = dict(BASE_ENV, **{ENV_OF[k]: str(v) for k, v in
                                extra.items()})
        monkeypatch.setenv("SPARKDL_TPU_HBM_BYTES", "1000")
        gt = jaggregate.GangTelemetry()
        det = jhealth.HangDetector(2, stall_s=100, clock=mono)
        engine = jalerts.AlertEngine(gt, detector=det, num_workers=2,
                                     env=env, clock=mono, wall=wall)
        registry, smod = JRegistry, jstatusz
    else:
        for k, v in dict(BASE_SETTINGS, **extra).items():
            monkeypatch.setattr(alerts, k, v)
        monkeypatch.setattr(perf, "hbm_capacity_bytes",
                            lambda kind=None: 1000)
        gt = aggregate.GangTelemetry()
        det = health.HangDetector(2, stall_s=100, clock=mono)
        engine = alerts.AlertEngine(gt, detector=det, num_workers=2,
                                    clock=mono, wall=wall)
        registry, smod = Registry, statusz
    fleets = []
    for op in script:
        if op[0] == "t":
            clock["t"] += op[1]
        elif op[0] == "ingest":
            _, rank, pid, what = op
            reg = registry()
            for name, value, labels in what.get("gauges", ()):
                reg.gauge(name, **labels).set(value)
            events = []
            if "steps" in what:
                off, durs = what["steps"]
                events = _steps(wall() + off, durs,
                                collective=what.get("collective", False))
            gt.ingest(rank, {"pid": pid, "host": "hostA",
                             "metrics": reg.snapshot(), "events": events})
        elif op[0] == "beat":
            det.observe_beat(op[1], op[2])
        elif op[0] == "fleet":
            fleets.append(_Fleet(registry(), op[1]))
            smod.register_fleet(fleets[-1])
        elif op[0] == "poll":
            engine.poll()
    gt.add_alert_report(engine.report())
    return engine.records(), engine.report(), gt


def _close(a, b, path="doc"):
    """``a == b`` with floats to rel 1e-9."""
    if isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-9), (path, a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rule_fires_as_in_jax(rule, monkeypatch, tmp_path):
    extra, script = CASES[rule]
    want, want_report, jgt = _replay("jax", script, extra, monkeypatch)
    got, got_report, gt = _replay("port", script, extra, monkeypatch)
    assert [r["rule"] for r in want] == [rule]
    _close(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    _close(got_report, want_report)
    jpath = jgt.write(str(tmp_path / "jax"))["alerts.json"]
    path = gt.write(str(tmp_path / "port"))["alerts.json"]
    _close(json.load(open(path)), json.load(open(jpath)))


def test_a_rule_latches_once_per_rank(monkeypatch):
    for k, v in dict(BASE_SETTINGS, STEP_BASELINE_S=0.02).items():
        monkeypatch.setattr(alerts, k, v)
    gt = aggregate.GangTelemetry()
    engine = alerts.AlertEngine(gt)
    import time

    for rank in (0, 1, 0):
        gt.ingest(rank, {"pid": 1, "events": _steps(time.time() - 5,
                                                    [0.05] * 5)})
        engine.poll()
    assert [(r["rule"], r["rank"]) for r in engine.records()] == [
        ("step_time_regression", 0), ("step_time_regression", 1)]
    assert engine.report()["baseline_source"] == "env"


def test_set_world_rebuilds_rank_state_like_jax(monkeypatch):
    """One engine spans a launch's attempts: ``set_world`` swaps in the
    attempt's detector and, on a new world size, drops the calibrated
    baselines and the departed ranks' latches, as JAX's does."""
    import time

    now = time.time()
    out = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            gt = jaggregate.GangTelemetry()
            engine = jalerts.AlertEngine(gt, num_workers=2, env=BASE_ENV)
        else:
            for k, v in BASE_SETTINGS.items():
                monkeypatch.setattr(alerts, k, v)
            gt = aggregate.GangTelemetry()
            engine = alerts.AlertEngine(gt, num_workers=2)
        for rank in (0, 1):
            gt.ingest(rank, {"pid": 100 + rank, "events": _steps(
                now - 10, [0.01, 0.011, 0.009])})
        engine.poll()
        gt.ingest(1, {"pid": 101, "events": _steps(now - 5, [0.05] * 6)})
        fired = [r["rank"] for r in engine.poll()]
        engine.set_world(1)
        out[pkg] = (fired, engine.baseline_for(0), engine.baseline_for(1),
                    sorted(engine._fired), engine.num_workers)
        engine.set_world(1, detector="det")
        assert engine._detector == "det"
    assert out["port"] == out["jax"]
    assert out["port"][0] == [1] and out["port"][3] == []


def test_off_makes_no_engine_and_no_thread(monkeypatch):
    monkeypatch.setenv("SPARKDL_TPU_ALERTS", "1")  # never read
    threads = set(threading.enumerate())
    assert alerts.ENABLED is False
    assert alerts.maybe_make_engine(aggregate.GangTelemetry()) is None
    monkeypatch.setattr(alerts, "ENABLED", True)
    assert alerts.maybe_make_engine(None) is None
    engine = alerts.maybe_make_engine(aggregate.GangTelemetry())
    assert isinstance(engine, alerts.AlertEngine)
    assert set(threading.enumerate()) == threads
    report = engine.report()
    assert report["alerts"] == [] and report["schema"] == \
        jalerts.ALERTS_SCHEMA
    assert [r["rule"] for r in report["rules"]] == [
        r for r, *_ in jalerts.RULES]


def test_format_alert_line_is_jaxs():
    rec = {"rule": "heartbeat_gap", "severity": "warning", "rank": 3,
           "detail": {"rank": 3, "beat_age_s": 9.0, "warn_at_s": 5.0}}
    assert alerts.format_alert_line(rec) == jalerts.format_alert_line(rec)
    rec = {"rule": "queue_depth_growth", "severity": "warning",
           "rank": None, "detail": {}}
    assert alerts.format_alert_line(rec) == jalerts.format_alert_line(rec)
