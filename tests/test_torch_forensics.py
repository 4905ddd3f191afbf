"""The port's perf forensics against the JAX package's: the differential
step attribution and its rendering on the same windows, the regression
ledger read across packages both ways, the capture service on the CPU's
``torch.profiler`` (its step bound, wall cap, one capture at a time,
``AT_STEP``, its report's keys beside the JAX service's), an in-process
PROFILE_REQ / PROFILE_DONE round trip; and one module-scoped CPU gang of
two ranks whose steps slow down: exactly ``step_time_regression`` fires,
each rank's capture completes, ``/statusz`` is scraped mid-run, and the
run dir is read by both packages' doctors.

cloudpickle sends this module's functions by value, so a worker imports
the port and torch, never this module or JAX."""

import contextlib
import glob
import json
import os
import sys
import threading
import time
import urllib.request

import cloudpickle
import pytest
import torch

from sparkdl_tpu import observe as jobs
from sparkdl_tpu.observe import capture as jcapture
from sparkdl_tpu.observe import doctor as jdoctor
from sparkdl_tpu.observe import perf as jperf
from sparkdl_tpu_torch import HorovodRunner, observe
from sparkdl_tpu_torch.horovod import launcher
from sparkdl_tpu_torch.horovod.control_plane import (
    ControlPlaneClient,
    ControlPlaneServer,
)
from sparkdl_tpu_torch.observe import alerts, capture, doctor, forensics
from sparkdl_tpu_torch.observe import health, perf, statusz, top

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def fresh():
    observe._reset_for_tests()
    yield
    observe._reset_for_tests()


# -- diff_attribution --------------------------------------------------------


def _window(t0, step_s, coll_s, host_s, n=4):
    """``n`` steps of ``step_s`` on thread 1, each with a collective of
    ``coll_s`` and a host callback of ``host_s`` inside it."""
    out, t = [], t0
    for i in range(n):
        out.append({"name": "train_step", "cat": "train", "ph": "X",
                    "ts": t, "dur": step_s, "tid": 1,
                    "args": {"step": i, "phase": "execute"}})
        if coll_s:
            out.append({"name": "allreduce.grads", "cat": "collective",
                        "ph": "X", "ts": t + 10, "dur": coll_s, "tid": 1})
        if host_s:
            out.append({"name": "ckpt.snapshot", "cat": "host", "ph": "X",
                        "ts": t + 20 + coll_s, "dur": host_s, "tid": 1})
        t += step_s + 100
    return out


BASE = _window(0, 10_000, 2_000, 500)
SLOW = _window(10**7, 30_000, 20_000, 500)
DIFF_CASES = {
    "events": (BASE, SLOW),
    "rows": (jperf.attribution_report(BASE)["per_step"],
             jperf.attribution_report(SLOW)["per_step"]),
    "docs": ({"events": BASE, "mfu": 0.4}, {"events": SLOW, "mfu": 0.2}),
    "under_the_floor": (BASE, _window(10**7, 10_000, 2_000, 500)),
    "unattributable": (BASE, []),
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_attribution_and_its_lines_are_jaxs(case):
    base, regressed = DIFF_CASES[case]
    want = jperf.diff_attribution(base, regressed)
    got = perf.diff_attribution(base, regressed)
    assert got == want
    assert perf.render_diff_lines(got, indent="  ") == \
        jperf.render_diff_lines(want, indent="  ")
    if case == "events":
        assert got["top_growing_component"] == "collective"
        assert got["top_growing_spans"][0]["name"] == "allreduce.grads"
    if case in ("under_the_floor", "unattributable"):
        assert got is None or not got["significant"]


# -- the regression ledger ---------------------------------------------------


def test_the_ledger_reads_across_packages_both_ways(tmp_path, monkeypatch):
    monkeypatch.delenv("SPARKDL_TPU_PERF_HISTORY", raising=False)
    metrics = {"step_time_s": perf.sample_metric([0.5, 0.52, 0.49],
                                                 unit="s"),
               "tokens_per_s": {"value": 1000.0, "higher_is_better": True},
               "plain": 3.0, "dropped": {"value": None}}
    assert perf.sample_metric([0.5, 0.52, 0.49], unit="s") == \
        jperf.sample_metric([0.5, 0.52, 0.49], unit="s")
    rec = perf.history_record(metrics, device_kind="cpu", bench="b",
                              extra={"note": 1})
    jrec = jperf.history_record(metrics, device_kind="cpu", bench="b",
                                extra={"note": 1})
    assert {k: v for k, v in rec.items() if k != "ts"} == \
        {k: v for k, v in jrec.items() if k != "ts"}
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert perf.append_history(rec, path=ours) == ours
    assert jperf.append_history(rec, path=theirs) == theirs
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    with open(ours, "a") as f:
        f.write("not json\n\n")
    assert jperf.read_history(ours) == [rec]
    assert perf.read_history(theirs) == [rec]
    # no ledger: nothing written, nothing read
    assert perf.HISTORY_PATH is None
    assert perf.append_history(rec) is None and perf.read_history() == []
    monkeypatch.setattr(perf, "HISTORY_PATH", ours)
    assert perf.read_history() == [rec]
    # the alert engine's ledger baseline reads it
    monkeypatch.setattr(alerts, "STEP_BASELINE_S", None)
    engine = alerts.AlertEngine(None)
    assert engine.baseline_for(0) == 0.5
    assert engine.report()["baseline_source"] == "ledger"


# -- the capture service -----------------------------------------------------


class _Client:
    """What the capture service asks of a control-plane client."""

    def __init__(self):
        self.handler = None
        self.done = []
        self.got = threading.Event()

    def set_profile_handler(self, handler):
        self.handler = handler

    def send_profile_done(self, meta):
        self.done.append(meta)
        self.got.set()


def _steps(pkg, n, ops=True):
    """``n`` execute-phase step spans of ``pkg``'s timeline, each around
    a marked matmul (``user_step_<i>``)."""
    x = torch.ones(8, 8)
    for i in range(n):
        with pkg.span("train_step", cat="train", step=i, phase="execute"):
            if ops:
                with torch.profiler.record_function(f"user_step_{i}"):
                    torch.mm(x, x)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


@pytest.fixture
def telemetry(tmp_path, monkeypatch):
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "tele"))
    return tmp_path


def test_a_window_holds_exactly_its_steps(telemetry):
    client = _Client()
    svc = capture.CaptureService(client, 0, str(telemetry), steps=2).start()
    try:
        assert client.handler is not None
        client.handler({"reason": "alert", "rule": "mfu_drop"})
        _wait(lambda: svc._pending is not None)
        assert not svc.trigger()  # one at a time: this one is dropped
        _steps(observe, 5)
        assert client.got.wait(30)
    finally:
        svc.stop()
    (meta,) = client.done
    assert meta == {"rank": 0, "reason": "alert", "rule": "mfu_drop",
                    "report": "profile_report-rank-0-0.json",
                    "trace_dir": "trace-rank-0-0.json", "steps_captured": 2,
                    "window_s": meta["window_s"]}
    report = json.load(open(telemetry / meta["report"]))
    assert report["steps_captured"] == report["attribution"]["steps"] == 2
    assert [r["step"] for r in report["attribution"]["per_step"]] == [1, 2]
    trace = json.load(open(telemetry / meta["trace_dir"]))
    marks = sorted(e["name"] for e in trace["traceEvents"]
                   if e.get("name", "").startswith("user_step_"))
    assert marks == ["user_step_1", "user_step_2"]
    names = [e["name"] for e in observe.timeline().drain()]
    assert names.count("profile.capture.skipped") == 1
    assert names.count("profile.capture.done") == 1
    assert svc._tap not in (observe.timeline().observer,)


def test_the_wall_cap_and_at_step(telemetry, monkeypatch):
    client = _Client()
    svc = capture.CaptureService(client, 3, str(telemetry),
                                 max_window_s=0.2).start()
    try:
        svc.trigger(reason="manual")
        assert client.got.wait(30)  # no step came: the cap ended it
    finally:
        svc.stop()
    meta = client.done[0]
    assert meta["steps_captured"] == 0 and meta["trace_dir"] is None
    assert 0.2 <= meta["window_s"] < 10
    monkeypatch.setattr(capture, "AT_STEP", 2)
    client = _Client()
    svc = capture.CaptureService(client, 3, str(telemetry), steps=1).start()
    try:
        _steps(observe, 2)
        # the window opens at the next step boundary, or at this one
        _wait(lambda: svc._pending is not None or svc._buf is not None)
        _steps(observe, 3)
        assert client.got.wait(30)
    finally:
        svc.stop()
    (meta,) = client.done
    assert meta["reason"] == "at_step" and meta["steps_captured"] == 1
    assert meta["report"] == "profile_report-rank-3-0.json"


def test_the_report_has_jaxs_keys(telemetry, monkeypatch):
    """The same window through the JAX service (its xprof trace and
    device read stubbed) and the port's: the same report keys."""
    monkeypatch.setenv(jobs.TELEMETRY_DIR_ENV, str(telemetry / "jax"))
    monkeypatch.setattr(jcapture.jax_compat, "profiler_trace",
                        lambda path: contextlib.nullcontext(None))
    monkeypatch.setattr(jcapture.jax_compat, "device_memory_stats",
                        lambda: {})
    jobs._reset_for_tests()
    reports = {}
    try:
        for pkg, mod in (("jax", jcapture), ("port", capture)):
            client = _Client()
            obs = jobs if pkg == "jax" else observe
            svc = mod.CaptureService(client, 0, str(telemetry / pkg),
                                     steps=1)
            os.makedirs(telemetry / pkg, exist_ok=True)
            svc.start()
            try:
                svc.trigger(reason="manual")
                _wait(lambda: svc._buf is not None
                      or getattr(svc, "_pending", None) is not None)
                _steps(obs, 3, ops=False)
                assert client.got.wait(30)
            finally:
                svc.stop()
            reports[pkg] = json.load(
                open(telemetry / pkg / client.done[0]["report"]))
            assert set(client.done[0]) == {
                "rank", "reason", "rule", "report", "trace_dir",
                "steps_captured", "window_s"}
    finally:
        jobs._reset_for_tests()
    assert set(reports["port"]) == set(reports["jax"])
    assert reports["port"]["schema"] == reports["jax"]["schema"]
    assert set(reports["port"]["attribution"]) == \
        set(reports["jax"]["attribution"])


def test_profile_req_and_done_round_trip(telemetry):
    server = ControlPlaneServer(1)
    client = ControlPlaneClient(server.address, 0, server.secret)
    client.start_driver_watchdog()
    done = []
    server.on_profile_done = lambda rank, meta: done.append((rank, meta))
    svc = capture.CaptureService(client, 0, str(telemetry), steps=1).start()
    try:
        assert not server.request_profile(0)  # no READY yet: no socket
        client.send_ready()
        _wait(lambda: server.ready_count() == 1)
        assert server.request_profile(0, reason="manual", rule="r", steps=2)
        _wait(lambda: svc._pending is not None)
        _steps(observe, 4)
        _wait(lambda: done)
    finally:
        svc.stop()
        client.close()
        assert server.wait_drained(5.0)
        server.close()
    rank, meta = done[0]
    assert rank == 0 and meta["steps_captured"] == 2
    assert (meta["reason"], meta["rule"]) == ("manual", "r")
    assert server.profile_reports(0) == [meta]
    # with no service, PROFILE_REQ is dropped
    client = ControlPlaneClient.__new__(ControlPlaneClient)
    client._profile_handler = None
    client._dispatch_profile_request(b'{"reason": "alert"}')


# -- the manager -------------------------------------------------------------


class _ProfileServer:
    """A control plane that takes every PROFILE_REQ."""

    on_profile_done = None

    def __init__(self):
        self.asked = []

    def request_profile(self, rank, reason="manual", rule=None, steps=None):
        self.asked.append((rank, reason, rule))
        return True


def _trace_steps(t0, durs, coll=0.0):
    """Execute-phase step spans from wall time ``t0``, each with a
    collective of ``coll`` of its length inside it."""
    out, t = [], t0
    for i, d in enumerate(durs):
        out.append({"name": "train_step", "cat": "train", "ph": "X",
                    "ts": int(t * 1e6), "dur": int(d * 1e6), "tid": 1,
                    "args": {"step": i, "phase": "execute"}})
        if coll:
            out.append({"name": "reduce", "cat": "collective", "ph": "X",
                        "ts": int(t * 1e6), "dur": int(d * coll * 1e6),
                        "tid": 1, "args": {}})
        t += d
    return out


def _forensics_replay(pkg, now, tmp_path):
    """One alert and its PROFILE_DONE through one package's telemetry,
    alert engine and forensics manager; steps of another shape land
    between the two. (regression entries, captures block, the
    regression report as written, the entry as it stood at the alert)."""
    from sparkdl_tpu.observe import aggregate as jaggregate
    from sparkdl_tpu.observe import alerts as jalerts
    from sparkdl_tpu.observe import forensics as jforensics
    from sparkdl_tpu_torch.observe import aggregate

    wall = lambda: 1_700_000_000.0  # noqa: E731
    if pkg == "jax":
        gt = jaggregate.GangTelemetry()
        engine = jalerts.AlertEngine(gt, num_workers=1, env={
            "SPARKDL_TPU_ALERTS": "1", "SPARKDL_TPU_ALERT_CHECK_S": "0",
            "SPARKDL_TPU_ALERT_MIN_STEPS": "3",
            "SPARKDL_TPU_ALERT_STEP_FACTOR": "2.0",
            "SPARKDL_TPU_ALERT_WINDOW_S": "60"})
        manager = jforensics.ForensicsManager(
            gt, alert_engine=engine, wall=wall,
            env={"SPARKDL_TPU_PROFILE_ON_ALERT": "1"})
    else:
        gt = aggregate.GangTelemetry()
        engine = alerts.AlertEngine(gt, num_workers=1)
        manager = forensics.ForensicsManager(gt, alert_engine=engine,
                                             wall=wall)
    server = _ProfileServer()
    manager.bind_server(server)
    gt.ingest(0, {"pid": 100, "events": _trace_steps(
        now - 20, [0.01, 0.011, 0.009])})
    assert engine.poll() == []
    gt.ingest(0, {"pid": 100, "events": _trace_steps(now - 10, [0.05] * 6)})
    assert manager.on_alerts(engine.poll()) == [
        ("step_time_regression", 0)]
    assert server.asked == [(0, "alert", "step_time_regression")]
    at_alert = json.loads(json.dumps(gt._regression_reports))
    # the capture's steps: slower still, half of each in a collective
    gt.ingest(0, {"pid": 100, "events": _trace_steps(
        now - 3, [0.2] * 4, coll=0.5)})
    server.on_profile_done(0, {
        "reason": "alert", "rule": "step_time_regression",
        "report": "profile_report-rank-0-1.json",
        "trace_dir": "trace-rank-0-1.json", "steps_captured": 2,
        "window_s": 0.5})
    written = gt.write(str(tmp_path / pkg))["regression_report.json"]
    with open(written) as f:
        doc = json.load(f)
    return (json.loads(json.dumps(gt._regression_reports)),
            manager.captures_status(), doc, at_alert)


def test_the_manager_keeps_jaxs_entries(tmp_path, monkeypatch):
    """The same alert and PROFILE_DONE fed to both packages' managers
    give the same regression entries, captures block and
    ``regression_report.json``: the capture's names attached to the
    entry, whose diff stays the one of the window that fired."""
    from sparkdl_tpu.observe import statusz as jstatusz

    monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV, raising=False)
    monkeypatch.setenv("SPARKDL_TPU_PERF_HISTORY",
                       str(tmp_path / "no-ledger.jsonl"))
    for name, value in (("ENABLED", True), ("CHECK_S", 0.0),
                        ("MIN_STEPS", 3), ("STEP_FACTOR", 2.0),
                        ("WINDOW_S", 60.0)):
        monkeypatch.setattr(alerts, name, value)
    monkeypatch.setattr(forensics, "ON_ALERT", True)
    jobs._reset_for_tests()
    jstatusz._reset_fleets_for_tests()
    statusz._reset_fleets_for_tests()
    now = time.time()
    try:
        want = _forensics_replay("jax", now, tmp_path)
        got = _forensics_replay("port", now, tmp_path)
    finally:
        jobs._reset_for_tests()
    entries, captures, doc, at_alert = got
    assert (entries, captures) == want[:2]
    assert doc["reports"] == want[2]["reports"]
    assert entries[0]["capture"]["steps_captured"] == 2
    assert entries[0]["diff"] == at_alert[0]["diff"]
    assert entries[0]["diff"]["top_growing_component"] == "compute"


# -- the gang ----------------------------------------------------------------


def _slowdown_main(n_fast, n_slow, fast_s, slow_s):
    import time as _time

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.parallel.train import instrument_step

    torch.set_num_threads(2)
    hvd.init()

    def step(i):
        _time.sleep(fast_s if i < n_fast else slow_s)
        return i

    stepped = instrument_step(step)
    for i in range(n_fast + n_slow):
        stepped(i)
    return hvd.rank()


@pytest.fixture(scope="module")
def slowdown_gang(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("forensics_gang"))
    mp = pytest.MonkeyPatch()
    for mod, name, value in (
            (launcher, "START_TIMEOUT_S", 60.0),
            (launcher, "JOB_TIMEOUT_S", 120.0),
            (launcher, "ABORT_GRACE_S", 2.0),
            (launcher, "WORKER_DEVICE", "cpu"),
            (observe, "TELEMETRY_DIR", root), (observe, "FLUSH_S", 0.1),
            (health, "HEARTBEAT_S", 0.2), (alerts, "ENABLED", True),
            (alerts, "CHECK_S", 0.1), (alerts, "MIN_STEPS", 3),
            (alerts, "WINDOW_S", 3.0), (alerts, "STEP_FACTOR", 2.0),
            (forensics, "ON_ALERT", True), (capture, "STEPS", 2),
            (statusz, "PORT", 0)):
        mp.setattr(mod, name, value)
    servers, docs = [], []
    start = statusz.maybe_start_statusz

    def kept(*a, **k):
        servers.append(start(*a, **k))
        return servers[-1]

    mp.setattr(statusz, "maybe_start_statusz", kept)

    def scrape():
        while not servers:
            time.sleep(0.05)
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://{servers[0].address}/statusz",
                        timeout=5) as r:
                    docs.append(json.loads(r.read()))
            except OSError:
                return
            time.sleep(0.3)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    observe._reset_for_tests()
    try:
        out = HorovodRunner(np=-2).run(_slowdown_main, n_fast=12,
                                       n_slow=14, fast_s=0.05, slow_s=0.35)
    finally:
        mp.undo()
        observe._reset_for_tests()
    scraper.join(timeout=10)
    (run_dir,) = glob.glob(os.path.join(root, "run-*"))
    return out, run_dir, docs


@pytest.mark.gang
def test_gang_fires_exactly_step_time_regression(slowdown_gang):
    out, run_dir, _ = slowdown_gang
    assert out == 0
    doc = json.load(open(os.path.join(run_dir, "alerts.json")))
    assert {a["rule"] for a in doc["alerts"]} == {"step_time_regression"}
    for a in doc["alerts"]:
        assert a["detail"]["median_step_s"] > \
            2.0 * a["detail"]["baseline_step_s"]
    prom = open(os.path.join(run_dir, "metrics.prom")).read()
    assert ('gang_alerts_total{rank="driver",rule="step_time_regression",'
            'severity="critical"}') in prom


@pytest.mark.gang
def test_gang_capture_round_trip_completes(slowdown_gang):
    _, run_dir, _ = slowdown_gang
    reports = json.load(open(os.path.join(
        run_dir, "regression_report.json")))["reports"]
    assert reports
    for entry in reports:
        assert entry["rule"] == "step_time_regression"
        assert entry["diff"]["top_growing_component"] == "compute"
        cap = entry["capture"]
        assert cap["steps_captured"] == 2 and "error" not in cap
        assert os.path.exists(os.path.join(run_dir, cap["report"]))
        assert os.path.exists(os.path.join(run_dir, cap["trace_dir"]))


@pytest.mark.gang
def test_gang_statusz_scraped_mid_run(slowdown_gang):
    _, _, docs = slowdown_gang
    live = [d for d in docs if d["ranks"].get("0", {}).get("step")]
    assert live, docs[:1]
    doc = live[-1]
    assert doc["gang"]["num_workers"] == 2
    assert isinstance(doc["ranks"]["0"]["beat_age_s"], float)
    assert doc["perf"]["per_rank"]
    assert "sparkdl-tpu gang status" in top.render(doc)


@pytest.mark.gang
def test_gang_run_dir_is_read_by_both_doctors(slowdown_gang):
    _, run_dir, _ = slowdown_gang
    want, got = jdoctor.diagnose(run_dir), doctor.diagnose(run_dir)
    # the port's doctor also lists its Chrome trace files
    assert got["forensics"].pop("trace_dirs") == sorted(
        os.path.basename(p) for p in glob.glob(
            os.path.join(run_dir, "trace-rank-*.json")))
    want["forensics"].pop("trace_dirs")
    assert got == want
    text = doctor.render_text(doctor.diagnose(run_dir))
    for part in ("alerts:", "step_time_regression", "perf forensics",
                 "traces recovered: trace-rank-"):
        assert part in text, part
