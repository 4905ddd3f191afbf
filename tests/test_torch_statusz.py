"""The port's live status server against the JAX package's: the
``/statusz`` document, the ``/metrics`` text and the ``/events`` tail of
two servers over the same gang state (the same TELEMETRY flushes, beats,
alert firing, capture and registered fleet); the weak fleet registry;
and ``statusz.PORT = None`` opening no socket and starting no thread."""

import gc
import http.client
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from sparkdl_tpu import observe as jobs
from sparkdl_tpu.horovod import supervisor as jsupervisor
from sparkdl_tpu.observe import aggregate as jaggregate
from sparkdl_tpu.observe import alerts as jalerts
from sparkdl_tpu.observe import forensics as jforensics
from sparkdl_tpu.observe import health as jhealth
from sparkdl_tpu.observe import statusz as jstatusz
from sparkdl_tpu.observe.metrics import Registry as JRegistry
from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.horovod import supervisor
from sparkdl_tpu_torch.observe import aggregate, alerts, forensics, health
from sparkdl_tpu_torch.observe import statusz
from sparkdl_tpu_torch.observe.metrics import Registry

torch.set_num_threads(2)

ENV = {"SPARKDL_TPU_ALERTS": "1", "SPARKDL_TPU_ALERT_CHECK_S": "0",
       "SPARKDL_TPU_ALERT_MIN_STEPS": "3",
       "SPARKDL_TPU_ALERT_STEP_BASELINE_S": "0.02",
       "SPARKDL_TPU_ALERT_WINDOW_S": "60"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    monkeypatch.delenv(jobs.TELEMETRY_DIR_ENV, raising=False)
    monkeypatch.delenv("SPARKDL_TPU_STATUSZ_PORT", raising=False)
    monkeypatch.setenv("SPARKDL_TPU_PERF_HISTORY",
                       str(tmp_path / "no-ledger.jsonl"))
    for mod, names in ((alerts, ("ENABLED", "CHECK_S", "MIN_STEPS",
                                 "STEP_BASELINE_S", "WINDOW_S")),
                       (statusz, ("PORT",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    # each package's attempt-world ledger empty: a fresh driver
    monkeypatch.setattr(jsupervisor, "_attempt_worlds", [])
    monkeypatch.setattr(jsupervisor, "_attempt_stamps", [])
    monkeypatch.setattr(supervisor, "_attempt_worlds", [])
    monkeypatch.setattr(supervisor, "_attempt_stamps", [])
    jobs._reset_for_tests()
    observe._reset_for_tests()
    jstatusz._reset_fleets_for_tests()
    statusz._reset_fleets_for_tests()
    yield
    jstatusz._reset_fleets_for_tests()
    statusz._reset_fleets_for_tests()
    jobs._reset_for_tests()
    observe._reset_for_tests()


class _Fleet:
    address = ("127.0.0.1", 8)
    max_queue = 64
    _restarts = 1

    def __init__(self, registry):
        self.metrics = registry

    def replica_states(self):
        return [{"replica": 0, "alive": True, "queued": 2, "inflight": 1,
                 "restart_cause": None}]

    def queue_depth(self):
        return 3


class _Server:
    """A control plane that answers PROFILE_REQ at once."""

    def __init__(self):
        self.on_profile_done = None

    def request_profile(self, rank, reason="alert", rule=None, steps=None):
        return True


def _gang(pkg, monkeypatch, t0):
    """One package's gang state, built from the same frames (events from
    wall time ``t0``): two ranks' step spans, gauges and beats, the alert
    firings, their captures (rank 1's completed), one registered fleet;
    its status server (port 0)."""
    if pkg == "jax":
        gt, reg = jaggregate.GangTelemetry(), JRegistry
        det = jhealth.HangDetector(2, stall_s=100)
        engine = jalerts.AlertEngine(gt, detector=det, num_workers=2,
                                     env=ENV)
        fx = jforensics.ForensicsManager(gt, alert_engine=engine)
        smod = jstatusz
    else:
        for k, v in {"ENABLED": True, "CHECK_S": 0.0, "MIN_STEPS": 3,
                     "STEP_BASELINE_S": 0.02, "WINDOW_S": 60.0}.items():
            monkeypatch.setattr(alerts, k, v)
        gt, reg = aggregate.GangTelemetry(), Registry
        det = health.HangDetector(2, stall_s=100)
        engine = alerts.AlertEngine(gt, detector=det, num_workers=2)
        fx = forensics.ForensicsManager(gt, alert_engine=engine)
        smod = statusz
    for rank in (0, 1):
        r = reg()
        r.gauge("mfu", fn="train_step", device_kind="cpu").set(0.25 + rank)
        r.counter("collective_calls_total", op="reduce").inc(4)
        r.histogram("train_step_seconds", phase="execute").observe(0.05)
        events = [{"name": "train_step", "cat": "train", "ph": "X",
                   "ts": int((t0 + 0.1 * i) * 1e6), "dur": 50_000 * (
                       1 + (rank and i > 2)), "tid": 1,
                   "args": {"step": i, "phase": "execute"}}
                  for i in range(5)]
        events.append({"name": "worker.start", "cat": "worker", "ph": "i",
                       "ts": int(t0 * 1e6), "tid": 1, "s": "p",
                       "args": {"rank": rank}})
        gt.ingest(rank, {"pid": 10 + rank, "host": "hostA",
                         "metrics": r.snapshot(), "events": events})
        det.observe_beat(rank, {"progress": 5, "step": 4,
                                "collective": "reduce",
                                "hbm": {"in_use": 1000 * (rank + 1)},
                                "mem": {"rss": 10**8, "hbm": None,
                                        "categories": {"params": 10},
                                        "unattributed": 0}})
    fired = engine.poll()
    fx.bind_server(_Server())
    monkeypatch.setattr(fx, "on_alert_enabled", True)
    fx.on_alerts(fired)
    fx._on_profile_done(1, {"reason": "alert",
                            "rule": "step_time_regression",
                            "report": "profile_report-rank-1-0.json",
                            "trace_dir": "trace-rank-1-0.json",
                            "steps_captured": 2, "window_s": 0.5})
    fleet = _Fleet(reg())
    fleet.metrics.histogram("server_ttft_seconds").observe(0.1)
    smod.register_fleet(fleet)
    server = smod.StatuszServer(gt, detector=det, num_workers=2,
                                alerts=engine, forensics=fx).start()
    return server, fleet


_VOLATILE = {"ts", "uptime_s", "beat_age_s"}


def _stable(doc):
    """The document without its clock readings (the send times)."""
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


def _get(server, path):
    with urllib.request.urlopen(f"http://{server.address}{path}",
                                timeout=10) as r:
        return r.read().decode()


def _sse(server, n):
    """The first ``n`` events of the ``/events`` tail."""
    host, port = server.address.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.request("GET", "/events")
    resp = conn.getresponse()
    out, cur = [], {}
    while len(out) < n:
        line = resp.fp.readline().decode().rstrip("\n")
        if line.startswith("id: "):
            cur["id"] = int(line[4:])
        elif line.startswith("data: "):
            cur["data"] = json.loads(line[6:])
        elif not line and cur:
            out.append(cur)
            cur = {}
    conn.close()
    return out


@pytest.fixture
def servers(monkeypatch):
    t0 = time.time() - 5
    jserver, jfleet = _gang("jax", monkeypatch, t0)
    server, fleet = _gang("port", monkeypatch, t0)
    try:
        yield jserver, server
    finally:
        jserver.close()
        server.close()


def test_status_doc_is_jaxs(servers):
    jserver, server = servers
    want = json.loads(_get(jserver, "/statusz"))
    got = json.loads(_get(server, "/statusz"))
    assert want["schema"] == "sparkdl_tpu.observe.statusz/1"
    assert got.pop("schema") == "sparkdl_tpu_torch.observe.statusz/1"
    want.pop("schema")
    assert _stable(got) == _stable(want)
    # what the 25a check reads: a rank's step, its beat age, the window
    assert got["ranks"]["0"]["step"] == 4
    assert isinstance(got["ranks"]["0"]["beat_age_s"], float)
    assert got["perf"]["per_rank"]["1"]["steps"] == 5
    assert [(a["rule"], a["rank"]) for a in got["alerts"]["fired"]] == [
        ("step_time_regression", 0), ("step_time_regression", 1)]
    assert got["fleet"][0]["replicas"][0]["queued"] == 2
    assert got["captures"]["completed"][0]["steps_captured"] == 2


def test_metrics_text_is_jaxs(servers):
    """The same series and values; ``build_info`` differs by design
    (``torch_version`` in place of ``jax_version``)."""
    jserver, server = servers

    def lines(text):
        return sorted(ln for ln in text.splitlines()
                      if ln and "build_info" not in ln)

    got = _get(server, "/metrics")
    assert lines(got) == lines(_get(jserver, "/metrics"))
    assert 'mfu{device_kind="cpu",fn="train_step",rank="1"} 1.25' in got
    assert 'torch_version=' in got


def test_events_tail_is_jaxs(servers):
    jserver, server = servers
    want = _sse(jserver, 12)
    got = _sse(server, 12)
    assert got == want
    assert [e["id"] for e in got] == list(range(1, 13))
    assert {e["data"]["rank"] for e in got} == {0, 1}


def test_capturez_asks_the_forensics_manager(servers):
    _, server = servers
    req = urllib.request.Request(
        f"http://{server.address}/capturez?rank=1", data=b"",
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read()) == {"ok": True, "detail": "requested",
                                        "rank": "1"}
    doc = json.loads(_get(server, "/statusz"))
    assert [(c["rank"], c["reason"]) for c in doc["captures"][
        "in_flight"]] == [(0, "alert"), (1, "manual")]
    # rank 0's alert capture is still in flight: a second one is refused
    req = urllib.request.Request(
        f"http://{server.address}/capturez?rank=0", data=b"",
        method="POST")
    with pytest.raises(urllib.error.HTTPError, match="409"):
        urllib.request.urlopen(req, timeout=10)


def test_the_fleet_registry_is_weak_and_close_unregisters():
    a, b = _Fleet(Registry()), _Fleet(Registry())
    statusz.register_fleet(a)
    statusz.register_fleet(a)  # idempotent
    statusz.register_fleet(b)
    assert statusz.live_fleets() == [a, b]
    assert [f["queue_depth"] for f in statusz.fleet_status()] == [3, 3]
    statusz.unregister_fleet(a)
    assert statusz.live_fleets() == [b]
    del b
    gc.collect()
    assert statusz.live_fleets() == [] and statusz.fleet_status() is None


def test_port_none_opens_no_socket_and_no_thread(monkeypatch):
    monkeypatch.setenv("SPARKDL_TPU_STATUSZ_PORT", "0")  # never read
    before = {t.name for t in threading.enumerate()}
    assert statusz.PORT is None and statusz.statusz_port() is None
    assert statusz.maybe_start_statusz(aggregate.GangTelemetry()) is None
    monkeypatch.setattr(statusz, "PORT", 0)
    assert statusz.maybe_start_statusz(None) is None
    server = statusz.maybe_start_statusz(aggregate.GangTelemetry(),
                                         num_workers=1)
    try:
        assert server.port > 0
        assert "sparkdl-torch-statusz" in {
            t.name for t in threading.enumerate()}
        assert _get(server, "/healthz") == "ok\n"
    finally:
        server.close()
    assert "sparkdl-torch-statusz" not in before
    # elastic= is taken and its status shown (the elastic controller)
    elastic = types.SimpleNamespace(
        status=lambda: {"enabled": True, "current_np": 1,
                        "available_np": 2})
    server = statusz.maybe_start_statusz(aggregate.GangTelemetry(),
                                         num_workers=1, elastic=elastic)
    try:
        assert json.loads(_get(server, "/statusz"))["elastic"] == \
            elastic.status()
    finally:
        server.close()
