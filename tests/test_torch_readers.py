"""The port's readers against the JAX package's on the same inputs: the
doctor on a synthetic run dir that holds every optional artifact (and on
the port's own gang run dir in ``tests/test_torch_forensics.py``), the
compare gate on run dirs, ledgers and documents, the trend over a ledger
and the caller's baselines, and ``top``'s frame over status documents.
Every input is made under ``tmp_path``; none of the repo's bench or
baseline files is read."""

import json
import os

import pytest
import torch

from sparkdl_tpu.observe import compare as jcompare
from sparkdl_tpu.observe import doctor as jdoctor
from sparkdl_tpu.observe import perf as jperf
from sparkdl_tpu.observe import top as jtop
from sparkdl_tpu.observe import trend as jtrend
from sparkdl_tpu_torch.observe import compare, doctor, perf, top, trend

torch.set_num_threads(2)


def _steps(t0, durs, tid=1):
    out, t = [], t0
    for i, d in enumerate(durs):
        out.append({"name": "train_step", "cat": "train", "ph": "X",
                    "ts": t, "dur": d, "tid": tid,
                    "args": {"step": i, "phase": "execute"}})
        out.append({"name": "reduce", "cat": "collective", "ph": "X",
                    "ts": t + 10, "dur": d // 4, "tid": tid, "args": {}})
        t += d + 50
    return out


def _lane(pid, events):
    return [dict(e, pid=pid) for e in events]


def _metrics(step_s, steps=4):
    def rank(r):
        return {"labels": {"rank": str(r)}, "counters": [
            {"name": "collective_bytes_total",
             "labels": {"rank": str(r), "op": "reduce"}, "value": 16384},
            {"name": "train_step_total",
             "labels": {"rank": str(r), "phase": "execute"},
             "value": steps},
            {"name": "server_requests_total",
             "labels": {"rank": str(r), "code": "200"}, "value": 3}],
            "gauges": [
                {"name": "train_step_per_second",
                 "labels": {"rank": str(r)}, "value": 1.0 / step_s},
                {"name": "mfu", "labels": {"rank": str(r),
                                           "fn": "train_step",
                                           "device_kind": "cpu"},
                 "value": 0.3},
                {"name": "host_rss_bytes", "labels": {"rank": str(r)},
                 "value": 3 * 10**8},
                {"name": "mem_bytes",
                 "labels": {"rank": str(r), "category": "params"},
                 "value": 2 * 10**8}],
            "histograms": [
                {"name": "train_step_seconds",
                 "labels": {"rank": str(r), "phase": "execute"},
                 "buckets": [0.1, 1.0], "counts": [0, steps, 0],
                 "sum": step_s * steps, "count": steps},
                {"name": "engine_batch_utilization", "labels": {},
                 "buckets": [0.5, 1.0], "counts": [1, 2, 0],
                 "sum": 2.0, "count": 3}]}
    return {"generated_at": 0, "series": [rank(0), rank(1)]}


def _run_dir(root, name, step_us, hang=False):
    """A run dir with every artifact the doctor reads."""
    run = root / name
    run.mkdir()
    base, slow = _steps(0, [step_us] * 4), _steps(10**6, [3 * step_us] * 4)
    driver = [
        {"name": "health.stall", "cat": "health", "ph": "i", "ts": 100,
         "tid": 1, "s": "p", "args": {"rank": 1, "verdict": "stall",
                                      "step": 417, "collective": "reduce"}},
        {"name": "gang.failure", "cat": "supervisor", "ph": "i", "ts": 300,
         "tid": 1, "s": "p", "args": {"attempt": 1, "verdict": "transient",
                                      "cause": "HANG (straggler)"}},
        {"name": "alert.step_time_regression", "cat": "alert", "ph": "i",
         "ts": 350, "tid": 1, "s": "p", "args": {"severity": "critical"}},
        {"name": "request", "cat": "serving", "ph": "X", "ts": 10,
         "dur": 500, "tid": 7, "args": {"rid": 7, "ttft_s": 0.02,
                                        "queue_wait_s": 0.001, "tokens": 9,
                                        "tokens_per_sec": 100.0,
                                        "code": 200, "prompt_len": 5}}]
    if hang:
        driver.insert(1, {"name": "health.hang", "cat": "health",
                          "ph": "i", "ts": 200, "tid": 1, "s": "p",
                          "args": {"verdict": "straggler", "stalled": [1],
                                   "silent": []}})
    events = (_lane(0, driver) + _lane(1, base + slow)
              + _lane(2, base + slow)
              + [{"name": "gang.resume", "cat": "supervisor", "ph": "i",
                  "ts": 400, "pid": 2, "tid": 1, "s": "p",
                  "args": {"attempt": 1, "resume_step": 416}}])
    docs = {
        "timeline.json": {"traceEvents": events},
        "metrics.json": _metrics(step_us / 1e6),
        "health.json": {"attempts": [{
            "num_workers": 2, "stall_s": 2.0,
            "hang_verdict": "straggler" if hang else None,
            "stalled": [1] if hang else [], "silent": [],
            "ranks": {"0": {"step": 418, "progress": 9,
                            "collective": "reduce",
                            "hbm": {"peak": 15247630336},
                            "mem": {"rss": 10**8, "categories":
                                    {"params": 9 * 10**7},
                                    "unattributed": 10**6}},
                      "1": {"step": 417, "progress": 5,
                            "collective": "reduce", "hbm": {}}}}]},
        "flightrec-rank-1.json": {"rank": 1, "events": [
            {"name": "chaos.stall_in_step", "ts": 1, "ph": "i"}]},
        "perf.json": {"schema": jperf.BREAKDOWN_SCHEMA, "ranks": {
            "0": jperf.attribution_report(base + slow)}},
        "comms_report.json": {"reports": [{
            "schema": "sparkdl_tpu.analysis.comms_report/1",
            "name": "train_step", "device_kind": "cpu",
            "totals": {"count": 3, "wire_bytes_per_device": 2048.0,
                       "predicted_s": 2e-7, "by_kind": {}}}]},
        "fixit_report.json": {"reports": [{
            "name": "train_step", "mode": "suggest",
            "summary": {"fixes": 1},
            "fixes": [{"rule_id": "DONATE", "action": "donate_argnums",
                       "verified": True, "applied": False,
                       "degraded": False,
                       "fix": {"description": "donate the params"},
                       "proofs": {"budget_delta": {
                           "ok": True, "memory": {
                               "peak_bytes_delta": -1024}}}}],
            "unfixable": []}]},
        "alerts.json": {"schema": "sparkdl_tpu.observe.alerts/1",
                        "enabled": True, "window_s": 3.0, "check_s": 0.1,
                        "rules": [{"rule": "step_time_regression",
                                   "severity": "critical", "doc": "d"}],
                        "baseline_step_s": {"0": 0.01},
                        "baseline_source": "self", "attempts": 1,
                        "alerts": [{"rule": "step_time_regression",
                                    "severity": "critical", "rank": 0,
                                    "ts": 5.0, "detail": {
                                        "rank": 0, "median_step_s": 0.03,
                                        "baseline_step_s": 0.01}}]},
        "regression_report.json": {
            "schema": jperf.REGRESSION_SCHEMA, "reports": [{
                "rule": "step_time_regression", "rank": 0,
                "reason": "alert", "ts": 5.0, "severity": "critical",
                "alert_detail": {"rank": 0},
                "diff": jperf.diff_attribution(base, slow),
                "capture": {"report": "profile_report-rank-0-0.json",
                            "trace_dir": "xprof-rank-0-0",
                            "steps_captured": 2, "window_s": 0.5}}]},
        "profile_report-rank-0-0.json": {
            "schema": "sparkdl_tpu.observe.capture/1", "rank": 0,
            "reason": "alert", "rule": "step_time_regression", "ts": 5.0,
            "window_s": 0.5, "requested_steps": 2, "steps_captured": 2,
            "attribution": jperf.attribution_report(slow[:4]),
            "device_memory": {"bytes_in_use": 10},
            "trace_dir": "xprof-rank-0-0"},
        "elastic.json": {"enabled": True, "arbiter": False,
                         "current_np": 2, "available_np": 2,
                         "transitions": {"grow": 0},
                         "decisions": [{"action": "hold", "np": 2}]},
        "oom_report-rank-0.json": {
            "schema": "sparkdl_tpu.observe.mem/oom_report/1", "ts": 0,
            "phase": "step", "rank": 0,
            "error": "RuntimeError: CUDA out of memory",
            "host_rss_bytes": 4 * 10**8,
            "device": {"hbm": 2 * 10**9, "peak": 25 * 10**8,
                       "limit": 2 * 10**9, "live": 2 * 10**9},
            "categories": {"params": 15 * 10**8},
            "unattributed": 10**8, "largest_buffers": [
                {"shape": "(4096, 4096)", "dtype": "float32",
                 "count": 12, "bytes": 8 * 10**8}],
            "static_budget_bytes": None, "sample_tail": [],
            "hints": ["a hint"]},
    }
    for fname, doc in docs.items():
        (run / fname).write_text(json.dumps(doc))
    (run / "metrics.prom").write_text("# empty\n")
    (run / "stack-rank-1.txt").write_text(
        "==== stack dump (reason: stall) ====\n"
        'File "train.py", line 1 in _stall_in_step\n')
    return str(run)


@pytest.mark.parametrize("hang", [False, True], ids=["clean", "hang"])
def test_doctor_is_jaxs_on_every_artifact(tmp_path, capsys, hang):
    run = _run_dir(tmp_path, "run-1-0", 10_000, hang=hang)
    want = jdoctor.diagnose(run)
    got = doctor.diagnose(run)
    assert got == want
    for key in ("perf", "comms", "fixit", "alerts", "forensics", "elastic",
                "serving", "memory"):
        assert got.get(key), key
    assert doctor.render_text(got) == jdoctor.render_text(want)
    for fmt in ("text", "json"):
        rc = jdoctor.main([run, "--format", fmt])
        want_out = capsys.readouterr().out
        assert doctor.main([run, "--format", fmt]) == rc
        assert capsys.readouterr().out == want_out
    assert rc != 0  # the OOM report, or the hang, makes it nonzero


def test_doctor_lists_the_ports_trace_files(tmp_path):
    run = _run_dir(tmp_path, "run-2-0", 10_000)
    open(os.path.join(run, "trace-rank-0-0.json"), "w").write("{}")
    assert doctor.diagnose(run)["forensics"]["trace_dirs"] == [
        "trace-rank-0-0.json"]
    assert "traces recovered: trace-rank-0-0.json" in doctor.render_text(
        doctor.diagnose(run))


def _ledger(path, values):
    for i, v in enumerate(values):
        rec = jperf.history_record({
            "step_time_s": jperf.sample_metric([v, v * 1.01, v * 0.99],
                                               unit="s"),
            "tokens_per_s": {"value": 1000.0 / v, "unit": "tok/s",
                             "higher_is_better": True}},
            device_kind="cpu", bench="b", extra={"ts": f"t{i}"})
        jperf.append_history(rec, path=path)


@pytest.mark.parametrize("sides", ["run_dirs", "ledger", "documents"])
def test_compare_is_jaxs(tmp_path, capsys, sides):
    if sides == "run_dirs":
        base = _run_dir(tmp_path, "run-1-0", 10_000)
        cand = _run_dir(tmp_path, "run-2-0", 30_000)
        args = [base, cand, "--explain"]
    elif sides == "ledger":
        path = str(tmp_path / "history.jsonl")
        _ledger(path, [0.5, 0.51, 0.8])
        args = [f"{path}@-3", path]
    else:
        base, cand = tmp_path / "base.json", tmp_path / "cand.json"
        base.write_text(json.dumps({"published": {"step_ms": 10.0,
                                                  "_note": "x"},
                                    "host_fingerprint": "h1"}))
        cand.write_text(json.dumps({"metric": "step_ms", "value": 9.0,
                                    "samples": [9.0, 9.1, 8.9],
                                    "host": "h1"}))
        args = [str(base), str(cand)]
    for fmt in ("text", "json"):
        rc = jcompare.main(args + ["--format", fmt])
        want = capsys.readouterr().out
        assert compare.main(args + ["--format", fmt]) == rc
        assert capsys.readouterr().out == want
    assert compare.load_record(args[1]) == jcompare.load_record(args[1])
    if sides == "run_dirs":
        assert rc == 1
        assert compare.explain_run_dirs(base, cand) == \
            jcompare.explain_run_dirs(base, cand)


def test_trend_is_jaxs_with_the_callers_baselines(tmp_path, capsys):
    path = str(tmp_path / "history.jsonl")
    _ledger(path, [0.5, 0.45, 0.6])
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"published": {"step_time_s": 0.5},
                                    "metrics": {"tokens_per_s": {
                                        "value": 1500.0}}}))
    entries = jperf.read_history(path)
    bases = jtrend.load_baselines([str(baseline)])
    assert trend.load_baselines([str(baseline)]) == bases
    assert trend.build_trend(entries, baselines=bases, last=2) == \
        jtrend.build_trend(entries, baselines=bases, last=2)
    assert trend.render_text(trend.build_trend(entries, baselines=bases)) \
        == jtrend.render_text(jtrend.build_trend(entries, baselines=bases))
    for fmt in ("text", "json"):
        args = ["--history", path, "--baseline", str(baseline),
                "--format", fmt]
        rc = jtrend.main(args)
        want = capsys.readouterr().out
        assert trend.main(args) == rc == 0
        assert capsys.readouterr().out == want
    # no ledger and no baseline unless the caller names them
    assert trend.main(["--format", "json"]) == 2
    doc = json.loads(capsys.readouterr().out)
    assert doc["history_path"] is None and doc["metrics"] == {}


STATUS = {
    "schema": "sparkdl_tpu.observe.statusz/1", "ts": 1.0, "uptime_s": 42.0,
    "gang": {"num_workers": 2, "stall_s": 300.0, "hang_verdict": None},
    "ranks": {"0": {"state": "progressing", "step": 12, "beat_age_s": 0.4,
                    "hbm": {"in_use": 3 * 2**30}, "collective": "reduce"},
              "1": {"state": "stalled", "step": 9, "beat_age_s": 7.5,
                    "hbm": {}, "collective": None}},
    "supervisor": {"attempts_total": 2, "restarts_total": 1},
    "perf": {"window_s": 60.0, "per_rank": {
        "0": {"steps": 5, "median_step_s": 0.25, "mfu": 0.31,
              "overlap_efficiency": 0.5, "fractions": {"compute": 1.0}}}},
    "alerts": {"enabled": True, "rules": ["step_time_regression"],
               "fired": [{"rule": "step_time_regression",
                          "severity": "critical", "rank": 0,
                          "detail": {"rank": 0, "factor": 3.0}}]},
    "captures": {"on_alert": True, "cooldown_s": 300.0,
                 "in_flight": [{"rank": 1, "rule": None,
                                "reason": "manual"}],
                 "completed": [{"rank": 0, "rule": "step_time_regression",
                                "steps_captured": 2,
                                "report": "profile_report-rank-0-0.json",
                                "trace_dir": "xprof-rank-0-0"}]},
    "fleet": [{"address": ["127.0.0.1", 8000], "queue_depth": 3,
               "max_queue": 64, "restarts": 1, "replicas": [
                   {"replica": 0, "alive": True, "queued": 2,
                    "inflight": 1, "restart_cause": None}]}],
}


def test_top_frames_are_jaxs():
    assert top.render(STATUS) == jtop.render(STATUS)
    quiet = dict(STATUS, alerts={"enabled": True, "rules": ["a"],
                                 "fired": []}, captures={}, fleet=[])
    assert top.render(quiet) == jtop.render(quiet)
    # the one line that names the switch of a gang whose alerts are off
    off = dict(quiet, alerts={"enabled": False, "fired": []})
    assert top.render(off).replace(
        "set alerts.ENABLED = True", "set SPARKDL_TPU_ALERTS=1") == \
        jtop.render(off)
    # the port's Chrome trace file is named without a directory slash
    mine = json.loads(json.dumps(STATUS))
    mine["captures"]["completed"][0]["trace_dir"] = "trace-rank-0-0.json"
    assert "+ trace-rank-0-0.json\n" in top.render(mine) + "\n"


def test_top_fetches_a_live_page(monkeypatch):
    from sparkdl_tpu_torch.observe import aggregate, statusz

    monkeypatch.setattr(statusz, "PORT", 0)
    server = statusz.maybe_start_statusz(aggregate.GangTelemetry(),
                                         num_workers=1)
    try:
        doc = top.fetch_status(server.address)
        assert doc["gang"]["num_workers"] == 1
        assert "1 worker(s)" in top.render(doc)
        assert top.main([server.address, "--once"]) == 0
    finally:
        server.close()
    assert top.main([server.address, "--once"]) == 2
