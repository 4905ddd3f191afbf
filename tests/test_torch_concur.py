"""The port's concurrency lint against the JAX package's: every lint
source of ``tests/analysis/test_concur.py`` gives the same findings
(rule, op, line and severity) through both linters (the one collective
source spelled with ``torch.distributed`` for the port, whose rule
matches the port's collectives where the JAX rule matches
``jax.lax``'s). Then the port's own: its collectives, the runtime clean
modulo the committed baseline (every waiver with a reason, none stale),
the CLI gate, and a test for each repair the lint led to."""

import importlib
import json
import textwrap
import threading
from pathlib import Path

import pytest
import torch

from sparkdl_tpu.analysis import concur as jax_concur
from sparkdl_tpu_torch.analysis import Severity
from sparkdl_tpu_torch.analysis import concur
from sparkdl_tpu_torch.analysis.__main__ import main
from sparkdl_tpu_torch.analysis.concur import (
    ALLOW_COMMENT,
    BASELINE_SCHEMA,
    DEFAULT_BASELINE,
    RULE_BLOCKING,
    RULE_COLLECTIVE,
    apply_baseline,
    lint_paths,
    lint_source,
    load_baseline,
    self_runtime_targets,
)

torch.set_num_threads(2)

PKG = Path(__file__).resolve().parents[1] / "sparkdl_tpu_torch"

# the lint sources of tests/analysis/test_concur.py, verbatim
SOURCES = {
    "ab-ba": """
        import threading
        _a = threading.Lock()
        _b = threading.Lock()

        def f():
            with _a:
                with _b:
                    pass

        def g():
            with _b:
                with _a:
                    pass
    """,
    "consistent": """
        import threading
        _a = threading.Lock()
        _b = threading.Lock()

        def f():
            with _a:
                with _b:
                    pass

        def g():
            with _a:
                with _b:
                    pass
    """,
    "subprocess-under-lock": """
        import threading, subprocess
        _lock = threading.Lock()

        def f():
            with _lock:
                subprocess.run(["ls"])
    """,
    "through-a-helper": """
        import threading, subprocess
        _lock = threading.Lock()

        def helper():
            subprocess.run(["ls"])

        def f():
            with _lock:
                helper()
    """,
    "outside-lock": """
        import threading, subprocess
        _lock = threading.Lock()

        def f():
            with _lock:
                pass
            subprocess.run(["ls"])
    """,
    "suppressed": f"""
        import threading, subprocess
        _lock = threading.Lock()

        def f():
            with _lock:
                subprocess.run(["ls"])  {ALLOW_COMMENT}
    """,
    "shared-state": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(
                    target=self._loop, daemon=True)

            def _loop(self):
                self.count += 1

            def bump(self):
                self.count += 1
    """,
    "guarded": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                self._t = threading.Thread(
                    target=self._loop, daemon=True)

            def _loop(self):
                with self._lock:
                    self.count += 1

            def bump(self):
                with self._lock:
                    self.count += 1
    """,
    "never-joined": """
        import threading

        def spawn():
            t = threading.Thread(target=print)
            t.start()
            return t
    """,
    "daemon-or-joined": """
        import threading

        def spawn():
            t = threading.Thread(target=print, daemon=True)
            t.start()
            u = threading.Thread(target=print)
            u.start()
            u.join()
    """,
    "wait-outside-loop": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self.ready = False

            def wait_ready(self):
                with self._cv:
                    self._cv.wait()
    """,
    "wait-in-loop": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self.ready = False

            def wait_ready(self):
                with self._cv:
                    while not self.ready:
                        self._cv.wait()
    """,
    "pool-dispatch": """
        from concurrent.futures import ThreadPoolExecutor

        class Engine:
            def __init__(self):
                self._pool = ThreadPoolExecutor(1)

            def submit_async(self, op_name, start, nbytes=0):
                def run():
                    finish = start()
                    return finish()
                return self._pool.submit(run)
    """,
    "pool-finish-only": """
        from concurrent.futures import ThreadPoolExecutor

        class Engine:
            def __init__(self):
                self._pool = ThreadPoolExecutor(1)

            def submit_async(self, op_name, start, nbytes=0):
                finish = start()
                def finish_observed():
                    return finish()
                return self._pool.submit(finish_observed)
    """,
    "collective-in-lambda": """
        import jax

        def go(pool, x):
            return pool.submit(lambda: jax.lax.psum(x, "i"))
    """,
    "syntax-error": "def broken(:\n",
}

# the port's spelling of a source (the same lines)
PORT_SPELLING = {
    "collective-in-lambda": (
        ("import jax", "import torch.distributed as dist"),
        ('jax.lax.psum(x, "i")', "dist.all_reduce(x)")),
}


def _key(f):
    return (f.rule_id, f.op, f.location.rsplit(":", 1)[1], int(f.severity))


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_same_findings_through_both_linters(name):
    src = textwrap.dedent(SOURCES[name])
    port_src = src
    for a, b in PORT_SPELLING.get(name, ()):
        port_src = port_src.replace(a, b)
    want = [_key(f) for f in jax_concur.lint_source(src, "mod.py")]
    got = [_key(f) for f in lint_source(port_src, "mod.py")]
    assert got == want


def test_port_collectives_off_thread_are_flagged():
    fs = lint_source(textwrap.dedent("""
        import threading
        import torch.distributed as dist

        class Stepper:
            def __init__(self, mesh, pool):
                self.mesh = mesh
                self._pool = pool

            def go(self, x):
                threading.Thread(target=lambda: dist.broadcast(x, 0),
                                 daemon=True).start()
                self._pool.submit(lambda: self.mesh.all_gather(x, "model"))
                self._pool.submit(lambda: hvd_engine.reduce_start(x, "sum"))
                t = threading.Thread(target=print, daemon=True)
                t.start()
                return self.mesh.all_reduce(x, "data")
    """), "mod.py")
    assert [(f.rule_id, f.location) for f in fs] == [
        (RULE_COLLECTIVE, "mod.py:11"), (RULE_COLLECTIVE, "mod.py:13"),
        (RULE_COLLECTIVE, "mod.py:14")]
    assert "dist.broadcast" in fs[0].message
    assert "self.mesh.all_gather" in fs[1].message
    assert "reduce_start" in fs[2].message
    # the port's live dispatch stays clean
    assert [f for f in lint_paths([PKG / "hvd"])
            if f.rule_id == RULE_COLLECTIVE] == []


# -- the runtime, the baseline and the gate ------------------------------------


def test_committed_baseline_loads_and_every_waiver_has_a_reason():
    waivers = load_baseline(DEFAULT_BASELINE)
    assert waivers and all(len(w["reason"]) > 80 for w in waivers)
    assert {w["path"] for w in waivers} == {
        "sparkdl_tpu_torch/horovod/control_plane.py",
        "sparkdl_tpu_torch/ops/_build.py"}


def test_runtime_clean_modulo_committed_baseline():
    assert self_runtime_targets() == [PKG]
    fs = lint_paths(self_runtime_targets())
    kept, waived, stale = apply_baseline(
        [f for f in fs if f.severity != Severity.INFO], load_baseline())
    assert kept == [], [str(f) for f in kept]
    assert stale == [], stale
    assert len(waived) == 4


def test_baseline_waiver_semantics(tmp_path):
    src = textwrap.dedent(SOURCES["subprocess-under-lock"])
    fs = lint_source(src, "mod.py")
    w = {"rule": RULE_BLOCKING, "path": "mod.py", "op": "subprocess.run",
         "reason": "by design"}
    assert apply_baseline(fs, [w])[0] == []
    fs2 = lint_source("\n\n\n" + src, "mod.py")  # the line moved
    assert fs2[0].location != fs[0].location
    assert apply_baseline(fs2, [w])[0] == []
    other = dict(w, path="other.py")
    kept, waived, stale = apply_baseline(fs, [other])
    assert len(kept) == 1 and waived == [] and stale == [other]
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"schema": BASELINE_SCHEMA, "waivers": [
        {"rule": RULE_BLOCKING, "path": "x.py", "op": "subprocess.run"}]}))
    with pytest.raises(ValueError, match="no reason"):
        load_baseline(p)
    p.write_text(json.dumps({"schema": "nope/9", "waivers": []}))
    with pytest.raises(ValueError, match="schema"):
        load_baseline(p)


def test_cli_concur_gate(tmp_path, capsys):
    assert main(["--concur"]) == 0
    assert "4 finding(s) waived via baseline" in capsys.readouterr().out
    # the waived findings are real: without the baseline the gate is red
    assert main(["--concur", "--baseline", "none"]) == 1
    assert RULE_BLOCKING in capsys.readouterr().out
    out = tmp_path / "concur_report.json"
    assert main(["--concur", "--out", str(out)]) == 0
    capsys.readouterr()
    doc = json.loads(out.read_text())
    assert doc["schema"] == concur.REPORT_SCHEMA
    assert doc["stale_waivers"] == [] and all(
        f["waived"] for f in doc["findings"])
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(SOURCES["subprocess-under-lock"]))
    assert main(["--concur", "--baseline", "none", str(bad)]) == 1
    capsys.readouterr()
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"schema": BASELINE_SCHEMA, "waivers": [
        {"rule": RULE_BLOCKING, "path": "ghost.py", "op": "nothing",
         "reason": "stale on purpose"}]}))
    clean = tmp_path / "ok.py"
    clean.write_text("x = 1\n")
    assert main(["--concur", "--baseline", str(stale), str(clean)]) == 0
    assert "1 stale waiver(s)" in capsys.readouterr().out


# -- the repairs -----------------------------------------------------------------


@pytest.mark.parametrize("path", ["observe/metrics.py", "observe/capture.py",
                                  "utils/checkpoint.py"])
def test_repaired_modules_lint_clean(path):
    assert lint_paths([PKG / path]) == []


def test_build_info_labels_run_git_outside_the_lock(monkeypatch):
    # the module (observe's metrics() function shadows its name there)
    metrics = importlib.import_module("sparkdl_tpu_torch.observe.metrics")
    held = []

    def git_sha():
        held.append(metrics._build_info_lock.locked())
        return "abc1234"

    monkeypatch.setattr(metrics, "_build_info_labels", None)
    monkeypatch.setattr(metrics, "_git_sha", git_sha)
    labels = metrics.build_info_labels()
    assert labels["git_sha"] == "abc1234" and held == [False]
    assert metrics.build_info_labels() == labels and held == [False]


def test_driver_frames_to_a_rank_go_whole_under_one_lock(tmp_path):
    """DUMP_REQ (the hang detector), PROFILE_REQ (forensics) and
    SERVE_REQ (a fleet) come from different threads: each frame is
    written under the server's send lock."""
    from sparkdl_tpu_torch.horovod import control_plane as cp

    server = cp.ControlPlaneServer(1, log_path=str(tmp_path / "job.log"))
    try:
        sent = []

        class Conn:
            def sendall(self, data):
                sent.append((server._send_lock.locked(), data[4]))

        with server._lock:
            server._conns[0] = Conn()
        assert server.request_dump(0)
        assert server.request_profile(0, rule="step", steps=2)
        assert server.send_serve(0, {"admit": []})
        assert sent == [(True, cp.MSG_DUMP_REQ), (True, cp.MSG_PROFILE_REQ),
                        (True, cp.MSG_SERVE_REQ)]
        assert not server.request_dump(1)  # no such rank
    finally:
        server.close()


def test_capture_stop_flag_is_handed_over_under_the_lock():
    from sparkdl_tpu_torch.observe.capture import CaptureService

    svc = CaptureService(None, 0, "/nonexistent", steps=1)
    stopped = []

    class Prof:
        def stop(self):
            stopped.append(svc._lock.locked())

    svc._prof, svc._prof_running = Prof(), True
    svc._prof_thread = threading.get_ident()
    svc._stop_at_next_step = True
    svc._tap({"ph": "X", "cat": "train", "name": "train_step"})
    assert stopped == [False] and svc._stop_at_next_step is False
    assert svc._prof_running is False


def test_async_save_fills_in_its_own_record(tmp_path):
    from sparkdl_tpu_torch.utils.checkpoint import TrainCheckpointer

    ck = TrainCheckpointer(str(tmp_path), async_save=True)
    assert ck.save(0, {"w": torch.ones(4)})
    first = ck.last_save
    assert ck.save(1, {"w": torch.zeros(4)})  # joins the first write
    ck.wait_until_finished()
    assert ck.last_save is not first and ck.last_save["step"] == 1
    for rec in (first, ck.last_save):
        assert rec["bytes"] > 0 and rec["write_s"] is not None
