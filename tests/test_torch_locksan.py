"""The port's lock-order sanitizer against the JAX package's: the
scenarios of ``tests/utils/test_locksan.py`` (a seeded ABBA inversion
witnessed with both stacks, clean runs reporting nothing, long holds,
RLock re-entry, Condition over an RLock, the factories swapped and
restored, the report artifact, the fork-reinit protocol) give the same
edges, cycles and report fields through both, the locks built at the
same source lines so their sites match. Then the port's own: the
settings it reads, the rank-suffixed report, and one gang of two whose
driver and ranks run under the sanitizer with no lock-order cycle."""

import json
import os
import sys
import threading
import time

import cloudpickle
import pytest
import torch

from sparkdl_tpu.utils import locksan as jax_locksan
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import _worker, launcher
from sparkdl_tpu_torch.utils import locksan

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

SIDES = (jax_locksan, locksan)


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    monkeypatch.delenv(jax_locksan.REPORT_ENV, raising=False)
    monkeypatch.delenv("SPARKDL_TPU_TELEMETRY_DIR", raising=False)
    for mod in SIDES:
        mod.reset()
    yield
    for mod in SIDES:
        mod.uninstall()
        mod.reset()
    locksan._rank = None


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


def _pair(mod):
    a = mod.SanLock()
    b = mod.SanLock()
    return a, b


def _abba(mod):
    a, b = _pair(mod)

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    _run(t1)
    _run(t2)
    return a, b


def _consistent(mod):
    a, b = _pair(mod)

    def t():
        with a:
            with b:
                pass

    _run(t)
    _run(t)
    return a, b


def _independent(mod):
    a, b = _pair(mod)
    with a:
        pass
    with b:
        pass
    return a, b


def _reentry(mod):
    r = mod.SanRLock()
    with r:
        with r:
            pass
    return r, r


def _shape(rep):
    """The report's comparable fields (stacks aside: their frames are
    the sanitizers' own)."""
    return {
        "schema": rep["schema"],
        "installed": rep["installed"],
        "lock_sites": rep["lock_sites"],
        "edges": rep["edges"],
        "cycles": rep["cycles"],
        "inversions": [(sorted(i["locks"]), i["first"]["order"],
                        i["second"]["order"]) for i in rep["inversions"]],
        "long_holds": [h["lock"] for h in rep["long_holds"]],
    }


@pytest.mark.parametrize("scenario", [_abba, _consistent, _independent,
                                      _reentry],
                         ids=["abba", "consistent", "independent",
                              "rlock-reentry"])
def test_scenarios_report_the_same_through_both(scenario):
    got = []
    for mod in SIDES:
        mod.reset()
        scenario(mod)
        got.append(_shape(mod.report()))
    assert got[0] == got[1]


def test_seeded_abba_inversion_witnessed_with_both_stacks():
    a, b = _abba(locksan)
    rep = locksan.report()
    assert len(rep["inversions"]) == 1
    inv = rep["inversions"][0]
    assert sorted(inv["locks"]) == sorted([a._site, b._site])
    for side in (inv["first"], inv["second"]):
        assert "test_torch_locksan" in side["held_stack"]
        assert "test_torch_locksan" in side["acquiring_stack"]
    assert inv["first"]["order"] != inv["second"]["order"]
    assert sorted([a._site, b._site]) in rep["cycles"]


def test_consistent_order_records_the_edge_and_nothing_else():
    a, b = _consistent(locksan)
    rep = locksan.report()
    assert rep["inversions"] == [] and rep["cycles"] == []
    assert rep["long_holds"] == []
    assert [(e["from"], e["to"], e["count"]) for e in rep["edges"]] == \
        [(a._site, b._site, 2)]


def test_long_hold_is_reported(monkeypatch):
    monkeypatch.setenv(jax_locksan.HOLD_WARN_ENV, "0.01")
    monkeypatch.setattr(locksan, "HOLD_WARN_S", 0.01)
    got = []
    for mod in SIDES:
        a = mod.SanLock()
        with a:
            time.sleep(0.05)
        (h,) = mod.report()["long_holds"]
        assert h["held_s"] >= 0.01 and h["lock"] == a._site
        assert "test_torch_locksan" in h["stack"]
        got.append(sorted(h))
    assert got[0] == got[1]


def test_stack_depth_setting_bounds_the_stacks(monkeypatch):
    monkeypatch.setattr(locksan, "STACK_DEPTH", 1)
    a, b = _abba(locksan)
    inv = locksan.report()["inversions"][0]
    # one frame: its "File ..." line and its source line
    assert inv["second"]["acquiring_stack"].count('File "') == 1


def test_condition_over_san_rlock_wait_notify():
    for mod in SIDES:
        r = mod.SanRLock()
        cv = threading.Condition(r)
        ready = []

        def waiter():
            with cv:
                with r:  # a recursive hold across the wait
                    while not ready:
                        cv.wait(timeout=10)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cv:
            ready.append(1)
            cv.notify()
        t.join(10)
        assert not t.is_alive()


def test_install_swaps_factories_and_uninstall_restores():
    real_lock_type = type(threading.Lock())
    locksan.install()
    try:
        assert locksan.installed()
        assert isinstance(threading.Lock(), locksan.SanLock)
        assert isinstance(threading.RLock(), locksan.SanRLock)
    finally:
        locksan.uninstall()
    assert not locksan.installed()
    assert isinstance(threading.Lock(), real_lock_type)


def test_maybe_install_honors_the_setting(monkeypatch):
    assert locksan.maybe_install() is False
    assert not locksan.installed()
    monkeypatch.setattr(locksan, "ENABLED", True)
    assert locksan.maybe_install(rank=3) is True
    assert locksan.installed()
    assert jax_locksan.maybe_install(env={jax_locksan.SAN_ENV: "1"}) is True


def test_write_report_artifact(tmp_path):
    docs = []
    for mod in SIDES:
        mod.reset()
        _abba(mod)
        path = tmp_path / f"{mod.__name__}.json"
        assert mod.write_report(str(path)) == str(path)
        docs.append(_shape(json.loads(path.read_text())))
    assert docs[0] == docs[1]
    assert docs[1]["lock_sites"] == 2 and docs[1]["cycles"]


def test_report_destinations(tmp_path, monkeypatch):
    from sparkdl_tpu_torch import observe

    assert locksan.write_report() is None  # no destination: nothing
    monkeypatch.setattr(locksan, "REPORT", str(tmp_path / "concur.json"))
    assert locksan.write_report() == str(tmp_path / "concur.json")
    locksan._rank = 1  # a gang rank's report beside its peers'
    assert locksan.write_report() == str(tmp_path / "concur-rank-1.json")
    monkeypatch.setattr(locksan, "REPORT", None)
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "tel"))
    assert locksan.write_report() == str(
        tmp_path / "tel" / "concur_report-rank-1.json")


def test_fork_reinit_protocol():
    a = locksan.SanLock()
    a.acquire()
    a._at_fork_reinit()
    assert not a._inner.locked()
    assert a.acquire(blocking=False)
    a.release()
    r = locksan.SanRLock()
    r.acquire()
    r.acquire()
    r._at_fork_reinit()
    assert r._owner is None and r._count == 0
    assert r.acquire(blocking=False)
    r.release()


def test_driver_ships_the_settings_and_a_worker_installs_first(monkeypatch):
    assert locksan.settings() == {}
    monkeypatch.setattr(locksan, "ENABLED", True)
    monkeypatch.setattr(locksan, "REPORT", "/x/concur.json")
    settings = _worker.rank_settings()
    assert settings == {"locksan.ENABLED": True, "locksan.HOLD_WARN_S": 1.0,
                        "locksan.REPORT": "/x/concur.json",
                        "locksan.STACK_DEPTH": 12}
    monkeypatch.setattr(locksan, "ENABLED", False)
    monkeypatch.setattr(locksan, "REPORT", None)
    assert _worker.install_locksan(settings, rank=2) is True
    assert locksan.installed() and locksan._rank == 2
    assert locksan.REPORT == "/x/concur.json"


def _sanitized_main():
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.utils import locksan

    hvd.init()
    hvd.allreduce(torch.ones(3))
    hvd.barrier()
    return locksan.installed()


@pytest.mark.gang
def test_gang_under_the_sanitizer_has_no_lock_order_cycle(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(locksan, "ENABLED", True)
    monkeypatch.setattr(locksan, "REPORT", str(tmp_path / "concur.json"))
    assert HorovodRunner(np=-2).run(_sanitized_main) is True
    # the supervisor installed it in the driver, where JAX does
    assert locksan.installed()
    rep = locksan.report()
    assert rep["lock_sites"] > 0 and rep["cycles"] == []
    assert rep["inversions"] == []
    for r in (0, 1):  # written at each rank's exit
        doc = json.loads((tmp_path / f"concur-rank-{r}.json").read_text())
        assert doc["installed"] and doc["lock_sites"] > 0
        assert doc["cycles"] == [] and doc["inversions"] == []
    assert not os.path.exists(tmp_path / "concur.json")
