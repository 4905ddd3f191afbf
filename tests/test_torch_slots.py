"""The port's slot registry and slot resolution: a gang waits while its
slots are busy and fails fast only when ``np`` exceeds the total
(reference ``runner_base.py:56-58``). The registry's semantics run the
cases of ``tests/horovod/test_slots.py`` on both packages' registries
(each in a directory of its own); the slot counts are held against the
JAX launcher's on the same settings; one gang waits for a held claim and
then runs.
"""

import os
import subprocess
import sys
import threading
import time

import cloudpickle
import pytest
import torch

from sparkdl_tpu.horovod import launcher as jax_launcher
from sparkdl_tpu.horovod.topology import Placement as JaxPlacement
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher, supervisor
from sparkdl_tpu_torch.horovod.topology import Placement, parse_hosts

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def settings(monkeypatch, tmp_path):
    """Bounded gangs, a slot registry of this test's own for each
    package; the launcher's settings restored afterwards."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(launcher, "SLOT_WAIT_TIMEOUT_S", 600.0)
    for name in ("NUM_SLOTS", "HOSTS", "WORKER_DEVICE", "REMOTE_SHELL"):
        monkeypatch.setattr(launcher, name, None)
    monkeypatch.setenv("SPARKDL_TPU_SLOT_DIR", str(tmp_path / "jax-slots"))
    for name in ("NUM_SLOTS", "WORKER_PLATFORM", "SLOT_WAIT_TIMEOUT",
                 "HOSTS"):
        monkeypatch.delenv(f"SPARKDL_TPU_{name}", raising=False)


@pytest.fixture(params=["jax", "port"])
def impl(request, tmp_path):
    """(the launcher module, its registry's directory)."""
    if request.param == "port":
        return launcher, launcher.SLOT_DIR
    return jax_launcher, str(tmp_path / "jax-slots")


def test_claim_and_release_roundtrip(impl):
    mod, _ = impl
    c = mod.claim_slots(3, 4, timeout=1)
    c2 = mod.claim_slots(1, 4, timeout=1)  # 3 busy + 1 = the total
    c.release()
    c2.release()
    mod.claim_slots(4, 4, timeout=1).release()


def test_busy_slots_block_until_released(impl):
    mod, _ = impl
    first = mod.claim_slots(3, 4, timeout=1)
    acquired = []

    def waiter():
        c = mod.claim_slots(2, 4, timeout=10)
        acquired.append(time.monotonic())
        c.release()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.8)
    assert not acquired, "claim went through while slots were busy"
    released_at = time.monotonic()
    first.release()
    t.join(10)
    assert acquired, "claim never went through after release"
    assert acquired[0] >= released_at


def test_wait_timeout_names_the_busy_count(impl):
    mod, _ = impl
    first = mod.claim_slots(3, 4, timeout=1)
    with pytest.raises(mod.SlotWaitTimeout, match="3 busy"):
        mod.claim_slots(2, 4, timeout=0.5)
    first.release()


def test_stale_claims_of_dead_processes_are_reaped(impl):
    mod, d = impl
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "stale.claim"), "w") as f:
        f.write(f"{p.pid} 4")
    # all 4 slots look busy, but their owner is dead
    mod.claim_slots(4, 4, timeout=2).release()
    assert not os.path.exists(os.path.join(d, "stale.claim"))


def test_corrupt_claim_files_are_ignored(impl):
    mod, d = impl
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "junk.claim"), "w") as f:
        f.write("not a pid")
    mod.claim_slots(4, 4, timeout=2).release()


def test_the_wait_is_the_settings_and_the_registry_apart_from_jax(
        monkeypatch):
    monkeypatch.setattr(launcher, "SLOT_WAIT_TIMEOUT_S", 0.3)
    held = launcher.claim_slots(1, 1, timeout=1)
    try:
        t = time.monotonic()
        with pytest.raises(launcher.SlotWaitTimeout):
            launcher.claim_slots(1, 1)
        assert 0.3 <= time.monotonic() - t < 5
    finally:
        held.release()
    monkeypatch.setattr(launcher, "SLOT_DIR", None)
    monkeypatch.delenv("SPARKDL_TPU_SLOT_DIR")
    assert launcher._slot_dir().endswith("sparkdl-torch-slots")
    assert launcher._slot_dir() != jax_launcher._slot_dir()


@pytest.mark.parametrize("knobs,slots", [
    ({"NUM_SLOTS": 3}, 3),
    ({"WORKER_DEVICE": "cpu"}, os.cpu_count()),
    ({"NUM_SLOTS": 5, "WORKER_DEVICE": "cpu"}, 5),
], ids=["num_slots", "cpu", "num_slots_over_cpu"])
def test_available_slots_as_in_jax(monkeypatch, knobs, slots):
    env = {"NUM_SLOTS": "SPARKDL_TPU_NUM_SLOTS",
           "WORKER_DEVICE": "SPARKDL_TPU_WORKER_PLATFORM"}
    for name, value in knobs.items():
        monkeypatch.setattr(launcher, name, value)
        monkeypatch.setenv(env[name], str(value))
    assert launcher.available_slots() == jax_launcher.available_slots()
    assert launcher.available_slots() == slots


def test_cards_are_counted_without_a_cuda_context(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launcher.available_slots() == 4
    assert not torch.cuda.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launcher.available_slots() == 0
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cuda")
    with pytest.raises(ValueError, match="WORKER_DEVICE"):
        launcher.available_slots()


@pytest.mark.parametrize("np_arg,num_slots,spec", [
    (-3, None, None), (2, 4, None), (0, 4, None), (4, 4, None),
    (5, 4, None), (3, None, "a:2,b:2"), (0, None, "a:2,b:2"),
    (5, None, "a:2,b:2"),
])
def test_resolve_num_workers_as_in_jax(monkeypatch, np_arg, num_slots,
                                       spec):
    monkeypatch.setattr(launcher, "NUM_SLOTS", num_slots)
    if num_slots is not None:
        monkeypatch.setenv("SPARKDL_TPU_NUM_SLOTS", str(num_slots))
    hosts = parse_hosts(spec) if spec else None
    ours = Placement(hosts) if hosts else None
    theirs = JaxPlacement(hosts) if hosts else None
    try:
        ref = jax_launcher._resolve_num_workers(np_arg, theirs)
    except jax_launcher.SlotExhaustionError:
        with pytest.raises(launcher.SlotExhaustionError,
                           match="fails fast"):
            launcher._resolve_num_workers(np_arg, ours)
        return
    assert launcher._resolve_num_workers(np_arg, ours) == ref


def _claimed_in(monkeypatch):
    """Run launches without their gang: record what the registry holds
    while the gang would run, and the gang's layout."""
    seen = []

    def run_gang(num_workers, mode, placement, remote, shell, *rest):
        with open(os.path.join(launcher._slot_dir(), ".lock"), "w"):
            busy = launcher._busy_slots_locked(launcher._slot_dir())
        seen.append({"n": num_workers, "mode": mode, "busy": busy,
                     "hosts": placement.hosts, "remote": remote,
                     "shell": shell})
        return "ran"

    monkeypatch.setattr(launcher, "_run_gang", run_gang)
    return seen


def test_a_gang_claims_its_slots_and_releases_them(monkeypatch):
    """A one-worker-a-slot gang holds its claim while it runs and frees
    it when it ends, also when it fails; a local gang claims nothing."""
    seen = _claimed_in(monkeypatch)
    monkeypatch.setattr(launcher, "NUM_SLOTS", 3)
    assert HorovodRunner(np=2).run(lambda: None) == "ran"
    assert HorovodRunner(np=-5).run(lambda: None) == "ran"
    assert [(s["n"], s["mode"], s["busy"]) for s in seen] == [
        (2, "cluster", 2), (5, "local", 0)]

    def broken(*a):
        raise RuntimeError("spawn failed")

    monkeypatch.setattr(launcher, "_run_gang", broken)
    with pytest.raises(RuntimeError, match="spawn failed"):
        HorovodRunner(np=3).run(lambda: None)
    launcher.claim_slots(3, 3, timeout=1).release()  # nothing left held


def test_a_slot_wait_timeout_is_permanent_and_spawns_nothing(monkeypatch):
    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    monkeypatch.setattr(launcher, "NUM_SLOTS", 2)
    monkeypatch.setattr(launcher, "SLOT_WAIT_TIMEOUT_S", 0.3)
    monkeypatch.setattr(supervisor, "policy",
                        supervisor.RetryPolicy(max_retries=3))
    held = launcher.claim_slots(1, 2, timeout=1)
    try:
        with pytest.raises(launcher.SlotWaitTimeout, match="1 busy") as exc:
            HorovodRunner(np=2).run(lambda: None)
    finally:
        held.release()
    assert supervisor.classify_failure(exc.value)[0] == supervisor.PERMANENT


def _size_main():
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state

    hvd.init()
    return hvd.size(), _state.state().backend, str(_state.state().device)


@pytest.mark.gang
def test_gang_waits_for_busy_slots_then_runs(monkeypatch):
    """np fits the total but the slots are busy: the gang waits (the
    contract), then runs once the competing claim is released."""
    monkeypatch.setattr(launcher, "NUM_SLOTS", 2)
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    busy = launcher.claim_slots(2, 2, timeout=1)
    releaser = threading.Timer(2.0, busy.release)
    t0 = time.monotonic()
    releaser.start()
    try:
        result = HorovodRunner(np=2).run(_size_main)
    finally:
        releaser.cancel()
        busy.release()
    assert result == (2, "gloo", "cpu")
    assert time.monotonic() - t0 >= 2.0, "the gang did not wait"
