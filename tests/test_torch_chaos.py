"""The port's fault injection and profiler annotations on the CPU: the
hooks' decisions against the JAX package's ``sparkdl_tpu.utils.chaos``
for the same settings (the JAX side through its environment, the port
through its module settings), the injections' ``cat="chaos"`` instants,
``annotate`` inside ``trace`` (a Chrome trace naming the region and a
``cat="xprof"`` span on the timeline), and one gang of two whose ranks
receive the driver's chaos and profiler settings with telemetry off."""

import glob
import json
import os
import sys

import cloudpickle
import pytest
import torch

from sparkdl_tpu.utils import chaos as jax_chaos
from sparkdl_tpu_torch import HorovodRunner, observe
from sparkdl_tpu_torch.horovod import _worker, launcher
from sparkdl_tpu_torch.horovod.control_plane import _MSG_NAMES
from sparkdl_tpu_torch.utils import chaos, profiler

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def _inert(monkeypatch):
    for name in list(os.environ):
        if name.startswith("SPARKDL_TPU_CHAOS_"):
            monkeypatch.delenv(name)
    chaos._reset_for_tests()
    jax_chaos._reset_cache_for_tests()
    yield
    chaos._reset_for_tests()
    jax_chaos._reset_cache_for_tests()
    observe._reset_for_tests()


def _configure(monkeypatch, settings, rank=0):
    """``settings`` as the port's settings and the JAX module's
    environment, both hooks seeing this process as ``rank``."""
    for name, value in settings.items():
        monkeypatch.setattr(chaos, name, value)
        monkeypatch.setenv(f"SPARKDL_TPU_CHAOS_{name}", str(value))
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("SPARKDL_TPU_RANK", str(rank))
    jax_chaos._reset_cache_for_tests()


FRAME_CASES = [
    ("inert", {}),
    ("drop_two", {"CP_DROP": "ready, result"}),
    ("drop_and_delay", {"CP_DROP": "ready, result", "CP_DELAY_S": 0.25}),
    ("delay_only", {"CP_DELAY_S": 0.5}),
    ("drop_heartbeat", {"CP_DROP": "HEARTBEAT"}),
    ("zero_delay", {"CP_DELAY_S": 0, "KILL_RANK": 3}),
]


@pytest.mark.parametrize("settings", [c[1] for c in FRAME_CASES],
                         ids=[c[0] for c in FRAME_CASES])
def test_control_frame_fate_matches_jax(monkeypatch, settings):
    """Every frame name the client sends gets JAX's fate: dropped,
    delayed or sent."""
    _configure(monkeypatch, settings)
    for name in sorted(set(_MSG_NAMES.values())):
        assert chaos.control_frame_fate(name) == \
            jax_chaos.control_frame_fate(name), name


def test_once_claim_matches_jax(monkeypatch, tmp_path):
    """The one-shot token: the first claimant of each side wins, the
    second does not; without a token every claim wins; an unwritable
    token never fires."""
    assert chaos._claim_once() is jax_chaos._claim_once() is True
    for side, mod in (("jax", jax_chaos), ("port", chaos)):
        once = tmp_path / f"token-{side}"
        _configure(monkeypatch, {"ONCE_FILE": str(once)})
        assert mod._claim_once() is True
        assert once.exists()
        assert mod._claim_once() is False
    _configure(monkeypatch, {"ONCE_FILE": str(tmp_path / "no" / "dir")})
    assert chaos._claim_once() is jax_chaos._claim_once() is False


STEP_CASES = [
    # (name, settings, rank)
    ("kill_at_step", {"KILL_RANK": 1, "KILL_STEP": 2}, 1),
    ("kill_other_rank", {"KILL_RANK": 1, "KILL_STEP": 2}, 0),
    ("kill_default_step", {"KILL_RANK": 0}, 0),
    ("kill_at_boot_only", {"KILL_RANK": 0, "KILL_PHASE": "boot"}, 0),
    ("stall_in_step", {"STALL_STEP": 1}, 0),
    ("stall_other_rank", {"STALL_STEP": 1, "STALL_STEP_RANK": 1}, 0),
    ("leak_then_kill", {"LEAK_BYTES_PER_STEP": 8192, "KILL_RANK": 0,
                        "KILL_STEP": 3}, 0),
    ("leak_other_rank", {"LEAK_BYTES_PER_STEP": 8192, "LEAK_RANK": 1}, 0),
]


@pytest.mark.parametrize("settings,rank", [c[1:] for c in STEP_CASES],
                         ids=[c[0] for c in STEP_CASES])
def test_chaos_step_fires_where_jax_fires(monkeypatch, tmp_path, settings,
                                          rank):
    """``chaos_step`` over steps 0-4: the kills, in-step stalls and leaks
    JAX's hook makes for the same settings, at the same steps, each kill
    and stall claimed once (the kill and the stall themselves are
    recorded, not made)."""
    fired = {}
    for side, mod in (("jax", jax_chaos), ("port", chaos)):
        events = fired[side] = []
        _configure(monkeypatch, dict(settings,
                                     ONCE_FILE=str(tmp_path / side)), rank)
        monkeypatch.setattr(mod, "_kill_self", lambda phase="step", step=None,
                            events=events: events.append(("kill", step)))
        monkeypatch.setattr(mod, "_stall_in_step",
                            lambda step, events=events: events.append(
                                ("stall", step)))
        for step in range(5):
            mod.chaos_step(step)
        events.append(("leaked", len(mod._leaked)))
    assert fired["port"] == fired["jax"]


BOOT_CASES = [
    ("boot_kill", {"KILL_RANK": 1, "KILL_PHASE": "boot"}, 1),
    ("boot_kill_other_rank", {"KILL_RANK": 1, "KILL_PHASE": "boot"}, 0),
    ("step_kill_not_at_boot", {"KILL_RANK": 1}, 1),
    ("stall_every_rank", {"RENDEZVOUS_STALL_S": 0.05}, 1),
    ("stall_other_rank", {"RENDEZVOUS_STALL_S": 0.05,
                          "RENDEZVOUS_STALL_RANK": 0}, 1),
]


@pytest.mark.parametrize("settings,rank", [c[1:] for c in BOOT_CASES],
                         ids=[c[0] for c in BOOT_CASES])
def test_on_worker_boot_matches_jax(monkeypatch, settings, rank):
    """The boot hook stalls and kills the ranks JAX's does."""
    done = {}
    for side, mod in (("jax", jax_chaos), ("port", chaos)):
        events = done[side] = []
        _configure(monkeypatch, settings, rank)
        monkeypatch.setattr(mod, "_kill_self", lambda phase="step", step=None,
                            events=events: events.append(("kill", phase)))
        monkeypatch.setattr(mod.time, "sleep",
                            lambda s, events=events: events.append(
                                ("sleep", s)))
        mod.on_worker_boot(rank)
    assert done["port"] == done["jax"]


@pytest.mark.parametrize("muted,rank", [(None, 0), (1, 1), (1, 0)])
def test_heartbeat_muted_matches_jax(monkeypatch, muted, rank):
    settings = {} if muted is None else {"MUTE_HEARTBEAT": muted}
    _configure(monkeypatch, settings, rank)
    assert chaos.heartbeat_muted(rank) is jax_chaos.heartbeat_muted(rank)


def test_a_muted_heartbeat_sends_nothing(monkeypatch):
    from sparkdl_tpu_torch.observe.health import HeartbeatSender

    class Client:
        beats = 0

        def send_heartbeat(self, payload):
            Client.beats += 1

    sender = HeartbeatSender(Client(), 1, interval=60.0)
    assert sender.beat() is True
    monkeypatch.setattr(chaos, "MUTE_HEARTBEAT", 1)
    assert sender.beat() is False
    assert Client.beats == 1


def test_injections_are_chaos_instants(monkeypatch, tmp_path):
    """A dropped frame, a boot stall and a kill each land as a
    ``cat="chaos"`` instant (the kill's flushed before its signal)."""
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path))
    observe._reset_for_tests()
    flushed = []
    monkeypatch.setattr(observe, "flush", lambda *a, **k: flushed.append(1))
    signals = []
    monkeypatch.setattr(chaos.os, "kill", lambda pid, sig: signals.append(
        sig))
    monkeypatch.setattr(chaos.time, "sleep", lambda s: None)
    _configure(monkeypatch, {"CP_DROP": "RESULT", "RENDEZVOUS_STALL_S": 1,
                             "KILL_RANK": 1, "KILL_STEP": 2}, rank=1)
    assert chaos.control_frame_fate("RESULT") == "drop"
    chaos.on_worker_boot(1)
    chaos.chaos_step(2)
    events = observe.timeline().drain()
    assert [(e["name"], e["cat"]) for e in events] == [
        ("chaos.frame_drop", "chaos"), ("chaos.stall", "chaos"),
        ("chaos.kill", "chaos")]
    assert events[-1]["args"]["step"] == 2
    assert flushed and signals == [9]


def test_annotate_inside_trace_names_the_region(monkeypatch, tmp_path):
    """``annotate`` inside ``trace``: the window's Chrome trace holds the
    region's name, and the gang timeline a ``cat="xprof"`` span of the
    same name (after JAX's ``test_profiler_trace_writes_files``)."""
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "tel"))
    observe._reset_for_tests()
    d = str(tmp_path / "trace")
    with profiler.trace(d) as got:
        with profiler.annotate("test-region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    assert got == d
    files = glob.glob(os.path.join(d, "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test-region" in names
    spans = [e for e in observe.timeline().drain()
             if e["name"] == "test-region"]
    assert [(e["cat"], e["ph"]) for e in spans] == [("xprof", "X")]


def test_annotate_outside_a_window_and_telemetry_is_inert():
    with profiler.annotate("nothing"):
        pass
    assert len(observe.timeline()) == 0
    with profiler.maybe_trace_worker(0) as d:
        assert d is None


def _settings_main():
    """A rank's view of the settings its driver shipped, and a region
    under its profile window."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.utils import chaos as _chaos
    from sparkdl_tpu_torch.utils import profiler as _profiler

    hvd.init()
    with _profiler.annotate("rank-region"):
        torch.ones(8).sum().item()
    return hvd.allgather_object({"rank": hvd.rank(),
                                 "chaos": _chaos.settings(),
                                 "profile_dir": _profiler.PROFILE_DIR})


@pytest.mark.gang
def test_the_driver_ships_chaos_and_profiler_settings_with_telemetry_off(
        monkeypatch, tmp_path):
    """With telemetry off (``observe.worker_settings()`` is None), every
    rank still runs under the driver's chaos settings and profile
    directory: its bootstrap traced ``main`` into
    ``<PROFILE_DIR>/rank-<r>``."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 60.0)
    assert observe.worker_settings() is None
    monkeypatch.setattr(chaos, "CP_DELAY_S", 0.0)
    monkeypatch.setattr(chaos, "KILL_RANK", 5)
    monkeypatch.setattr(profiler, "PROFILE_DIR", str(tmp_path / "prof"))
    assert _worker.rank_settings() == {
        "chaos.KILL_RANK": 5, "chaos.CP_DELAY_S": 0.0,
        "profiler.PROFILE_DIR": str(tmp_path / "prof")}
    ranks = HorovodRunner(np=-2).run(_settings_main)
    for r in ranks:
        assert r["chaos"] == {"KILL_RANK": 5, "CP_DELAY_S": 0.0}
        assert r["profile_dir"] == str(tmp_path / "prof")
        files = glob.glob(str(tmp_path / "prof" / f"rank-{r['rank']}"
                              / "trace-*.json"))
        assert len(files) == 1
        with open(files[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "rank-region" in names
    # the driver's own settings are as they were
    assert chaos.KILL_RANK == 5 and profiler.PROFILE_DIR
