"""The port's elastic relaunch against the JAX package on the CPU: the
capacity probe, ``choose_np`` and ``check_grow`` on the inputs of
``tests/horovod/test_elastic_policy.py``; the ``ElasticController`` on
the same scripted clock, probe, checkpoint steps and alert engine as the
JAX controller, decision log for decision log; the reshard pre-flight of
a relaunch and the axes the supervisor ships; and one supervised CPU
gang that loses a rank, shrinks to one, and grows back to two when the
capacity file says so, ending on the never-killed control's parameters.

The JAX modules used as oracles are pure Python over dicts and files;
the JAX side is configured through its environment, the port through
its module settings."""

import json
import os
import signal
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

from sparkdl_tpu.analysis import comms as jax_comms
from sparkdl_tpu.analysis import core as jax_core
from sparkdl_tpu.horovod import elastic as jax_elastic
from sparkdl_tpu.observe import statusz as jax_statusz
from sparkdl_tpu_torch import HorovodRunner, analysis, observe
from sparkdl_tpu_torch.analysis import comms as pt_comms
from sparkdl_tpu_torch.horovod import elastic as pt_elastic
from sparkdl_tpu_torch.horovod import launcher, supervisor
from sparkdl_tpu_torch.models import llama as pt_llama
from sparkdl_tpu_torch.observe import perf as pt_perf
from sparkdl_tpu_torch.observe import statusz as pt_statusz
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh
from sparkdl_tpu_torch.utils import chaos
from sparkdl_tpu_torch.utils.checkpoint import (
    TrainCheckpointer,
    latest_complete_step,
)

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

RESUME_DIR_NAMES = ("SPARKDL_TPU_GANG_RESUME_DIR",
                    "supervisor.policy.resume_dir")
CFG = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab_size=256)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Fresh registries on both sides; no ledger on either."""
    for name in list(os.environ):
        if name.startswith(("SPARKDL_TPU_ELASTIC", "SPARKDL_TPU_GANG_")):
            monkeypatch.delenv(name)
    monkeypatch.setenv("SPARKDL_TPU_PERF_HISTORY", "")
    monkeypatch.setattr(pt_perf, "HISTORY_PATH", None)
    jax_elastic._reset_for_tests()
    pt_elastic._reset_for_tests()
    jax_comms.clear_gang_sharding()
    pt_comms.clear_gang_sharding()
    yield
    jax_elastic._reset_for_tests()
    pt_elastic._reset_for_tests()
    jax_comms.clear_gang_sharding()
    pt_comms.clear_gang_sharding()
    jax_statusz._reset_fleets_for_tests()
    pt_statusz._reset_fleets_for_tests()


# the port's settings -> the JAX module's environment names
SETTING_ENV = {
    "PROBE": "SPARKDL_TPU_ELASTIC_PROBE",
    "CAPACITY": "SPARKDL_TPU_ELASTIC_CAPACITY",
    "CAPACITY_FILE": "SPARKDL_TPU_ELASTIC_CAPACITY_FILE",
    "CHECK_S": "SPARKDL_TPU_ELASTIC_CHECK_S",
    "DEBOUNCE_S": "SPARKDL_TPU_ELASTIC_DEBOUNCE_S",
    "MARGIN": "SPARKDL_TPU_ELASTIC_MARGIN",
    "CKPT_WAIT_S": "SPARKDL_TPU_ELASTIC_CKPT_WAIT_S",
    "MAX_NP": "SPARKDL_TPU_ELASTIC_MAX_NP",
    "MIN_NP": "SPARKDL_TPU_ELASTIC_MIN_NP",
    "ARBITER": "SPARKDL_TPU_ELASTIC_ARBITER",
    "ARBITER_RULES": "SPARKDL_TPU_ELASTIC_ARBITER_RULES",
    "ARBITER_CHIPS": "SPARKDL_TPU_ELASTIC_ARBITER_CHIPS",
    "ARBITER_CLEAR_S": "SPARKDL_TPU_ELASTIC_ARBITER_CLEAR_S",
}


def _configure(monkeypatch, settings):
    """``settings`` ({port name: value}) as the port's settings and as
    the JAX module's environment (the dict returned)."""
    env = {}
    for name, value in settings.items():
        monkeypatch.setattr(pt_elastic, name, value)
        jax_value = value
        if name == "PROBE" and value == "setting":
            jax_value = "env"
        elif isinstance(value, bool):
            jax_value = "1" if value else "0"
        elif isinstance(value, (tuple, list)):
            jax_value = ",".join(value)
        env[SETTING_ENV[name]] = str(jax_value)
    return env


def _ledger(*entries):
    """History records (np, steps_per_s), shaped as the ledger's."""
    return [{"np": n, "bench": "fixture",
             "metrics": {"steps_per_s": {"value": rate}}}
            for n, rate in entries]


def _outcome(fn):
    """("value", result) or ("refused", reason, findings)."""
    try:
        return ("value", fn())
    except (jax_elastic.ElasticGrowRefused,
            pt_elastic.ElasticGrowRefused) as e:
        findings = [str(f).replace(*RESUME_DIR_NAMES) for f in e.findings]
        return ("refused", e.reason, findings)


# -- the policy ----------------------------------------------------------------

# (name, settings, call, args, kwargs); "FILE" in a setting is the case's
# capacity file, whose contents each case writes first
POLICY_CASES = [
    ("probe_setting_wins", {"CAPACITY": "4"}, "probe", (), {}),
    ("probe_unparsable_is_unknown", {"CAPACITY": "banana",
                                     "CAPACITY_FILE": "FILE:8"},
     "probe", (), {}),
    ("probe_file", {"PROBE": "file", "CAPACITY_FILE": "FILE:1"},
     "probe", (), {}),
    ("probe_file_reread", {"PROBE": "file", "CAPACITY_FILE": "FILE:2"},
     "probe", (), {}),
    ("probe_file_missing", {"PROBE": "file", "CAPACITY_FILE": "MISSING"},
     "probe", (), {}),
    ("probe_setting_mode_unset", {"PROBE": "setting"}, "probe", (), {}),
    ("stay_at_capacity", {}, "choose", (2, 2), {"history": []}),
    ("stay_below_capacity", {}, "choose", (2, 1), {"history": []}),
    ("grow_empty_ledger", {}, "choose", (1, 4), {"history": []}),
    ("grow_blessed", {}, "choose", (1, 2),
     {"history": _ledger((1, 10.0), (2, 19.0)), "margin": 0.8}),
    ("refuse_worse", {}, "choose", (1, 2),
     {"history": _ledger((1, 10.0), (2, 10.0)), "margin": 0.8}),
    ("fall_back_to_unmeasured", {}, "choose", (2, 4),
     {"history": _ledger((2, 20.0), (4, 10.0)), "margin": 0.8}),
    ("median_discipline", {}, "choose", (1, 2),
     {"history": _ledger((1, 10.0), (2, 7.0), (2, 19.0), (2, 20.0)),
      "margin": 0.8}),
    ("max_np_cap", {}, "choose", (1, 8), {"history": [], "max_np": 2}),
    ("margin_setting", {"MARGIN": 0.5}, "choose", (1, 2),
     {"history": _ledger((1, 10.0), (2, 12.0))}),
    ("reads_the_ledger", {}, "choose", (1, 2), {"history": "LEDGER",
                                                "margin": 0.8}),
    ("check_no_resume_dir", {}, "check", (1, 2),
     {"resume_dir": None, "history": []}),
    ("check_no_committed_step", {}, "check", (1, 2),
     {"resume_dir": "DIR", "latest_step": lambda: None, "history": []}),
    ("check_empty_dir", {}, "check", (1, 2),
     {"resume_dir": "DIR", "history": []}),
    ("check_returns_target", {}, "check", (1, 2),
     {"resume_dir": "DIR", "latest_step": lambda: 7, "history": []}),
    ("check_refused_by_ledger", {}, "check", (1, 2),
     {"resume_dir": "DIR", "latest_step": 7,
      "history": _ledger((1, 10.0), (2, 10.0)), "margin": 0.8}),
]


@pytest.mark.parametrize("name,settings,call,args,kwargs", POLICY_CASES,
                         ids=[c[0] for c in POLICY_CASES])
def test_policy_matches_jax(monkeypatch, tmp_path, name, settings, call,
                            args, kwargs):
    """The port's ``probe_capacity``, ``choose_np`` and ``check_grow``
    give JAX's target, or JAX's refusal with its reason and findings
    (the no-checkpoint finding names the port's setting in place of
    ``SPARKDL_TPU_GANG_RESUME_DIR``), on the same inputs."""
    settings = dict(settings)
    cap = tmp_path / "capacity"
    if "CAPACITY_FILE" in settings:
        spec = settings["CAPACITY_FILE"]
        if spec.startswith("FILE:"):
            cap.write_text(spec[5:])
        settings["CAPACITY_FILE"] = str(cap)
    env = _configure(monkeypatch, settings)
    kwargs = dict(kwargs)
    if kwargs.get("resume_dir") == "DIR":
        kwargs["resume_dir"] = str(tmp_path / "ck")
        os.makedirs(kwargs["resume_dir"])
    if kwargs.get("history") == "LEDGER":
        ledger = tmp_path / "history.jsonl"
        ledger.write_text("".join(json.dumps(r) + "\n" for r in _ledger(
            (1, 10.0), (2, 10.0))))
        del kwargs["history"]
        monkeypatch.setenv("SPARKDL_TPU_PERF_HISTORY", str(ledger))
        monkeypatch.setattr(pt_perf, "HISTORY_PATH", str(ledger))
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if call == "probe":
        got = _outcome(pt_elastic.probe_capacity)
        want = _outcome(lambda: jax_elastic.probe_capacity(env))
        if name == "probe_file_reread":
            cap.write_text("3")
            got = got, _outcome(pt_elastic.probe_capacity)
            want = want, _outcome(lambda: jax_elastic.probe_capacity(env))
    else:
        fn = {"choose": "choose_np", "check": "check_grow"}[call]
        got = _outcome(lambda: getattr(pt_elastic, fn)(*args, **kwargs))
        want = _outcome(lambda: getattr(jax_elastic, fn)(*args, **kwargs))
    assert got == want


# -- the controller ------------------------------------------------------------

class _Alerts:
    """An alert engine's ``records()``, appended to by the scenario."""

    def __init__(self):
        self.recs = []

    def records(self):
        return list(self.recs)


class _Fleet:
    """A colocated fleet as the controller reads it: its queue depth,
    replica count and ``scale_to``, which notes whether the controller's
    lock was free when it was called."""

    def __init__(self):
        self.address = ("127.0.0.1", 0)
        self.max_queue = 8
        self._restarts = 0
        self.depth = 0
        self.replicas = 1
        self.calls = []
        self.controller = None

    def replica_states(self):
        return []

    def queue_depth(self):
        return self.depth

    def replica_count(self):
        return self.replicas

    def scale_to(self, n):
        lock = self.controller._lock
        free = lock.acquire(blocking=False)
        if free:
            lock.release()
        self.calls.append((n, free))
        self.replicas = n


def _no_wall_times(doc):
    """``doc`` with its decisions' wall times left out."""
    if isinstance(doc, dict) and "decisions" in doc:
        doc = dict(doc, decisions=[{k: v for k, v in d.items() if k != "ts"}
                                   for d in doc["decisions"]])
    return doc


class _Twin:
    """The JAX controller and the port's, made from the same settings,
    the same scripted probe (the capacities successive probes see, the
    last repeating), checkpoint step and alert engine, each on a clock
    of 0 (every poll names its time)."""

    def __init__(self, monkeypatch, caps, settings, *, current_np=2,
                 fleet=False):
        base = {"CHECK_S": 1.0, "DEBOUNCE_S": 3.0}
        env = _configure(monkeypatch, dict(base, **settings))
        env["SPARKDL_TPU_ELASTIC"] = "1"
        self.step = 5
        self.alerts = _Alerts()
        self.fleets = {}
        self.ctrl = {}
        for side, mod in (("jax", jax_elastic), ("port", pt_elastic)):
            seq = list(caps)

            def probe(seq=seq):
                return seq.pop(0) if len(seq) > 1 else seq[0]

            kw = dict(probe=probe, clock=lambda: 0.0,
                      latest_step=lambda: self.step,
                      resume_dir="/nonexistent/ck-elastic",
                      alerts=self.alerts)
            if side == "jax":
                kw["env"] = env
            self.ctrl[side] = mod.ElasticController(current_np, **kw)
            if fleet:
                f = _Fleet()
                f.controller = self.ctrl[side]
                (jax_statusz if side == "jax"
                 else pt_statusz).register_fleet(f)
                self.fleets[side] = f

    def both(self, method, *args):
        out = {side: _no_wall_times(getattr(c, method)(*args))
               for side, c in self.ctrl.items()}
        assert out["jax"] == out["port"], (method, args, out)
        return out["port"]

    def poll(self, now):
        return self.both("poll", now)

    def set_depth(self, depth):
        for f in self.fleets.values():
            f.depth = depth

    def decisions(self):
        logs = {}
        for side, c in self.ctrl.items():
            rep = c.report()
            logs[side] = (
                [{k: v for k, v in d.items() if k != "ts"}
                 for d in rep["decisions"]],
                rep["transitions"], rep["current_np"], rep["available_np"],
                rep["yielded_chips"])
        assert logs["jax"] == logs["port"]
        return logs["port"][0]


def _flapping(t):
    """Capacity blinks 3, 2, 3, ...: the surplus never holds the
    debounce, so nothing is planned and nothing shrinks."""
    for now in range(10):
        t.step += 1
        assert t.poll(float(now)) is None
    assert t.both("status")["pending"] is None


def _debounced_grow(t):
    """A surplus held past the debounce plans a grow, emitted once the
    next step commits; the emitted plan answers the relaunch target."""
    for now in range(4):
        assert t.poll(float(now)) is None
    assert t.both("status")["pending"]["direction"] == "grow"
    t.step = 6
    assert t.poll(4.0) == {"direction": "grow", "target_np": 4,
                           "reason": "capacity_returned", "resume_step": 6}
    assert t.both("relaunch_target") == 4


def _latched_refusal(t):
    """The ledger refuses the capacity once; the same capacity is never
    weighed again; after a dip it is weighed again."""
    for now in range(7):
        assert t.poll(float(now)) is None


def _relaunch_clamp(t):
    """Two cards gone: the relaunch is clamped to the capacity and lands
    as a shrink transition; the same world again is no transition."""
    assert t.both("relaunch_target") == 1
    t.both("note_attempt", 1)
    assert t.both("relaunch_target") == 1
    t.both("note_attempt", 1)


def _consumed_plan(t):
    """An emitted plan is consumed by the attempt at its target."""
    assert t.poll(0.0) is None
    assert t.poll(1.0) is None
    t.step = 6
    assert t.poll(2.0)["target_np"] == 4
    t.both("note_attempt", 4)
    assert t.both("status")["pending"] is None


def _ckpt_wait_expiry(t):
    """A plan whose checkpoint vanished is cancelled when the wait runs
    out; one whose step never advances is emitted at the older step."""
    assert t.poll(0.0) is None
    assert t.poll(1.0) is None
    t.step = None
    assert t.poll(3.0) is None
    assert t.poll(7.0) is None
    assert t.both("status")["pending"] is None
    t.step = 5
    assert t.poll(8.0) is None
    assert t.poll(9.0) is None
    assert t.poll(15.0)["resume_step"] == 5


def _cancelled_by_preflight(t):
    """The supervisor cancels an emitted plan its pre-flight refused:
    the relaunch keeps the current world."""
    assert t.poll(0.0) is None
    assert t.poll(1.0) is None
    t.step = 6
    assert t.poll(2.0) is not None
    t.both("cancel_pending", "reshard_preflight_refused")
    assert t.both("relaunch_target") == 2


def _arbiter(t):
    """A serving-pressure alert makes training yield a card (the fleet
    scaled up outside the controller's lock), and the cards come back
    after ``ARBITER_CLEAR_S`` of quiet (the fleet back to its size)."""
    t.alerts.recs.append({"rule": "queue_depth_growth"})
    t.set_depth(3)
    assert t.poll(0.0) is None
    assert t.both("status")["pending"]["direction"] == "yield"
    t.step = 6
    req = t.poll(1.0)
    assert req["direction"] == "yield" and req["target_np"] == 1
    assert t.both("relaunch_target") == 1
    t.both("note_attempt", 1)
    t.alerts.recs.append({"rule": "hbm_leak"})  # not an arbiter rule
    t.set_depth(0)
    for now in (2.0, 3.0):
        assert t.poll(now) is None
    assert t.poll(4.0) is None
    assert t.both("status")["pending"]["direction"] == "reclaim"
    t.step = 7
    req = t.poll(5.0)
    assert req["direction"] == "reclaim" and req["target_np"] == 2
    t.both("note_attempt", 2)
    calls = {side: f.calls for side, f in t.fleets.items()}
    assert calls["jax"] == calls["port"] == [(2, True), (1, True)]


# (name, scenario, capacities, settings, options)
CONTROLLER_CASES = [
    ("flapping_probe", _flapping, [3, 2] * 5, {}, {}),
    ("debounced_grow", _debounced_grow, [4], {}, {}),
    ("latched_refusal", _latched_refusal, [3, 3, 3, 2, 3],
     {"DEBOUNCE_S": 0.0}, {"ledger": True}),
    ("relaunch_clamp", _relaunch_clamp, [1], {}, {}),
    ("consumed_plan", _consumed_plan, [4], {"DEBOUNCE_S": 0.0}, {}),
    ("ckpt_wait_expiry", _ckpt_wait_expiry, [4],
     {"DEBOUNCE_S": 0.0, "CKPT_WAIT_S": 5.0}, {}),
    ("cancelled_by_preflight", _cancelled_by_preflight, [4],
     {"DEBOUNCE_S": 0.0}, {}),
    ("arbiter_yield_reclaim", _arbiter, [2],
     {"ARBITER": True, "ARBITER_CLEAR_S": 2.0}, {"fleet": True}),
]


@pytest.mark.parametrize("name,scenario,caps,settings,options",
                         CONTROLLER_CASES,
                         ids=[c[0] for c in CONTROLLER_CASES])
def test_controller_decisions_match_jax(monkeypatch, tmp_path, name,
                                        scenario, caps, settings, options):
    """Every scripted scenario gives the same answers at every call and
    the same ``report()`` decision log (its wall times aside), the same
    transitions and the same state, as the JAX controller."""
    if options.get("ledger"):
        ledger = tmp_path / "history.jsonl"
        ledger.write_text("".join(json.dumps(r) + "\n" for r in _ledger(
            (2, 10.0), (3, 10.0))))
        monkeypatch.setenv("SPARKDL_TPU_PERF_HISTORY", str(ledger))
        monkeypatch.setattr(pt_perf, "HISTORY_PATH", str(ledger))
    twin = _Twin(monkeypatch, caps, settings, fleet=options.get("fleet"))
    scenario(twin)
    log = twin.decisions()
    if name == "latched_refusal":
        assert [d["outcome"] for d in log] == ["refused", "refused"]
    if name == "relaunch_clamp":
        assert log == [{"direction": "shrink", "outcome": "transition",
                        "reason": "capacity", "from_np": 2, "to_np": 1}]


def test_maybe_make_controller_is_off_by_default(monkeypatch):
    assert pt_elastic.maybe_make_controller() is None
    monkeypatch.setattr(pt_elastic, "ENABLED", True)
    ctrl = pt_elastic.maybe_make_controller(2)
    assert isinstance(ctrl, pt_elastic.ElasticController)
    assert ctrl.report()["schema"] == "sparkdl_tpu_torch.horovod.elastic/1"
    for call in (pt_elastic.probe_capacity, pt_elastic.maybe_make_controller,
                 pt_elastic.ElasticController):
        with pytest.raises(NotImplementedError, match="env="):
            call(env={"SPARKDL_TPU_ELASTIC": "1"})


def test_devices_probe_counts_cards_without_a_context(monkeypatch):
    """``"devices"``: this host's CUDA cards, None without one (this
    box has none); it never looks for TPU device files."""
    monkeypatch.setattr(pt_elastic, "PROBE", "devices")
    assert pt_elastic.probe_capacity() is None
    monkeypatch.setattr(pt_elastic, "_card_count", lambda: 2)
    assert pt_elastic.probe_capacity() == 2


# -- the pre-flight and the axes --------------------------------------------------

def _tp_model():
    mesh = Mesh(AXES, (1, 1, 1, 2))
    return pt_llama.Llama(pt_llama.LlamaConfig.tiny(dtype=torch.float32,
                                                    **CFG),
                          device="meta", mesh=mesh)


def _data_model():
    return pt_llama.Llama(pt_llama.LlamaConfig.tiny(dtype=torch.float32,
                                                    **CFG, lora_rank=4),
                          device="meta")


def _jax_register(reg):
    """The port's registration as the JAX registry's."""
    jax_comms.register_gang_sharding(
        [jax_core.ParamInfo(path=i.path, shape=i.shape, dtype=i.dtype,
                            sharded_axes=i.sharded_axes, spec=i.spec,
                            mesh_axes=i.mesh_axes)
         for i in reg["param_info"]], reg["source_axes"],
        local_device_count=reg["local_device_count"],
        hbm_bytes=reg["hbm_bytes"],
        state_multiplier=reg["state_multiplier"])


PREFLIGHT_CASES = [
    # (name, model, mesh, registration kwargs, target np, refused op)
    ("tp_not_a_multiple_of_model", "tp", None, {}, 3, "mesh"),
    ("tp_shrink_to_model", "tp", None, {"hbm_bytes": 1e12}, 2, None),
    ("tp_grow", "tp", None, {"hbm_bytes": 1e12}, 6, None),
    ("tp_over_hbm", "tp", None, {"hbm_bytes": 4e5}, 2, "hbm"),
    ("tp_fraction_of_a_host", "tp", None,
     {"hbm_bytes": 1e12, "local_device_count": 4}, 2, "mesh"),
    ("data_shrink", "data", {"data": 2}, {"hbm_bytes": 1e12}, 1, None),
    ("data_over_hbm", "data", {"data": 2}, {"hbm_bytes": 1e5}, 1, "hbm"),
]


@pytest.mark.parametrize("name,kind,mesh,kw,target,refused",
                         PREFLIGHT_CASES, ids=[c[0] for c in PREFLIGHT_CASES])
def test_check_relaunch_np_matches_jax(name, kind, mesh, kw, target,
                                       refused):
    """``check_relaunch_np`` on a registered TP tree (``model=2``) and a
    data-parallel one: the plan JAX computes for the same tree, or its
    typed refusal naming the failing axis or budget."""
    model = _tp_model() if kind == "tp" else _data_model()
    reg = analysis.register_gang_sharding(model, mesh=mesh, **kw)
    assert reg is pt_comms.registered_gang_sharding()
    _jax_register(reg)
    if refused is None:
        plan = pt_comms.check_relaunch_np(target)
        ref = jax_comms.check_relaunch_np(target)
        assert plan.to_dict() == ref.to_dict()
        return
    with pytest.raises(pt_comms.ReshardPreflightError) as got:
        pt_comms.check_relaunch_np(target)
    with pytest.raises(jax_comms.ReshardPreflightError) as want:
        jax_comms.check_relaunch_np(target)
    assert [f.to_dict() for f in got.value.findings] == [
        f.to_dict() for f in want.value.findings]
    assert got.value.findings[0].op == refused


def test_no_registration_is_unchecked():
    assert pt_comms.check_relaunch_np(3) is None
    assert supervisor._reshard_preflight(3) is None


def _preempted_once(seen, outcome="done"):
    """A launch that fails as a SIGKILLed rank on its first call, and
    records every call's context and world."""
    def launch(ctx, world=None):
        seen.append((ctx, world))
        if len(seen) == 1:
            raise supervisor.GangFailure(
                "preempted", kind="worker_death",
                exit_codes=[0, -signal.SIGKILL])
        return outcome

    return launch


def test_operator_target_refused_before_any_relaunch():
    """An infeasible ``relaunch_np`` raises ``ReshardPreflightError``
    after the failure, before the backoff: no second launch, no sleep."""
    analysis.register_gang_sharding(_tp_model(), hbm_bytes=1e12)
    seen, slept = [], []
    policy = supervisor.RetryPolicy(max_retries=2, relaunch_np=3)
    with pytest.raises(pt_comms.ReshardPreflightError):
        supervisor.supervise(_preempted_once(seen), policy,
                             _sleep=slept.append)
    assert len(seen) == 1 and slept == []


def test_controller_target_refused_cancels_its_plan(monkeypatch):
    """The controller's infeasible target (a planned grow to 3 on a
    ``model=2`` tree) is cancelled, ``"reshard_preflight_refused"`` in
    its log, and the relaunch keeps the current world."""
    analysis.register_gang_sharding(_tp_model(), hbm_bytes=1e12)
    step = {"v": 5}
    monkeypatch.setattr(pt_elastic, "DEBOUNCE_S", 0.0)
    monkeypatch.setattr(pt_elastic, "CHECK_S", 1.0)
    ctrl = pt_elastic.ElasticController(
        2, probe=lambda: 3, clock=lambda: 0.0,
        latest_step=lambda: step["v"], resume_dir="/nonexistent/ck")
    pt_elastic.set_active_controller(ctrl)
    ctrl.poll(0.0)
    ctrl.poll(1.0)
    step["v"] = 6
    req = ctrl.poll(2.0)
    assert req["target_np"] == 3
    seen = []

    def launch(ctx, world=None):
        seen.append((ctx, world))
        if len(seen) == 1:
            raise supervisor.GangFailure(
                "elastic resize", kind="elastic_resize",
                exit_codes=[-signal.SIGKILL, -signal.SIGKILL],
                elastic_direction="grow", elastic_target=3)
        return "done"

    assert supervisor.supervise(launch, supervisor.RetryPolicy(),
                                _sleep=pytest.fail) == "done"
    assert seen[1][1] == 2
    cancelled = [d for d in ctrl.report()["decisions"]
                 if d["outcome"] == "cancelled"]
    assert [d["reason"] for d in cancelled] == ["reshard_preflight_refused"]


def test_supervisor_ships_axes_from_the_registry():
    """With a registered tree the relaunch's axes are the registry's and
    ``shrink_mesh``'s; the registry then holds the relaunched gang's axes,
    the source of the next relaunch."""
    analysis.register_gang_sharding(_data_model(), mesh={"data": 2},
                                    hbm_bytes=1e12)
    seen = []
    policy = supervisor.RetryPolicy(max_retries=1, backoff_base=0.0,
                                    jitter=0.0, relaunch_np=1)
    assert supervisor.supervise(_preempted_once(seen), policy,
                                _sleep=lambda s: None) == "done"
    ctx, world = seen[1]
    assert world == 1 and ctx.attempt == 1
    assert ctx.source_axes == {"data": 2, "fsdp": 1, "seq": 1, "model": 1}
    assert ctx.target_axes == {"data": 1, "fsdp": 1, "seq": 1, "model": 1}
    assert (pt_comms.registered_gang_sharding()["source_axes"]
            == ctx.target_axes)


def test_supervisor_ships_axes_from_the_sidecar(tmp_path, monkeypatch):
    """Without a registered tree, the axes come from the resume step's
    sidecar, as the JAX supervisor derives them (after JAX's
    ``test_supervisor_ships_reshard_axes_from_sidecar``)."""
    from sparkdl_tpu.horovod import supervisor as jax_sup

    mesh = Mesh(AXES, (2, 1, 1, 2))
    ckpt = TrainCheckpointer(str(tmp_path))
    ckpt.save(7, {"w": torch.ones(8, 4)}, mesh=mesh, specs={})
    ckpt.close()
    seen = []
    policy = supervisor.RetryPolicy(max_retries=2, backoff_base=0.0,
                                    jitter=0.0, resume_dir=str(tmp_path),
                                    relaunch_np=2)
    assert supervisor.supervise(_preempted_once(seen), policy,
                                _sleep=lambda s: None) == "done"
    ctx, world = seen[1]
    monkeypatch.setenv("SPARKDL_TPU_GANG_RELAUNCH_NP", "2")
    ref = []

    def jax_launch(extra_env):
        ref.append(dict(extra_env))
        if len(ref) == 1:
            raise jax_sup.GangFailure("preempted", kind="worker_death",
                                      exit_codes=[-signal.SIGKILL])
        return "done"

    jax_sup.supervise(jax_launch, jax_sup.RetryPolicy(
        max_retries=2, backoff_base=0.0, jitter=0.0,
        resume_dir=str(tmp_path)), _sleep=lambda s: None)
    assert world == int(ref[1]["SPARKDL_TPU_GANG_RELAUNCH_NP"]) == 2
    assert ctx.resume_step == 7
    assert ctx.source_axes == json.loads(
        ref[1]["SPARKDL_TPU_RESHARD_SOURCE_AXES"])
    assert ctx.target_axes == json.loads(
        ref[1]["SPARKDL_TPU_RESHARD_TARGET_AXES"]) == {
        "data": 1, "fsdp": 1, "seq": 1, "model": 2}


def test_an_elastic_resize_takes_no_budget_and_no_backoff():
    """Planned resizes relaunch with ``max_retries=0`` and never sleep;
    each is a ``gang.resize``, classified as JAX classifies it."""
    from sparkdl_tpu.horovod import supervisor as jax_sup

    def resize():
        return supervisor.GangFailure(
            "elastic resize", kind="elastic_resize", exit_codes=[-9, -9],
            elastic_direction="grow", elastic_target=2)

    calls = []

    def launch(ctx):
        calls.append(ctx.attempt)
        if len(calls) < 3:
            raise resize()
        return "done"

    assert supervisor.supervise(launch, supervisor.RetryPolicy(),
                                _sleep=pytest.fail) == "done"
    assert calls == [0, 1, 2]
    err = jax_sup.GangFailure("elastic resize", kind="elastic_resize",
                              exit_codes=[-9, -9])
    err.elastic_direction, err.elastic_target = "grow", 2
    assert supervisor.classify_failure(resize()) == \
        jax_sup.classify_failure(err)


# -- one supervised gang: 2 -> 1 -> 2 -----------------------------------------------

TOTAL_STEPS = 12
LR = 0.01


def _elastic_train_main(ckpt_dir, total_steps, step_s=0.0, restores=None):
    """The twin of JAX's ``_elastic_train_main``: fp32 ``w`` (8, 4) on
    the mesh of the restart context's target axes (else ``data`` over
    the world), a rank-independent all-reduced gradient (``step + 1``
    everywhere), a save on the mesh each step, the fault injection's
    hook, ``step_s`` of pacing; resumed from the restart context's step
    (else the newest committed one) onto this attempt's mesh. Rank 0
    appends each restore (attempt, world, resharding) to the file
    ``restores``: an attempt that is killed returns nothing."""
    import json as _json
    import time as _time

    import torch as _torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import restart_context
    from sparkdl_tpu_torch.parallel.mesh import make_mesh_from_axes
    from sparkdl_tpu_torch.utils.chaos import chaos_step
    from sparkdl_tpu_torch.utils.checkpoint import (
        TrainCheckpointer as _Ckpt,
        latest_complete_step as _latest,
    )

    hvd.init()
    ctx = restart_context()
    axes = dict(ctx.target_axes or {"data": hvd.size()})
    mesh = make_mesh_from_axes(axes)
    w = _torch.ones(8, 4)
    ckpt = _Ckpt(ckpt_dir)
    resume = ctx.resume_step
    if resume is None:
        resume = _latest(ckpt_dir)
    start, restored_w, reshard = 0, None, None
    if resume is not None:
        w = ckpt.restore(resume, target_mesh=mesh)["w"]
        reshard = dict(ckpt.last_reshard) if ckpt.last_reshard else None
        restored_w = w.tolist()
        start = resume + 1
        if restores and hvd.rank() == 0:
            with open(restores, "a") as f:
                f.write(_json.dumps({"attempt": ctx.attempt,
                                     "world": hvd.size(), "resume": resume,
                                     "reshard": reshard}) + "\n")
    history = {}
    try:
        for step in range(start, total_steps):
            g = hvd.allreduce(_torch.full((8, 4), float(step + 1)),
                              op=hvd.Average)
            w = w - LR * g
            ckpt.save(step, {"w": w}, mesh=mesh, specs={})
            hvd.barrier()  # rank 0's save is durable before any death
            history[str(step)] = w.tolist()
            chaos_step(step)
            if step_s:
                _time.sleep(step_s)
    finally:
        ckpt.close()
    return {"w": w.tolist(), "attempt": ctx.attempt,
            "resume_step": ctx.resume_step, "world": hvd.size(),
            "axes": axes, "source_axes": ctx.source_axes,
            "target_axes": ctx.target_axes, "restored_w": restored_w,
            "reshard": reshard, "history": history}


@pytest.fixture
def bounded_launcher(monkeypatch):
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 5.0)


@pytest.mark.gang
def test_kill_shrink_autonomous_grow_matches_control(monkeypatch, tmp_path,
                                                     bounded_launcher):
    """The twin of JAX's ``test_kill_shrink_autonomous_grow_matches_control``
    in one supervised ``HorovodRunner(np=-2)`` launch: rank 1 is killed
    after step 2, the controller clamps the relaunch to the one card the
    capacity file offers, the file says 2 once step 3 is committed, and
    the controller recycles the gang at 2; no operator step. The final
    ``w`` is the never-killed control's, bit for bit, and numpy's closed
    form; each restart context carries the axes of its world change, and
    the restores resharded shrink, then grow."""
    control = HorovodRunner(np=-2).run(
        _elastic_train_main, ckpt_dir=str(tmp_path / "control"),
        total_steps=TOTAL_STEPS)
    assert control["attempt"] == 0 and control["world"] == 2

    cap_file = tmp_path / "capacity"
    cap_file.write_text("1")
    ck = tmp_path / "ck"
    once = tmp_path / "one-kill"
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy(
        max_retries=2, backoff_base=0.1, backoff_max=0.2,
        resume_dir=str(ck)))
    for name, value in {"KILL_RANK": 1, "KILL_STEP": 2,
                        "ONCE_FILE": str(once)}.items():
        monkeypatch.setattr(chaos, name, value)
    for name, value in {"ENABLED": True, "PROBE": "file",
                        "CAPACITY_FILE": str(cap_file), "CHECK_S": 0.1,
                        "DEBOUNCE_S": 0.4, "CKPT_WAIT_S": 60.0}.items():
        monkeypatch.setattr(pt_elastic, name, value)
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path / "tel"))
    stop = threading.Event()

    def return_capacity():
        # the cards come back once the shrunken gang committed step 3
        while not stop.is_set():
            if (latest_complete_step(str(ck)) or -1) >= 3:
                cap_file.write_text("2")
                return
            time.sleep(0.05)

    contexts = []
    launch_once = launcher._launch_gang_once

    def noted(*args, **kw):
        contexts.append((kw["restart"], kw["world"]))
        return launch_once(*args, **kw)

    monkeypatch.setattr(launcher, "_launch_gang_once", noted)
    restores = tmp_path / "restores.jsonl"
    returner = threading.Thread(target=return_capacity, daemon=True)
    returner.start()
    try:
        result = HorovodRunner(np=-2).run(
            _elastic_train_main, ckpt_dir=str(ck), total_steps=TOTAL_STEPS,
            step_s=0.45, restores=str(restores))
    finally:
        stop.set()
        returner.join(timeout=5)
    chaos._reset_for_tests()

    assert once.exists()  # the kill fired, once
    assert result["attempt"] == 2  # the kill's relaunch and the resize
    assert supervisor.attempt_world_sizes() == [2, 1, 2]
    assert result["world"] == 2 and result["axes"]["data"] == 2

    def axes(data):
        return {"data": data, "fsdp": 1, "seq": 1, "model": 1}

    assert [(c.attempt, c.source_axes, c.target_axes, world)
            for c, world in contexts] == [
        (0, None, None, None), (1, axes(2), axes(1), 1),
        (2, axes(1), axes(2), 2)]
    assert (result["source_axes"], result["target_axes"]) == (axes(1),
                                                              axes(2))
    lines = [json.loads(x) for x in restores.read_text().splitlines()]
    assert [(r["attempt"], r["world"], r["reshard"]["direction"])
            for r in lines] == [(1, 1, "shrink"), (2, 2, "grow")]
    assert lines[0]["resume"] == 2
    grown = result["reshard"]
    assert grown == lines[1]["reshard"]
    resume = result["resume_step"]
    assert resume is not None and resume > 3
    assert result["restored_w"] == control["history"][str(resume)]
    assert result["w"] == control["w"]
    w = np.ones((8, 4), np.float32)
    for step in range(TOTAL_STEPS):
        w = w - np.float32(LR) * np.float32(step + 1)
    assert np.array_equal(np.asarray(result["w"], np.float32), w)

    run_dir = next((tmp_path / "tel").iterdir())
    with open(run_dir / "elastic.json") as f:
        decisions = json.load(f)["decisions"]
    assert [(d["direction"], d["outcome"], d["reason"], d["from_np"],
             d["to_np"]) for d in decisions] == [
        ("shrink", "transition", "capacity", 2, 1),
        ("grow", "resize", "capacity_returned", 1, 2),
        ("grow", "transition", "capacity_returned", 1, 2)]
    # the kill's instant is flushed before the signal
    from sparkdl_tpu_torch.observe import doctor

    assert doctor.diagnose(str(run_dir))["chaos_injections"] == [
        "chaos.kill"]
