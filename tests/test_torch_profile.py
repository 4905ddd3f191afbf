"""The port's per-card profile and the launcher pre-flight that applies
it, on the CPU: the JAX package's profile tests with the port's module
settings (round trip, refusals, operator precedence, resolution by card
kind, quarantine, degrade honoring), the same profile through both
packages' apply step giving the same settings, the rank settings of
every supervised attempt carrying the profile, and one gang of two whose
ranks run under the profile on both attempts of a supervised relaunch."""

import json
import os
import sys

import cloudpickle
import pytest
import torch

from sparkdl_tpu.perf import profile as jax_prof
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import _worker, launcher, supervisor
from sparkdl_tpu_torch.perf import profile as prof
from sparkdl_tpu_torch.perf import trial
from sparkdl_tpu_torch.utils import knobs

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

CHUNK = "sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK"
LOSS = "sparkdl_tpu_torch.perf.trial.LOSS_CHUNK"


@pytest.fixture(autouse=True)
def _cpu_launch(monkeypatch):
    """Launches of this file run on the CPU (the profile key ``cpu``),
    with no profile unless a test sets one."""
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    monkeypatch.setattr(prof, "PROFILE", None)


def _verified(tmp_path, knobs_map=None, name="cpu.json", **kw):
    doc = prof.make_profile(
        {CHUNK: 8} if knobs_map is None else knobs_map,
        device_kind="cpu", bench="serve", status=prof.STATUS_VERIFIED, **kw)
    return doc, prof.save_profile(doc, str(tmp_path / name))


def test_profile_round_trip(tmp_path):
    doc, path = _verified(tmp_path, evidence={"trials": []})
    loaded = prof.load_profile(path)
    assert loaded["schema"] == prof.PROFILE_SCHEMA == jax_prof.PROFILE_SCHEMA
    assert loaded["knobs"] == {CHUNK: 8}
    assert loaded["host"] and loaded["device_kind"] == "cpu"
    # the JAX record layout
    jax_doc = jax_prof.make_profile(
        {"SPARKDL_TPU_SERVE_DECODE_CHUNK": "8"}, device_kind="cpu",
        bench="serve", status=jax_prof.STATUS_VERIFIED,
        evidence={"trials": []})
    assert set(jax_doc) == set(loaded)


def test_make_profile_refuses_non_tunable_settings():
    for name in ("sparkdl_tpu_torch.horovod.launcher.HOSTS",
                 "TOTALLY_UNKNOWN", "SPARKDL_TPU_SERVE_DECODE_CHUNK"):
        with pytest.raises(prof.ProfileError, match="tunable"):
            prof.make_profile({name: "x"}, device_kind="cpu",
                              bench="serve", status=prof.STATUS_VERIFIED)
    with pytest.raises(prof.ProfileError, match="status"):
        prof.make_profile({}, device_kind="cpu", bench="serve",
                          status="maybe")


def test_load_profile_rejects_wrong_schema(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": "something/else", "knobs": {}}))
    with pytest.raises(prof.ProfileError, match="schema"):
        prof.load_profile(str(p))


def test_operator_pin_wins_over_profile(tmp_path, monkeypatch):
    doc, _ = _verified(tmp_path)
    assert prof.profile_settings_delta(doc) == {CHUNK: 8}
    assert prof.profile_settings_delta(doc, current={CHUNK: 32}) == {}
    # the live setting moved off its registered default is the pin
    monkeypatch.setattr(trial, "SERVE_DECODE_CHUNK", 32)
    assert prof.profile_settings_delta(doc) == {}


def test_unregistered_profile_setting_is_skipped(tmp_path):
    doc, _ = _verified(tmp_path)
    # a hand-edited profile smuggling a wiring setting and an unknown one
    doc["knobs"]["sparkdl_tpu_torch.horovod.launcher.HOSTS"] = "evil:1"
    doc["knobs"]["LD_PRELOAD_ISH"] = "evil"
    assert prof.profile_settings_delta(doc) == {CHUNK: 8}


def test_same_profile_through_both_apply_steps(tmp_path):
    """The JAX profile of the same knobs and the port's apply the same
    settings, names mapped through the registry, under the same operator
    rule (a pinned knob yields)."""
    port_doc, _ = _verified(tmp_path, {CHUNK: 8, LOSS: 1024})
    jax_doc = jax_prof.make_profile(
        {"SPARKDL_TPU_SERVE_DECODE_CHUNK": "8",
         "SPARKDL_TPU_LOSS_CHUNK": "1024"}, device_kind="cpu",
        bench="serve", status=jax_prof.STATUS_VERIFIED)

    def port_side(pinned):
        current = {knobs.by_env(k).name: knobs.parse_value(
            knobs.by_env(k), v) for k, v in pinned.items()}
        got = prof.profile_settings_delta(port_doc, current=current)
        return {knobs.get(k).env: str(v) for k, v in got.items()}

    for pinned in ({}, {"SPARKDL_TPU_LOSS_CHUNK": "256"}):
        assert port_side(pinned) == jax_prof.profile_env_delta(
            jax_doc, pinned)


def test_find_profiles_resolution(tmp_path, monkeypatch):
    doc, path = _verified(tmp_path)
    monkeypatch.setattr(prof, "PROFILE", path)
    assert [p for _, p in prof.find_profiles()] == [path]
    # a directory: the flat <root>/<kind>.json is honored
    monkeypatch.setattr(prof, "PROFILE", str(tmp_path))
    found = prof.find_profiles()
    assert found and found[0][0]["knobs"] == {CHUNK: 8}
    monkeypatch.setattr(prof, "PROFILE", "off")
    assert prof.find_profiles() == []
    monkeypatch.setattr(prof, "PROFILE", None)
    assert prof.find_profiles() == []
    # a pinned path that is neither file nor directory is loud, and the
    # pre-flight logs it and applies nothing
    monkeypatch.setattr(prof, "PROFILE", str(tmp_path / "cpu.jsn"))
    with pytest.raises(prof.ProfileError, match="neither"):
        prof.find_profiles()
    assert prof.preflight_settings() == {}


def test_per_bench_profiles_compose_under_one_kind(tmp_path, monkeypatch):
    train = prof.make_profile({LOSS: 1024}, device_kind="cpu",
                              bench="train", status=prof.STATUS_VERIFIED)
    serve = prof.make_profile({CHUNK: 8, LOSS: 256}, device_kind="cpu",
                              bench="serve", status=prof.STATUS_VERIFIED)
    p1 = prof.save_profile(serve, prof.profile_path("cpu", "serve",
                                                    str(tmp_path)))
    prof.save_profile(train, prof.profile_path("cpu", "train",
                                               str(tmp_path)))
    assert p1 == str(tmp_path / "cpu" / "serve.json")
    monkeypatch.setattr(prof, "PROFILE", str(tmp_path))
    # serve.json sorts first and keeps its LOSS_CHUNK
    assert prof.preflight_settings() == {CHUNK: 8, LOSS: 256}


def test_rotten_profile_is_quarantined_to_itself(tmp_path, monkeypatch):
    good = prof.make_profile({CHUNK: 8}, device_kind="cpu", bench="serve",
                             status=prof.STATUS_VERIFIED)
    prof.save_profile(good, prof.profile_path("cpu", "serve", str(tmp_path)))
    (tmp_path / "cpu" / "train.json").write_text("{truncated")
    monkeypatch.setattr(prof, "PROFILE", str(tmp_path))
    assert prof.preflight_settings() == {CHUNK: 8}


def test_strict_device_kind_never_guesses(tmp_path, monkeypatch):
    assert prof.strict_device_kind("NVIDIA H100 80GB HBM3") == "h100"
    assert prof.strict_device_kind("NVIDIA H100 PCIe") is None
    assert prof.strict_device_kind("NVIDIA A100-SXM4-80GB") is None
    for raw in ("tpu", None, "cpu"):
        assert prof.strict_device_kind(raw) == jax_prof.strict_device_kind(
            raw)
    with pytest.raises(prof.ProfileError, match="cannot key"):
        prof.profile_path("tpu", "serve", str(tmp_path))
    # a card the registry cannot name applies no profile
    monkeypatch.setattr(prof, "resolve_launch_device_kind", lambda: None)
    _verified(tmp_path)
    monkeypatch.setattr(prof, "PROFILE", str(tmp_path))
    assert prof.find_profiles() == []


def test_launch_device_kind_without_a_card(monkeypatch):
    assert prof.resolve_launch_device_kind() == "cpu"
    monkeypatch.setattr(launcher, "WORKER_DEVICE", None)
    # this box has no card: a gloo gang
    assert prof.resolve_launch_device_kind() == "cpu"


def test_preflight_settings_applies_and_never_raises(tmp_path, monkeypatch):
    _, path = _verified(tmp_path)
    monkeypatch.setattr(prof, "PROFILE", path)
    assert prof.preflight_settings() == {CHUNK: 8}
    (tmp_path / "cpu.json").write_text("{not json")
    assert prof.preflight_settings() == {}


def test_degraded_profile_applies_nothing(tmp_path, monkeypatch):
    doc = prof.make_profile({}, device_kind="cpu", bench="serve",
                            status=prof.STATUS_DEGRADED,
                            candidate_knobs={CHUNK: 8})
    path = prof.save_profile(doc, str(tmp_path / "cpu.json"))
    monkeypatch.setattr(prof, "PROFILE", path)
    assert prof.preflight_settings() == {}


# -- the launcher's side --------------------------------------------------------


def test_rank_settings_carry_the_profile_on_every_attempt(tmp_path,
                                                         monkeypatch):
    """What the supervised launch function ships on each attempt: the
    profile's settings, again on the relaunch, under the operator."""
    from sparkdl_tpu_torch.horovod.supervisor import (
        GangFailure,
        RetryPolicy,
        supervise,
    )

    _, path = _verified(tmp_path, {CHUNK: 8, LOSS: 1024})
    monkeypatch.setattr(prof, "PROFILE", path)
    monkeypatch.setattr(trial, "LOSS_CHUNK", 256)  # the operator's pin
    seen = []

    def launch(ctx):
        seen.append((ctx.attempt, _worker.rank_settings()))
        if len(seen) == 1:
            raise GangFailure("transient boom", kind="rendezvous_timeout")
        return "ok"

    policy = RetryPolicy(max_retries=2, backoff_base=0.0, backoff_max=0.0,
                         jitter=0.0)
    assert supervise(launch, policy, _sleep=lambda s: None) == "ok"
    assert [a for a, _ in seen] == [0, 1]
    for _, settings in seen:
        assert settings == {CHUNK: 8}
    monkeypatch.setattr(prof, "PROFILE", None)
    assert _worker.rank_settings() is None


def test_a_rank_applies_the_profile_for_its_run():
    assert trial.SERVE_DECODE_CHUNK == 16
    with _worker.applied_rank_settings({CHUNK: 8, "chaos.KILL_RANK": 3}):
        assert knobs.read(CHUNK) == 8
        from sparkdl_tpu_torch.utils import chaos

        assert chaos.KILL_RANK == 3
    assert trial.SERVE_DECODE_CHUNK == 16


def _profile_rank_main(record_dir):
    """Each rank writes the settings in force on each attempt; rank 1
    SIGKILLs itself on the first attempt."""
    import json
    import os
    import signal

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import restart_context
    from sparkdl_tpu_torch.utils import knobs

    hvd.init()
    ctx = restart_context()
    seen = {n: knobs.read(n) for n in (
        "sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK",
        "sparkdl_tpu_torch.perf.trial.LOSS_CHUNK")}
    with open(os.path.join(record_dir,
                           f"{ctx.attempt}-{hvd.rank()}.json"), "w") as f:
        json.dump(seen, f)
    hvd.barrier()
    if ctx.attempt == 0 and hvd.rank() == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    hvd.barrier()
    return ctx.attempt, seen


@pytest.mark.gang
def test_profile_reaches_gang_ranks_and_survives_a_relaunch(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(launcher, "WORKER_DEVICE", None)
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy(
        max_retries=1, backoff_base=0.2, backoff_max=0.2, jitter=0.0))
    prof.save_profile(
        prof.make_profile({CHUNK: 8, LOSS: 1024}, device_kind="cpu",
                          bench="serve", status=prof.STATUS_VERIFIED),
        prof.profile_path("cpu", "serve", str(tmp_path / "profiles")))
    monkeypatch.setattr(prof, "PROFILE", str(tmp_path / "profiles"))
    monkeypatch.setattr(trial, "LOSS_CHUNK", 256)  # the operator's pin
    record = tmp_path / "seen"
    record.mkdir()
    attempt, seen = HorovodRunner(np=-2).run(_profile_rank_main,
                                             record_dir=str(record))
    assert attempt == 1
    # the pinned setting is not shipped; the rank keeps its default
    want = {CHUNK: 8, LOSS: 512}
    assert seen == want
    files = sorted(os.listdir(record))
    assert files == ["0-0.json", "0-1.json", "1-0.json", "1-1.json"]
    for name in files:
        assert json.loads((record / name).read_text()) == want
