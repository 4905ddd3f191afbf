"""The port's hosts specs and remote workers: the topology helpers held
against the JAX package's on the same inputs, the remote command line
(no secret, every value shell-quoted), the refusals that come before
anything is spawned or claimed, and one gang of two ranks on two
``.invalid`` hosts through a fake remote shell, which records its argv,
drops the host and runs the rest here (``ssh``'s join-and-run semantics,
so the quoting, the standard-input boot stream and the routable
rendezvous all run for real without an sshd).
"""

import os
import shlex
import socket
import subprocess
import sys
import time

import cloudpickle
import pytest
import torch

from sparkdl_tpu.horovod import launcher as jax_launcher
from sparkdl_tpu.horovod import topology as jax_topology
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import control_plane, launcher, supervisor
from sparkdl_tpu_torch.horovod import topology
from tests.test_torch_slots import _claimed_in

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


@pytest.fixture(autouse=True)
def settings(monkeypatch, tmp_path):
    """Bounded gangs on the CPU, a slot registry of this test's own; the
    launcher's settings restored afterwards."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    for name in ("NUM_SLOTS", "HOSTS", "REMOTE_SHELL", "REMOTE_PYTHON"):
        monkeypatch.setattr(launcher, name, None)


@pytest.mark.parametrize("spec", [
    "h1:4,h2:4", "h1", " a:1 , b:2 ,", "host:3,host:1", "10.0.0.7:2",
])
def test_parse_hosts_as_in_jax(spec):
    assert topology.parse_hosts(spec) == jax_topology.parse_hosts(spec)


@pytest.mark.parametrize("spec", ["", ",", ":4", "h:x", "h:0", "h:-1",
                                  "a:1,:2"])
def test_malformed_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as ref:
        jax_topology.parse_hosts(spec)
    with pytest.raises(ValueError) as got:
        topology.parse_hosts(spec)
    assert str(got.value) == str(ref.value)


def _layout(p, n):
    return (p.hosts, p.total_slots,
            [(p.host(r), p.host_index(r), p.local_rank(r), p.local_size(r))
             for r in range(n)])


@pytest.mark.parametrize("hosts", [
    ["a", "a"], ["a", "b", "a", "b"], ["h0", "h1", "h1", "h0", "h2"],
    ["127.0.0.1"] * 3,
], ids=["one_host", "interleaved", "uneven", "loopback"])
def test_placement_from_task_hosts_as_in_jax(hosts):
    assert _layout(topology.placement_from_task_hosts(hosts), len(hosts)) \
        == _layout(jax_topology.placement_from_task_hosts(hosts), len(hosts))


def test_a_spec_placement_as_in_jax_and_its_first_ranks():
    spec = [("a", 2), ("b", 3)]
    assert _layout(topology.Placement(spec), 5) == _layout(
        jax_topology.Placement(spec), 5)
    assert topology.Placement(spec).first(3).hosts == [("a", 2), ("b", 1)]
    assert topology.Placement(spec).first(2).hosts == [("a", 2)]
    assert topology.Placement(spec).first(5).hosts == spec


@pytest.mark.parametrize("host", [
    "localhost", "127.0.0.1", "::1", socket.gethostname(),
    "no-such-host-deadbeef.invalid",
])
def test_is_local_host_as_in_jax(host):
    assert topology.is_local_host(host) == jax_topology.is_local_host(host)
    assert topology.is_local_host(host) == (not host.endswith(".invalid"))


@pytest.mark.parametrize("host", ["localhost", "127.0.0.1",
                                  "elsewhere.invalid", "10.1.2.3"])
def test_addressable_as_in_jax(host):
    assert topology._addressable(host) == jax_topology._addressable(host)


def test_routable_host_ip_as_in_jax():
    from sparkdl_tpu.horovod.control_plane import (
        routable_host_ip as jax_routable,
    )

    assert control_plane.routable_host_ip() == jax_routable()


def _until(predicate, timeout=10.0):
    """Poll ``predicate`` (the server's handler threads run on their
    own) until it holds or ``timeout`` passes; its last value."""
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.02)
    return predicate()


def test_a_control_plane_bound_beyond_loopback_advertises_a_routable_ip(
        tmp_path):
    log = tmp_path / "job.log"
    server = control_plane.ControlPlaneServer(1, log_path=str(log),
                                              bind_host="0.0.0.0")
    try:
        host, port = server.address.rsplit(":", 1)
        assert host == control_plane.routable_host_ip()
        c = control_plane.ControlPlaneClient(server.address, 0,
                                             server.secret)
        c.send_ready()
        c.close()
        assert _until(lambda: server.ready_count() == 1)
        # without the secret: dropped before any handler
        intruder = control_plane.ControlPlaneClient(server.address, 0,
                                                    "not the secret")
        intruder.send_user_log("let me in")
        intruder.close()
        _until(lambda: "unauthenticated connection" in log.read_text())
        text = log.read_text()
    finally:
        server.close()
    assert "unauthenticated connection" in text
    assert "let me in" not in text


SECRET = "5ec7e7" * 10


def _rank_env():
    """A worker's environment, on a driver whose own environment holds a
    secret and unrelated names: none of them may cross."""
    return launcher._worker_env(
        {"PYTHONPATH": "/site dir", "HOME": "/home/user", "UNRELATED": "x",
         control_plane.CONTROL_SECRET_ENV: SECRET},
        rank=1, size=2, placement=topology.Placement([("a", 1), ("b", 1)]),
        master_addr="10.0.0.1", master_port=29500,
        control_addr="10.0.0.1:4000")


def test_remote_command_carries_no_secret_and_only_the_gang_names():
    args = ["--job-dir", "/tmp/job", "--attempt", "0", "--device", "cuda"]
    cmd = launcher._remote_worker_cmd(["ssh", "-o", "BatchMode=yes"],
                                      "hostB", _rank_env(), "python3", args)
    assert cmd[:5] == ["ssh", "-o", "BatchMode=yes", "hostB", "env"]
    assert SECRET not in " ".join(cmd)
    assert not any(t.startswith(control_plane.CONTROL_SECRET_ENV)
                   for t in cmd)
    names = [t.split("=", 1)[0] for t in cmd[5:] if "=" in t]
    assert names == ["RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                     "MASTER_ADDR", "MASTER_PORT",
                     launcher.CONTROL_ADDR_ENV, "PYTHONPATH"]
    assert "RANK=1" in cmd and "LOCAL_RANK=0" in cmd
    assert "MASTER_ADDR=10.0.0.1" in cmd and "MASTER_PORT=29500" in cmd
    # the worker's arguments, the device among them
    assert cmd[-len(args) - 3:] == [
        "python3", "-m", "sparkdl_tpu_torch.horovod._worker", *args]


def test_remote_command_values_are_shell_quoted():
    nasty = "/tmp/a b;$(rm -rf ~)"
    env = dict(_rank_env(), PYTHONPATH=nasty)
    cmd = launcher._remote_worker_cmd([], "h", env, "/usr/local/my python",
                                      ["--job-dir", nasty])
    joined = " ".join(cmd)
    # single quotes, where $(...) does not expand
    assert f"PYTHONPATH={shlex.quote(nasty)}" in cmd
    assert "'/usr/local/my python'" in joined
    # what the remote shell parses is the tokens themselves
    assert shlex.split(" ".join(cmd[2:]))[-2:] == ["--job-dir", nasty]


@pytest.mark.parametrize("setting,want", [
    ("none", None), ("  NONE ", None), ([], None),
    ("ssh -F /x/cfg", ["ssh", "-F", "/x/cfg"]),
    (["/bin/fake", "-p", 22], ["/bin/fake", "-p", "22"]),
])
def test_resolve_remote_shell(monkeypatch, setting, want):
    monkeypatch.setattr(launcher, "REMOTE_SHELL", setting)
    if want is None:
        with pytest.raises(launcher.RemoteTransportError):
            launcher._resolve_remote_shell()
    else:
        assert launcher._resolve_remote_shell() == want


def _gang_main():
    import os

    import torch

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod.control_plane import CONTROL_SECRET_ENV
    from sparkdl_tpu_torch.hvd import _state

    hvd.init()
    total = hvd.allreduce(torch.ones(2), op=hvd.Sum)
    with open("/proc/self/environ", "rb") as f:
        started_with = f.read()  # the environment the rank started with
    return {"size": hvd.size(), "sum": total.tolist(),
            "backend": _state.state().backend,
            "master": _state.state().master[0],
            "secret_at_exec": CONTROL_SECRET_ENV.encode() in started_with,
            "secret_in_env": CONTROL_SECRET_ENV in os.environ}


def test_a_multi_host_spec_is_refused_without_a_transport(monkeypatch):
    """No quiet local launch: remote hosts without a transport raise,
    naming the hosts, before any slot claim or spawn, as in JAX."""
    from sparkdl import HorovodRunner as JaxHorovodRunner

    monkeypatch.setenv("SPARKDL_TPU_HOSTS", "otherhost-deadbeef.invalid:2")
    monkeypatch.setenv("SPARKDL_TPU_REMOTE_SHELL", "none")
    monkeypatch.setenv("SPARKDL_TPU_NUM_SLOTS", "2")
    with pytest.raises(jax_launcher.RemoteTransportError,
                       match="otherhost-deadbeef"):
        JaxHorovodRunner(np=2).run(_gang_main)

    def nothing(*a, **k):
        raise AssertionError("claimed or spawned")

    monkeypatch.setattr(subprocess, "Popen", nothing)
    monkeypatch.setattr(launcher, "claim_slots", nothing)
    monkeypatch.setattr(launcher, "HOSTS", "otherhost-deadbeef.invalid:2")
    monkeypatch.setattr(launcher, "REMOTE_SHELL", "none")
    monkeypatch.setattr(supervisor, "policy",
                        supervisor.RetryPolicy(max_retries=2))
    with pytest.raises(launcher.RemoteTransportError,
                       match="otherhost-deadbeef") as exc:
        HorovodRunner(np=2).run(_gang_main)
    assert supervisor.classify_failure(exc.value)[0] == supervisor.PERMANENT


def test_a_spec_filled_by_local_hosts_needs_no_transport(monkeypatch):
    """Hosts fill in order: np=2 on 'localhost:2,remote:2' lands every
    rank here, with no transport and the control plane on loopback."""
    seen = _claimed_in(monkeypatch)
    monkeypatch.setattr(launcher, "HOSTS", [("localhost", 2),
                                            ("other.invalid", 2)])
    monkeypatch.setattr(launcher, "REMOTE_SHELL", "none")
    HorovodRunner(np=2).run(_gang_main)
    assert seen == [{"n": 2, "mode": "cluster", "busy": 2,
                     "hosts": [("localhost", 2)], "remote": [],
                     "shell": None}]


def test_a_mixed_spec_claims_only_this_hosts_ranks(monkeypatch):
    seen = _claimed_in(monkeypatch)
    monkeypatch.setattr(launcher, "HOSTS", "localhost:2,other.invalid:2")
    monkeypatch.setattr(launcher, "REMOTE_SHELL", ["/bin/fake-ssh"])
    HorovodRunner(np=3).run(_gang_main)
    assert seen == [{"n": 3, "mode": "cluster", "busy": 2,
                     "hosts": [("localhost", 2), ("other.invalid", 1)],
                     "remote": ["other.invalid"],
                     "shell": ["/bin/fake-ssh"]}]


@pytest.mark.gang
def test_a_gang_on_two_remote_hosts_through_a_fake_shell(monkeypatch,
                                                         tmp_path):
    """Two ranks on two '.invalid' hosts: both are started through the
    shell, read the secret and the payload from standard input (the
    recorded argv holds neither), and rendezvous at this host's routable
    address."""
    argv_log = tmp_path / "argv.log"
    fake = tmp_path / "fakessh"
    fake.write_text("#!/bin/sh\n"
                    f"printf '%s\\n' \"$*\" >> {argv_log}\n"
                    "shift\n"
                    "exec sh -c \"$*\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(control_plane._secrets, "token_hex",
                        lambda n: SECRET)
    monkeypatch.setattr(launcher, "HOSTS", "fakeremote-a.invalid:1,"
                                           "fakeremote-b.invalid:1")
    monkeypatch.setattr(launcher, "REMOTE_SHELL", str(fake))
    monkeypatch.setattr(launcher, "REMOTE_PYTHON", sys.executable)
    got = HorovodRunner(np=2).run(_gang_main)
    assert got == {"size": 2, "sum": [2.0, 2.0], "backend": "gloo",
                   "master": control_plane.routable_host_ip(),
                   "secret_at_exec": False, "secret_in_env": True}
    lines = argv_log.read_text().splitlines()
    assert sorted(line.split()[0] for line in lines) == [
        "fakeremote-a.invalid", "fakeremote-b.invalid"]
    for line in lines:
        assert SECRET not in line
        assert control_plane.CONTROL_SECRET_ENV not in line
        assert "payload" not in line
        assert "--device cpu" in line
