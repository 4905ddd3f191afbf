"""The port's HorovodRunner contract in one process (nothing spawned):
the runner's signatures and argument checks, local mode, the hvd
collectives at size 1 against the JAX package's under its own
``local_mode()``, the object collectives' size codec, ``log_to_driver``,
the control plane's frames, ``DistributedOptimizer``'s refusals and
``shard_batch``."""

import inspect
import socket
import subprocess
import time

import numpy as np
import pytest
import torch

import sparkdl_tpu.hvd as jax_hvd
from sparkdl_tpu import HorovodRunner as JaxRunner
from sparkdl_tpu.horovod import log_to_driver as jax_log_to_driver
from sparkdl_tpu.hvd import _state as jax_state
from sparkdl_tpu_torch import HorovodRunner, hvd
from sparkdl_tpu_torch.horovod import control_plane as cp
from sparkdl_tpu_torch.horovod import launcher, log_to_driver
from sparkdl_tpu_torch.hvd import _state
from sparkdl_tpu_torch.parallel.train import shard_batch

torch.set_num_threads(2)


@pytest.mark.parametrize("get", [
    lambda m: m.__init__, lambda m: m.run],
    ids=["__init__", "run"])
def test_runner_signature_equals_jax(get):
    assert inspect.getfullargspec(get(HorovodRunner)) == \
        inspect.getfullargspec(get(JaxRunner))


def test_log_to_driver_signature_equals_jax():
    assert inspect.getfullargspec(log_to_driver) == \
        inspect.getfullargspec(jax_log_to_driver)


@pytest.mark.parametrize("make,exc", [
    (lambda cls: cls(2), TypeError),
    (lambda cls: cls(np="4"), TypeError),
    (lambda cls: cls(np=True), TypeError),
    (lambda cls: cls(np=-1, driver_log_verbosity="loud"), ValueError),
], ids=["positional", "str", "bool", "verbosity"])
def test_runner_argument_errors_match_jax(make, exc):
    with pytest.raises(exc) as ours:
        make(HorovodRunner)
    with pytest.raises(exc) as ref:
        make(JaxRunner)
    assert str(ours.value) == str(ref.value)


def test_local_mode_runs_main_in_process(caplog):
    seen = []

    def main(value):
        hvd.init()
        seen.append((value, hvd.rank(), hvd.size(), hvd.local_size()))
        return {"value": value}

    with caplog.at_level("WARNING", logger="HorovodRunner"):
        out = HorovodRunner(np=-1).run(main, value=7)
    assert out == {"value": 7} and seen == [(7, 0, 1, 1)]
    assert "local mode (np=-1)" in caplog.text
    # the state is left as it was found
    assert not _state.state().initialized


def _seeded():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((6, 3)).astype(np.float32),
        "i32": rng.integers(-50, 50, (6, 3)).astype(np.int32),
        "bool": rng.random((6, 3)) > 0.5,
    }


def _surface(h, x):
    """Every size-1 collective of an hvd module on one input."""
    return {
        "allreduce": h.allreduce(x),
        "sum": h.allreduce(x, op=h.Sum),
        "min": h.allreduce(x, op=h.Min),
        "max": h.allreduce(x, op=h.Max),
        "average_false": h.allreduce(x, average=False),
        "allgather": h.allgather(x),
        "broadcast": h.broadcast(x, 0),
        "alltoall": h.alltoall(x),
        "alltoall_splits": h.alltoall(x, splits=[x.shape[0]]),
        "reducescatter": h.reducescatter(x),
        "grouped": h.grouped_allreduce([x, x[:2]])[1],
    }


@pytest.mark.parametrize("kind", ["f32", "i32", "bool"])
def test_size_one_collectives_match_jax_local_mode(kind):
    x = _seeded()[kind]
    with jax_state.local_mode():
        jax_hvd.init()
        ref = _surface(jax_hvd, x)
        ref_ids = (jax_hvd.rank(), jax_hvd.size(), jax_hvd.local_rank(),
                   jax_hvd.local_size(), jax_hvd.cross_rank(),
                   jax_hvd.cross_size())
        ref_obj = (jax_hvd.broadcast_object({"a": [1, 2]}),
                   jax_hvd.allgather_object(("x", 3)))
    with _state.local_mode():
        hvd.init()
        ours = _surface(hvd, x)
        ours_t = _surface(hvd, torch.from_numpy(x))
        ids = (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
               hvd.cross_rank(), hvd.cross_size())
        obj = (hvd.broadcast_object({"a": [1, 2]}),
               hvd.allgather_object(("x", 3)))
        assert hvd.check_synchronized({"x": torch.from_numpy(x)})
        hvd.barrier()
    assert ids == ref_ids == (0, 1, 0, 1, 0, 1)
    assert obj == ref_obj
    for name, want in ref.items():
        assert isinstance(ours[name], np.ndarray), name
        assert ours[name].dtype == want.dtype, name
        np.testing.assert_array_equal(ours[name], want, err_msg=name)
        # a torch tensor in gives a torch tensor of its dtype back
        assert isinstance(ours_t[name], torch.Tensor), name
        assert ours_t[name].dtype == torch.from_numpy(want).dtype, name
        np.testing.assert_array_equal(ours_t[name].numpy(), want,
                                      err_msg=name)


def test_async_allreduce_and_compression_at_size_one():
    x = _seeded()["f32"]
    with _state.local_mode():
        hvd.init()
        handle = hvd.allreduce_async(torch.from_numpy(x))
        assert handle.done()
        np.testing.assert_array_equal(handle.result().numpy(), x)
        half, ctx = hvd.Compression.fp16.compress(torch.from_numpy(x))
    ref_half, ref_ctx = jax_hvd.Compression.fp16.compress(x)
    np.testing.assert_array_equal(half.numpy(), ref_half)
    back = hvd.Compression.fp16.decompress(half, ctx)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(
        back.numpy(), jax_hvd.Compression.fp16.decompress(ref_half, ref_ctx))


def test_collectives_need_init():
    with _state.local_mode():
        with pytest.raises(ValueError, match="hvd.init"):
            hvd.allreduce(np.ones(2))


@pytest.mark.parametrize("n", [0, 2**24 + 1, 2**31 + 5])
def test_size_limbs_equal_the_jax_codec(n):
    ours = hvd._size_to_limbs(n)
    ref = jax_hvd._size_to_limbs(n)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert hvd._size_from_limbs(ours) == jax_hvd._size_from_limbs(ref) == n


def test_log_to_driver_truncates_as_jax(capsys):
    for message in ("short", "x" * 4100, 12345):
        log_to_driver(message)
        ours = capsys.readouterr().out
        jax_log_to_driver(message)
        assert ours == capsys.readouterr().out
    log_to_driver("y" * 5000)
    assert capsys.readouterr().out == "y" * 4000 + "\n"


def test_np_above_the_card_count_raises_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    for np_arg in (1, 4, 0):
        with pytest.raises(RuntimeError, match="one worker a CUDA card"):
            HorovodRunner(np=np_arg).run(lambda: 1)


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert _state.backend_for(1, 2) == ("cpu:gloo,cuda:nccl",
                                        torch.device("cuda", 1))
    # three ranks on two cards: gloo, the cards shared round robin
    assert _state.backend_for(2, 3) == ("gloo", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _state.backend_for(0, 2) == ("gloo", torch.device("cpu"))


def test_worker_env_carries_the_torch_distributed_names():
    from sparkdl_tpu_torch.horovod.topology import Placement

    env = launcher._worker_env(
        {"PYTHONPATH": "elsewhere"}, rank=2, size=3,
        placement=Placement.single_host(3), master_addr="127.0.0.1",
        master_port=1234, control_addr="127.0.0.1:5")
    assert {k: env[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                                "MASTER_PORT")} == {
        "RANK": "2", "WORLD_SIZE": "3", "LOCAL_RANK": "2",
        "LOCAL_WORLD_SIZE": "3", "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": "1234"}
    assert env["PYTHONPATH"].endswith("elsewhere")
    assert not any(k.startswith("SPARKDL_TPU_") for k in env)


def _wait(predicate, timeout=10.0):
    for _ in range(int(timeout / 0.02)):
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_control_plane_frames(capfd, tmp_path):
    """READY, a log_to_driver line, an oversized log line (cut by the
    sender, the connection kept), EXC, a RESULT larger than one frame,
    BYE; an unauthenticated peer is dropped before any handler."""
    server = cp.ControlPlaneServer(2, verbosity="all",
                                   log_path=str(tmp_path / "job.log"))
    try:
        host, port = server.address.rsplit(":", 1)
        intruder = socket.create_connection((host, int(port)))
        intruder.sendall(cp._HEADER.pack(5, cp.MSG_READY, 0))
        c0 = cp.ControlPlaneClient(server.address, 0, server.secret)
        c1 = cp.ControlPlaneClient(server.address, 1, server.secret)
        c1.send_ready()
        c1.send_log("stdout", "A" * 200_000)
        c1.send_exception("Traceback: boom")
        c1.send_result(b"not rank 0")
        c0.send_ready()
        c0.send_user_log("hello driver")
        blob = bytes(range(256)) * ((cp.RESULT_CHUNK // 256) + 3)
        c0.send_result(blob)
        assert _wait(lambda: server.ready_count() == 2)
        for c in (c0, c1):
            c.send_bye(0)
            c.close()
        intruder.close()
        assert _wait(lambda: server.result_bytes is not None)
        server.wait_drained(5)
        assert server.result_bytes == blob
        assert server.exceptions == {1: "Traceback: boom"}
        out = capfd.readouterr().out
        assert "hello driver\n" in out
        assert "[1] " + "A" * cp.MAX_LOG_TEXT + "\n" in out
        assert "A" * (cp.MAX_LOG_TEXT + 1) not in out
    finally:
        server.close()
    log = (tmp_path / "job.log").read_text()
    assert "unauthenticated" in log or "pre-auth" in log
    assert "ignoring RESULT from rank 1" in log


def test_distributed_optimizer_refusals_and_class():
    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(NotImplementedError, match="backward_passes"):
        hvd.DistributedOptimizer(opt, backward_passes_per_step=2)
    with pytest.raises(NotImplementedError, match="sparse_as_dense"):
        hvd.DistributedOptimizer(opt, sparse_as_dense=True)
    with pytest.raises(ValueError, match="named_parameters"):
        hvd.DistributedOptimizer(
            opt, named_parameters=[("w", model.weight)])
    wrapped = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    assert isinstance(wrapped, torch.optim.SGD)
    assert type(wrapped).__name__ == "DistributedSGD"
    ref = torch.nn.Linear(3, 1)
    ref.load_state_dict(model.state_dict())
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    with _state.local_mode():
        hvd.init()
        for m, o in ((model, wrapped), (ref, ref_opt)):
            m(x).pow(2).mean().backward()
            o.step()
    for p, q in zip(model.parameters(), ref.parameters()):
        assert torch.equal(p, q)


def test_shard_batch():
    batch = {"inputs": np.arange(12).reshape(6, 2),
             "targets": np.arange(12).reshape(6, 2) + 100}
    parts = [shard_batch(batch, rank=r, size=3) for r in range(3)]
    for k in batch:
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), batch[k])
    np.testing.assert_array_equal(parts[1]["inputs"], [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch(batch, rank=0, size=4)
    with pytest.raises(ValueError, match="outside"):
        shard_batch(batch, rank=3, size=3)
    with _state.local_mode():
        hvd.init()
        whole = shard_batch(batch)
    np.testing.assert_array_equal(whole["inputs"], batch["inputs"])
