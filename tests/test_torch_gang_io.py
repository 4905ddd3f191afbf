"""The gang's I/O repairs of the port, in one process: a worker's tee'd
lines go through a drop-oldest ring on a connection of their own, so a
stalled or dead driver never blocks ``print``, and ``log_to_driver``,
RESULT and BYE still arrive; an unmodified ``import horovod.torch as
hvd`` main runs on the port through ``HorovodRunner(np=-1)`` and leaves
``sys.modules`` as it found it; the bound names cover the JAX shim's;
and the data helpers of a gang main against the JAX ones."""

import ast
import importlib
import importlib.abc
import json
import pathlib
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu.utils import data as jax_data
from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.compat import horovod_torch
from sparkdl_tpu_torch.horovod import control_plane as cp
from sparkdl_tpu_torch.horovod._worker import _TeeStream
from sparkdl_tpu_torch.utils import data as pt_data

REPO = pathlib.Path(__file__).resolve().parents[1]
_HEADER = struct.Struct(">IBI")


class _StalledDriver:
    """A driver end that accepts connections but reads nothing until
    ``resume`` is set (a tiny receive buffer, so the stall shows at
    once), then records every frame of every connection; ``close``
    kills it."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.address = f"127.0.0.1:{self.srv.getsockname()[1]}"
        self.resume = threading.Event()
        self.frames = []  # (connection number, type, payload)
        self.conns, self.readers = [], []
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            self.conns.append(conn)
            t = threading.Thread(target=self._read,
                                 args=(conn, len(self.conns) - 1),
                                 daemon=True)
            t.start()
            self.readers.append(t)

    def _read(self, conn, n):
        self.resume.wait()
        buf = b""
        while True:
            try:
                chunk = conn.recv(1 << 16)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= _HEADER.size:
                length, mtype, _rank = _HEADER.unpack(buf[:_HEADER.size])
                end = _HEADER.size + length - 5
                if len(buf) < end:
                    break
                with self._lock:
                    self.frames.append((n, mtype, buf[_HEADER.size:end]))
                buf = buf[end:]

    def of_type(self, mtype):
        with self._lock:
            return [p for _, t, p in self.frames if t == mtype]

    def close(self):
        self.srv.close()
        for c in self.conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()


def test_a_stalled_driver_never_blocks_print(tmp_path):
    """8 MB of print against a driver that reads nothing returns within
    2 s, dropping the oldest lines (and counting them); once the driver
    reads again, a log_to_driver line arrives, the LOG lines that were
    kept arrive in order with the newest last, and BYE carries the drop
    count."""
    driver = _StalledDriver()
    client = cp.ControlPlaneClient(driver.address, 0, "secret")
    local = open(tmp_path / "rank-0.log", "w")
    tee = _TeeStream("stdout", local, client)
    t0 = time.monotonic()
    for i in range(8000):
        print(f"{i:06d} " + "x" * 993, file=tee)
    elapsed = time.monotonic() - t0
    assert elapsed < 2.0, elapsed
    dropped = client.log_dropped
    assert dropped > 0
    driver.resume.set()
    client.send_user_log("after the stall")
    client.send_bye(0)  # flushes the ring first
    client.close()
    local.close()
    for t in driver.readers:
        t.join(10)
    assert [json.loads(p)["text"] for p in driver.of_type(cp.MSG_USERLOG)] \
        == ["after the stall"]
    lines = [int(json.loads(p)["text"][:6])
             for p in driver.of_type(cp.MSG_LOG)]
    assert lines == sorted(lines) and lines[-1] == 7999
    assert len(lines) + dropped == 8000
    bye = [json.loads(p) for p in driver.of_type(cp.MSG_BYE)]
    assert bye == [{"exit_code": 0, "log_dropped": dropped}]
    # the local log keeps every line
    assert (tmp_path / "rank-0.log").read_text().count("\n") == 8000
    driver.close()


def test_a_dead_driver_never_blocks_print():
    driver = _StalledDriver()
    client = cp.ControlPlaneClient(driver.address, 0, "secret")
    driver.resume.set()
    client.send_log("stdout", "before")
    assert client._logs.flush(5.0)
    driver.close()
    t0 = time.monotonic()
    for _ in range(2000):
        client.send_log("stdout", "y" * 1000)
    client.send_user_log("nobody reads this")
    client.send_bye(1)
    client.close()
    assert time.monotonic() - t0 < 2.0 + cp.LOG_FLUSH_S


def test_the_driver_logs_and_prints_a_ranks_drop_count(tmp_path, capsys):
    path = tmp_path / "job.log"
    server = cp.ControlPlaneServer(1, log_path=str(path))
    try:
        client = cp.ControlPlaneClient(server.address, 0, server.secret)
        client.send_log("stdout", "a line")
        client._logs.dropped = 3  # as a stalled driver would leave it
        client.send_bye(0)
        client.close()
        # the server accepts on a thread of its own: wait for the BYE
        deadline = time.monotonic() + 30
        while "BYE" not in path.read_text() and time.monotonic() < deadline:
            time.sleep(0.05)
        server.wait_drained()
    finally:
        server.close()
    log = path.read_text()
    assert "[rank 0 stdout] a line" in log
    assert "[rank 0 BYE] exit code 0, 3 log lines dropped" in log
    assert "[0] 3 stdout/stderr lines were dropped" in capsys.readouterr().out


def _torch_main_local():
    """tests/horovod/test_frameworks.py::_torch_main as a user writes
    it (``import horovod.torch as hvd``), at any size."""
    import numpy as np
    import torch

    import horovod.torch as hvd

    hvd.init()
    torch.manual_seed(1234 + hvd.rank())
    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    opt = hvd.DistributedOptimizer(opt)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    x = torch.full((8, 4), float(hvd.rank() + 1))
    loss = ((model(x) - torch.zeros(8, 1)) ** 2).mean()
    loss.backward()
    opt.step()
    flat = np.concatenate(
        [p.detach().numpy().ravel() for p in model.parameters()])
    gathered = hvd.allgather(flat[None, :])
    import horovod

    return {"size": hvd.size(), "params": flat.tolist(),
            "sync_diff": float(np.ptp(gathered, axis=0).max()),
            "module": hvd.__name__, "package": horovod.__version__}


def test_np_minus_one_runs_an_import_horovod_torch_main():
    """np=-1 binds horovod and horovod.torch to the port for the run
    only: the JAX shim imported before is back in sys.modules after."""
    import horovod.torch  # noqa: F401  (the JAX shim, loaded first)

    before = {k: v for k, v in sys.modules.items()
              if k == "horovod" or k.startswith("horovod.")}
    assert before["horovod.torch"].__name__ == "horovod.torch"
    got = HorovodRunner(np=-1).run(_torch_main_local)
    after = {k: v for k, v in sys.modules.items()
             if k == "horovod" or k.startswith("horovod.")}
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    assert horovod_torch._FINDER not in sys.meta_path
    assert got["module"] == "sparkdl_tpu_torch.compat.horovod_torch"
    assert got["size"] == 1 and got["sync_diff"] == 0.0
    assert got["package"] == "0.1.0"
    # one process, its own gradient: one SGD step of the rank-0 init
    torch.manual_seed(1234)
    model = torch.nn.Linear(4, 1)
    loss = (model(torch.full((8, 4), 1.0)) ** 2).mean()
    loss.backward()
    want = [(p - 0.1 * p.grad).detach().numpy().ravel()
            for p in model.parameters()]
    np.testing.assert_allclose(got["params"], np.concatenate(want),
                               rtol=1e-6)


class _HideFramework(importlib.abc.MetaPathFinder):
    """A meta-path stub for which ``package`` is not installed."""

    def __init__(self, package):
        self.package = package

    def find_spec(self, name, path=None, target=None):
        if name == self.package or name.startswith(self.package + "."):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None


def test_bound_names_refuse_other_frameworks_and_restore_on_error(
        monkeypatch):
    """The framework shims resolve to the port's modules; a shim whose
    framework is missing raises an ImportError that names it; and
    ``sys.modules`` is restored after the block, an error or not."""
    before = {k: v for k, v in sys.modules.items()
              if k.split(".")[0] in ("horovod", "sparkdl")}
    with pytest.raises(RuntimeError, match="boom"):
        with horovod_torch.bound():
            import horovod
            import horovod.torch as hvd

            assert hvd is horovod_torch and horovod.torch is horovod_torch
            for name, port in horovod_torch.LAZY.items():
                if port[1] == "keras":  # bound without importing keras
                    assert importlib.import_module(name).__name__ == port[0]
            # tensorflow hidden: the shims that need it say so by name
            for key in [k for k in sys.modules
                        if k.split(".")[0] == "tensorflow"]:
                monkeypatch.delitem(sys.modules, key)
            monkeypatch.setattr(sys, "meta_path",
                                [_HideFramework("tensorflow"), *sys.meta_path])
            # (a submodule's parent is imported first, and names itself)
            for name, shim in (
                    ("horovod.tensorflow", "horovod.tensorflow"),
                    ("horovod.tensorflow.keras", "horovod.tensorflow"),
                    ("sparkdl.horovod.tensorflow.keras",
                     "sparkdl.horovod.tensorflow.keras")):
                with pytest.raises(ImportError) as err:
                    importlib.import_module(name)
                assert str(err.value).startswith(
                    f"{shim} needs the tensorflow package, which is not "
                    "installed here"), str(err.value)
            with pytest.raises(ImportError,
                               match="use sparkdl_tpu_torch.HorovodRunner"):
                from sparkdl import HorovodRunner  # noqa: F401
            monkeypatch.undo()
            raise RuntimeError("boom")
    after = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] in ("horovod", "sparkdl")}
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before)
    assert sys.modules.get("horovod.torch") is not horovod_torch
    assert horovod_torch._FINDER not in sys.meta_path


def _names(path, what):
    tree = ast.parse((REPO / path).read_text())
    if what == "__all__":
        for node in tree.body:
            if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
                return set(ast.literal_eval(node.value))
    return {a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names}


def test_bound_names_cover_the_jax_shims():
    shim_all = _names("horovod/torch/__init__.py", "__all__")
    assert set(horovod_torch.__all__) == shim_all
    for name in shim_all:
        assert callable(getattr(horovod_torch, name)) or name in (
            "Average", "Sum", "Min", "Max"), name
    package = _names("horovod/__init__.py", "imports")
    assert set(horovod_torch.PACKAGE_NAMES) == package
    with horovod_torch.bound():
        import horovod

        for name in package:
            assert hasattr(horovod, name), name


def _leaves(tree):
    import jax

    return jax.tree.leaves(tree)


@pytest.mark.parametrize("rank,size,drop_last", [
    (0, 3, True), (2, 3, True), (1, 3, False), (2, 3, False), (0, 1, True)])
def test_shard_for_rank_matches_jax(rank, size, drop_last):
    rng = np.random.default_rng(rank + 10 * size)
    tree = {"x": rng.standard_normal((10, 3)),
            "y": [rng.integers(0, 9, (10,)), (rng.random((10, 2)),)]}
    want = jax_data.shard_for_rank(tree, rank, size, drop_last=drop_last)
    got = pt_data.shard_for_rank(tree, rank, size, drop_last=drop_last)
    assert type(got["y"][1]) is tuple
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    t = pt_data.shard_for_rank(torch.arange(10), rank, size,
                               drop_last=drop_last)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jax_data.shard_for_rank(
            np.arange(10), rank, size, drop_last=drop_last)))
    with pytest.raises(ValueError, match="outside"):
        pt_data.shard_for_rank(tree, size, size)
    with pytest.raises(ValueError, match="cannot shard"):
        pt_data.shard_for_rank({"x": np.zeros(2)}, 0, 3)


@pytest.mark.parametrize("shuffle,drop_last", [
    (False, True), (True, True), (True, False)])
def test_batched_matches_jax(shuffle, drop_last):
    rng = np.random.default_rng(4)
    tree = {"x": rng.standard_normal((11, 2)), "y": np.arange(11)}
    want = list(jax_data.batched(tree, 4, shuffle=shuffle, seed=3,
                                 drop_last=drop_last))
    got = list(pt_data.batched(tree, 4, shuffle=shuffle, seed=3,
                               drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        for a, b in zip(_leaves(g), _leaves(w)):
            np.testing.assert_array_equal(a, np.asarray(b))
    tensors = {"x": torch.arange(22).reshape(11, 2)}
    got_t = list(pt_data.batched(tensors, 4, shuffle=shuffle, seed=3,
                                 drop_last=drop_last))
    for g, w in zip(got_t, want):
        np.testing.assert_array_equal(g["x"].numpy(),
                                      np.arange(22).reshape(11, 2)[
                                          w["y"]])


def test_log_ring_keeps_the_newest_within_its_capacity():
    """The ring alone: with nothing draining it, it holds at most its
    capacity in bytes (the newest frames), and counts the rest."""
    driver = _StalledDriver()
    ring = cp.LogRing("127.0.0.1", int(driver.address.rsplit(":", 1)[1]),
                      b"", capacity=10_000)
    ring._closed = True  # stop the drain thread at its next look
    with ring._cond:
        ring._cond.notify_all()
    time.sleep(0.1)
    ring._closed = False
    for i in range(100):
        ring.send(bytes([i]) * 1000)
    assert ring._bytes <= 10_000 and ring.dropped == 90
    assert [f[0] for f in ring._frames] == list(range(90, 100))
    ring.close()
    driver.close()
