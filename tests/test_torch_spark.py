"""The port's HorovodRunner on Spark: the barrier backend's decisions
against a faked pyspark (beside the JAX backend's on the same fakes), the
barrier task run twice in one process (a Python worker that Spark
reuses), and barrier gangs through the minispark double
(``tests/minispark``: real executor processes, a real barrier), whose
data-parallel LoRA steps are held against the JAX package's
``make_train_step`` on the whole batch.

Every fixture restores ``sys.modules`` (``pyspark*``, both backends),
``sys.path`` and the launcher's settings, so neither the fakes nor the
double reach a later file of the same worker.
"""

import importlib
import os
import sys
import types

import cloudpickle
import numpy as np
import pytest
import torch

from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import RestartContext, launcher, supervisor
from sparkdl_tpu_torch.horovod.control_plane import ControlPlaneServer
from sparkdl_tpu_torch.parallel.train import global_batch
from tests.test_torch_gang import (  # noqa: F401  (lora_tree: a fixture)
    ROWS,
    SEQ,
    VOCAB,
    _lora_main,
    jax_lora_reference,
    lora_tree,
)

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM = os.path.join(REPO, "tests", "minispark", "shim")
BACKENDS = ("sparkdl_tpu_torch.horovod.spark_backend",
            "sparkdl_tpu.horovod.spark_backend")


def _backend():
    """The port's backend as ``sys.modules`` has it now (the package's
    attribute may name one imported against another pyspark)."""
    return importlib.import_module(BACKENDS[0])


def _drop_spark_modules():
    for mod in list(sys.modules):
        if mod == "pyspark" or mod.startswith("pyspark.") or mod in BACKENDS:
            del sys.modules[mod]


@pytest.fixture(autouse=True)
def settings(monkeypatch, tmp_path):
    """Bounded gangs on the CPU, a slot registry of this test's own; the
    launcher's settings and ``sys.modules`` restored afterwards."""
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(launcher, "NUM_SLOTS", None)
    monkeypatch.setattr(launcher, "HOSTS", None)
    saved = {m: sys.modules[m] for m in list(sys.modules)
             if m == "pyspark" or m.startswith("pyspark.") or m in BACKENDS}
    yield
    _drop_spark_modules()
    sys.modules.update(saved)


class _FakeSession:
    _active = None

    def __init__(self, slots, on_parallelize=None):
        def parallelize(data, n):
            raise AssertionError("a Spark job was started")

        self.sparkContext = types.SimpleNamespace(
            defaultParallelism=slots,
            parallelize=on_parallelize or parallelize)

    @classmethod
    def getActiveSession(cls):
        return cls._active


@pytest.fixture
def fake_pyspark(monkeypatch):
    """Minimal pyspark modules (``tests/horovod/test_spark_backend.py``'s
    fake) that both backends import."""
    _FakeSession._active = None
    pyspark = types.ModuleType("pyspark")
    sql = types.ModuleType("pyspark.sql")

    class FakeBarrierTaskContext:
        current = None

        @classmethod
        def get(cls):
            if cls.current is None:
                raise RuntimeError("not in a barrier task")
            return cls.current

    sql.SparkSession = _FakeSession
    pyspark.BarrierTaskContext = FakeBarrierTaskContext
    pyspark.sql = sql
    _drop_spark_modules()
    monkeypatch.setitem(sys.modules, "pyspark", pyspark)
    monkeypatch.setitem(sys.modules, "pyspark.sql", sql)
    yield _FakeSession
    _FakeSession._active = None


def _no_local_gang(monkeypatch):
    """Record the local gangs the launcher would start instead of
    starting them."""
    calls = []

    def run_gang(num_workers, mode, *a, **k):
        calls.append((num_workers, mode))
        return "local gang"

    monkeypatch.setattr(launcher, "_run_gang", run_gang)
    return calls


def test_no_active_session_returns_none_as_in_jax(fake_pyspark):
    from sparkdl_tpu.horovod.spark_backend import (
        maybe_launch_on_spark as jax_launch,
    )
    assert jax_launch(2, lambda: None, {}, "all") is None
    assert _backend().maybe_launch_on_spark(2, b"", "all", RestartContext(0, None),
                                 "cpu") is None


def test_slot_check_fails_fast_as_in_jax(fake_pyspark):
    from sparkdl_tpu.horovod.spark_backend import (
        maybe_launch_on_spark as jax_launch,
    )
    fake_pyspark._active = _FakeSession(2)
    with pytest.raises(RuntimeError, match="failing fast"):
        jax_launch(8, lambda: None, {}, "all")
    with pytest.raises(launcher.SlotExhaustionError, match="failing fast"):
        _backend().maybe_launch_on_spark(8, b"", "all", RestartContext(0, None), "cpu")


def test_no_session_means_a_local_launch(fake_pyspark, monkeypatch):
    monkeypatch.setattr(launcher, "NUM_SLOTS", 2)
    calls = _no_local_gang(monkeypatch)
    assert HorovodRunner(np=2).run(lambda: 1) == "local gang"
    assert calls == [(2, "cluster")]


def test_no_pyspark_means_a_local_launch(monkeypatch):
    """As the JAX launcher falls back without pyspark
    (``test_launcher_falls_back_without_pyspark``)."""
    from sparkdl_tpu.horovod import launcher as jax_launcher

    _drop_spark_modules()
    monkeypatch.setitem(sys.modules, "pyspark", None)  # import fails
    assert jax_launcher._resolve_num_workers(-2) == (2, "local", None)
    assert launcher._resolve_num_workers(-2) == (2, "local", None)
    monkeypatch.setattr(launcher, "NUM_SLOTS", 1)
    calls = _no_local_gang(monkeypatch)
    assert HorovodRunner(np=1).run(lambda: 1) == "local gang"
    assert HorovodRunner(np=-2).run(lambda: 1) == "local gang"
    assert calls == [(1, "cluster"), (2, "local")]


def test_spark_comes_before_counting_this_hosts_cards(fake_pyspark,
                                                      monkeypatch):
    """A driver without a card in front of a cluster: np=2 and np=0 go to
    the barrier job (np=0 as the cluster's parallelism) with the card
    decision, and the np beyond the cluster fails fast, all under the
    supervisor, which relaunches nothing permanent."""
    spark_backend = _backend()
    monkeypatch.setattr(launcher, "WORKER_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(supervisor, "policy",
                        supervisor.RetryPolicy(max_retries=2))
    jobs = []

    def run_job(sc, n, payload, verbosity, restart, device, telemetry):
        assert telemetry is None  # the switch is off
        jobs.append((n, verbosity, restart, device))
        main, kwargs = cloudpickle.loads(payload)
        return spark_backend.SparkGangResult(main(**kwargs))

    monkeypatch.setattr(spark_backend, "_run_barrier_job", run_job)
    fake_pyspark._active = _FakeSession(3)
    assert HorovodRunner(np=2).run(lambda x: x + 1, x=1) == 2
    assert HorovodRunner(np=0, driver_log_verbosity="all").run(
        lambda: "all") == "all"
    first = RestartContext(0, None)
    assert jobs == [(2, "log_callback_only", first, "cuda"),
                    (3, "all", first, "cuda")]
    with pytest.raises(launcher.SlotExhaustionError, match="failing fast"):
        HorovodRunner(np=4).run(lambda: None)
    assert len(jobs) == 2


def _job_main(job):
    """A barrier task's main: what this rank joined, and a line for this
    job's driver."""
    import torch
    import torch.distributed as dist

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import log_to_driver, restart_context
    from sparkdl_tpu_torch.hvd import _state

    hvd.init()
    log_to_driver(f"barrier job {job} rank {hvd.rank()}")
    total = hvd.allreduce(torch.full((2,), float(job)), op=hvd.Sum)
    return {"rank": hvd.rank(), "size": hvd.size(),
            "world": dist.get_world_size(), "master": _state.state().master,
            "backend": _state.state().backend, "sum": total.tolist(),
            "context": restart_context()}


def test_a_reused_python_worker_joins_each_jobs_own_group(fake_pyspark,
                                                         tmp_path):
    """Spark reuses a Python worker across jobs: the same process runs
    one barrier task of job 1, then one of job 2. Each joins its own
    job's group (its store) and reports to its own job's driver; between
    them the process holds no group, no restart context, no client and
    no ``horovod`` binding: its ``horovod`` modules are the ones it held
    before (none, unless an earlier test of this process imported the
    JAX package's ``horovod``)."""
    import torch.distributed as dist

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.horovod import control_plane, restart_context

    def horovod_modules():
        return {k: m for k, m in sys.modules.items()
                if k == "horovod" or k.startswith("horovod.")}

    held = horovod_modules()
    task = types.SimpleNamespace(
        partitionId=lambda: 0, barrier=lambda: None,
        getTaskInfos=lambda: [types.SimpleNamespace(address="127.0.0.1:0")])
    sys.modules["pyspark"].BarrierTaskContext.current = task
    stdout = sys.stdout
    for job in (1, 2):
        log = tmp_path / f"job{job}.log"
        server = ControlPlaneServer(1, log_path=str(log))
        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              wait_for_workers=False)
        try:
            run = _backend()._barrier_main(
                cloudpickle.dumps((_job_main, {"job": job})),
                server.address, server.secret, "127.0.0.1", store.port,
                "cpu", RestartContext(job, 7 * job))
            [pickled] = run(iter([0]))
            assert server.wait_drained(5.0)
        finally:
            server.close()
        got = cloudpickle.loads(pickled)
        assert got == {"rank": 0, "size": 1, "world": 1,
                       "master": ("127.0.0.1", store.port),
                       "backend": "gloo", "sum": [float(job)] * 2,
                       "context": (job, 7 * job, None, None)}
        assert f"barrier job {job} rank 0" in log.read_text()
        assert not dist.is_initialized() and not hvd.is_initialized()
        assert restart_context() == (0, None, None, None)
        assert control_plane.get_worker_client() is None
        assert horovod_modules() == held and sys.stdout is stdout
        del store


def test_a_card_task_without_its_card_raises(fake_pyspark, tmp_path):
    """No fallback to the CPU: a barrier task told "cuda" on a host with
    no card raises (its traceback reaches the driver), and leaves no
    group behind."""
    import torch.distributed as dist

    task = types.SimpleNamespace(
        partitionId=lambda: 0, barrier=lambda: None,
        getTaskInfos=lambda: [types.SimpleNamespace(address="127.0.0.1:0")])
    sys.modules["pyspark"].BarrierTaskContext.current = task
    server = ControlPlaneServer(1, log_path=str(tmp_path / "job.log"))
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    try:
        run = _backend()._barrier_main(
            cloudpickle.dumps((_job_main, {"job": 1})), server.address,
            server.secret, "127.0.0.1", store.port, "cuda",
            RestartContext(0, None))
        with pytest.raises(RuntimeError, match="CUDA device"):
            run(iter([0]))
        assert server.wait_drained(5.0)
        excs = server.exceptions
    finally:
        server.close()
        del store
    assert "no such rank moves to the CPU" in excs[0]
    assert not dist.is_initialized()


def test_the_version_is_the_jax_packages():
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.version import __version__ as jax_version
    from sparkdl_tpu_torch.compat import horovod_torch
    from sparkdl_tpu_torch.version import __version__

    assert __version__ == jax_version == sparkdl_tpu.__version__
    assert sparkdl_tpu_torch.__version__ == horovod_torch.__version__ \
        == __version__


# -- barrier gangs through the minispark double -----------------------------


@pytest.fixture
def minispark(monkeypatch):
    """The double as ``pyspark`` with an active session of 2 slots; its
    executors import the port from this checkout."""
    _drop_spark_modules()
    monkeypatch.syspath_prepend(SHIM)
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       REPO if not path else REPO + os.pathsep + path)
    from pyspark.sql import SparkSession

    session = SparkSession._activate(n_slots=2)
    yield session
    SparkSession._deactivate()


def test_np_beyond_the_session_fails_before_any_task(minispark,
                                                      monkeypatch):
    import subprocess

    def no_spawn(*a, **k):
        raise AssertionError("an executor was started")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    with pytest.raises(launcher.SlotExhaustionError, match="only 2 task"):
        HorovodRunner(np=3).run(lambda: None)


@pytest.mark.gang
def test_barrier_gang_lora_step_matches_the_jax_step(minispark, lora_tree,
                                                     capfd):
    """``tests/test_torch_gang.py``'s data-parallel LoRA step, each rank
    a barrier task: the ranks' mean loss against the JAX step's on the
    whole batch, rank 0's adapters against its trained tree."""
    from sparkdl_tpu_torch.models.from_jax import flatten_jax_tree

    batch = global_batch(np.random.default_rng(2), VOCAB, ROWS, SEQ)
    ref_losses, ref = jax_lora_reference(lora_tree, batch)
    got = HorovodRunner(np=2, driver_log_verbosity="all").run(
        _lora_main, tree=flatten_jax_tree(lora_tree), batch=batch,
        steps=len(ref_losses))
    assert got["rows"] == [ROWS // 2, ROWS // 2]
    np.testing.assert_allclose(np.mean(got["losses"], axis=0), ref_losses,
                               rtol=1e-5)
    assert len(got["params"]) == 8
    for name, value in got["params"].items():
        # relative, with a floor of a few fp32 ulps for entries near 0
        np.testing.assert_allclose(value, ref[name], rtol=1e-4, atol=1e-7,
                                   err_msg=name)
    # "all": the executors' hvd log lines, rank-tagged, on this stdout
    out = capfd.readouterr().out
    assert "[0] " in out and "[1] " in out


def _failing_barrier_main():
    from sparkdl_tpu_torch import hvd

    hvd.init()
    if hvd.rank() == 1:
        raise ValueError("boom on barrier rank 1")
    return "rank 0 done"


@pytest.mark.gang
def test_a_barrier_ranks_exception_surfaces_rank_tagged(minispark):
    with pytest.raises(supervisor.GangFailure) as exc:
        HorovodRunner(np=2).run(_failing_barrier_main)
    text = str(exc.value)
    assert "--- rank 1 ---" in text
    assert "ValueError: boom on barrier rank 1" in text
    assert "_failing_barrier_main" in text  # the rank's own traceback
    assert "Merged job log: " in text and "job.log" in text
    assert exc.value.kind == "worker_death"
    assert supervisor.classify_failure(exc.value)[0] == supervisor.PERMANENT
