"""Spark barrier-mode backend of ``HorovodRunner(np >= 0)``.

Counterpart of ``sparkdl_tpu/horovod/spark_backend.py`` up to
``maybe_launch_on_spark``. It runs the reference's documented behavior
(``runner_base.py:54-61``): the gang is "the 2nd spark job started by
HorovodRunner", launched with barrier scheduling so that all ``np``
tasks start together, one task a slot, failing fast when ``np`` exceeds
the cluster's slots (busy slots are Spark's scheduler's to wait for: a
barrier job that fits the cluster queues until they drain). Each task
runs the same rank bootstrap as a local worker
(:func:`sparkdl_tpu_torch.horovod._worker.run_rank`).

The rendezvous stays the driver's: the driver opens the job's
``TCPStore`` (it listens on every interface) and its control plane on
all interfaces, and ships their routable addresses, the control plane's
secret, the device, the restart context and, with telemetry on, the
driver's telemetry settings to the tasks in the job's closure (their
flushes reach the launch's GangTelemetry through the control plane; a
task keeps no flight recorder, as in the JAX package). Each task sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` (local values by
:func:`~sparkdl_tpu_torch.horovod.topology.placement_from_task_hosts`
over the barrier's task infos), ``MASTER_ADDR``, ``MASTER_PORT`` and the
control plane's address and secret, by assignment: Spark reuses its
Python workers across jobs (``spark.python.worker.reuse``), so a value
kept from a previous job would be that job's; they are put back as they
were when the task ends. Then it waits at the barrier and runs the
bootstrap, which leaves the job's process group at its end; rank 0's
cloudpickled result comes back through ``collect()``. A rank of a card
gang binds ``cuda:LOCAL_RANK`` and raises without it
(``launcher.WORKER_DEVICE = "cpu"`` runs the tasks on the CPU): Spark's
GPU resource addresses are not read.

This module imports pyspark at module scope on purpose: the launcher
imports it under ``try/except ImportError`` and launches from the
driver's host when there is no pyspark.
"""

import os

from pyspark import BarrierTaskContext
from pyspark.sql import SparkSession


class SparkGangResult:
    def __init__(self, value):
        self.value = value


def _barrier_main(payload, control_addr, control_secret, master_addr,
                  master_port, device, restart, telemetry=None):
    """The function each barrier task runs on its partition (executor
    side); it returns ``[rank 0's cloudpickled result]`` on rank 0 and
    nothing elsewhere."""

    def run_partition(_rows):
        import tempfile

        import cloudpickle

        from sparkdl_tpu_torch.horovod._worker import run_rank
        from sparkdl_tpu_torch.horovod.control_plane import (
            CONTROL_ADDR_ENV,
            CONTROL_SECRET_ENV,
            ControlPlaneClient,
        )
        from sparkdl_tpu_torch.horovod.topology import (
            placement_from_task_hosts,
        )

        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        infos = ctx.getTaskInfos()
        placement = placement_from_task_hosts(
            [i.address.rsplit(":", 1)[0] for i in infos])
        names = {
            "RANK": str(rank),
            "WORLD_SIZE": str(len(infos)),
            "LOCAL_RANK": str(placement.local_rank(rank)),
            "LOCAL_WORLD_SIZE": str(placement.local_size(rank)),
            "MASTER_ADDR": master_addr,
            "MASTER_PORT": str(master_port),
            CONTROL_ADDR_ENV: control_addr,
            CONTROL_SECRET_ENV: control_secret,
        }
        before = {k: os.environ.get(k) for k in names}
        os.environ.update(names)
        try:
            ctx.barrier()  # the gang starts together (runner_base.py:54-55)
            fd, log_path = tempfile.mkstemp(
                prefix=f"sparkdl-torch-rank-{rank}-", suffix=".log")
            os.close(fd)
            pickled = run_rank(
                ControlPlaneClient(control_addr, rank, control_secret),
                log_path=log_path, device=device, restart=restart,
                load_payload=lambda: cloudpickle.loads(payload),
                send_result=False, parent_death=False, telemetry=telemetry)
        finally:
            # the worker as it was: no later code of the process finds
            # this job's rank or its driver's address
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return [] if pickled is None else [pickled]

    return run_partition


def _check_slots(sc, num_workers):
    """Fail fast when the cluster cannot host the gang (reference
    ``runner_base.py:56-58``)."""
    total = int(sc.defaultParallelism)
    if num_workers > total:
        from sparkdl_tpu_torch.horovod.launcher import SlotExhaustionError

        raise SlotExhaustionError(
            f"HorovodRunner requested np={num_workers} but the cluster has "
            f"only {total} task slots; failing fast.")


def _run_barrier_job(sc, num_workers, payload, driver_log_verbosity,
                     restart, device, telemetry=None):
    """The barrier job: control plane and store on the driver, the
    payload in the closure, rank-tagged failures, rank 0's result."""
    import tempfile

    import cloudpickle
    import torch.distributed as dist

    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.horovod.control_plane import ControlPlaneServer
    from sparkdl_tpu_torch.horovod.supervisor import GangFailure

    job_dir = tempfile.mkdtemp(prefix="sparkdl-torch-spark-job-")
    log_path = os.path.join(job_dir, "job.log")
    # executors on other hosts dial back: all interfaces, routable address
    server = ControlPlaneServer(num_workers, verbosity=driver_log_verbosity,
                                log_path=log_path, bind_host="0.0.0.0",
                                telemetry=telemetry)
    store = None
    try:
        master_addr = server.address.rsplit(":", 1)[0]
        store = dist.TCPStore(master_addr, 0, is_master=True,
                              wait_for_workers=False)
        rdd = sc.parallelize(range(num_workers), num_workers).barrier()
        try:
            pickled = rdd.mapPartitions(_barrier_main(
                payload, server.address, server.secret, master_addr,
                store.port, device, restart,
                observe.worker_settings())).collect()
        except Exception as e:
            # the ranks' own tracebacks, not Spark's opaque task failure
            # (reference runner_base.py:62-72)
            server.wait_drained(5.0)
            excs = server.exceptions
            detail = "\n".join(f"--- rank {r} ---\n{tb}"
                               for r, tb in sorted(excs.items()))
            raise GangFailure(
                f"HorovodRunner Spark barrier job failed. Merged job log: "
                f"{log_path}\n{detail or e}", kind="worker_death",
                exceptions=excs) from e
        server.wait_drained(5.0)  # the tasks' last lines, printed
        if not pickled:
            raise GangFailure("HorovodRunner Spark barrier job returned no "
                              f"rank-0 result. Merged job log: {log_path}",
                              kind="no_result")
        return SparkGangResult(cloudpickle.loads(pickled[0]))
    finally:
        server.close()
        del store  # closes the rendezvous store's server


def maybe_launch_on_spark(num_workers, payload, driver_log_verbosity,
                          restart, device, telemetry=None):
    """Run the cloudpickled ``(main, kwargs)`` as a Spark barrier job of
    ``num_workers`` tasks (0: ``sc.defaultParallelism``, resolved
    against the cluster, not the driver's host), the tasks told
    ``restart`` and ``device`` (``"cuda"`` or ``"cpu"``), their flushes
    into ``telemetry`` (a GangTelemetry, or None); returns a
    :class:`SparkGangResult`, or None when no SparkSession is active
    (then the launcher runs the gang from this host)."""
    spark = SparkSession.getActiveSession()
    if spark is None:
        return None
    sc = spark.sparkContext
    if num_workers == 0:
        num_workers = int(sc.defaultParallelism)
    _check_slots(sc, num_workers)
    return _run_barrier_job(sc, num_workers, payload, driver_log_verbosity,
                            restart, device, telemetry=telemetry)
