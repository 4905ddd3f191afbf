"""Spark barrier-mode backend of ``HorovodRunner(np >= 0)`` and of the
estimators.

Counterpart of ``sparkdl_tpu/horovod/spark_backend.py``. It runs the reference's documented behavior
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
secret, the device, the restart context, the fault injection's and the
profiler's settings (:func:`~sparkdl_tpu_torch.horovod._worker.
rank_settings`) and, with telemetry on, the driver's telemetry settings
to the tasks in the job's closure (their
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

The estimators ride the same barrier job
(:func:`maybe_launch_estimator_on_spark`): the DataFrame is
repartitioned to one partition a worker when it needs to be, and each
task hands its own partition's rows, as a pandas frame built on the
executor, to ``main`` as its first argument, so the driver never holds
the dataset. Their inference is :func:`maybe_transform_on_spark`:
``mapInPandas`` over the model's pandas closure, broadcast cloudpickled
by its caller, with no gang at all. Each task's device is the driver's
decision, shipped in the closure, as for a HorovodRunner gang.

This module imports pyspark at module scope on purpose: the launcher
imports it under ``try/except ImportError`` and launches from the
driver's host when there is no pyspark.
"""

import functools
import os

from pyspark import BarrierTaskContext
from pyspark.sql import SparkSession


class SparkGangResult:
    def __init__(self, value):
        self.value = value


def _barrier_main(payload, control_addr, control_secret, master_addr,
                  master_port, device, restart, telemetry=None,
                  settings=None, pass_partition=False):
    """The function each barrier task runs on its partition (executor
    side); it returns ``[rank 0's cloudpickled result]`` on rank 0 and
    nothing elsewhere. ``pass_partition``: the task's rows, as a pandas
    frame built here on the executor (None for an empty partition), are
    ``main``'s first argument (the partition-resident estimator data
    path, reference ``xgboost.py:58-80``)."""

    def run_partition(rows):
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

        def load_payload():
            main, kwargs = cloudpickle.loads(payload)
            if pass_partition:
                main = functools.partial(main, partition_pdf)
            return main, kwargs

        partition_pdf = None
        if pass_partition:
            import pandas as pd

            rows = [r.asDict() for r in rows]
            partition_pdf = pd.DataFrame(rows) if rows else None
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
                load_payload=load_payload,
                send_result=False, parent_death=False, telemetry=telemetry,
                settings=settings)
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
                     restart, device, telemetry=None, rdd=None,
                     pass_partition=False):
    """The barrier job: control plane and store on the driver, the
    payload in the closure, rank-tagged failures, rank 0's result. ``rdd``
    (a barrier RDD of ``num_workers`` partitions; None: one of
    ``range(num_workers)``) and ``pass_partition`` as
    :func:`_barrier_main` takes it."""
    import tempfile

    import cloudpickle
    import torch.distributed as dist

    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.horovod._worker import rank_settings
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
        if rdd is None:
            rdd = sc.parallelize(range(num_workers), num_workers).barrier()
        try:
            pickled = rdd.mapPartitions(_barrier_main(
                payload, server.address, server.secret, master_addr,
                store.port, device, restart,
                observe.worker_settings(), rank_settings(),
                pass_partition=pass_partition)).collect()
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


def maybe_launch_estimator_on_spark(dataset, num_workers, main, kwargs,
                                    driver_log_verbosity,
                                    force_repartition=False):
    """Partition-resident estimator training (reference
    ``xgboost.py:58-80``): ``main(partition_pdf, **kwargs)`` on a barrier
    job of ``num_workers`` tasks over ``dataset``'s partitions, each task
    handed its own partition's rows; the DataFrame is repartitioned to
    ``num_workers`` partitions when its count differs or
    ``force_repartition`` asks (the reshuffle of reference
    ``xgboost.py:72-80``). The slots are checked first (fail fast). The
    tasks' device is the driver's decision (``launcher.rank_device``).
    Returns a :class:`SparkGangResult`, or None when no SparkSession is
    active."""
    import cloudpickle

    from sparkdl_tpu_torch.horovod import RestartContext
    from sparkdl_tpu_torch.horovod.launcher import rank_device

    spark = SparkSession.getActiveSession()
    if spark is None:
        return None
    sc = spark.sparkContext
    _check_slots(sc, num_workers)
    if force_repartition or dataset.rdd.getNumPartitions() != num_workers:
        dataset = dataset.repartition(num_workers)
    return _run_barrier_job(
        sc, num_workers, cloudpickle.dumps((main, kwargs)),
        driver_log_verbosity, RestartContext(0, None),
        rank_device("cluster"), rdd=dataset.rdd.barrier(),
        pass_partition=True)


def _has_udt(dt):
    """A user-defined type (a pyspark.ml Vector among them) at any depth
    of ``dt``: Arrow, ``mapInPandas``' transport, cannot convert one."""
    if type(dt).__name__.endswith("UDT"):
        return True
    if hasattr(dt, "elementType"):
        return _has_udt(dt.elementType)
    if hasattr(dt, "fields"):
        return any(_has_udt(f.dataType) for f in dt.fields)
    return False


def maybe_transform_on_spark(dataset, get_broadcast, extra_cols):
    """Executor-side inference through ``mapInPandas``: the partitions'
    pandas batches go through the model's pandas -> pandas closure, with
    the output schema given explicitly (no schema-inference job), and the
    driver never holds the dataset. ``get_broadcast(spark)`` returns a
    Broadcast of the cloudpickled closure (bytes: Spark's broadcast
    serializer is plain pickle), owned and cached by the caller, so that
    repeated transforms reuse one executor-resident copy. ``extra_cols``:
    ``[(name, "double" | "array<double>"), ...]`` that the closure
    appends; an input column of the same name is replaced. Returns None
    when no SparkSession is active, or when a column holds a
    user-defined type (the caller's driver-side path reads those)."""
    from pyspark.sql.types import (
        ArrayType,
        DoubleType,
        StructField,
        StructType,
    )

    spark = SparkSession.getActiveSession()
    if spark is None:
        return None
    if any(_has_udt(f.dataType) for f in dataset.schema.fields):
        return None
    extra_names = {name for name, _ in extra_cols}
    schema = StructType(
        [f for f in dataset.schema.fields if f.name not in extra_names]
        + [StructField(name, ArrayType(DoubleType())
                       if typ == "array<double>" else DoubleType(), True)
           for name, typ in extra_cols])
    names = [f.name for f in schema.fields]
    bc = get_broadcast(spark)

    def run(batches):
        import cloudpickle

        fn = cloudpickle.loads(bc.value)  # once a partition task
        for pdf in batches:
            yield fn(pdf)[names]

    return dataset.mapInPandas(run, schema)
