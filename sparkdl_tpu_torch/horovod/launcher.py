"""Gang launcher: starts a HorovodRunner gang of worker processes and
returns rank 0's result.

Counterpart of ``sparkdl_tpu/horovod/launcher.py``:

- ``np >= 0`` under an active SparkSession runs the gang as a Spark
  barrier job, "the 2nd spark job started by HorovodRunner" (reference
  ``runner_base.py:54-61``; :mod:`sparkdl_tpu_torch.horovod.spark_backend`),
  tried before anything of this host is counted: the slots are the
  executors', and a driver in front of a GPU cluster often has no card;
- ``np <= -2`` spawns ``-np`` workers on this host (several may share a
  card, or there is none: a CPU gang), reads no hosts spec and claims no
  slot;
- ``np >= 1`` otherwise runs one worker a task slot: a CUDA card of this
  host (a core under ``WORKER_DEVICE = "cpu"``), ``NUM_SLOTS`` of them
  when that is set, or the slots a ``HOSTS`` spec declares; ``np`` above
  the total fails fast, before anything is spawned (reference
  ``runner_base.py:54-58``); ``np = 0`` is deprecated and takes every
  slot;
- busy slots are waited for (reference ``runner_base.py:56-58``): every
  such gang claims its ranks on this host in a registry of claim files
  under ``fcntl.flock`` that the drivers of this host share
  (:func:`claim_slots`), waits while other live gangs hold them, and
  raises :class:`SlotWaitTimeout` after ``SLOT_WAIT_TIMEOUT_S``; the
  claims of dead drivers are reaped;
- a ``HOSTS`` spec that places ranks on other machines starts them
  through ``REMOTE_SHELL`` (``ssh``), or raises
  :class:`RemoteTransportError` before anything is spawned; a multi-host
  spec never collapses onto this host. Only the ``torch.distributed``
  names, the control plane's address, ``PYTHONPATH`` and the device
  cross the remote command line;
- every worker, local or remote, reads the control plane's secret and
  then ``(main, kwargs)``, cloudpickled as the JAX package ships them,
  from its standard input: neither is on a command line or in an
  environment;
- the rendezvous is a ``torch.distributed.TCPStore`` that the driver
  opens on port 0, so concurrent gangs never race for a port, at this
  host's routable address when a rank is on another machine (the store
  listens on every interface); each worker gets ``MASTER_ADDR`` /
  ``MASTER_PORT`` (that store), ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
  and ``LOCAL_WORLD_SIZE``, and a rank of a one-card-a-slot gang binds
  ``cuda:LOCAL_RANK``;
- the gang starts together: a worker that dies before READY fails it at
  once, and all must be READY within ``START_TIMEOUT_S``; after a worker
  fails, the others get ``ABORT_GRACE_S`` to end before they are killed
  (one left in a collective would wait for its peer forever);
- a failed launch raises a typed
  :class:`~sparkdl_tpu_torch.horovod.supervisor.GangFailure` (a
  RuntimeError) with its kind, every rank's exit code and the tracebacks
  of the ranks that raised; no worker outlives the launch: every process
  is killed and reaped, and the slot claim released, when the launch
  ends, however it ends;
- :func:`launch_gang` runs each launch, a Spark barrier job included,
  under the supervisor (:data:`sparkdl_tpu_torch.horovod.supervisor.
  policy`, read at call time): a transient failure is launched again
  with a fresh job dir, rendezvous store and control plane, and its
  attempt number and resume step reach the workers.

The port reads no ``SPARKDL_TPU_*`` environment variable: each knob of
the JAX launcher is a module setting here, read at call time (set it as
``launcher.HOSTS = "h1:4,h2:4"``).

With telemetry on (``observe.TELEMETRY_DIR``), one
:class:`~sparkdl_tpu_torch.observe.aggregate.GangTelemetry` spans every
supervised attempt of a launch and receives its ranks' flushes; each
rank gets the driver's telemetry settings on its command line; each
attempt runs a :class:`~sparkdl_tpu_torch.observe.health.HangDetector`
in the monitor loop over the ranks' heartbeats. When it declares the
gang hung, the launcher asks every rank for a stack dump, waits up to
``_DUMP_GRACE_S`` for the stalled ranks' answers, kills the gang and
raises ``GangFailure(kind="hang")``, which the supervisor relaunches as
transient. The run dir (timeline, metrics, step attribution, health,
stack dumps, flight-recorder tails) is written however the launch ends,
an exhausted retry budget included.

The live tier rides the same telemetry: with ``statusz.PORT`` set, each
attempt of a local or remote gang serves ``/statusz``, ``/metrics``,
``/events`` and ``/capturez`` on the driver
(:mod:`sparkdl_tpu_torch.observe.statusz`); with ``alerts.ENABLED``, one
alert engine spans the launch's attempts and is polled in the monitor
loop beside the hang detector, and its report becomes the run dir's
``alerts.json``; one perf-forensics manager spans them too, bound to
each attempt's control plane, and with ``forensics.ON_ALERT`` a perf
alert asks the rank for a ``torch.profiler`` window (PROFILE_REQ) and
writes ``regression_report.json``. None of it ever replaces the gang's
own result or exception. A Spark barrier gang gets the telemetry and the
run dir, not the live tier.

**Elastic relaunch.** An attempt's world size follows the supervisor's
relaunch target (:attr:`~sparkdl_tpu_torch.horovod.supervisor.
RetryPolicy.relaunch_np`, or the elastic controller's): a local gang
spawns that many workers (a target of 1 is a one-rank subprocess gang
under the control plane, not ``np=-1``'s in-process run), a
one-worker-a-slot gang claims that many slots. With
:data:`sparkdl_tpu_torch.horovod.elastic.ENABLED`, one
:class:`~sparkdl_tpu_torch.horovod.elastic.ElasticController` spans the
launch's attempts (the active controller the supervisor asks), is told
each attempt's world size and is polled in the monitor loop; when a
resize it planned reaches its checkpoint boundary the launcher kills
the gang and raises ``GangFailure(kind="elastic_resize")``, which the
supervisor relaunches at the target with no budget and no backoff. Its
decision log is the run dir's ``elastic.json`` and ``/statusz``'s
``elastic`` section. A Spark barrier gang keeps its ``np``, as in the
JAX launcher. The driver ships the fault injection's, the profiler's and
the lock-order sanitizer's settings to every rank (``--rank-settings``),
whether its telemetry is on or not.

**Pre-flight.** With :data:`sparkdl_tpu_torch.analysis.preflight.
ENABLED`, :func:`launch_gang` lints ``main``'s captures before anything
else and refuses the launch on an ERROR. Each attempt resolves the perf
profile (:data:`sparkdl_tpu_torch.perf.profile.PROFILE`) for the card
kind the gang runs on and ships its settings to every rank with the
rank settings, under the operator's: a relaunched attempt gets them
again.

**Per-rank kwargs.** ``launch_gang(per_rank_kwargs=[...])`` gives each
rank ``kwargs`` updated with its own entry, cloudpickled into its own
payload and boot stream, so that rank-private data (a dataset shard) is
shipped only to its worker; without it the one payload is written once,
as before. The list's length must be the gang's: checked before anything
is spawned (``np > 0``) and again once each attempt's world is resolved,
an elastic relaunch to another size included (a ValueError, never
retried). Such a gang opts out of the Spark barrier job, which would
drop the rank-private payloads (the partition-resident estimator path,
:func:`~sparkdl_tpu_torch.horovod.spark_backend.
maybe_launch_estimator_on_spark`, ships data a partition instead). The
payload-size warning applies to each rank's payload.

Not ported: the JAX launcher's comms and fixit pre-flight reports, the
producers of ``comms_report.json`` and ``fixit_report.json``.
"""

import json
import logging
import os
import shlex
import subprocess
import sys
import tempfile
import time

from sparkdl_tpu_torch.horovod.control_plane import CONTROL_ADDR_ENV

logger = logging.getLogger("HorovodRunner")

START_TIMEOUT_S = 300.0  # every worker READY within this
JOB_TIMEOUT_S = None  # the whole gang within this (None: no limit)
ABORT_GRACE_S = 30.0  # survivors of a failed worker, before the kill
LARGE_PAYLOAD_BYTES = 10 << 20
# the module settings that replace the JAX launcher's environment knobs
# (SPARKDL_TPU_HOSTS, _NUM_SLOTS, _SLOT_DIR, _SLOT_WAIT_TIMEOUT,
# _REMOTE_SHELL, _REMOTE_PYTHON, _WORKER_PLATFORM):
# a cluster gang's hosts x slots, "h1:4,h2:4" or [("h1", 4), ...];
# None: this host alone
HOSTS = None
# this host's task slots, in place of counting its cards (None: count)
NUM_SLOTS = None
# the slot registry's directory (None: <tempdir>/sparkdl-torch-slots,
# apart from the JAX package's registry)
SLOT_DIR = None
# how long a gang waits for busy slots before SlotWaitTimeout
SLOT_WAIT_TIMEOUT_S = 600.0
# the remote shell: None is ssh -o BatchMode=yes, "none" refuses remote
# ranks, a string is split as a shell would, a list is taken as tokens
REMOTE_SHELL = None
# the Python a remote rank runs (None: this driver's)
REMOTE_PYTHON = None
# None: a rank of a one-card-a-slot gang (a Spark task, a remote rank)
# binds cuda:LOCAL_RANK and raises without it; "cpu": every rank runs on
# the CPU over gloo, and the slots are this host's cores
WORKER_DEVICE = None
# how long a hung gang waits for its stalled ranks' stack dumps before
# the kill (the JAX launcher's default SPARKDL_TPU_DUMP_GRACE)
_DUMP_GRACE_S = 10.0

# the directory that holds sparkdl_tpu_torch, for the workers' imports
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_WORKER_MODULE = "sparkdl_tpu_torch.horovod._worker"
# what crosses a remote rank's command line: the torch.distributed names,
# the control plane's address and the package's path (the device is a
# worker argument; the secret and the payload go over standard input)
_REMOTE_NAMES = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT", CONTROL_ADDR_ENV,
                 "PYTHONPATH")


class SlotExhaustionError(RuntimeError):
    """``np`` exceeds the task slots in total (reference
    ``runner_base.py:56-58``). Never retried: a relaunch cannot create
    slots."""


class SlotWaitTimeout(RuntimeError):
    """Gave up waiting for busy slots to free. Never retried: a relaunch
    would wait the whole period again right after giving up."""


class RemoteTransportError(RuntimeError):
    """A placement on other hosts cannot be honored: the remote shell is
    refused or missing. Raised instead of launching every rank on this
    host."""


def _worker_device():
    """``WORKER_DEVICE``, checked."""
    if WORKER_DEVICE not in (None, "cpu"):
        raise ValueError(f"launcher.WORKER_DEVICE is None or 'cpu', not "
                         f"{WORKER_DEVICE!r}")
    return WORKER_DEVICE


def rank_device(mode):
    """The driver's decision for a gang's ranks, which it ships to them:
    ``"cpu"`` under ``WORKER_DEVICE = "cpu"``; ``"cuda"`` for a
    one-card-a-slot gang (``mode`` ``"cluster"``: local, remote or Spark);
    None for a local gang, whose ranks take the backend rule of
    :mod:`sparkdl_tpu_torch.hvd._state`."""
    if _worker_device() == "cpu":
        return "cpu"
    return "cuda" if mode == "cluster" else None


def available_slots():
    """This host's task slots: ``NUM_SLOTS`` when set, else its cores
    under ``WORKER_DEVICE = "cpu"``, else its CUDA cards, counted without
    creating a CUDA context (the driver must not hold the card that its
    worker binds)."""
    if NUM_SLOTS is not None:
        return int(NUM_SLOTS)
    if _worker_device() == "cpu":
        return os.cpu_count() or 1
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


# -- slot registry ----------------------------------------------------------
#
# The contract tells BUSY slots from MISSING ones: a job whose np fits
# the total "will wait until np task slots are available", and fails only
# when np exceeds the total (reference runner_base.py:56-58). Concurrent
# gangs on one host coordinate through a directory of claim files: each
# gang claims its slot count under an flock, and the claims of dead
# processes are reaped, so a crashed driver never leaks slots.


def _slot_dir():
    d = SLOT_DIR or os.path.join(tempfile.gettempdir(),
                                 "sparkdl-torch-slots")
    os.makedirs(d, exist_ok=True)
    return d


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def _busy_slots_locked(d):
    """The live claims' slots in the registry (the caller holds its
    lock); reaps the claims of dead processes and drops corrupt files."""
    busy = 0
    for name in os.listdir(d):
        if not name.endswith(".claim"):
            continue
        path = os.path.join(d, name)
        try:
            with open(path) as f:
                pid_s, count_s = f.read().split()
            if _pid_alive(int(pid_s)):
                busy += int(count_s)
            else:
                os.unlink(path)  # its owner died without releasing it
        except (OSError, ValueError):
            try:
                os.unlink(path)
            except OSError:
                pass
    return busy


class SlotClaim:
    def __init__(self, path):
        self._path = path

    def release(self):
        try:
            os.unlink(self._path)
        except OSError:
            pass


def claim_slots(n, total, timeout=None):
    """Claim ``n`` of this host's ``total`` slots, waiting while other
    live gangs hold them; raises :class:`SlotWaitTimeout` after
    ``timeout`` seconds (None: ``SLOT_WAIT_TIMEOUT_S``). ``n > total``
    fails fast before this, in :func:`_resolve_num_workers`."""
    import fcntl
    import uuid

    if timeout is None:
        timeout = float(SLOT_WAIT_TIMEOUT_S)
    d = _slot_dir()
    lock_path = os.path.join(d, ".lock")
    deadline = time.monotonic() + timeout
    logged_waiting = False
    while True:
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            busy = _busy_slots_locked(d)
            if total - busy >= n:
                path = os.path.join(d, f"{uuid.uuid4().hex}.claim")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(f"{os.getpid()} {n}")
                os.replace(tmp, path)
                return SlotClaim(path)
        if time.monotonic() > deadline:
            raise SlotWaitTimeout(
                f"HorovodRunner waited {timeout:.0f}s for {n} of {total} "
                f"task slots ({busy} busy in other jobs) without success; "
                "giving up. Raise launcher.SLOT_WAIT_TIMEOUT_S or stop the "
                "competing jobs.")
        if not logged_waiting:
            logger.info(
                "HorovodRunner: %d/%d task slots busy; waiting for %d to "
                "free up (the contract: wait while busy, fail only when np "
                "exceeds the total).", busy, total, n)
            logged_waiting = True
        time.sleep(0.2)


def _hosts_placement():
    """The ``HOSTS`` spec as a Placement, or None."""
    from sparkdl_tpu_torch.horovod.topology import Placement, parse_hosts

    if HOSTS is None:
        return None
    spec = HOSTS if isinstance(HOSTS, str) else ",".join(
        f"{host}:{slots}" for host, slots in HOSTS)
    return Placement(parse_hosts(spec))


def _resolve_num_workers(np_arg, placement=None):
    """(number of workers, mode, total slots) for ``HorovodRunner(np=
    np_arg)``, ``np_arg != -1``: ``"local"`` (``np <= -2``, no slot
    accounting, total None) or ``"cluster"`` (one worker a slot). The
    total is the ``HOSTS`` spec's (``placement``), trusted as declared,
    or :func:`available_slots`; raises before anything is spawned when
    ``np`` asks for more."""
    if np_arg <= -2:
        return -np_arg, "local", None
    slots = (placement.total_slots if placement is not None
             else available_slots())
    n = slots if np_arg == 0 else np_arg
    if n == 0 or n > slots:
        where = (f"the HOSTS spec declares {slots}" if placement is not None
                 else f"this host has {slots} (launcher.NUM_SLOTS "
                      "overrides the count)")
        raise SlotExhaustionError(
            f"HorovodRunner(np={np_arg}) runs one worker a task slot (one "
            "worker a CUDA card, or a core under WORKER_DEVICE='cpu'), and "
            f"{where}; the job fails fast rather than wait (np <= -2 runs "
            "a gang of -np local workers, which may share a card or run "
            "on the CPU).")
    return n, "cluster", slots


def _worker_env(base_env, *, rank, size, placement, master_addr,
                master_port, control_addr):
    """A worker's environment: the driver's, with the names
    ``torch.distributed`` reads, the control plane's address, and the
    package on ``PYTHONPATH``."""
    env = dict(base_env)
    env.update({
        "RANK": str(rank),
        "WORLD_SIZE": str(size),
        "LOCAL_RANK": str(placement.local_rank(rank)),
        "LOCAL_WORLD_SIZE": str(placement.local_size(rank)),
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
        CONTROL_ADDR_ENV: control_addr,
    })
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_PACKAGE_ROOT if not path
                         else _PACKAGE_ROOT + os.pathsep + path)
    return env


# -- remote exec transport --------------------------------------------------
#
# A hosts spec naming other machines (reference runner_base.py:54-55:
# the slots live on the task nodes) starts those ranks through a remote
# shell, mpirun-style: ``ssh <host> env K=V ... python -m
# sparkdl_tpu_torch.horovod._worker ...``, the boot stream on the
# connection's standard input. It assumes a
# homogeneous cluster: the same Python (REMOTE_PYTHON overrides) and the
# same package path. There is no fallback to this host.


def _resolve_remote_shell():
    """The remote shell's tokens (``["ssh", "-o", "BatchMode=yes"]``), or
    raises :class:`RemoteTransportError`."""
    import shutil

    spec = REMOTE_SHELL
    if isinstance(spec, (list, tuple)):
        if not spec:
            raise RemoteTransportError("launcher.REMOTE_SHELL is an empty "
                                       "token list")
        return [str(t) for t in spec]
    if spec is not None and spec.strip():
        if spec.strip().lower() == "none":
            raise RemoteTransportError(
                "launcher.REMOTE_SHELL = 'none' refuses remote ranks")
        return shlex.split(spec)
    if shutil.which("ssh") is None:
        raise RemoteTransportError(
            "no `ssh` on PATH and no launcher.REMOTE_SHELL")
    # BatchMode: a gang launch fails fast, never waits at a password
    # prompt inside its start timeout
    return ["ssh", "-o", "BatchMode=yes"]


def _remote_worker_cmd(shell_tokens, host, env, python, worker_args):
    """The remote launch's argv: ``shell host env K=V ... python -m
    sparkdl_tpu_torch.horovod._worker worker_args``. Of the worker's
    environment ``env`` only ``_REMOTE_NAMES`` cross. The remote shell
    joins and parses what follows the host, so every token after it is
    shell-quoted."""
    names = [k for k in _REMOTE_NAMES if k in env]
    return (list(shell_tokens) + [host, "env"]
            + [f"{k}={shlex.quote(env[k])}" for k in names]
            + [shlex.quote(t) for t in [python, "-m", _WORKER_MODULE,
                                        *worker_args]])


def _tail(path, n=40):
    try:
        with open(path, "r", errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def _check_per_rank(per_rank_kwargs, num_workers):
    if per_rank_kwargs is not None and len(per_rank_kwargs) != num_workers:
        raise ValueError(f"per_rank_kwargs has {len(per_rank_kwargs)} "
                         f"entries for a gang of {num_workers}")


def launch_gang(np, main, kwargs, driver_log_verbosity, per_rank_kwargs=None,
                *, policy=None, attach=None, cancel=None):
    """Run ``main(**kwargs)`` on a gang of workers (``np`` as
    :class:`~sparkdl_tpu_torch.horovod.runner_base.HorovodRunner` takes
    it, ``np != -1``) and return rank 0's return value, relaunching a
    gang that fails transiently as the supervisor's policy allows
    (``policy``; None: :data:`~sparkdl_tpu_torch.horovod.supervisor.
    policy`). ``per_rank_kwargs``: a list of dicts, one a rank, each
    merged into ``kwargs`` for its rank alone (module docstring).

    ``attach(server)`` is called with each local or remote attempt's
    control plane (:class:`~sparkdl_tpu_torch.horovod.control_plane.
    ControlPlaneServer`) before its workers are spawned, so the caller
    can exchange frames with the ranks (a fleet's gang replica); the
    JAX launcher has no such hook. Setting ``cancel`` (a
    ``threading.Event``) kills the attempt's workers and raises
    ``GangFailure(kind="cancelled")``.
    Raises :class:`~sparkdl_tpu_torch.horovod.supervisor.GangFailure`
    when a worker fails (with its traceback), when the gang does not
    start within ``START_TIMEOUT_S`` or runs past ``JOB_TIMEOUT_S``;
    :class:`SlotExhaustionError` when ``np`` exceeds the slots,
    :class:`SlotWaitTimeout` when busy slots do not free in time,
    :class:`RemoteTransportError` when remote ranks cannot be started and
    :class:`~sparkdl_tpu_torch.analysis.preflight.PreflightLintError`
    when the pre-flight lint (on) finds an ERROR, before anything is
    spawned."""
    import cloudpickle

    from sparkdl_tpu_torch.analysis.preflight import preflight_lint
    from sparkdl_tpu_torch.horovod import elastic, supervisor

    # the opt-in pre-flight lint (analysis.preflight.ENABLED): a capture
    # that cannot cross the pickle refuses the launch before the
    # supervisor loop, the slot claims, the payload and any spawn — a
    # retry would only spend its budget on the same failure
    if np > 0:
        _check_per_rank(per_rank_kwargs, np)
    preflight_lint(main, kwargs, per_rank_kwargs=per_rank_kwargs)
    if per_rank_kwargs is None:
        payload = cloudpickle.dumps((main, kwargs))
        largest = len(payload)
    else:
        # one payload a rank: its shard reaches its worker alone
        payload = [cloudpickle.dumps((main, {**kwargs, **own}))
                   for own in per_rank_kwargs]
        largest = max(len(p) for p in payload)
    if largest > LARGE_PAYLOAD_BYTES:
        logger.warning(
            "Pickled main + kwargs is %.1f MB%s; large closures make "
            "HorovodRunner jobs slow to start. Move data loading inside "
            "main().", largest / 2**20,
            "" if per_rank_kwargs is None else " for one rank")
    from sparkdl_tpu_torch import observe

    telemetry = alert_engine = forensics = None
    if observe.enabled():
        from sparkdl_tpu_torch.observe.aggregate import GangTelemetry
        from sparkdl_tpu_torch.observe.alerts import maybe_make_engine
        from sparkdl_tpu_torch.observe.forensics import maybe_make_forensics

        telemetry = GangTelemetry()
        # one engine and one forensics manager span the attempts
        alert_engine = maybe_make_engine(telemetry)
        forensics = maybe_make_forensics(telemetry, alert_engine=alert_engine)
    # the capacity watcher and card arbiter span the attempts too; the
    # supervisor asks the active one for relaunch targets
    controller = elastic.maybe_make_controller(alerts=alert_engine)
    if controller is not None:
        elastic.set_active_controller(controller)
    try:
        return supervisor.supervise(
            lambda ctx, world=None: _launch_gang_once(
                np, payload, driver_log_verbosity, restart=ctx,
                telemetry=telemetry, alerts=alert_engine,
                forensics=forensics, world=world, controller=controller,
                attach=attach, cancel=cancel),
            supervisor.policy if policy is None else policy)
    finally:
        if controller is not None:
            elastic.set_active_controller(None)
            if telemetry is not None:
                try:
                    telemetry.add_elastic_report(controller.report())
                except Exception as e:  # noqa: BLE001 - never masks the gang
                    logger.warning("elastic report attach failed: %s", e)
        if alert_engine is not None:
            # a clean run's alerts.json too: the rules ran, none fired
            try:
                telemetry.add_alert_report(alert_engine.report())
            except Exception as e:  # noqa: BLE001 - never masks the gang
                logger.warning("alert report attach failed: %s", e)
        if telemetry is not None and observe.telemetry_dir():
            # never masks the gang's own result or exception
            try:
                paths = telemetry.write(observe.new_run_dir())
            except Exception as e:  # noqa: BLE001 - an unwritable dir or
                # a malformed frame must not replace the gang's outcome
                logger.warning("telemetry write under %s failed: %s",
                               observe.telemetry_dir(), e)
            else:
                logger.info("gang telemetry written: %s",
                            ", ".join(sorted(paths.values())))


def _launch_gang_once(np, payload, driver_log_verbosity, restart,
                      telemetry=None, alerts=None, forensics=None,
                      world=None, controller=None, attach=None,
                      cancel=None):
    """One launch attempt of the cloudpickled ``(main, kwargs)`` (a
    list of them, one a rank, for per-rank kwargs), its
    workers told ``restart`` (a RestartContext), their telemetry into
    ``telemetry`` (a GangTelemetry, or None), polled by ``alerts`` (an
    AlertEngine, or None), captures through ``forensics`` (a
    ForensicsManager, or None), ``world`` workers when it is given (an
    elastic relaunch; None: ``np``'s), ``controller`` (an
    ElasticController, or None) told the world and polled, ``attach``
    and ``cancel`` as :func:`launch_gang` takes them; rank 0's
    result."""
    from sparkdl_tpu_torch.horovod.topology import (
        Placement,
        _addressable,
        is_local_host,
    )

    if np == 0:
        logger.warning("HorovodRunner(np=0) is deprecated (reference "
                       "README.md:57-61); using every task slot.")
    per_rank = isinstance(payload, list)
    # per-rank payloads opt out of the barrier job, which would drop them
    if np >= 0 and not per_rank:
        try:
            from sparkdl_tpu_torch.horovod.spark_backend import (
                maybe_launch_on_spark,
            )
        except ImportError:
            pass  # no pyspark: the gang runs from this host
        else:
            ran = maybe_launch_on_spark(
                np, payload, driver_log_verbosity, restart,
                rank_device("cluster"), telemetry)
            if ran is not None:
                return ran.value

    spec = _hosts_placement()
    # local mode reads no spec; one argument when there is none
    num_workers, mode, total = (
        _resolve_num_workers(np) if spec is None or np <= -2
        else _resolve_num_workers(np, spec))
    if world and int(world) != num_workers:
        # the supervisor's relaunch target, cleared by its pre-flight: a
        # local gang spawns that many workers, a cluster gang resolves
        # (and claims) that many slots
        if mode == "local":
            num_workers = int(world)
        else:
            num_workers, mode, total = (
                _resolve_num_workers(int(world)) if spec is None
                else _resolve_num_workers(int(world), spec))
        logger.info("elastic relaunch: gang world resized to np=%d (%s "
                    "mode)", num_workers, mode)
    if per_rank:
        _check_per_rank(payload, num_workers)
    placement = (spec.first(num_workers) if spec is not None
                 and mode == "cluster" else Placement.single_host(num_workers))
    remote = sorted({h for h, _ in placement.hosts if not is_local_host(h)})
    shell = None
    if remote:
        # before the slot claim, which may wait for minutes
        try:
            shell = _resolve_remote_shell()
        except RemoteTransportError as e:
            raise RemoteTransportError(
                f"the HOSTS spec places ranks on remote host(s) {remote}, "
                f"but remote exec is unavailable ({e}). Refusing to launch "
                "the whole gang on this host: that would oversubscribe its "
                "cards. Fix the transport or launcher.HOSTS.") from None
    claim = None
    if mode == "cluster":
        # this host's ranks claim this host's slots; remote ranks take
        # their hosts' slots, not ours
        n_here = sum(n for h, n in placement.hosts if h not in remote)
        here_total = total if spec is None else sum(
            n for h, n in spec.hosts if is_local_host(h))
        if n_here:
            claim = claim_slots(n_here, here_total)
    try:
        master_addr = _addressable("localhost") if remote else "127.0.0.1"
        return _run_gang(num_workers, mode, placement, remote, shell,
                         master_addr, payload, driver_log_verbosity, restart,
                         telemetry, alerts, forensics, controller, attach,
                         cancel)
    finally:
        if claim is not None:
            claim.release()


def _run_gang(num_workers, mode, placement, remote, shell, master_addr,
              payload, driver_log_verbosity, restart, telemetry=None,
              alerts=None, forensics=None, controller=None, attach=None,
              cancel=None):
    """Spawn the workers (``remote`` hosts' through ``shell``), wait for
    them and return rank 0's unpickled result."""
    import cloudpickle
    import torch.distributed as dist

    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.horovod._worker import rank_settings
    from sparkdl_tpu_torch.horovod.control_plane import ControlPlaneServer
    from sparkdl_tpu_torch.horovod.supervisor import (
        GangFailure,
        record_attempt_world,
    )

    job_dir = tempfile.mkdtemp(prefix="sparkdl-torch-job-")
    payloads = payload if isinstance(payload, list) else [payload]
    boot_paths = [os.path.join(job_dir, f"boot-{i}.bin")
                  for i in range(len(payloads))]
    store = server = detector = statusz = None
    procs, boot_logs = [], []
    record_attempt_world(num_workers)
    if controller is not None:
        # a change of world counts here, where the attempt's size is known
        controller.note_attempt(num_workers)
    if telemetry is not None:
        from sparkdl_tpu_torch.observe.health import HangDetector

        detector = HangDetector(num_workers)
        if alerts is not None:
            alerts.set_world(num_workers, detector=detector)
        # the attempt's rings, OOM reports and captures, for the run dir
        telemetry.note_job_dir(job_dir)
    try:
        if telemetry is not None:
            from sparkdl_tpu_torch.observe.statusz import maybe_start_statusz

            # inside the try: the finally closes it however the attempt ends
            statusz = maybe_start_statusz(
                telemetry, detector=detector, num_workers=num_workers,
                alerts=alerts, elastic=controller, forensics=forensics)
            if statusz is not None:
                logger.info("statusz live at http://%s/statusz",
                            statusz.address)
        # local gangs stream their workers' output to the driver
        # (reference README.md:44-47); one-worker-a-slot gangs honor
        # driver_log_verbosity
        server = ControlPlaneServer(
            num_workers,
            verbosity=driver_log_verbosity if mode == "cluster" else "all",
            log_path=os.path.join(job_dir, "job.log"),
            bind_host="0.0.0.0" if remote else "127.0.0.1",
            telemetry=telemetry, health=detector)
        if forensics is not None:
            # PROFILE_REQ goes out through this attempt's control plane
            forensics.bind_server(server)
        if attach is not None:
            # before any worker can connect: no frame of theirs is missed
            attach(server)
        # the store's server listens on every interface; master_addr is
        # what the workers dial, a routable one when a rank is remote
        store = dist.TCPStore(master_addr, 0, is_master=True,
                              wait_for_workers=False)
        logger.info("Launching HorovodRunner gang: %d worker(s), %s, "
                    "attempt %d, job_dir=%s", num_workers,
                    "one a slot" if mode == "cluster" else "local",
                    restart.attempt, job_dir)
        args = ["--job-dir", job_dir, "--attempt", str(restart.attempt)]
        if restart.resume_step is not None:
            args += ["--resume-step", str(restart.resume_step)]
        if restart.source_axes and restart.target_axes:
            args += ["--source-axes", json.dumps(restart.source_axes),
                     "--target-axes", json.dumps(restart.target_axes)]
        device = rank_device(mode)
        if device is not None:
            args += ["--device", device]
        if telemetry is not None:
            args += ["--telemetry", json.dumps(observe.worker_settings())]
        settings = rank_settings()
        if settings:
            args += ["--rank-settings", json.dumps(settings)]
        python = REMOTE_PYTHON or sys.executable
        # the workers' boot stream: the secret's line, then the payload
        # (one for all, or one a rank); each worker's stdin opens it anew,
        # and it is unlinked once they are spawned
        for path, body in zip(boot_paths, payloads):
            with open(path, "wb") as f:
                f.write(server.secret.encode() + b"\n" + body)
        for r in range(num_workers):
            env = _worker_env(
                os.environ, rank=r, size=num_workers, placement=placement,
                master_addr=master_addr, master_port=store.port,
                control_addr=server.address)
            if placement.host(r) in remote:
                cmd = _remote_worker_cmd(shell, placement.host(r), env,
                                         python, args)
                env = None  # the shell's own: what crosses is in cmd
            else:
                cmd = [sys.executable, "-m", _WORKER_MODULE, *args]
            # output from before the worker's tee (an import error) lands
            # in its per-rank log too
            boot_log = open(os.path.join(job_dir, f"rank-{r}.log"), "ab",
                            buffering=0)
            boot_logs.append(boot_log)
            with open(boot_paths[r % len(boot_paths)], "rb") as boot_in:
                procs.append(subprocess.Popen(
                    cmd, env=env, stdin=boot_in, stdout=boot_log,
                    stderr=subprocess.STDOUT))
        for path in boot_paths:
            os.unlink(path)
        observe.instant("gang.spawn", cat="launch", num_workers=num_workers,
                        mode=mode, job_dir=job_dir)

        def fail(reason, codes, kind):
            excs = server.exceptions
            detail = "\n".join(f"--- rank {r} ---\n{tb}"
                               for r, tb in sorted(excs.items()))
            if not detail:
                detail = "\n".join(
                    f"--- rank {r} log tail ---\n"
                    + _tail(os.path.join(job_dir, f"rank-{r}.log"))
                    for r, c in enumerate(codes) if c)
            raise GangFailure(f"{reason} Worker logs: {job_dir}\n{detail}",
                              kind=kind, exit_codes=[c or 0 for c in codes],
                              exceptions=excs)

        start = time.monotonic()
        with observe.span("gang.rendezvous", cat="launch",
                          num_workers=num_workers):
            while server.ready_count() < num_workers:
                _check_cancel(cancel, procs)
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    server.wait_drained(1.0)  # the EXC frames of the dead
                    fail("HorovodRunner gang failed to start: worker(s) "
                         f"{[r for r, c in enumerate(codes) if c]} exited "
                         f"during rendezvous (codes {codes}).", codes,
                         "start_failure")
                if time.monotonic() - start > START_TIMEOUT_S:
                    fail(f"HorovodRunner gang failed to start: only "
                         f"{server.ready_count()}/{num_workers} workers "
                         f"reached the rendezvous within "
                         f"{START_TIMEOUT_S:.0f}s (fail-fast, reference "
                         "runner_base.py:54-58).", codes,
                         "rendezvous_timeout")
                time.sleep(0.05)
        observe.instant("gang.ready", cat="launch", num_workers=num_workers)
        logger.info("HorovodRunner gang ready in %.1f s",
                    time.monotonic() - start)

        first_death = None
        while any(p.poll() is None for p in procs):
            _check_cancel(cancel, procs)
            codes = [p.poll() for p in procs]
            if alerts is not None:
                # the streaming rules (throttled to their cadence); a perf
                # firing asks its rank for a profile window
                fired = alerts.poll()
                if forensics is not None and fired:
                    forensics.on_alerts(fired)
            if controller is not None and first_death is None:
                # the elastic tick (throttled inside): a resize at its
                # checkpoint boundary recycles the gang now
                resize = controller.poll()
                if resize is not None:
                    _recycle(procs, resize)
            if detector is not None and first_death is None:
                _check_hang(detector, server, procs, num_workers, job_dir)
            if (JOB_TIMEOUT_S is not None
                    and time.monotonic() - start > JOB_TIMEOUT_S):
                fail(f"HorovodRunner job ran past {JOB_TIMEOUT_S:.0f}s; "
                     "every worker was killed.", codes, "job_timeout")
            if any(c not in (None, 0) for c in codes):
                if first_death is None:
                    first_death = time.monotonic()
                elif time.monotonic() - first_death > ABORT_GRACE_S:
                    fail("HorovodRunner job failed: worker(s) "
                         f"{[r for r, c in enumerate(codes) if c]} died; "
                         "the others were killed after a "
                         f"{ABORT_GRACE_S:.0f}s grace period.", codes,
                         "worker_death")
            time.sleep(0.05)
        codes = [p.wait() for p in procs]
        if not server.wait_drained(5.0):
            logger.warning("the control plane did not drain within 5 s of "
                           "the workers' exit; frames after that are lost")
        if any(codes):
            fail(f"HorovodRunner job failed (exit codes {codes}).", codes,
                 "worker_death")
        result = server.result_bytes
        if result is None:
            fail("HorovodRunner job finished, but rank 0 returned no "
                 "result over the control plane.", codes, "no_result")
        return cloudpickle.loads(result)
    finally:
        if statusz is not None:
            statusz.close()  # before the teardown a scrape would race
        if detector is not None:
            # however the attempt ended: its verdicts, for health.json
            telemetry.add_health_summary(detector.summary())
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in boot_logs:
            f.close()
        for path in boot_paths:
            if os.path.exists(path):
                os.unlink(path)  # the secret outlives no launch
        if server is not None:
            server.close()
        del store  # closes the rendezvous store's server


def _check_cancel(cancel, procs):
    """When ``cancel`` is set: kill the gang and raise
    ``GangFailure(kind="cancelled")`` (its caller ended it)."""
    if cancel is None or not cancel.is_set():
        return
    from sparkdl_tpu_torch.horovod.supervisor import GangFailure

    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    raise GangFailure("HorovodRunner gang cancelled by its caller; every "
                      "worker was killed.", kind="cancelled",
                      exit_codes=[p.poll() or 0 for p in procs])


def _recycle(procs, resize):
    """Kill the gang for the elastic controller's ``resize`` and raise
    ``GangFailure(kind="elastic_resize")``, which the supervisor
    relaunches at the target with no budget and no backoff."""
    from sparkdl_tpu_torch.horovod.supervisor import GangFailure

    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    raise GangFailure(
        f"elastic resize: {resize['direction']} to np={resize['target_np']} "
        f"({resize['reason']}); resuming from step "
        f"{resize.get('resume_step')}", kind="elastic_resize",
        exit_codes=[p.poll() or 0 for p in procs],
        elastic_direction=resize["direction"],
        elastic_target=resize["target_np"])


def _check_hang(detector, server, procs, num_workers, job_dir):
    """One pass of the hang detector: a stack dump asked of each newly
    stalled rank; on a hang verdict, one of every rank, a wait of up to
    ``_DUMP_GRACE_S`` for the stalled ranks' answers, the gang killed, and
    ``GangFailure(kind="hang")`` raised."""
    from sparkdl_tpu_torch.horovod.supervisor import GangFailure

    report = detector.poll()
    for r in report["new_stalled"]:
        # while the evidence lives: the rank's watchdog thread answers
        # however wedged its training thread is
        server.request_dump(r, reason="stall")
    verdict = report["hang"]
    if not verdict:
        return
    stalled = detector.stalled_ranks
    for r in range(num_workers):
        server.request_dump(r, reason=f"hang:{verdict}")
    deadline = time.monotonic() + _DUMP_GRACE_S
    while time.monotonic() < deadline and not all(
            server.stack_dumps(r) for r in stalled):
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    raise GangFailure(
        "HorovodRunner gang hung: beats continued but no rank made "
        f"progress for {detector.stall_s:.0f}s (verdict: {verdict}; "
        f"stalled rank(s) {stalled}).\n{detector.describe()}\nStack dumps "
        f"captured from rank(s) {sorted(server.stack_dumps())}. Worker "
        f"logs: {job_dir}", kind="hang", hang_verdict=verdict,
        exit_codes=[p.poll() or 0 for p in procs],
        exceptions=server.exceptions)
