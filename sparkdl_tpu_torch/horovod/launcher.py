"""Gang launcher: starts a HorovodRunner gang of worker processes on this
host and returns rank 0's result.

Counterpart of the local half of ``sparkdl_tpu/horovod/launcher.py``:

- ``np <= -2`` spawns ``-np`` workers on this host (several may share a
  card, or there is none: a CPU gang);
- ``np >= 1`` spawns one worker a CUDA card, and fails fast, before
  spawning anything, when ``np`` exceeds ``torch.cuda.device_count()``
  (reference ``runner_base.py:54-58``); ``np = 0`` is deprecated and
  takes every card;
- ``(main, kwargs)`` go to the workers cloudpickled, as the JAX package
  ships them;
- the rendezvous is a ``torch.distributed.TCPStore`` that the driver
  opens on port 0, so concurrent gangs never race for a port; each
  worker gets ``MASTER_ADDR``/``MASTER_PORT`` (that store), ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``;
- the gang starts together: a worker that dies before READY fails it at
  once, and all must be READY within ``START_TIMEOUT_S``; after a worker
  fails, the others get ``ABORT_GRACE_S`` to end before they are killed
  (one left in a collective would wait for its peer forever);
- a failed launch raises a typed
  :class:`~sparkdl_tpu_torch.horovod.supervisor.GangFailure` (a
  RuntimeError) with its kind, every rank's exit code and the tracebacks
  of the ranks that raised; no worker outlives the launch: every process
  is killed and reaped when the launch ends, however it ends;
- :func:`launch_gang` runs each launch under the supervisor
  (:data:`sparkdl_tpu_torch.horovod.supervisor.policy`, read at call
  time): a transient failure is launched again with a fresh job dir,
  rendezvous store and control plane, and its attempt number and resume
  step reach the workers on their command line (``--attempt``,
  ``--resume-step``).

Spark, ssh and multi-host specs, the slot registry, telemetry, the hang
detector, elastic resizing and the pre-flight lint of the JAX launcher
are not ported.
"""

import logging
import os
import subprocess
import sys
import tempfile
import time

logger = logging.getLogger("HorovodRunner")

START_TIMEOUT_S = 300.0  # every worker READY within this
JOB_TIMEOUT_S = None  # the whole gang within this (None: no limit)
ABORT_GRACE_S = 30.0  # survivors of a failed worker, before the kill
LARGE_PAYLOAD_BYTES = 10 << 20

# the directory that holds sparkdl_tpu_torch, for the workers' imports
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SlotExhaustionError(RuntimeError):
    """``np`` exceeds the host's CUDA cards (reference
    ``runner_base.py:56-58``). Never retried: a relaunch cannot create
    cards."""


def _resolve_num_workers(np_arg):
    """(number of workers, per_card) for ``HorovodRunner(np=np_arg)``,
    ``np_arg != -1``; raises before anything is spawned when a
    one-card-a-rank gang asks for more cards than the host has."""
    if np_arg <= -2:
        return -np_arg, False
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if np_arg == 0:
        logger.warning("HorovodRunner(np=0) is deprecated (reference "
                       "README.md:57-61); using every CUDA card.")
        np_arg = cards
    if cards == 0 or np_arg > cards:
        raise SlotExhaustionError(
            f"HorovodRunner(np={np_arg}) runs one worker a CUDA card, and "
            f"this host has {cards}; the job fails fast rather than wait "
            "(np <= -2 runs a gang of -np local workers, which may share a "
            "card or run on the CPU).")
    return np_arg, True


def _worker_env(base_env, *, rank, size, placement, master_addr,
                master_port, control_addr, control_secret):
    """A worker's environment: the driver's, with the names
    ``torch.distributed`` reads, the control plane's address and secret
    (never on the command line), and the package on ``PYTHONPATH``."""
    from sparkdl_tpu_torch.horovod.control_plane import (
        CONTROL_ADDR_ENV,
        CONTROL_SECRET_ENV,
    )

    env = dict(base_env)
    env.update({
        "RANK": str(rank),
        "WORLD_SIZE": str(size),
        "LOCAL_RANK": str(placement.local_rank(rank)),
        "LOCAL_WORLD_SIZE": str(placement.local_size(rank)),
        "MASTER_ADDR": master_addr,
        "MASTER_PORT": str(master_port),
        CONTROL_ADDR_ENV: control_addr,
        CONTROL_SECRET_ENV: control_secret,
    })
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_PACKAGE_ROOT if not path
                         else _PACKAGE_ROOT + os.pathsep + path)
    return env


def _tail(path, n=40):
    try:
        with open(path, "r", errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def launch_gang(np, main, kwargs, driver_log_verbosity):
    """Run ``main(**kwargs)`` on a gang of workers (``np`` as
    :class:`~sparkdl_tpu_torch.horovod.runner_base.HorovodRunner` takes
    it, ``np != -1``) and return rank 0's return value, relaunching a
    gang that fails transiently as the supervisor's policy allows.
    Raises :class:`~sparkdl_tpu_torch.horovod.supervisor.GangFailure`
    when a worker fails (with its traceback), when the gang does not
    start within ``START_TIMEOUT_S`` or runs past ``JOB_TIMEOUT_S``, and
    :class:`SlotExhaustionError` when ``np`` exceeds the card count."""
    import cloudpickle

    from sparkdl_tpu_torch.horovod import supervisor

    payload = cloudpickle.dumps((main, kwargs))
    if len(payload) > LARGE_PAYLOAD_BYTES:
        logger.warning(
            "Pickled main + kwargs is %.1f MB; large closures make "
            "HorovodRunner jobs slow to start. Move data loading inside "
            "main().", len(payload) / 2**20)
    return supervisor.supervise(
        lambda ctx: _launch_gang_once(np, payload, driver_log_verbosity,
                                      restart=ctx),
        supervisor.policy)


def _launch_gang_once(np, payload, driver_log_verbosity, restart):
    """One launch attempt of the cloudpickled ``(main, kwargs)``, its
    workers told ``restart`` (a RestartContext); rank 0's result."""
    import cloudpickle
    import torch.distributed as dist

    from sparkdl_tpu_torch.horovod.control_plane import ControlPlaneServer
    from sparkdl_tpu_torch.horovod.supervisor import GangFailure
    from sparkdl_tpu_torch.horovod.topology import Placement

    num_workers, per_card = _resolve_num_workers(np)
    job_dir = tempfile.mkdtemp(prefix="sparkdl-torch-job-")
    payload_path = os.path.join(job_dir, "payload.pkl")
    with open(payload_path, "wb") as f:
        f.write(payload)
    placement = Placement.single_host(num_workers)
    # local gangs stream their workers' output to the driver (reference
    # README.md:44-47); one-card-a-rank gangs honor driver_log_verbosity
    server = ControlPlaneServer(
        num_workers,
        verbosity=driver_log_verbosity if per_card else "all",
        log_path=os.path.join(job_dir, "job.log"))
    store = None
    procs, boot_logs = [], []
    try:
        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              wait_for_workers=False)
        logger.info("Launching HorovodRunner gang: %d worker(s), %s, "
                    "attempt %d, job_dir=%s", num_workers,
                    "one card a rank" if per_card else "local",
                    restart.attempt, job_dir)
        cmd = [sys.executable, "-m", "sparkdl_tpu_torch.horovod._worker",
               "--job-dir", job_dir, "--payload", payload_path,
               "--attempt", str(restart.attempt)]
        if restart.resume_step is not None:
            cmd += ["--resume-step", str(restart.resume_step)]
        if per_card:
            cmd.append("--per-card")
        for r in range(num_workers):
            env = _worker_env(
                os.environ, rank=r, size=num_workers, placement=placement,
                master_addr="127.0.0.1", master_port=store.port,
                control_addr=server.address, control_secret=server.secret)
            # output from before the worker's tee (an import error) lands
            # in its per-rank log too
            boot_log = open(os.path.join(job_dir, f"rank-{r}.log"), "ab",
                            buffering=0)
            boot_logs.append(boot_log)
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=boot_log, stderr=subprocess.STDOUT))

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
        while server.ready_count() < num_workers:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                server.wait_drained(1.0)  # the EXC frames of the dead
                fail("HorovodRunner gang failed to start: worker(s) "
                     f"{[r for r, c in enumerate(codes) if c]} exited "
                     f"during rendezvous (codes {codes}).", codes,
                     "start_failure")
            if time.monotonic() - start > START_TIMEOUT_S:
                fail(f"HorovodRunner gang failed to start: only "
                     f"{server.ready_count()}/{num_workers} workers reached "
                     f"the rendezvous within {START_TIMEOUT_S:.0f}s "
                     "(fail-fast, reference runner_base.py:54-58).", codes,
                     "rendezvous_timeout")
            time.sleep(0.05)
        logger.info("HorovodRunner gang ready in %.1f s",
                    time.monotonic() - start)

        first_death = None
        while any(p.poll() is None for p in procs):
            codes = [p.poll() for p in procs]
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
        server.wait_drained(5.0)
        if any(codes):
            fail(f"HorovodRunner job failed (exit codes {codes}).", codes,
                 "worker_death")
        result = server.result_bytes
        if result is None:
            fail("HorovodRunner job finished, but rank 0 returned no "
                 "result over the control plane.", codes, "no_result")
        return cloudpickle.loads(result)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in boot_logs:
            f.close()
        server.close()
        del store  # closes the rendezvous store's server
