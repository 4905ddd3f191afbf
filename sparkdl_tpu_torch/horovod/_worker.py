"""A HorovodRunner gang worker, and the bootstrap that every rank runs.

Counterpart of ``sparkdl_tpu/horovod/_worker.py``. The launcher runs
``python -m sparkdl_tpu_torch.horovod._worker --job-dir D --attempt A
[--resume-step S] [--source-axes JSON --target-axes JSON]
[--device cuda|cpu] [--telemetry JSON] [--rank-settings JSON]`` once
for each rank, on this
host or through the remote shell, with the rank's ``torch.distributed``
environment and the control plane's address. Its standard input is the
boot stream: the control plane's secret on the first line, then the
cloudpickled payload, so neither is on a command line or in the
environment it starts with (a remote shell's command line is readable
on both hosts); the worker then puts the secret in its own environment
for the processes it starts.
``--device``: the launcher's decision
(:func:`sparkdl_tpu_torch.hvd._state.init`); without it the local
gang's backend rule applies. ``--telemetry``: the driver's
:func:`sparkdl_tpu_torch.observe.worker_settings` when its telemetry is
on (the rank applies them; it reads none from its environment).
``--rank-settings``: the driver's :func:`rank_settings`, the fault
injection's and the profiler's settings, shipped whether telemetry is
on or not. ``--attempt``, ``--resume-step`` and the axes: the restart
context.

:func:`run_rank` is the bootstrap of every rank, a worker process's and
a Spark barrier task's alike. It:

1. tees stdout and stderr to the rank's log file and, line by line, to
   the driver through the control plane's drop-oldest log ring (a
   driver slow to read never blocks a ``print``), and, in a worker
   process, asks the kernel to end it if the launcher dies;
2. binds the drop-in import names for the length of the run (``import
   horovod.torch as hvd`` gives
   :mod:`sparkdl_tpu_torch.compat.horovod_torch`);
3. runs the fault injection's boot hook
   (:func:`sparkdl_tpu_torch.utils.chaos.on_worker_boot`), then joins
   the gang (``hvd.init`` with the launcher's device: a rank of a card
   gang binds ``cuda:LOCAL_RANK`` or raises);
4. sends READY;
5. sets its restart context (what
   :func:`sparkdl_tpu_torch.horovod.restart_context` returns), loads
   ``(main, kwargs)`` and runs ``main(**kwargs)``, under a profiler
   window when the driver set
   :data:`sparkdl_tpu_torch.utils.profiler.PROFILE_DIR`;
6. on rank 0, sends the cloudpickled return value as RESULT (a worker
   process) or returns it (a barrier task, whose result goes back
   through Spark's ``collect()``).

A failure anywhere sends the traceback (EXC); BYE ends every run. Then
the rank leaves its process group and its restart context is reset, so
that a process which runs another rank afterwards (a Python worker that
Spark reuses for the next job) joins that job's group, on its card.

With the driver's telemetry on, step 1 also sets the control plane as
the telemetry sink and starts the flusher, opens the rank's flight
recorder in its job dir (none for a Spark barrier task, which has no job
dir the driver reads), starts the perf-forensics capture service there
(:mod:`sparkdl_tpu_torch.observe.capture`: the driver's PROFILE_REQ
frames), the heartbeat and the memory sampler, and emits
``worker.start``; at the end it emits ``worker.exit``, stops them and
flushes once more, before BYE (the driver takes BYE as the rank's last
word). The heartbeat and the sampler start before ``hvd.init``:
they read no card until it is bound (:mod:`sparkdl_tpu_torch.observe.
health`). Before them the bootstrap imports ``torch._dynamo``, which a
process's first optimizer imports otherwise (seconds of host time): in
``main``, after its first observed collective, that gap would count
against ``health.STALL_S``. The JAX worker's compile cache has no
counterpart.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import traceback


class _TeeStream(io.TextIOBase):
    """Line-buffered tee: complete lines go to the control plane's log
    ring (never blocking), every write to the local per-rank log."""

    def __init__(self, stream_name, local_file, client):
        self.stream_name = stream_name
        self.local_file = local_file
        self.client = client
        self._buf = ""

    def write(self, s):
        if not isinstance(s, str):
            s = s.decode("utf-8", "replace")
        self.local_file.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.client.send_log(self.stream_name, line)
        return len(s)

    def flush(self):
        self.local_file.flush()
        if self._buf:
            self.client.send_log(self.stream_name, self._buf)
            self._buf = ""

    def writable(self):
        return True


# the module settings a driver ships to its ranks whether its telemetry
# is on or not: "chaos.NAME" (the fault injection's) and
# "profiler.PROFILE_DIR"
def _rank_setting_owners():
    from sparkdl_tpu_torch.utils import chaos, profiler

    return {"chaos": chaos, "profiler": profiler}


def rank_settings():
    """The fault injection's settings that are set and the profiler's
    ``PROFILE_DIR``, ``{"module.NAME": value}``, or None when none is:
    what a driver ships to its ranks."""
    from sparkdl_tpu_torch.utils import chaos, profiler

    out = {f"chaos.{k}": v for k, v in chaos.settings().items()}
    if profiler.PROFILE_DIR:
        out["profiler.PROFILE_DIR"] = profiler.PROFILE_DIR
    return out or None


def applied_rank_settings(settings):
    """The driver's :func:`rank_settings` in force for the block (None:
    nothing changes), the previous values back after it."""
    from sparkdl_tpu_torch import observe

    return observe.applied_module_settings(settings, _rank_setting_owners)


def _set_parent_death_signal():
    """Linux: SIGTERM this worker when its parent (the launcher) dies,
    beside the control-plane watchdog."""
    import ctypes
    import signal

    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:
        return  # not glibc: the watchdog alone ends an orphan
    pr_set_pdeathsig = 1
    libc.prctl(pr_set_pdeathsig, signal.SIGTERM)


def _start_telemetry(client, rank, job_dir):
    """The rank's telemetry (the module docstring's list); returns what
    :func:`_stop_telemetry` stops."""
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.observe import flightrec, mem
    from sparkdl_tpu_torch.observe.capture import maybe_start_capture_service
    from sparkdl_tpu_torch.observe.health import HeartbeatSender

    # the first optimizer's import, taken before the hang window opens
    import torch._dynamo  # noqa: F401

    observe.set_sink(client.send_telemetry)
    observe.start_flusher()
    recorder = None
    if job_dir:
        mem.set_job_dir(job_dir)
        try:
            recorder = flightrec.FlightRecorder(
                flightrec.ring_path(job_dir, rank))
            observe.set_flight_recorder(recorder)
        except OSError:
            recorder = None  # an unwritable dir: the rest still works
    # its tap chains over the flight recorder's mirror
    capture = maybe_start_capture_service(client, rank, job_dir)
    heartbeat = HeartbeatSender(client, rank)
    heartbeat.start()
    mem.maybe_start_sampler()
    observe.instant("worker.start", cat="worker", rank=rank)
    return heartbeat, recorder, capture


def _stop_telemetry(started, rank, exit_code):
    """Stop the rank's telemetry and flush its tail, before BYE."""
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.observe import mem

    heartbeat, recorder, capture = started
    heartbeat.stop()
    mem.stop_sampler()
    if capture is not None:
        # before the recorder its tap chains to; a capture in flight
        # writes its trace and sends PROFILE_DONE before BYE
        capture.stop(join_timeout=60.0)
    observe.instant("worker.exit", cat="worker", rank=rank,
                    exit_code=exit_code)
    observe.stop_flusher()
    observe.flush()
    observe.set_sink(None)
    mem.set_job_dir(None)
    if recorder is not None:
        observe.set_flight_recorder(None)
        recorder.close()


@contextlib.contextmanager
def worker_io(client, local_log_path, parent_death=True, job_dir=None):
    """The rank's I/O for the length of its run: the driver watchdog,
    the parent-death signal (``parent_death``: a worker process, not a
    Spark task, whose process Spark owns), stdout/stderr teed to the
    driver, and, with telemetry on, the rank's telemetry (its flight
    recorder in ``job_dir``); on an exception, its traceback to the log
    and as an EXC frame; the last telemetry flush, then BYE, last."""
    from sparkdl_tpu_torch import observe

    client.start_driver_watchdog()
    if parent_death:
        _set_parent_death_signal()
    local_log = open(local_log_path, "a", buffering=1)
    orig_stdout, orig_stderr = sys.stdout, sys.stderr
    sys.stdout = _TeeStream("stdout", local_log, client)
    sys.stderr = _TeeStream("stderr", local_log, client)
    telemetry = (_start_telemetry(client, client.rank, job_dir)
                 if observe.enabled() else None)
    exit_code = 0
    try:
        yield
    except BaseException:
        exit_code = 1
        tb = traceback.format_exc()
        sys.stderr.write(tb + "\n")
        client.send_exception(tb)
        raise
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        sys.stdout, sys.stderr = orig_stdout, orig_stderr
        if telemetry is not None:
            _stop_telemetry(telemetry, client.rank, exit_code)
        client.send_bye(exit_code)
        client.close()
        local_log.close()


def run_rank(client, *, log_path, device, restart, load_payload,
             send_result=True, parent_death=True, telemetry=None,
             job_dir=None, settings=None):
    """Run this rank (the module docstring's steps) and return rank 0's
    cloudpickled result (None on the other ranks). ``client``: a
    :class:`~sparkdl_tpu_torch.horovod.control_plane.ControlPlaneClient`
    to this job's driver, closed at the end; ``device``: the launcher's
    decision (``"cuda"``, ``"cpu"`` or None); ``restart``: the
    :class:`~sparkdl_tpu_torch.horovod.RestartContext`;
    ``load_payload()``: ``(main, kwargs)``; ``send_result``: rank 0
    sends its result as RESULT too; ``telemetry``: the driver's
    :func:`~sparkdl_tpu_torch.observe.worker_settings` (None: off),
    in force for the run; ``job_dir``: where the rank's flight recorder
    and OOM report go; ``settings``: the driver's :func:`rank_settings`,
    in force for the run. Raises what ``main`` raised, after its EXC
    frame."""
    import cloudpickle

    from sparkdl_tpu_torch import horovod, hvd, observe
    from sparkdl_tpu_torch.compat import horovod_torch
    from sparkdl_tpu_torch.horovod.control_plane import worker_client
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.utils import chaos, profiler

    try:
        with observe.applied_settings(telemetry), \
                applied_rank_settings(settings), worker_client(client), \
                worker_io(client, log_path, parent_death, job_dir):
            # the payload may name horovod modules: bound before it is
            # unpickled
            with horovod_torch.bound():
                chaos.on_worker_boot(client.rank)
                _state.init(device=device)
                client.send_ready()
                horovod._set_restart_context(restart)
                user_main, kwargs = load_payload()
                with profiler.maybe_trace_worker(client.rank):
                    result = user_main(**kwargs)
                if hvd.rank() != 0:
                    return None
                pickled = cloudpickle.dumps(result)
                if send_result:
                    client.send_result(pickled)
                return pickled
    finally:
        hvd.shutdown()
        horovod._set_restart_context(horovod.RestartContext(0, None))


def main(argv=None):
    import cloudpickle

    from sparkdl_tpu_torch.horovod import RestartContext
    from sparkdl_tpu_torch.horovod.control_plane import (
        CONTROL_ADDR_ENV,
        CONTROL_SECRET_ENV,
        ControlPlaneClient,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--job-dir", required=True)
    parser.add_argument("--attempt", type=int, default=0)
    parser.add_argument("--resume-step", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None)
    parser.add_argument("--source-axes", type=json.loads, default=None)
    parser.add_argument("--target-axes", type=json.loads, default=None)
    parser.add_argument("--telemetry", type=json.loads, default=None)
    parser.add_argument("--rank-settings", type=json.loads, default=None)
    args = parser.parse_args(argv)
    rank = int(os.environ["RANK"])
    # before the tee exists, stdout is the launcher's per-rank boot log
    addr = os.environ.get(CONTROL_ADDR_ENV)
    if not addr:
        sys.exit("a gang worker needs the launcher's control-plane address")
    # the boot stream: the secret's line now; the payload, which may be
    # large, waits in the pipe until after READY
    secret = sys.stdin.buffer.readline().rstrip(b"\n").decode()
    if not secret:
        sys.exit("a gang worker needs the control plane's secret: refusing "
                 "an unauthenticated channel to the driver")
    # for the processes this rank starts (their log_to_driver); no
    # command line shows it
    os.environ[CONTROL_SECRET_ENV] = secret
    # a remote host has no copy of the driver's job dir
    os.makedirs(args.job_dir, exist_ok=True)
    client = ControlPlaneClient(addr, rank, secret)
    try:
        run_rank(client,
                 log_path=os.path.join(args.job_dir, f"rank-{rank}.log"),
                 device=args.device,
                 restart=RestartContext(args.attempt, args.resume_step,
                                        args.source_axes, args.target_axes),
                 load_payload=lambda: cloudpickle.loads(
                     sys.stdin.buffer.read()),
                 telemetry=args.telemetry, job_dir=args.job_dir,
                 settings=args.rank_settings)
    except BaseException:
        sys.exit(1)  # worker_io logged the traceback and sent it
    sys.exit(0)


if __name__ == "__main__":
    main()
