"""A HorovodRunner gang worker, and the bootstrap that every rank runs.

Counterpart of ``sparkdl_tpu/horovod/_worker.py``. The launcher runs
``python -m sparkdl_tpu_torch.horovod._worker --job-dir D --attempt A
[--resume-step S] [--device cuda|cpu]`` once for each rank, on this
host or through the remote shell, with the rank's ``torch.distributed``
environment and the control plane's address. Its standard input is the
boot stream: the control plane's secret on the first line, then the
cloudpickled payload, so neither is on a command line or in the
environment it starts with (a remote shell's command line is readable
on both hosts); the worker then puts the secret in its own environment
for the processes it starts.
``--device``: the launcher's decision
(:func:`sparkdl_tpu_torch.hvd._state.init`); without it the local
gang's backend rule applies.

:func:`run_rank` is the bootstrap of every rank, a worker process's and
a Spark barrier task's alike. It:

1. tees stdout and stderr to the rank's log file and, line by line, to
   the driver through the control plane's drop-oldest log ring (a
   driver slow to read never blocks a ``print``), and, in a worker
   process, asks the kernel to end it if the launcher dies;
2. binds the drop-in import names for the length of the run (``import
   horovod.torch as hvd`` gives
   :mod:`sparkdl_tpu_torch.compat.horovod_torch`);
3. joins the gang (``hvd.init`` with the launcher's device: a rank of a
   card gang binds ``cuda:LOCAL_RANK`` or raises);
4. sends READY;
5. sets its restart context (what
   :func:`sparkdl_tpu_torch.horovod.restart_context` returns), loads
   ``(main, kwargs)`` and runs ``main(**kwargs)``;
6. on rank 0, sends the cloudpickled return value as RESULT (a worker
   process) or returns it (a barrier task, whose result goes back
   through Spark's ``collect()``).

A failure anywhere sends the traceback (EXC); BYE ends every run. Then
the rank leaves its process group and its restart context is reset, so
that a process which runs another rank afterwards (a Python worker that
Spark reuses for the next job) joins that job's group, on its card. The
JAX worker's fault injection, compile cache and profiler are not ported.
"""

import argparse
import contextlib
import io
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


@contextlib.contextmanager
def worker_io(client, local_log_path, parent_death=True):
    """The rank's I/O for the length of its run: the driver watchdog,
    the parent-death signal (``parent_death``: a worker process, not a
    Spark task, whose process Spark owns), and stdout/stderr teed to the
    driver; on an exception, its traceback to the log and as an EXC
    frame; BYE last."""
    client.start_driver_watchdog()
    if parent_death:
        _set_parent_death_signal()
    local_log = open(local_log_path, "a", buffering=1)
    orig_stdout, orig_stderr = sys.stdout, sys.stderr
    sys.stdout = _TeeStream("stdout", local_log, client)
    sys.stderr = _TeeStream("stderr", local_log, client)
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
        client.send_bye(exit_code)
        client.close()
        local_log.close()


def run_rank(client, *, log_path, device, restart, load_payload,
             send_result=True, parent_death=True):
    """Run this rank (the module docstring's steps) and return rank 0's
    cloudpickled result (None on the other ranks). ``client``: a
    :class:`~sparkdl_tpu_torch.horovod.control_plane.ControlPlaneClient`
    to this job's driver, closed at the end; ``device``: the launcher's
    decision (``"cuda"``, ``"cpu"`` or None); ``restart``: the
    :class:`~sparkdl_tpu_torch.horovod.RestartContext`;
    ``load_payload()``: ``(main, kwargs)``; ``send_result``: rank 0
    sends its result as RESULT too. Raises what ``main`` raised, after
    its EXC frame."""
    import cloudpickle

    from sparkdl_tpu_torch import horovod, hvd
    from sparkdl_tpu_torch.compat import horovod_torch
    from sparkdl_tpu_torch.horovod.control_plane import worker_client
    from sparkdl_tpu_torch.hvd import _state

    try:
        with worker_client(client), worker_io(client, log_path,
                                              parent_death):
            # the payload may name horovod modules: bound before it is
            # unpickled
            with horovod_torch.bound():
                _state.init(device=device)
                client.send_ready()
                horovod._set_restart_context(restart)
                user_main, kwargs = load_payload()
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
                 restart=RestartContext(args.attempt, args.resume_step),
                 load_payload=lambda: cloudpickle.loads(
                     sys.stdin.buffer.read()))
    except BaseException:
        sys.exit(1)  # worker_io logged the traceback and sent it
    sys.exit(0)


if __name__ == "__main__":
    main()
