"""A HorovodRunner gang worker.

Counterpart of ``sparkdl_tpu/horovod/_worker.py``. The launcher runs
``python -m sparkdl_tpu_torch.horovod._worker --job-dir D --payload P
--attempt A [--resume-step S] [--per-card]`` once for each rank, with
the rank's ``torch.distributed`` environment and the control plane's
address and secret. The worker:

1. tees its stdout and stderr to ``D/rank-<r>.log`` and, line by line,
   to the driver through the control plane's drop-oldest log ring (a
   driver slow to read never blocks a ``print``), and asks the kernel
   to end it if the launcher dies;
2. in a one-card-a-rank gang (``--per-card``), requires its card;
3. binds the drop-in import names (``import horovod.torch as hvd``
   gives :mod:`sparkdl_tpu_torch.compat.horovod_torch`) and calls
   ``hvd.init()`` (binds the card, joins the process group);
4. sends READY;
5. stores its restart context (``--attempt``, ``--resume-step``: what
   :func:`sparkdl_tpu_torch.horovod.restart_context` returns), loads
   ``(main, kwargs)`` from the cloudpickled payload and runs
   ``main(**kwargs)``;
6. on rank 0, sends the cloudpickled return value as RESULT.

A failure anywhere sends the traceback (EXC) and exits 1; BYE ends every
run. The JAX worker's fault injection, compile cache and profiler are
not ported.
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
def worker_io(client, local_log_path):
    """The worker's I/O for the length of its run: the driver watchdog,
    the parent-death signal, and stdout/stderr teed to the driver; on an
    exception, its traceback to the log and as an EXC frame; BYE last."""
    client.start_driver_watchdog()
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


def _require_card():
    """A one-card-a-rank gang's worker finds its card, or raises: no
    such worker moves to the CPU or to a shared card."""
    import torch

    local_rank = int(os.environ["LOCAL_RANK"])
    local_size = int(os.environ["LOCAL_WORLD_SIZE"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < local_size:
        raise RuntimeError(
            f"rank {os.environ['RANK']} of a one-card-a-rank gang (local "
            f"rank {local_rank} of {local_size}) finds {cards} CUDA "
            "device(s)")


def main(argv=None):
    import cloudpickle

    from sparkdl_tpu_torch import horovod, hvd
    from sparkdl_tpu_torch.compat import horovod_torch
    from sparkdl_tpu_torch.horovod.control_plane import get_worker_client

    parser = argparse.ArgumentParser()
    parser.add_argument("--job-dir", required=True)
    parser.add_argument("--payload", required=True)
    parser.add_argument("--attempt", type=int, default=0)
    parser.add_argument("--resume-step", type=int, default=None)
    parser.add_argument("--per-card", action="store_true")
    args = parser.parse_args(argv)
    rank = int(os.environ["RANK"])
    # before the tee exists, stdout is the launcher's per-rank boot log
    client = get_worker_client()
    if client is None:
        sys.exit("a gang worker needs the launcher's control-plane address")
    try:
        with worker_io(client,
                       os.path.join(args.job_dir, f"rank-{rank}.log")):
            if args.per_card:
                _require_card()
            # for the life of the process: the payload may name horovod
            # modules, so this comes before it is unpickled
            horovod_torch.install()
            hvd.init()
            client.send_ready()
            horovod._set_restart_context(horovod.RestartContext(
                args.attempt, args.resume_step))
            with open(args.payload, "rb") as f:
                user_main, kwargs = cloudpickle.load(f)
            result = user_main(**kwargs)
            if hvd.rank() == 0:
                client.send_result(cloudpickle.dumps(result))
            hvd.shutdown()
    except BaseException:
        sys.exit(1)  # worker_io logged the traceback and sent it
    sys.exit(0)


if __name__ == "__main__":
    main()
