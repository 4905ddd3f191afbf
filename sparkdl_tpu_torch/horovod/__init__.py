"""Worker-side utilities of HorovodRunner jobs, and the runner itself
(:mod:`sparkdl_tpu_torch.horovod.runner_base`, the launcher, the
control plane and the worker bootstrap).

Counterpart of ``sparkdl_tpu/horovod/__init__.py``: ``log_to_driver``
sends a string from a worker to the driver, which prints it. The
supervisor's ``restart_context`` is not ported.
"""

MAX_LOG_MESSAGE_LENGTH = 4000  # reference sparkdl/horovod/__init__.py:23


def log_to_driver(message):
    """
    Send a log message (string type) to driver side, and driver will print
    log to stdout. If message length is greater than 4000, it will be
    truncated. (Contract: reference ``sparkdl/horovod/__init__.py:20-25``.)
    """
    if not isinstance(message, str):
        message = str(message)
    if len(message) > MAX_LOG_MESSAGE_LENGTH:
        message = message[:MAX_LOG_MESSAGE_LENGTH]
    from sparkdl_tpu_torch.horovod.control_plane import get_worker_client

    client = get_worker_client()
    if client is not None:
        client.send_user_log(message)
    else:
        # local mode: this process is the driver
        print(message, flush=True)


__all__ = ["log_to_driver"]
