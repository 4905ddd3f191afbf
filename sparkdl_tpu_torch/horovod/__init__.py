"""Worker-side utilities of HorovodRunner jobs, and the runner itself
(:mod:`sparkdl_tpu_torch.horovod.runner_base`, the launcher with its
slot registry and remote transport, the Spark barrier backend, the
supervisor, the control plane and the rank bootstrap).

Counterpart of ``sparkdl_tpu/horovod/__init__.py``: ``log_to_driver``
sends a string from a worker to the driver, which prints it;
``restart_context`` tells a worker which attempt of a supervised gang
it runs in and the checkpoint step to resume from.
"""

import collections

MAX_LOG_MESSAGE_LENGTH = 4000  # reference sparkdl/horovod/__init__.py:23


RestartContext = collections.namedtuple(
    "RestartContext",
    ["attempt", "resume_step", "source_axes", "target_axes"],
    defaults=[None, None],
)
RestartContext.__doc__ = """The gang supervisor's restart context.

``attempt``: how many times this gang has been relaunched (0 on the
first launch). ``resume_step``: the newest
:class:`~sparkdl_tpu_torch.utils.checkpoint.TrainCheckpointer` step
committed under the supervisor policy's ``resume_dir`` when this attempt
was launched, or None (start from scratch). ``source_axes`` /
``target_axes``: on a relaunch at another world size (an elastic
shrink or grow), the mesh axes (``{"data": 2, "fsdp": 1, "seq": 1,
"model": 1}``) the resume step was saved on and the ones derived for
the new world, from which the relaunched main rebuilds its mesh
(``make_mesh_from_axes(ctx.target_axes)``); None otherwise."""

# this process's context: the worker bootstrap sets it from its command
# line before main runs; outside a relaunch it stays the first attempt's
_context = RestartContext(0, None)
# the gang.resume instant goes once a context, however often main asks
_resume_noted = False


def _set_restart_context(context):
    global _context, _resume_noted
    _context = context
    _resume_noted = False


def restart_context():
    """The supervisor's restart context for this worker process.

    A checkpoint-aware main resumes where the previous attempt left
    off::

        ctx = restart_context()
        start = 0
        if ctx.resume_step is not None:
            state = ckpt.restore(ctx.resume_step, target=state)
            start = ckpt.last_restored_step + 1
        for step in range(start, total_steps):
            ...

    A relaunch at another world size also names the mesh to rebuild
    (``ctx.target_axes``) and restores onto it
    (``ckpt.restore(step, target_mesh=make_mesh_from_axes(
    ctx.target_axes))``).

    Outside a supervised relaunch (the first attempt, a gang without
    retries, local ``np=-1`` mode) it is ``RestartContext(0, None)``, so
    calling it unconditionally is always safe. With telemetry on, a
    relaunched worker's first call marks the ``gang.resume`` instant on
    its timeline.
    """
    global _resume_noted
    if _context.attempt > 0 and not _resume_noted:
        _resume_noted = True
        from sparkdl_tpu_torch import observe

        observe.instant("gang.resume", cat="supervisor",
                        attempt=_context.attempt,
                        resume_step=_context.resume_step,
                        source_axes=_context.source_axes,
                        target_axes=_context.target_axes)
    return _context


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


__all__ = ["log_to_driver", "restart_context", "RestartContext"]
