"""Fault injection for testing a gang's fault tolerance.

Counterpart of ``sparkdl_tpu/utils/chaos.py``: the supervisor's relaunch
and resume, the hang detector and the elastic controller are only
trusted once driven under an adversarial schedule (a rank killed inside
a step, a stalled rendezvous, dropped control frames, a rank that hangs
in a step or stops its heartbeat, a host-memory leak). The faults are
hooks that do nothing unless one of this module's settings is set:

- :func:`chaos_step` (called by a chaos-aware main once a step): leaks
  :data:`LEAK_BYTES_PER_STEP` (every step, on :data:`LEAK_RANK` or every
  rank), hangs rank :data:`STALL_STEP_RANK` inside step
  :data:`STALL_STEP` forever (its heartbeat goes on: the hang
  detector's signature), and kills rank :data:`KILL_RANK` at step
  :data:`KILL_STEP` with :data:`KILL_SIGNAL` (SIGKILL: what preemption
  looks like from the driver);
- :func:`on_worker_boot` (the rank bootstrap, before ``hvd.init``):
  stalls :data:`RENDEZVOUS_STALL_S` (on :data:`RENDEZVOUS_STALL_RANK` or
  every rank), or kills :data:`KILL_RANK` when :data:`KILL_PHASE` is
  ``"boot"``;
- :func:`control_frame_fate` (the control-plane client, a frame at a
  time): ``"drop"`` for a frame named in :data:`CP_DROP` (READY, LOG,
  USERLOG, RESULT, EXC, BYE, TELEMETRY, HEARTBEAT, STACK_DUMP,
  PROFILE_DONE), else a delay of :data:`CP_DELAY_S`, else None;
- :func:`heartbeat_muted` (the heartbeat thread): rank
  :data:`MUTE_HEARTBEAT`'s beats stop while its process lives.

:data:`ONCE_FILE`: a path claimed atomically before a kill or an in-step
stall; the fault fires only for the process that creates it, so a
supervised relaunch runs clean. Every injection is a ``cat="chaos"``
timeline instant, flushed before a kill or a stall (a dropped frame's
is recorded, not flushed: the flush would go through the send path).

The settings are module attributes (the JAX module's
``SPARKDL_TPU_CHAOS_*`` variables; no environment variable is read),
all None by default. A gang's driver ships the ones it has set to every
rank, whether its telemetry is on or not
(:func:`sparkdl_tpu_torch.horovod._worker.rank_settings`), so set them
in the driver before ``HorovodRunner.run``.
"""

import os
import signal
import time

KILL_RANK = None
KILL_STEP = None  # None: step 0
KILL_SIGNAL = None  # None: SIGKILL
KILL_PHASE = None  # None: "step"; or "boot"
ONCE_FILE = None
RENDEZVOUS_STALL_S = None
RENDEZVOUS_STALL_RANK = None  # None: every rank
CP_DELAY_S = None
CP_DROP = None  # "READY,RESULT" or a list of frame names
STALL_STEP = None
STALL_STEP_RANK = None  # None: rank 0
MUTE_HEARTBEAT = None
LEAK_BYTES_PER_STEP = None
LEAK_RANK = None  # None: every rank

SETTINGS = ("KILL_RANK", "KILL_STEP", "KILL_SIGNAL", "KILL_PHASE",
            "ONCE_FILE", "RENDEZVOUS_STALL_S", "RENDEZVOUS_STALL_RANK",
            "CP_DELAY_S", "CP_DROP", "STALL_STEP", "STALL_STEP_RANK",
            "MUTE_HEARTBEAT", "LEAK_BYTES_PER_STEP", "LEAK_RANK")

# the injected leak: one written bytearray a step, never freed, so that
# the resident set grows at a known slope
_leaked = []


def settings():
    """The settings that are set, ``{name: value}`` (empty: inert)."""
    g = globals()
    return {name: g[name] for name in SETTINGS if g[name] is not None}


def _active():
    return bool(settings())


def _reset_for_tests():
    g = globals()
    for name in SETTINGS:
        g[name] = None
    del _leaked[:]


def _rank():
    return int(os.environ.get("RANK", "0"))


def _claim_once():
    """Claim the one-shot token atomically: True when this process owns
    the fault. Without :data:`ONCE_FILE` every match fires."""
    if not ONCE_FILE:
        return True
    try:
        fd = os.open(ONCE_FILE, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError:
        return False  # taken, or an unwritable dir: never fire blind
    os.close(fd)
    return True


def _flush_all():
    import sys

    from sparkdl_tpu_torch import observe

    observe.flush()
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001 - a closed stream
        pass


def _kill_self(phase="step", step=None):
    sig = int(signal.SIGKILL if KILL_SIGNAL is None else KILL_SIGNAL)
    from sparkdl_tpu_torch import observe

    # SIGKILL leaves no other trace: the instant goes out first
    observe.instant("chaos.kill", cat="chaos", rank=_rank(), phase=phase,
                    step=step, sig=sig)
    _flush_all()
    os.kill(os.getpid(), sig)
    # a catchable signal may take a moment to arrive
    time.sleep(5)


def _stall_in_step(step):
    """Hang this rank inside the step for good, its heartbeat alive."""
    from sparkdl_tpu_torch import observe

    observe.instant("chaos.stall_in_step", cat="chaos", rank=_rank(),
                    step=int(step))
    _flush_all()
    while True:  # until the launcher reaps the hung gang
        time.sleep(1)


def chaos_step(step):
    """A training main's hook, once a step: leak, hang or die here when
    this rank and step are the configured ones. Inert without a
    setting."""
    if not _active():
        return
    if LEAK_BYTES_PER_STEP is not None and (
            LEAK_RANK is None or int(LEAK_RANK) == _rank()):
        n = int(LEAK_BYTES_PER_STEP)
        if n > 0:
            buf = bytearray(n)
            buf[::4096] = b"\x01" * len(buf[::4096])  # the pages written
            _leaked.append(buf)
    if (STALL_STEP is not None and int(STALL_STEP) == int(step)
            and int(STALL_STEP_RANK or 0) == _rank() and _claim_once()):
        _stall_in_step(step)
    if KILL_RANK is None or int(KILL_RANK) != _rank():
        return
    if (KILL_PHASE or "step") != "step":
        return
    if int(step) != int(KILL_STEP or 0):
        return
    if _claim_once():
        _kill_self(phase="step", step=int(step))


def heartbeat_muted(rank):
    """The heartbeat's hook: True when this rank's beats are muted."""
    if not _active():
        return False
    return MUTE_HEARTBEAT is not None and int(MUTE_HEARTBEAT) == int(rank)


def on_worker_boot(rank):
    """The rank bootstrap's hook, before the rendezvous: stall or kill
    the configured rank. Inert without a setting."""
    if not _active():
        return
    stall = float(RENDEZVOUS_STALL_S or 0)
    if stall > 0 and (RENDEZVOUS_STALL_RANK is None
                      or int(RENDEZVOUS_STALL_RANK) == rank):
        from sparkdl_tpu_torch import observe

        observe.instant("chaos.stall", cat="chaos", rank=rank,
                        stall_s=stall)
        time.sleep(stall)
    if (KILL_PHASE == "boot" and KILL_RANK is not None
            and int(KILL_RANK) == rank and _claim_once()):
        _kill_self(phase="boot")


def _dropped_frames():
    raw = CP_DROP or ()
    if isinstance(raw, str):
        raw = raw.split(",")
    return {str(t).strip().upper() for t in raw if str(t).strip()}


def control_frame_fate(mtype_name):
    """The control-plane client's hook, a frame at a time: ``"drop"``,
    a delay in seconds, or None."""
    if not _active():
        return None
    if mtype_name in _dropped_frames():
        from sparkdl_tpu_torch import observe

        observe.instant("chaos.frame_drop", cat="chaos", rank=_rank(),
                        frame=mtype_name)
        return "drop"
    delay = float(CP_DELAY_S or 0)
    return delay if delay > 0 else None
