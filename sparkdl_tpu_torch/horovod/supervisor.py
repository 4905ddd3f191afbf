"""Gang supervision: a gang that fails transiently is launched again
under backoff and resumes from its latest checkpoint.

Counterpart of ``sparkdl_tpu/horovod/supervisor.py``. The launcher's
gangs are fail-fast (reference ``runner_base.py:54-58``): one rank dying
ends the run. The supervisor wraps each launch:

1. **Classify** the failure (:func:`classify_failure`): *transient* (a
   gang the hang detector declared hung; a rank killed by a signal, as
   preemption looks from the driver; a rendezvous timeout; a lost
   result; a rank whose traceback is the distributed runtime failing)
   or *permanent* (a user-code exception, slot exhaustion, bad
   arguments, anything unnamed). A permanent failure is raised at once.
2. **Relaunch** a transient one after :meth:`RetryPolicy.backoff`
   seconds, up to ``max_retries`` times.
3. **Resume**: each relaunch runs with a
   :class:`~sparkdl_tpu_torch.horovod.RestartContext` (its attempt
   number and the newest committed
   :class:`~sparkdl_tpu_torch.utils.checkpoint.TrainCheckpointer` step
   under ``resume_dir``), which the workers read with
   :func:`~sparkdl_tpu_torch.horovod.restart_context`.
4. **Exhaust loudly**: :class:`GangRetryBudgetExhausted` names every
   attempt with its classified cause.

**Elastic relaunch.** A relaunch may run at another world size: the
operator's :attr:`RetryPolicy.relaunch_np` (the JAX package's
``SPARKDL_TPU_GANG_RELAUNCH_NP``) or, with it unset, the active
:class:`~sparkdl_tpu_torch.horovod.elastic.ElasticController`'s target
(a planned resize, or the current world clamped to the probed capacity).
Before the backoff, the target goes through the reshard pre-flight
(:func:`~sparkdl_tpu_torch.analysis.comms.check_relaunch_np` against the
tree registered with :func:`sparkdl_tpu_torch.analysis.
register_gang_sharding`): an infeasible target of the operator's raises
the typed ``ReshardPreflightError``; one of the controller's cancels its
plan (``"reshard_preflight_refused"``) and the relaunch keeps the
current world. The relaunch's restart context carries the mesh axes it
comes from (the registry's, else the resume step's sidecar) and the
ones :func:`~sparkdl_tpu_torch.analysis.comms.shrink_mesh` derives for
the target, and the launcher resizes the gang to the target. A resize
the controller planned (a ``GangFailure`` of kind ``"elastic_resize"``)
takes no retry budget and no backoff, and lands as a ``gang.resize``
instant instead of ``gang.failure``.

The policy is the module's :data:`policy`, which
:func:`~sparkdl_tpu_torch.horovod.launcher.launch_gang` reads at call
time; its default (``max_retries=0``) turns supervision off. No
environment variable is read (``RetryPolicy.from_env`` is not ported):
``extra_patterns`` takes the place of ``SPARKDL_TPU_TRANSIENT_PATTERNS``.
With telemetry on, each attempt lands on the driver's timeline and
metrics as in the JAX package: the ``gang.attempt``, ``gang.failure``,
``gang.resize``, ``gang.reshard_preflight`` and ``gang.reshard_refused``
instants, ``gang_attempts_total``, ``gang_failures_total{verdict}``,
``gang_restarts_total`` and the ``gang.backoff`` span. The launcher
records each attempt's world size (:func:`record_attempt_world`), which
``/statusz`` reads.
"""

import dataclasses
import logging
import random
import re
import time

logger = logging.getLogger("HorovodRunner")

TRANSIENT = "transient"
PERMANENT = "permanent"

# Infrastructure signatures of a worker's terminal exception block
# (case-insensitive substrings). The JAX list without its jax.distributed
# entries ("coordination service", "heartbeat") and without the bare word
# "gloo": torch's gloo names its source path in every enforce failure,
# misuse included ("[enforce fail at .../gloo/transport/tcp/pair.cc:456]
# op.preamble.length <= op.nbytes ... Is there a distributed collective
# mismatch in your code?"), so the word alone would relaunch a user bug.
# torch.distributed's own transport failures take their place.
TRANSIENT_SIGNATURES = (
    "connection reset",
    "connection closed",            # gloo: "Connection closed by peer"
    "connection refused",
    "connection aborted",
    "broken pipe",
    "socket closed",
    "address already in use",       # rendezvous port clash
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable:",
    "failed to connect",
    "barrier timed out",
    "rendezvous",
    "preempt",
    "timed out waiting",            # gloo: a recv or send past its timeout
    "remote process exited or there was a network error",  # ncclRemoteError
    "communicator was aborted",     # NCCL: a communicator aborted on a rank
)

# Exception types of the terminal block that are the runtime failing,
# whatever their message: the socket errors, and torch.distributed's
# network errors and store timeouts. A DistBackendError is not among them:
# it also reports misuse (an NCCL invalid usage), which stays permanent.
_INFRA_TYPES = re.compile(
    r"(\w+\.)*(Connection(Reset|Refused|Aborted)?Error|BrokenPipeError|"
    r"TimeoutError|socket\.timeout|DistNetworkError)\b"
    r"|(\w+\.)*DistStoreError\b.*(?i:timed out|timeout)",
    re.S)


class GangFailure(RuntimeError):
    """A launched gang failed. ``kind``: ``"start_failure"``,
    ``"rendezvous_timeout"``, ``"worker_death"``, ``"no_result"``,
    ``"job_timeout"``, ``"hang"``, ``"elastic_resize"`` (the launcher
    recycled the gang for the elastic controller's planned resize) or
    ``"cancelled"`` (its caller ended it: ``launch_gang(cancel=)``);
    ``exit_codes``: each rank's (negative: killed by that signal);
    ``exceptions``: rank -> traceback text of its EXC frame;
    ``hang_verdict``: the hang detector's verdict of a ``"hang"``;
    ``elastic_direction`` and ``elastic_target``: a resize's direction
    and np. A RuntimeError, so callers that catch one keep working."""

    def __init__(self, message, *, kind="unknown", exit_codes=None,
                 exceptions=None, hang_verdict=None, elastic_direction=None,
                 elastic_target=None):
        super().__init__(message)
        self.kind = kind
        self.exit_codes = list(exit_codes or [])
        self.exceptions = dict(exceptions or {})
        self.hang_verdict = hang_verdict
        self.elastic_direction = elastic_direction
        self.elastic_target = elastic_target


@dataclasses.dataclass
class AttemptRecord:
    """One launch attempt, as named in the exhaustion error."""
    number: int
    verdict: str  # TRANSIENT | PERMANENT
    cause: str

    def __str__(self):
        return f"attempt {self.number}: {self.verdict} — {self.cause}"


class GangRetryBudgetExhausted(RuntimeError):
    """Every relaunch in the budget failed transiently; the message names
    every attempt with its classified cause."""

    def __init__(self, attempts, budget):
        self.attempts = list(attempts)
        self.budget = budget
        lines = "\n".join(f"  {a}" for a in self.attempts)
        super().__init__(
            f"HorovodRunner gang failed {len(self.attempts)} time(s); "
            f"retry budget ({budget} relaunch(es)) exhausted. "
            f"Attempt log:\n{lines}")


def _is_message_line(ln):
    return (ln and not ln[0].isspace()
            and not ln.startswith("Traceback (")
            and not ln.startswith("During handling")
            and not ln.startswith("The above exception"))


def _terminal_block(tb_text):
    """The traceback's final exception, type line and whole message: from
    the first unindented line after the last frame line to the end. Frame
    lines and source echoes are left out, so a user file path or source
    line that mentions "rendezvous" never reads as infrastructure.

    The JAX function starts at the last unindented line instead, which
    drops the first lines of a message that spans several: NCCL's
    errors do ("NCCL error in: ..., remote process exited or there was a
    network error, ...\\nncclRemoteError: ...\\nLast error:\\n...")."""
    lines = tb_text.rstrip().splitlines()
    last_frame = max((i for i, ln in enumerate(lines)
                      if ln.startswith("  File ")), default=-1)
    start = next((i for i in range(last_frame + 1, len(lines))
                  if _is_message_line(lines[i])), None)
    if start is None:  # no message after the frames: the last line
        start = max((i for i, ln in enumerate(lines)
                     if _is_message_line(ln)), default=0)
    return "\n".join(lines[start:])


def _is_infra_traceback(tb_text, extra_patterns=()):
    """True when a worker's EXC frame is the distributed runtime failing,
    judged on its terminal exception block alone."""
    if not tb_text.strip():
        return False
    term = _terminal_block(tb_text)
    if _INFRA_TYPES.match(term):
        return True
    low = term.lower()
    return any(sig in low for sig in TRANSIENT_SIGNATURES
               + tuple(p.lower() for p in extra_patterns))


def classify_failure(exc, extra_patterns=()):
    """(verdict, cause) of a failed launch; a *permanent* one is never
    relaunched.

    - A resize the elastic controller planned: transient (the relaunch
      is its purpose), judged first, since the launcher's kill looks
      like signal deaths.
    - A gang its caller cancelled (``launch_gang(cancel=)``): permanent,
      judged first, since the launcher's kill looks like signal deaths.
    - A gang the hang detector declared hung: transient (the launcher
      took its stack dumps and killed it; its state is in the
      checkpoint), judged first, since that kill looks like signal
      deaths and a rank may have raised while dying.
    - Slot exhaustion, a slot wait that timed out, remote ranks that
      cannot be started, and bad arguments: permanent.
    - A worker EXC frame that is not infrastructure: permanent (user
      code raised; running it again reproduces the bug).
    - A rendezvous timeout, a lost result, ranks killed by signals, EXC
      frames that are all infrastructure: transient.
    - Anything else (a worker exiting 1 with no traceback, a job past
      its time limit): permanent, since what cannot be named is not
      retried blindly.

    ``extra_patterns``: more infrastructure signatures
    (:attr:`RetryPolicy.extra_patterns`).
    """
    from sparkdl_tpu_torch.horovod.launcher import (
        RemoteTransportError,
        SlotExhaustionError,
        SlotWaitTimeout,
    )

    if isinstance(exc, (SlotExhaustionError, SlotWaitTimeout,
                        RemoteTransportError)):
        return PERMANENT, f"{type(exc).__name__} (cannot self-heal)"
    if isinstance(exc, (ValueError, TypeError)):
        return PERMANENT, f"bad arguments ({type(exc).__name__})"
    if isinstance(exc, GangFailure):
        if exc.kind == "cancelled":
            return PERMANENT, "CANCELLED — its caller ended the gang"
        if exc.kind == "elastic_resize":
            return TRANSIENT, (
                f"ELASTIC ({exc.elastic_direction or 'resize'}) — planned "
                f"resize to np={exc.elastic_target}; relaunching from "
                "checkpoint")
        if exc.kind == "hang":
            return TRANSIENT, (
                f"HANG ({exc.hang_verdict or 'hung'}) — gang made no "
                "progress; stack dumps captured, relaunching from "
                "checkpoint")
        user_ranks = [r for r, tb in sorted(exc.exceptions.items())
                      if not _is_infra_traceback(tb, extra_patterns)]
        if user_ranks:
            return PERMANENT, f"user-code exception on rank(s) {user_ranks}"
        if exc.kind == "rendezvous_timeout":
            return TRANSIENT, "gang rendezvous timed out"
        if exc.kind == "no_result":
            return TRANSIENT, "rank 0 result lost on the control plane"
        killed = [(r, -c) for r, c in enumerate(exc.exit_codes)
                  if c and c < 0]
        if killed:
            return TRANSIENT, (
                "rank(s) killed by signal "
                + ", ".join(f"{r} (sig {s})" for r, s in killed)
                + " — preemption-like")
        if exc.exceptions:  # all infrastructure, no signal deaths
            return TRANSIENT, ("infrastructure failure on rank(s) "
                               f"{sorted(exc.exceptions)}")
        return PERMANENT, (
            f"unclassified worker failure (kind={exc.kind}, exit codes "
            f"{exc.exit_codes}) — not retried blindly")
    return PERMANENT, f"unclassified {type(exc).__name__} (not retried)"


@dataclasses.dataclass
class RetryPolicy:
    """Relaunch budget, backoff schedule, resume source, extra transient
    signatures and ``relaunch_np``: the world size of every relaunch
    (None: the elastic controller's target, else the configured np)."""
    max_retries: int = 0
    backoff_base: float = 1.0
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    jitter: float = 0.5
    resume_dir: str = None
    extra_patterns: tuple = ()
    relaunch_np: int = None

    def backoff(self, attempt, _random=random.random):
        """Seconds before relaunch number ``attempt`` (1-based): capped
        exponential, plus up to ``jitter`` of it on top."""
        base = min(self.backoff_base * self.backoff_factor ** (attempt - 1),
                   self.backoff_max)
        return base * (1.0 + self.jitter * _random())


# the policy launch_gang supervises with; replace it to turn retries on
policy = RetryPolicy()

# the world size and the wall-clock start of each launch attempt of the
# current supervised launch, for /statusz
_attempt_worlds = []
_attempt_stamps = []


def record_attempt_world(num_workers):
    """Launcher hook: one resolved gang size a launch attempt."""
    _attempt_worlds.append(int(num_workers))
    _attempt_stamps.append(time.time())


def attempt_world_sizes():
    """World sizes of this driver's launch attempts, oldest first."""
    return list(_attempt_worlds)


def attempt_chip_hours(now=None):
    """Card-hours an attempt (world size x the attempt's wall time), the
    last one up to ``now``; None where an attempt's start is unknown."""
    now = time.time() if now is None else now
    out = []
    for i, world in enumerate(_attempt_worlds):
        t0 = _attempt_stamps[i] if i < len(_attempt_stamps) else None
        if t0 is None:
            out.append({"attempt": i + 1, "world": world,
                        "chip_hours": None})
            continue
        t1 = (_attempt_stamps[i + 1]
              if i + 1 < len(_attempt_stamps) else now)
        out.append({
            "attempt": i + 1, "world": world,
            "chip_hours": round(world * max(0.0, t1 - t0) / 3600.0, 6),
        })
    return out


def _resume_step(policy):
    if not policy.resume_dir:
        return None
    from sparkdl_tpu_torch.utils.checkpoint import latest_complete_step

    return latest_complete_step(policy.resume_dir)


def _relaunch_np_target(policy):
    """The world size of the next relaunch, or None (the configured
    np): the policy's ``relaunch_np`` wins; else the active elastic
    controller's answer (a planned resize's target, or the current
    world clamped to the probed capacity)."""
    if policy.relaunch_np is not None:
        return int(policy.relaunch_np)
    from sparkdl_tpu_torch.horovod import elastic

    ctrl = elastic.active_controller()
    if ctrl is not None:
        try:
            return ctrl.relaunch_target()
        except Exception:  # noqa: BLE001 - a probe failure keeps the np
            logger.warning("elastic relaunch-target probe failed",
                           exc_info=True)
    return None


def _reshard_preflight(target_np):
    """Check a relaunch at ``target_np`` before the backoff: an
    infeasible one raises the typed ``ReshardPreflightError`` here, on
    the driver, not mid-restore on the cards. Returns the ReshardPlan,
    or None when no sharding tree is registered (nothing provable)."""
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.analysis.comms import (
        ReshardPreflightError,
        check_relaunch_np,
    )

    try:
        plan = check_relaunch_np(target_np)
    except ReshardPreflightError as e:
        observe.instant("gang.reshard_refused", cat="supervisor",
                        target_np=target_np,
                        problems=[str(f) for f in e.findings[:4]])
        logger.error("elastic relaunch at np=%d refused by the reshard "
                     "pre-flight; not relaunching: %s", target_np, e)
        raise
    if plan is not None:
        observe.instant("gang.reshard_preflight", cat="supervisor",
                        target_np=target_np, feasible=True,
                        restore_high_water_bytes=
                        plan.restore_high_water_bytes)
        logger.info("elastic relaunch at np=%d cleared the reshard "
                    "pre-flight (target mesh %s, restore high-water %.2f "
                    "GiB)", target_np, plan.target_axes,
                    plan.restore_high_water_bytes / 2**30)
    return plan


def _reshard_axes(policy, target_np, resume_step):
    """(source_axes, target_axes) of a relaunch at ``target_np``: the
    source from the registered gang sharding, else from the resume
    step's sidecar; the target by ``shrink_mesh``. ``(None, None)``
    when no source is known (the workers then take their own
    defaults)."""
    from sparkdl_tpu_torch.analysis.comms import (
        registered_gang_sharding,
        shrink_mesh,
    )

    src = None
    reg = registered_gang_sharding()
    if reg is not None:
        src = dict(reg["source_axes"])
    if not src and policy.resume_dir and resume_step is not None:
        from sparkdl_tpu_torch.utils.checkpoint import (
            load_sharding_tree,
            sidecar_mesh_axes,
        )

        doc = load_sharding_tree(policy.resume_dir, resume_step)
        if doc is not None:
            src = sidecar_mesh_axes(doc)
    if not src:
        return None, None
    tgt, _reason = shrink_mesh(src, int(target_np))
    return src, tgt


def supervise(launch, policy, _sleep=time.sleep):
    """Run ``launch(context)`` under ``policy`` and return its result.

    ``launch`` takes the attempt's
    :class:`~sparkdl_tpu_torch.horovod.RestartContext` and raises on
    failure; a relaunch at another world size (:func:`_relaunch_np_target`)
    calls ``launch(context, world)``. The first attempt gets
    ``RestartContext(0, None)``; each relaunch its number, the newest
    committed step under ``policy.resume_dir`` (read after the backoff)
    and, at a target world size, the source and target mesh axes. A
    relaunch at a target moves the registered gang sharding's axes to
    the target's, the source of the next relaunch.
    """
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.analysis.comms import note_gang_axes
    from sparkdl_tpu_torch.horovod import RestartContext
    from sparkdl_tpu_torch.utils import locksan

    # the opt-in lock-order sanitizer (locksan.ENABLED), installed before
    # the control plane's and the elastic controller's threads make
    # their locks, so that every one of them is instrumented from birth
    locksan.maybe_install()

    attempts = []
    attempt = 1
    budget_used = 0  # only unplanned transient failures take budget
    del _attempt_worlds[:]  # each supervised launch its own
    del _attempt_stamps[:]
    while True:
        target_np = None
        context = RestartContext(0, None)
        if attempt > 1:
            step = _resume_step(policy)
            target_np = _relaunch_np_target(policy)
            src = tgt = None
            if target_np is not None:
                src, tgt = _reshard_axes(policy, target_np, step)
                note_gang_axes(tgt)
            context = RestartContext(attempt - 1, step, src, tgt)
        observe.inc("gang_attempts_total")
        observe.instant("gang.attempt", cat="supervisor", attempt=attempt)
        try:
            if target_np is None:
                return launch(context)
            return launch(context, target_np)
        except Exception as e:
            verdict, cause = classify_failure(e, policy.extra_patterns)
            planned = getattr(e, "kind", None) == "elastic_resize"
            attempts.append(AttemptRecord(attempt, verdict, cause))
            first_line = (str(e).splitlines() or ["<no message>"])[0]
            if planned:
                # the controller's resize, not a failure
                observe.instant("gang.resize", cat="supervisor",
                                attempt=attempt, cause=cause,
                                direction=e.elastic_direction,
                                target_np=e.elastic_target)
                logger.info("HorovodRunner gang recycling for a planned "
                            "elastic resize (attempt %d: %s)", attempt,
                            cause)
            else:
                observe.instant("gang.failure", cat="supervisor",
                                attempt=attempt, verdict=verdict,
                                cause=cause,
                                kind=getattr(e, "kind", type(e).__name__))
                observe.inc("gang_failures_total", verdict=verdict)
            if verdict == PERMANENT:
                # a gang its caller cancelled did not fail
                log = (logger.info if getattr(e, "kind", None) == "cancelled"
                       else logger.error)
                log("HorovodRunner gang failed permanently on attempt %d "
                    "(%s); not retrying: %s", attempt, cause, first_line)
                raise
            if not planned:
                budget_used += 1
                if budget_used > policy.max_retries:
                    if policy.max_retries > 0:
                        raise GangRetryBudgetExhausted(
                            attempts, policy.max_retries) from e
                    raise  # supervision off: surface untouched
            target = _relaunch_np_target(policy)
            if target is not None:
                # before the backoff: an infeasible operator target raises;
                # the controller's plan is cancelled instead
                try:
                    _reshard_preflight(target)
                except Exception:
                    if policy.relaunch_np is not None:
                        raise
                    from sparkdl_tpu_torch.horovod import elastic

                    ctrl = elastic.active_controller()
                    if ctrl is None:
                        raise
                    ctrl.cancel_pending("reshard_preflight_refused")
            delay = 0.0 if planned else policy.backoff(budget_used)
            resume = _resume_step(policy)
            if not planned:
                logger.warning(
                    "HorovodRunner gang failed transiently (attempt %d, "
                    "retry %d/%d: %s); relaunching in %.1fs%s: %s", attempt,
                    budget_used, policy.max_retries, cause, delay,
                    "" if resume is None
                    else f" (will resume from step {resume})", first_line)
            observe.inc("gang_restarts_total")
            if delay > 0:
                with observe.span("gang.backoff", cat="supervisor",
                                  attempt=attempt, delay_s=round(delay, 3),
                                  resume_step=resume):
                    _sleep(delay)
            attempt += 1
