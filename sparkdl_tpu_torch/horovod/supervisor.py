"""Gang supervision: a gang that fails transiently is launched again
under backoff and resumes from its latest checkpoint.

Counterpart of ``sparkdl_tpu/horovod/supervisor.py``. The launcher's
gangs are fail-fast (reference ``runner_base.py:54-58``): one rank dying
ends the run. The supervisor wraps each launch:

1. **Classify** the failure (:func:`classify_failure`): *transient* (a
   rank killed by a signal, as preemption looks from the driver; a
   rendezvous timeout; a lost result; a rank whose traceback is the
   distributed runtime failing) or *permanent* (a user-code exception,
   slot exhaustion, bad arguments, anything unnamed). A permanent
   failure is raised at once.
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

The policy is the module's :data:`policy`, which
:func:`~sparkdl_tpu_torch.horovod.launcher.launch_gang` reads at call
time; its default (``max_retries=0``) turns supervision off. No
environment variable is read (``RetryPolicy.from_env`` is not ported):
``extra_patterns`` takes the place of ``SPARKDL_TPU_TRANSIENT_PATTERNS``.
Not ported: the elastic relaunch at another world size and its reshard
pre-flight, the hang kind, the attempt-world ledger, and the observe
instants and counters (``gang.attempt``, ``gang_failures_total``, ...),
whose facts stand in the log lines and in
:attr:`GangRetryBudgetExhausted.attempts`.
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
    ``"rendezvous_timeout"``, ``"worker_death"``, ``"no_result"`` or
    ``"job_timeout"``; ``exit_codes``: each rank's (negative: killed by
    that signal); ``exceptions``: rank -> traceback text of its EXC
    frame. A RuntimeError, so callers that catch one keep working."""

    def __init__(self, message, *, kind="unknown", exit_codes=None,
                 exceptions=None):
        super().__init__(message)
        self.kind = kind
        self.exit_codes = list(exit_codes or [])
        self.exceptions = dict(exceptions or {})


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
    """Relaunch budget, backoff schedule, resume source and extra
    transient signatures."""
    max_retries: int = 0
    backoff_base: float = 1.0
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    jitter: float = 0.5
    resume_dir: str = None
    extra_patterns: tuple = ()

    def backoff(self, attempt, _random=random.random):
        """Seconds before relaunch number ``attempt`` (1-based): capped
        exponential, plus up to ``jitter`` of it on top."""
        base = min(self.backoff_base * self.backoff_factor ** (attempt - 1),
                   self.backoff_max)
        return base * (1.0 + self.jitter * _random())


# the policy launch_gang supervises with; replace it to turn retries on
policy = RetryPolicy()


def _resume_step(policy):
    if not policy.resume_dir:
        return None
    from sparkdl_tpu_torch.utils.checkpoint import latest_complete_step

    return latest_complete_step(policy.resume_dir)


def supervise(launch, policy, _sleep=time.sleep):
    """Run ``launch(context)`` under ``policy`` and return its result.

    ``launch`` takes the attempt's
    :class:`~sparkdl_tpu_torch.horovod.RestartContext` and raises on
    failure. The first attempt gets ``RestartContext(0, None)``; each
    relaunch its number and the newest committed step under
    ``policy.resume_dir``, read after the backoff.
    """
    from sparkdl_tpu_torch.horovod import RestartContext

    attempts = []
    attempt = 1
    while True:
        context = (RestartContext(0, None) if attempt == 1 else
                   RestartContext(attempt - 1, _resume_step(policy)))
        try:
            return launch(context)
        except Exception as e:
            verdict, cause = classify_failure(e, policy.extra_patterns)
            attempts.append(AttemptRecord(attempt, verdict, cause))
            first_line = (str(e).splitlines() or ["<no message>"])[0]
            if verdict == PERMANENT:
                logger.error(
                    "HorovodRunner gang failed permanently on attempt %d "
                    "(%s); not retrying: %s", attempt, cause, first_line)
                raise
            if attempt > policy.max_retries:
                if policy.max_retries > 0:
                    raise GangRetryBudgetExhausted(
                        attempts, policy.max_retries) from e
                raise  # supervision off: surface untouched
            delay = policy.backoff(attempt)
            resume = _resume_step(policy)
            logger.warning(
                "HorovodRunner gang failed transiently (attempt %d, retry "
                "%d/%d: %s); relaunching in %.1fs%s: %s", attempt, attempt,
                policy.max_retries, cause, delay,
                "" if resume is None else f" (will resume from step {resume})",
                first_line)
            if delay > 0:
                _sleep(delay)
            attempt += 1
