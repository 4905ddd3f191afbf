"""Gang health: worker liveness beacons and the driver's hang detector.

Counterpart of ``sparkdl_tpu/observe/health.py``. A gang's worst failure
is the silent hang: a rank stuck in a collective its peers already
left, no rank dies, no EXC frame comes. This module makes a hung gang
diagnose itself:

- **Worker side**: a :class:`HeartbeatSender` thread ships a beacon over
  the control plane every :data:`HEARTBEAT_S` seconds: the rank's step,
  a monotonic *progress* counter (bumped by :func:`note_step` from
  ``instrument_step`` and by :func:`note_collective` on every
  collective's entry and exit), the last collective entered, and the
  card's memory (``device_hbm_bytes{kind=in_use|peak|limit}``).
- **Driver side**: a :class:`HangDetector` tracks each rank's last beat
  and last progress. A rank whose beats go on but whose progress has not
  moved for :data:`STALL_S` seconds is *stalled*; one whose beats stop
  is *silent*; when every rank is stalled or silent the gang is *hung*,
  with a ``straggler`` (ranks at different steps) or ``deadlock``
  verdict. Verdicts land as ``health.*`` instants and
  ``gang_stalls_total{verdict}`` counters; the launcher asks the stalled
  ranks for stack dumps (:func:`dump_all_threads`) and fails the gang
  with ``kind="hang"``. The detector is the JAX package's code.

The settings :data:`HEARTBEAT_S` and :data:`STALL_S` are module
settings (the JAX package's ``SPARKDL_TPU_HEARTBEAT_S`` and
``SPARKDL_TPU_STALL_S``), read when a sender or a detector is made; a
gang's driver ships ``HEARTBEAT_S`` to its ranks. Everything here is
inert with telemetry off: the sender is only started, and the detector
only made, behind ``observe.enabled()``. A rank becomes stall-eligible
only once it has progressed, so an uninstrumented main is never killed.
After that, :data:`STALL_S` must exceed the longest host-side gap
between two progress marks (a step's entry, a collective's entry or
exit): the first step's kernel builds, a checkpoint restore, a data
load. The worker bootstrap takes the first optimizer's import of
``torch._dynamo`` before ``main`` runs.

**No CUDA call before the card is bound.** The sender starts before the
rank's ``hvd.init()``; :func:`device_memory_stats` reads the allocator's
statistics (``torch.cuda.memory_stats``) only of the card that
``hvd.init()`` bound, and only once its CUDA context exists. A beat sent
before, or by a CPU rank, carries no device gauges: a call with no
device would make a context on ``cuda:0`` from every rank.
"""

import threading
import time

# seconds between a worker's beats (<= 0: no sender)
HEARTBEAT_S = 10.0
# seconds without progress before a rank is declared stalled
STALL_S = 300.0

# Gang-level hang verdicts (strings of the JAX package's contract).
VERDICT_STALL = "stall"
VERDICT_SILENT = "silent"
VERDICT_STRAGGLER = "straggler"
VERDICT_DEADLOCK = "deadlock"


def heartbeat_interval():
    return float(HEARTBEAT_S)


def stall_seconds():
    return float(STALL_S)


# -- worker-side progress state ----------------------------------------------
#
# Writers: the training thread (note_step, note_collective, behind the
# callers' observe.enabled() test). Reader: the heartbeat thread.

_state_lock = threading.Lock()
_state = {"step": None, "progress": 0, "collective": None}


def note_step(step):
    """Training progress (``instrument_step`` calls it at step entry):
    bumps the progress counter."""
    with _state_lock:
        _state["step"] = int(step)
        _state["progress"] += 1


def note_collective(op, done=False):
    """A collective's entry (records ``op`` as the last entered, the line
    a hang's postmortem shows) or exit; both are progress."""
    with _state_lock:
        if not done:
            _state["collective"] = str(op)
        _state["progress"] += 1


def progress_snapshot():
    with _state_lock:
        return dict(_state)


def bound_card():
    """The card ``hvd.init()`` bound, once its CUDA context exists; None
    before that, on a CPU rank and outside a gang."""
    import torch

    from sparkdl_tpu_torch.hvd import _state as hvd_state

    dev = hvd_state.state().device
    if dev is None or dev.type != "cuda" or not torch.cuda.is_initialized():
        return None
    return dev


def _read_cuda_memory(dev):
    """The allocator's statistics of card ``dev`` and its total memory."""
    import torch

    return (torch.cuda.memory_stats(dev),
            torch.cuda.get_device_properties(dev).total_memory)


def device_memory_stats():
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
    "bytes_limit"}`` of the bound card (:func:`bound_card`), or ``{}``."""
    dev = bound_card()
    if dev is None:
        return {}
    stats, total = _read_cuda_memory(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(total)}


def export_device_memory(registry):
    """Set ``device_hbm_bytes{kind=in_use|peak|limit}`` on ``registry``
    from :func:`device_memory_stats` and return them (``{}`` before the
    card is bound, or on the CPU)."""
    stats = device_memory_stats()
    out = {}
    for key, kind in (("bytes_in_use", "in_use"),
                      ("peak_bytes_in_use", "peak"),
                      ("bytes_limit", "limit")):
        if key in stats:
            out[kind] = stats[key]
    for kind, value in out.items():
        registry.gauge("device_hbm_bytes", kind=kind).set(value)
    return out


def heartbeat_payload(rank):
    """One beacon: progress state, the card's memory and the latest mem
    sample, with the ``worker_step`` / ``worker_progress`` /
    ``device_hbm_bytes`` gauges refreshed for the next flush."""
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.observe import mem as _mem

    snap = progress_snapshot()
    registry = observe.metrics()
    if snap["step"] is not None:
        registry.gauge("worker_step").set(snap["step"])
    registry.gauge("worker_progress").set(snap["progress"])
    hbm = export_device_memory(registry)
    return {
        "rank": int(rank),
        "step": snap["step"],
        "progress": snap["progress"],
        "collective": snap["collective"],
        "hbm": hbm,
        "mem": _mem.beacon_sample(),
        "ts": time.time(),
    }


class HeartbeatSender:
    """The worker's beacon thread: :func:`heartbeat_payload` over the
    control plane every ``interval`` seconds (None: :data:`HEARTBEAT_S`),
    the first at once, so the driver has this rank's baseline before the
    first stall window can pass. The fault injection can mute it
    (:data:`sparkdl_tpu_torch.utils.chaos.MUTE_HEARTBEAT`: the beats
    stop, the process lives), the detector's silent verdict."""

    def __init__(self, client, rank, interval=None):
        self._client = client
        self._rank = int(rank)
        self._interval = (heartbeat_interval() if interval is None
                          else float(interval))
        self._stop = threading.Event()
        self._thread = None

    def beat(self):
        from sparkdl_tpu_torch.utils.chaos import heartbeat_muted

        if heartbeat_muted(self._rank):
            return False  # the fault injection's mute: beats stop
        try:
            self._client.send_heartbeat(heartbeat_payload(self._rank))
        except Exception:
            return False  # a beat never takes the worker down
        return True

    def start(self):
        if self._interval <= 0:
            return None
        if self._thread is not None and self._thread.is_alive():
            return self._thread

        def loop():
            self.beat()
            while not self._stop.wait(self._interval):
                self.beat()

        self._thread = threading.Thread(target=loop,
                                        name="sparkdl-torch-heartbeat",
                                        daemon=True)
        self._thread.start()
        return self._thread

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._thread = None


# -- driver-side detection ---------------------------------------------------


class HangDetector:
    """Tracks per-rank liveness from HEARTBEAT frames and declares
    stall / silent / hang verdicts.

    ``observe_beat`` is called from control-plane connection threads;
    ``poll`` from the launcher's monitor loop (throttled internally to
    ``check_every``). Verdict instants and counters are emitted HERE
    (the detector only exists when telemetry is on), while the caller
    acts on the returned report: request stack dumps for newly stalled
    ranks, fail the gang on a hang verdict.
    """

    def __init__(self, num_workers, stall_s=None, clock=time.monotonic,
                 check_every=1.0):
        self.num_workers = int(num_workers)
        self.stall_s = stall_seconds() if stall_s is None else float(stall_s)
        self._clock = clock
        self._check_every = float(check_every)
        self._lock = threading.Lock()
        self._ranks = {}       # rank -> beat/progress bookkeeping
        self._stalled = set()  # ranks with an emitted stall verdict
        self._silent = set()
        self._hang_verdict = None
        self._next_check = 0.0
        self._t0 = None        # first poll (gang considered running)

    def observe_beat(self, rank, payload):
        from sparkdl_tpu_torch import observe

        now = self._clock()
        rank = int(rank)
        progress = payload.get("progress")
        recovered = False
        with self._lock:
            info = self._ranks.get(rank)
            if info is None:
                info = self._ranks[rank] = {
                    "progress": None, "progress_t": now,
                    "ever_progressed": False,
                }
            info["last_beat"] = now
            info["step"] = payload.get("step")
            info["collective"] = payload.get("collective")
            info["hbm"] = payload.get("hbm") or {}
            info["mem"] = payload.get("mem") or {}
            if isinstance(progress, (int, float)):
                if info["progress"] is None or progress > info["progress"]:
                    if info["progress"] is not None and rank in self._stalled:
                        # Progress resumed after a stall verdict (the
                        # window was undersized, or the wedge cleared):
                        # revoke it, or one long-ago transient stall
                        # would let a later hang verdict condemn a
                        # rank that is demonstrably training.
                        self._stalled.discard(rank)
                        recovered = True
                    info["progress"] = progress
                    info["progress_t"] = now
                if progress > 0:
                    info["ever_progressed"] = True
            if rank in self._silent:
                # Beats resumed (e.g. a transient network blip): the
                # rank is observable again.
                self._silent.discard(rank)
        if recovered:
            observe.instant("health.recovered", cat="health", rank=rank,
                            progress=progress)

    # -- verdict machinery ---------------------------------------------------

    def _classify_locked(self, now):
        """(newly_stalled, newly_silent, hang_verdict_or_None)."""
        new_stalled, new_silent = [], []
        # Judge every EXPECTED rank, not just the observed ones: a
        # rank whose beacon never arrived at all (muted from boot, a
        # dead heartbeat thread, dropped frames) must become *silent*
        # once the gang has been running a full window — otherwise it
        # would both escape its own verdict and veto the gang's.
        expected = set(range(self.num_workers)) | set(self._ranks)
        for rank in expected:
            info = self._ranks.get(rank)
            if info is None:
                if (self._t0 is not None
                        and now - self._t0 > self.stall_s
                        and rank not in self._silent):
                    new_silent.append(rank)
                continue
            beat_age = now - info["last_beat"]
            if beat_age > self.stall_s:
                if rank not in self._silent:
                    new_silent.append(rank)
                continue
            # Beats continue: stall = no progress movement for the
            # whole window, on a rank that has proven it CAN progress
            # (uninstrumented mains never become stall-eligible).
            if (info["ever_progressed"]
                    and now - info["progress_t"] > self.stall_s
                    and rank not in self._stalled):
                new_stalled.append(rank)
        # Gang hang: every expected rank is beating-but-stalled or
        # silent (and at least one is genuinely stalled — an all-silent
        # gang is a dead control plane, not a hang).
        hang = None
        if self._hang_verdict is None and expected:
            stalled_after = self._stalled | set(new_stalled)
            silent_after = self._silent | set(new_silent)
            covered = stalled_after | silent_after
            if stalled_after and all(r in covered for r in expected):
                steps = {
                    self._ranks[r].get("step") for r in stalled_after
                }
                hang = (VERDICT_DEADLOCK if len(steps) <= 1
                        else VERDICT_STRAGGLER)
        return new_stalled, new_silent, hang

    def poll(self):
        """Run one detection pass. Returns ``{"new_stalled": [...],
        "new_silent": [...], "hang": verdict-or-None}`` — empty/None
        between check intervals and after the hang has been declared
        (one hang per gang attempt)."""
        from sparkdl_tpu_torch import observe

        now = self._clock()
        report = {"new_stalled": [], "new_silent": [], "hang": None}
        if now < self._next_check:
            return report
        self._next_check = now + self._check_every
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            new_stalled, new_silent, hang = self._classify_locked(now)
            self._stalled.update(new_stalled)
            self._silent.update(new_silent)
            if hang is not None:
                self._hang_verdict = hang
            stalled_info = {
                r: dict(self._ranks[r]) for r in new_stalled
            }
        for rank in sorted(new_stalled):
            info = stalled_info[rank]
            observe.instant(
                "health.stall", cat="health", rank=rank,
                verdict=VERDICT_STALL, step=info.get("step"),
                progress=info.get("progress"),
                collective=info.get("collective"),
                stalled_for_s=round(now - info["progress_t"], 1),
            )
            observe.inc("gang_stalls_total", verdict=VERDICT_STALL)
        for rank in sorted(new_silent):
            observe.instant(
                "health.silent", cat="health", rank=rank,
                verdict=VERDICT_SILENT,
            )
            observe.inc("gang_stalls_total", verdict=VERDICT_SILENT)
        if hang is not None:
            observe.instant(
                "health.hang", cat="health", verdict=hang,
                stalled=sorted(self._stalled),
                silent=sorted(self._silent),
            )
            observe.inc("gang_stalls_total", verdict=hang)
        report["new_stalled"] = sorted(new_stalled)
        report["new_silent"] = sorted(new_silent)
        report["hang"] = hang
        return report

    def note_stack_dump(self, rank):
        """A requested stack dump arrived (called by the control
        plane): mark the moment on the timeline so the postmortem can
        order detection → dump → relaunch."""
        from sparkdl_tpu_torch import observe

        observe.instant("health.stack_dump", cat="health", rank=int(rank))

    @property
    def stalled_ranks(self):
        with self._lock:
            return sorted(self._stalled)

    @property
    def hang_verdict(self):
        with self._lock:
            return self._hang_verdict

    def describe(self):
        """One human line per rank — the evidence block of a
        ``kind="hang"`` GangFailure message (and of the doctor's
        report, which re-reads it from ``health.json``)."""
        with self._lock:
            lines = []
            for rank in sorted(self._ranks):
                info = self._ranks[rank]
                state = ("stalled" if rank in self._stalled
                         else "silent" if rank in self._silent
                         else "progressing")
                coll = info.get("collective")
                lines.append(
                    f"rank {rank}: {state} @ step {info.get('step')}"
                    + (f", last entered {coll}" if coll else "")
                    + f", progress counter {info.get('progress')}"
                )
            return "\n".join(lines)

    def live_state(self):
        """Per-rank liveness as it stands NOW — the ``/statusz``
        ``ranks`` table and the alert engine's heartbeat-gap input.
        One dict per EXPECTED rank (a rank that never beat shows up as
        ``state="unseen"``, beat_age None), with the detector's own
        stall/silent classification and the age of the last beat on
        this detector's clock."""
        now = self._clock()
        out = {}
        with self._lock:
            for rank in sorted(set(range(self.num_workers))
                               | set(self._ranks)):
                info = self._ranks.get(rank)
                if info is None:
                    out[rank] = {
                        "state": ("silent" if rank in self._silent
                                  else "unseen"),
                        "step": None, "progress": None,
                        "collective": None, "hbm": {}, "mem": {},
                        "beat_age_s": None,
                    }
                    continue
                state = ("stalled" if rank in self._stalled
                         else "silent" if rank in self._silent
                         else "progressing")
                out[rank] = {
                    "state": state,
                    "step": info.get("step"),
                    "progress": info.get("progress"),
                    "collective": info.get("collective"),
                    "hbm": dict(info.get("hbm") or {}),
                    "mem": dict(info.get("mem") or {}),
                    "beat_age_s": round(now - info["last_beat"], 3),
                }
        return out

    def summary(self):
        """JSON-able detector state for ``health.json`` in the merged
        run dir (what ``observe.doctor`` diagnoses from)."""
        with self._lock:
            return {
                "num_workers": self.num_workers,
                "stall_s": self.stall_s,
                "hang_verdict": self._hang_verdict,
                "stalled": sorted(self._stalled),
                "silent": sorted(self._silent),
                "ranks": {
                    str(r): {
                        "step": info.get("step"),
                        "progress": info.get("progress"),
                        "collective": info.get("collective"),
                        "hbm": info.get("hbm") or {},
                        "mem": info.get("mem") or {},
                    }
                    for r, info in self._ranks.items()
                },
            }


def _reset_for_tests():
    with _state_lock:
        _state.update({"step": None, "progress": 0, "collective": None})


def dump_all_threads():
    """faulthandler all-thread stack dump as text — what a worker
    answers a driver dump request with. faulthandler needs a real
    fd, so spool through an unlinked temp file."""
    import faulthandler
    import tempfile

    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


__all__ = [
    "HeartbeatSender", "HangDetector", "heartbeat_payload",
    "note_step", "note_collective", "progress_snapshot",
    "export_device_memory", "device_memory_stats", "bound_card",
    "dump_all_threads", "heartbeat_interval", "stall_seconds",
    "VERDICT_STALL", "VERDICT_SILENT", "VERDICT_STRAGGLER",
    "VERDICT_DEADLOCK",
]
