"""Autonomous elasticity: a supervised gang that shrank grows back when
capacity returns, and training yields cards to a colocated serving fleet
under load and reclaims them when it is quiet.

Counterpart of ``sparkdl_tpu/horovod/elastic.py``, with the same
decisions and the same decision log:

1. **Capacity watcher** (:func:`probe_capacity`): how many cards the
   host can offer now, from the :data:`CAPACITY` setting, the file named
   by :data:`CAPACITY_FILE` (read again at every poll), the CUDA cards
   of this host (counted without creating a CUDA context, as
   :func:`~sparkdl_tpu_torch.horovod.launcher.available_slots` counts
   them) or the launcher's slots. ``"auto"`` takes the first configured
   source; a configured source that cannot be read reports None
   (unknown), never the next source's number.
2. **Debounced grow-back**: a surplus must hold for :data:`DEBOUNCE_S`
   before a grow is considered, so a flapping probe never thrashes the
   gang.
3. **Ledger-driven np** (:func:`choose_np`): the target comes from the
   throughput-a-card medians of the perf ledger
   (:data:`sparkdl_tpu_torch.observe.perf.HISTORY_PATH`); a grow into a
   configuration the ledger proves slower a card raises
   :class:`ElasticGrowRefused`. An empty ledger proves nothing: the grow
   is unconditional.
4. **Checkpoint-boundary resize**: a planned resize is emitted only once
   the newest committed checkpoint step under the supervisor policy's
   ``resume_dir`` passes the step at the decision (bounded by
   :data:`CKPT_WAIT_S`); the launcher then recycles the gang, and the
   supervisor relaunches it at the target through the reshard pre-flight
   with no retry budget and no backoff.
5. **Card-budget arbiter** (:data:`ARBITER`): when the alert engine's
   serving-pressure rules fire on a colocated fleet, training yields
   :data:`ARBITER_CHIPS` cards and the fleet scales up; after
   :data:`ARBITER_CLEAR_S` of quiet it reclaims them.

Every decision is a ``cat="elastic"`` timeline instant, a
``gang_elastic_transitions_total{direction,reason}`` count on a world
change, and a line of the run dir's ``elastic.json``.

The knobs are module settings read when a controller is made (the JAX
module's ``SPARKDL_TPU_ELASTIC_*`` variables; no environment variable is
read). :data:`ENABLED` is the switch: off, :func:`maybe_make_controller`
returns None and the launcher's monitor loop pays one ``is not None``
test a tick.
"""

import logging
import threading
import time

from sparkdl_tpu_torch import observe

logger = logging.getLogger("HorovodRunner")

# the switch (SPARKDL_TPU_ELASTIC)
ENABLED = False
# the capacity probe: "auto", "setting" (the JAX module's "env"),
# "file", "devices" or "slots"
PROBE = "auto"
# a fixed capacity (an int, or a string parsed as one); None: unset
CAPACITY = None
# a file whose contents are the capacity, read again at every poll
CAPACITY_FILE = None
# seconds between the watcher's polls
CHECK_S = 2.0
# seconds a surplus must hold before a grow is considered
DEBOUNCE_S = 10.0
# a grow target's ledger throughput a card must be at least MARGIN x the
# current np's
MARGIN = 0.8
# seconds a planned resize waits for the next committed checkpoint step
CKPT_WAIT_S = 60.0
# the largest and the smallest np the controller picks (None: no cap)
MAX_NP = None
MIN_NP = 1
# the card-budget arbiter's switch, the alert rules it answers, the cards
# it moves and the quiet it waits for before reclaiming them
ARBITER = False
ARBITER_RULES = ("queue_depth_growth", "server_ttft")
ARBITER_CHIPS = 1
ARBITER_CLEAR_S = 30.0

ELASTIC_SCHEMA = "sparkdl_tpu_torch.horovod.elastic/1"

# ledger metric names read as throughput (higher is better), in order of
# preference, then step-time names inverted to a rate
_RATE_METRICS = ("steps_per_s", "examples_per_s", "tokens_per_s",
                 "throughput")
_STEP_TIME_METRICS = ("step_time_s", "train_step_seconds_mean")
# top-level ledger keys naming the world size a record was measured at
_NP_KEYS = ("np", "world", "world_size", "num_workers")
_PROBES = ("auto", "setting", "file", "devices", "slots")


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    if not n:
        return None
    mid = n // 2
    if n % 2:
        return xs[mid]
    return 0.5 * (xs[mid - 1] + xs[mid])


def _no_env(env):
    if env is not None:
        raise NotImplementedError(
            "env=: the port reads the elastic module's settings "
            "(elastic.PROBE, CAPACITY, ...), not an environment")


def _card_count():
    """This host's CUDA cards, counted without creating a CUDA context."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def probe_capacity(env=None):
    """How many cards the host can offer now, or None (unknown).

    Under :data:`PROBE` ``"auto"``: :data:`CAPACITY` when set, else the
    contents of :data:`CAPACITY_FILE` when a path is set (read again at
    every call), else this host's CUDA cards when it has any, else the
    launcher's slots. A configured source that does not parse reports
    None rather than falling through to another source's number.
    ``env`` (the JAX function's environment) raises
    NotImplementedError."""
    _no_env(env)
    mode = (PROBE or "auto").strip().lower()
    if mode not in _PROBES:
        raise ValueError(f"elastic.PROBE is one of {list(_PROBES)}, not "
                         f"{PROBE!r}")
    if mode in ("setting", "auto"):
        raw = CAPACITY
        if raw is not None and str(raw).strip():
            try:
                return int(str(raw).strip())
            except ValueError:
                logger.warning("ignoring unparsable elastic.CAPACITY=%r", raw)
                return None
        if mode != "auto":
            return None
    if mode in ("file", "auto"):
        path = CAPACITY_FILE
        if path:
            try:
                with open(path) as f:
                    return int(f.read().strip())
            except (OSError, ValueError):
                return None
        if mode == "file":
            return None
    if mode in ("devices", "auto"):
        n = _card_count()
        if n or mode == "devices":
            return n or None
    try:
        from sparkdl_tpu_torch.horovod.launcher import available_slots

        return available_slots()
    except Exception:  # noqa: BLE001 - an unknown capacity, not a crash
        return None


class ElasticGrowRefused(RuntimeError):
    """A grow was refused: infeasible (``reason="no_checkpoint"``, no
    committed step for the resized gang to resume from) or unprofitable
    (``reason="unprofitable"``, the ledger's medians prove every measured
    candidate slower a card than the gang is now). ``findings`` name the
    rejected candidates."""

    def __init__(self, message, *, findings=(), reason="unprofitable"):
        super().__init__(message)
        self.findings = list(findings)
        self.reason = reason


def _metric_value(m):
    """The median over the record's samples when it has three or more,
    else its value (``observe.compare``'s rule)."""
    if not isinstance(m, dict):
        return None
    try:
        from sparkdl_tpu_torch.observe.compare import _effective_value

        v, _basis = _effective_value(m)
    except Exception:  # noqa: BLE001 - a malformed record reads as its value
        v = m.get("value")
    return float(v) if isinstance(v, (int, float)) else None


def _per_chip_throughput(history):
    """{np: median throughput a card} of the ledger records that carry a
    world size and a throughput (or a step time to invert)."""
    by_np = {}
    for entry in history or ():
        if not isinstance(entry, dict):
            continue
        np_v = None
        for key in _NP_KEYS:
            v = entry.get(key)
            if isinstance(v, (int, float)) and int(v) >= 1:
                np_v = int(v)
                break
        if np_v is None:
            continue
        metrics = entry.get("metrics")
        if not isinstance(metrics, dict):
            continue
        val = None
        for name in _RATE_METRICS:
            val = _metric_value(metrics.get(name))
            if val is not None:
                break
        if val is None:
            for name in _STEP_TIME_METRICS:
                t = _metric_value(metrics.get(name))
                if t is not None and t > 0:
                    val = 1.0 / t
                    break
        if val is None or val <= 0:
            continue
        by_np.setdefault(np_v, []).append(val / np_v)
    return {n: _median(vals) for n, vals in by_np.items()}


def choose_np(current_np, available_np, history=None, *, margin=None,
              max_np=None):
    """The np to grow to from ``current_np`` with ``available_np`` cards:
    the largest candidate the ledger does not prove slower a card;
    ``current_np`` when there is no surplus. Raises
    :class:`ElasticGrowRefused` when every measured candidate's median
    throughput a card is below ``margin`` (default :data:`MARGIN`) x the
    current np's. A candidate the ledger never measured is allowed.
    ``history``: the ledger's records (None: read
    :data:`~sparkdl_tpu_torch.observe.perf.HISTORY_PATH`, none when it
    is None)."""
    current_np = int(current_np)
    cap = int(available_np)
    if max_np:
        cap = min(cap, int(max_np))
    if cap <= current_np:
        return current_np
    if margin is None:
        margin = float(MARGIN)
    if history is None:
        from sparkdl_tpu_torch.observe.perf import read_history

        history = read_history()
    per_chip = _per_chip_throughput(history)
    cur = per_chip.get(current_np)
    if cur is None or cur <= 0:
        # nothing measured where the gang is now: nothing provable
        return cap
    findings = []
    for target in range(cap, current_np, -1):
        pc = per_chip.get(target)
        if pc is None or pc >= margin * cur:
            return target
        findings.append(
            f"np={target}: ledger median {pc:.4g}/chip < "
            f"{margin:.2f} x np={current_np}'s {cur:.4g}/chip")
    raise ElasticGrowRefused(
        f"grow from np={current_np} toward np={cap} refused: every "
        "measured candidate is slower per chip than the gang's current "
        "configuration (ledger medians)",
        findings=findings, reason="unprofitable")


def check_grow(current_np, available_np, *, resume_dir=None,
               latest_step=None, history=None, margin=None, max_np=None):
    """The gate of an autonomous grow: raises :class:`ElasticGrowRefused`
    when there is no checkpoint directory or no committed step in it
    (``latest_step``: a step, a callable giving one, or None to read
    ``resume_dir``), or when :func:`choose_np` refuses; returns the
    target np otherwise."""
    step = None
    if callable(latest_step):
        try:
            step = latest_step()
        except Exception:  # noqa: BLE001 - an unreadable dir has no step
            step = None
    elif latest_step is not None:
        step = latest_step
    elif resume_dir:
        from sparkdl_tpu_torch.utils.checkpoint import latest_complete_step

        step = latest_complete_step(resume_dir)
    if not resume_dir:
        raise ElasticGrowRefused(
            "grow refused: no checkpoint directory configured "
            "(supervisor.policy.resume_dir unset) — a resized gang would "
            "restart from step 0", reason="no_checkpoint",
            findings=["supervisor.policy.resume_dir unset"])
    if step is None:
        raise ElasticGrowRefused(
            f"grow refused: no committed checkpoint under {resume_dir} "
            "yet — nothing for the resized gang to resume from",
            reason="no_checkpoint",
            findings=[f"no committed step under {resume_dir}"])
    return choose_np(current_np, available_np, history, margin=margin,
                     max_np=max_np)


class ElasticController:
    """One a supervised launch: watches capacity and serving demand
    across the attempts, plans resizes at checkpoint boundaries, and
    answers the supervisor's question of the next attempt's np.

    :meth:`poll` runs in the launcher's monitor loop; :meth:`relaunch_target`,
    :meth:`cancel_pending` and :meth:`note_attempt` between attempts on
    the same thread; :meth:`status` from ``/statusz``'s threads, hence
    the lock. The settings are read here, once. ``probe``: the capacity
    probe (default :func:`probe_capacity`); ``clock``: monotonic seconds;
    ``latest_step``: the newest committed step (default: read
    ``resume_dir``, which defaults to the supervisor policy's). ``env``
    (the JAX controller's environment) raises NotImplementedError."""

    def __init__(self, current_np=None, *, alerts=None, env=None,
                 probe=None, clock=time.monotonic, latest_step=None,
                 resume_dir=None):
        _no_env(env)
        self.check_s = float(CHECK_S)
        self.debounce_s = float(DEBOUNCE_S)
        self.margin = float(MARGIN)
        self.ckpt_wait_s = float(CKPT_WAIT_S)
        self.max_np = int(MAX_NP or 0) or None
        self.min_np = max(1, int(MIN_NP or 1))
        self.arbiter = bool(ARBITER)
        rules = ARBITER_RULES
        if isinstance(rules, str):
            rules = rules.split(",")
        self.arbiter_rules = tuple(r.strip() for r in rules if r.strip())
        self.arbiter_chips = max(1, int(ARBITER_CHIPS or 1))
        self.clear_s = float(ARBITER_CLEAR_S)
        if resume_dir is None:
            from sparkdl_tpu_torch.horovod import supervisor

            resume_dir = supervisor.policy.resume_dir
        self.resume_dir = resume_dir or None

        self.current_np = int(current_np) if current_np else None
        self.available_np = None
        self._alerts = alerts
        self._probe = probe or probe_capacity
        self._clock = clock
        self._latest_step_fn = latest_step
        self._lock = threading.Lock()
        self._next_check = 0.0
        self._surplus_since = None
        self._refused_at = None      # the capacity the ledger refused
        self._pending = None         # a planned resize awaiting a step
        self._clamp_reason = None
        self._decisions = []
        self._transitions = {}       # "direction:reason" -> count
        self._demand_seen = 0        # arbiter-rule alert records seen
        self._quiet_since = None
        self._yielded = 0            # cards ceded to serving now
        self._pre_yield_np = None
        self._fleet_base = None      # the fleet's replicas before a yield

    # -- probes ---------------------------------------------------------------

    def _latest_step(self):
        if self._latest_step_fn is not None:
            try:
                return self._latest_step_fn()
            except Exception:  # noqa: BLE001 - unknown, not a crash
                return None
        if not self.resume_dir:
            return None
        try:
            from sparkdl_tpu_torch.utils.checkpoint import (
                latest_complete_step,
            )

            return latest_complete_step(self.resume_dir)
        except Exception:  # noqa: BLE001 - unknown, not a crash
            return None

    def _fleet_queue_depth(self):
        try:
            from sparkdl_tpu_torch.observe.statusz import fleet_status

            rows = fleet_status()
        except Exception:  # noqa: BLE001 - no fleet to read
            return None
        if not rows:
            return None
        return sum(int(r.get("queue_depth") or 0) for r in rows)

    # -- the monitor loop's tick ----------------------------------------------

    def poll(self, now=None):
        """One watcher tick (at most one a ``check_s``). Returns a resize
        request ``{"direction", "target_np", "reason", "resume_step"}``
        when a planned resize reached its checkpoint boundary and the
        launcher should recycle the gang now, else None."""
        now = self._clock() if now is None else now
        if now < self._next_check:
            return None
        self._next_check = now + self.check_s
        cap = self._probe()
        with self._lock:
            self.available_np = cap
            req = self._ripen_pending(now)
            if req is None and self._pending is None:
                plan = self._arbiter_plan(now)
                if plan is not None:
                    self._plan(plan, now)
                else:
                    self._grow_watch(now, cap)
        # the fleet's resize joins retired worker threads for seconds:
        # after the lock, or every status() and relaunch_target() caller
        # would wait behind it
        if req is not None:
            if req["direction"] == "yield":
                self._scale_fleet(grow=True)
            elif req["direction"] == "reclaim":
                self._scale_fleet(grow=False)
        return req

    def _ripen_pending(self, now):
        pend = self._pending
        if pend is None or pend.get("emitted"):
            return None
        step = self._latest_step()
        decided = pend.get("decided_step")
        ready = step is not None and (decided is None or step > decided)
        if not ready:
            if now - pend["planned_at"] < self.ckpt_wait_s:
                return None
            if step is None:
                # the wait ran out and no step was ever committed: a resize
                # would restart the run from scratch
                if pend["direction"] == "yield":
                    self._yielded = 0
                self._record(direction=pend["direction"],
                             outcome="cancelled", reason="no_checkpoint",
                             from_np=self.current_np,
                             to_np=pend["target_np"])
                observe.instant(
                    "elastic.cancelled", cat="elastic",
                    direction=pend["direction"], reason="no_checkpoint",
                    target_np=pend["target_np"])
                self._pending = None
                return None
            # the wait is bounded: resume from the newest committed step
            # though it predates the decision
        pend["emitted"] = True
        pend["resume_step"] = step
        self._record(direction=pend["direction"], outcome="resize",
                     reason=pend["reason"], from_np=self.current_np,
                     to_np=pend["target_np"], resume_step=step)
        observe.instant(
            "elastic.decision", cat="elastic", direction=pend["direction"],
            reason=pend["reason"], from_np=self.current_np,
            target_np=pend["target_np"], resume_step=step)
        logger.info(
            "elastic %s: recycling the gang np %s -> %s (%s), resuming from "
            "step %s", pend["direction"], self.current_np, pend["target_np"],
            pend["reason"], step)
        return {"direction": pend["direction"],
                "target_np": pend["target_np"], "reason": pend["reason"],
                "resume_step": step}

    def _arbiter_plan(self, now):
        if not self.arbiter:
            return None
        demand, rule = False, None
        if self._alerts is not None:
            try:
                recs = [r for r in self._alerts.records()
                        if r.get("rule") in self.arbiter_rules]
            except Exception:  # noqa: BLE001 - no demand read
                recs = []
            if len(recs) > self._demand_seen:
                self._demand_seen = len(recs)
                demand = True
                rule = recs[-1].get("rule")
        depth = self._fleet_queue_depth()
        if demand or (depth is not None and depth > 0):
            self._quiet_since = None
        elif self._quiet_since is None:
            self._quiet_since = now
        cur = self.current_np
        if (demand and not self._yielded and cur is not None
                and cur > self.min_np):
            target = max(self.min_np, cur - self.arbiter_chips)
            if target < cur:
                self._yielded = cur - target
                self._pre_yield_np = cur
                return {"direction": "yield",
                        "reason": rule or "serving_alert",
                        "target_np": target}
        if (self._yielded and cur is not None
                and self._quiet_since is not None
                and now - self._quiet_since >= self.clear_s):
            target = self._pre_yield_np or (cur + self._yielded)
            if self.available_np is not None:
                target = min(target, self.available_np)
            if target > cur:
                self._yielded = 0
                return {"direction": "reclaim", "reason": "alerts_clear",
                        "target_np": target}
        return None

    def _grow_watch(self, now, cap):
        cur = self.current_np
        if cap is None or cur is None or self._yielded:
            self._surplus_since = None
            return
        if cap <= cur:
            # no surplus, or a dip inside the debounce: the clock starts
            # again at the next surplus
            self._surplus_since = None
            if self._refused_at is not None and cap != self._refused_at:
                self._refused_at = None
            return
        if self._surplus_since is None:
            self._surplus_since = now
            return
        if now - self._surplus_since < self.debounce_s:
            return
        if self._refused_at == cap:
            return  # the ledger's verdict does not change mid-run
        try:
            target = check_grow(
                cur, cap, resume_dir=self.resume_dir,
                latest_step=self._latest_step, margin=self.margin,
                max_np=self.max_np)
        except ElasticGrowRefused as e:
            if e.reason == "unprofitable":
                self._refused_at = cap
            self._record(direction="grow", outcome="refused",
                         reason=e.reason, from_np=cur, to_np=cap)
            observe.instant(
                "elastic.grow_refused", cat="elastic", current_np=cur,
                available_np=cap, reason=e.reason,
                problems=[str(f) for f in e.findings[:4]])
            logger.warning("elastic grow toward np=%d refused: %s", cap, e)
            return
        if target > cur:
            self._plan({"direction": "grow", "reason": "capacity_returned",
                        "target_np": target}, now)

    def _plan(self, req, now):
        req = dict(req)
        req["planned_at"] = now
        req["decided_step"] = self._latest_step()
        req["emitted"] = False
        self._pending = req
        observe.instant(
            "elastic.planned", cat="elastic", direction=req["direction"],
            reason=req["reason"], from_np=self.current_np,
            target_np=req["target_np"])
        logger.info(
            "elastic %s planned: np %s -> %s (%s); waiting for the next "
            "checkpoint boundary", req["direction"], self.current_np,
            req["target_np"], req["reason"])

    def _scale_fleet(self, grow):
        """The cards moved the other way on a colocated fleet: a yield
        scales the first live fleet up by the yielded cards, a reclaim
        back to its size before. Best effort: a fleet that cannot resize
        never takes the training relaunch down."""
        try:
            from sparkdl_tpu_torch.observe.statusz import live_fleets

            fleets = live_fleets()
        except Exception:  # noqa: BLE001 - no fleet
            fleets = []
        for fleet in fleets[:1]:
            try:
                if grow:
                    self._fleet_base = fleet.replica_count()
                    target = self._fleet_base + (self._yielded
                                                 or self.arbiter_chips)
                else:
                    target = self._fleet_base or max(
                        1, fleet.replica_count() - self.arbiter_chips)
                fleet.scale_to(target)
                observe.instant(
                    "elastic.fleet_scale", cat="elastic", replicas=target,
                    direction="up" if grow else "down")
            except Exception:  # noqa: BLE001 - best effort, logged
                logger.warning("elastic fleet scale failed", exc_info=True)

    # -- the supervisor's questions -------------------------------------------

    def relaunch_target(self):
        """The np of the next relaunch, or None (the configured np): a
        planned resize that reached its boundary wins; else the current
        world, clamped down to the probed capacity (a gang never
        relaunches wider than the host)."""
        with self._lock:
            pend = self._pending
            if pend is not None and pend.get("emitted"):
                return int(pend["target_np"])
            cur = self.current_np
            if cur is None:
                return None
            cap = self._probe()
            if cap is not None:
                self.available_np = cap
            target = cur
            if cap is not None and cap < cur:
                target = max(self.min_np, cap)
            if target != cur:
                self._clamp_reason = "capacity"
            return target

    def cancel_pending(self, reason):
        """Drop a planned resize (the reshard pre-flight refused its
        target): the relaunch goes ahead at the current np."""
        with self._lock:
            pend, self._pending = self._pending, None
            if pend is None:
                return
            if pend["direction"] == "yield":
                self._yielded = 0
            self._record(direction=pend["direction"], outcome="cancelled",
                         reason=reason, from_np=self.current_np,
                         to_np=pend.get("target_np"))
            observe.instant(
                "elastic.cancelled", cat="elastic",
                direction=pend["direction"], reason=reason,
                target_np=pend.get("target_np"))

    def note_attempt(self, num_workers):
        """The launcher's hook: the world size of the attempt about to
        start. A change of world counts a transition (an instant, the
        counter, a decision); a consumed plan is cleared; the debounce
        starts again."""
        with self._lock:
            prev = self.current_np
            world = int(num_workers)
            self.current_np = world
            pend, self._pending = self._pending, None
            self._surplus_since = None
            clamp, self._clamp_reason = self._clamp_reason, None
            if prev is None or world == prev:
                return
            if (pend is not None and pend.get("emitted")
                    and int(pend["target_np"]) == world):
                direction, reason = pend["direction"], pend["reason"]
            else:
                direction = "shrink" if world < prev else "grow"
                reason = clamp or "relaunch"
            key = f"{direction}:{reason}"
            self._transitions[key] = self._transitions.get(key, 0) + 1
            observe.inc("gang_elastic_transitions_total",
                        direction=direction, reason=reason)
            observe.instant(
                "elastic.transition", cat="elastic", direction=direction,
                reason=reason, from_np=prev, to_np=world)
            self._record(direction=direction, outcome="transition",
                         reason=reason, from_np=prev, to_np=world)
            logger.info("elastic transition: np %d -> %d (%s, %s)", prev,
                        world, direction, reason)

    # -- introspection --------------------------------------------------------

    def _record(self, **kw):
        kw["ts"] = time.time()
        self._decisions.append(kw)
        del self._decisions[:-200]  # the newest 200

    def status(self):
        """The ``/statusz`` ``elastic`` section: current and available
        cards, the pending plan and the newest decisions."""
        with self._lock:
            pend = self._pending
            return {
                "enabled": True,
                "arbiter": self.arbiter,
                "current_np": self.current_np,
                "available_np": self.available_np,
                "yielded_chips": self._yielded,
                "pending": (None if pend is None else {
                    "direction": pend["direction"],
                    "target_np": pend["target_np"],
                    "reason": pend["reason"],
                }),
                "transitions": dict(self._transitions),
                "decisions": list(self._decisions)[-8:],
            }

    def report(self):
        """The run dir's ``elastic.json`` decision log."""
        with self._lock:
            return {
                "schema": ELASTIC_SCHEMA,
                "enabled": True,
                "arbiter": self.arbiter,
                "current_np": self.current_np,
                "available_np": self.available_np,
                "yielded_chips": self._yielded,
                "transitions": dict(self._transitions),
                "decisions": list(self._decisions),
            }


# the driver's active controller (one supervised gang at a time), which
# the supervisor asks for relaunch targets
_active = None


def set_active_controller(controller):
    global _active
    _active = controller


def active_controller():
    return _active


def _reset_for_tests():
    global _active
    _active = None


def maybe_make_controller(current_np=None, *, alerts=None, env=None):
    """An :class:`ElasticController` when :data:`ENABLED`, else None.
    ``env`` raises NotImplementedError."""
    _no_env(env)
    if not ENABLED:
        return None
    return ElasticController(current_np, alerts=alerts)
