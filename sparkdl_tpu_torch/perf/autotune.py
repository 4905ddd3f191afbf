"""The autotune search driver: measured trials over the registered
settings, judged by ``observe.compare``, emitted as a verified profile.

Counterpart of ``sparkdl_tpu/perf/autotune.py``, with its decisions and
its loud refusals. Search model (deliberately boring — the budget is
wall-clock, not cleverness): greedy coordinate descent over the tunable
settings a trial harness honors. One baseline trial on defaults, then
per setting each declared candidate value measured against the current
best configuration; the best *improving* value (per the compare gate's
median/IQR verdict — a noisy-but-flat setting is a tie, never an
improvement) is adopted before the next setting. Every measured trial
is one run of :mod:`sparkdl_tpu_torch.perf.trial` in a bounded
subprocess, which appends its own ledger line (``observe.perf.
append_history``) to the path the runner gives; the metrics are read
back from that line only.

Pruning: before any trial, the declared space is filtered against a
step-time attribution report. A setting declares the component that
must be material for it to matter (``knobs.Knob.component``); when the
report shows that component negligible the setting is dropped from the
plan and the drop is LOGGED. No attribution report = no pruning
(unknown is not irrelevant).

Trial accounting is loud: the driver logs the plan, refuses a
``--max-trials`` bound it cannot fit instead of silently truncating,
and the emitted profile carries every trial's compare verdict as
evidence.

Proof-or-degrade: a non-empty winner is re-measured — fresh default
run, fresh winner run — and only a verification pass emits ``status:
"verified"``. A winner whose verification regresses is emitted
``status: "degraded"`` (knobs empty, candidate recorded), and the
launcher pre-flight applies nothing.

CLI::

    python -m sparkdl_tpu_torch.perf.autotune --bench serve \\
        --knob sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK \\
        --values sparkdl_tpu_torch.perf.trial.SERVE_DECODE_CHUNK=32 \\
        --max-trials 4 --profile-dir DIR --bench-arg=--layers=8
    python -m sparkdl_tpu_torch.perf.autotune --bench train --dry-run

``--bench`` is ``serve`` (the paged int8 engine behind a
``FleetFrontend``), ``train`` (the LoRA step) or ``gbdt`` (the
estimators' fit and transform, ``gbdt_bench``'s harness); ``attention``
is refused by name. A trial runs on the card unless
``--bench-arg=--device=cpu``.
"""

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile

from sparkdl_tpu_torch.observe.compare import compare_records
from sparkdl_tpu_torch.perf import profile as profile_mod
from sparkdl_tpu_torch.utils import knobs as knob_reg

logger = logging.getLogger("sparkdl.perf")

# the directory that holds sparkdl_tpu_torch, for the trials' imports
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# A candidate must clear the SAME noise-aware bar the CI gate uses.
DEFAULT_FLOOR = 0.05
DEFAULT_IQR_K = 1.0
# attribution fraction below which a component-gated knob is pruned
MIN_COMPONENT_FRACTION = 0.05
# "a step that is 80% compute never explores prefetch depth"
COMPUTE_BOUND_FRACTION = 0.8


class TrialError(RuntimeError):
    """One measured trial failed (bench crashed, no ledger line)."""


@dataclasses.dataclass
class Trial:
    """One measured configuration and its verdict vs the then-best."""
    overrides: dict
    metrics: dict = None
    decision: str = "failed"     # improved | ok | regression | failed
    delta: float = None          # primary-metric relative delta
    threshold: float = None
    error: str = None


@dataclasses.dataclass
class SearchResult:
    bench: str
    primary_metric: str
    baseline: dict               # ledger-shaped metrics of defaults
    trials: list
    best_overrides: dict
    best_metrics: dict
    pruned: list                 # [(knob name, reason)]
    space_size: int
    device_kind: str = None


# -- trial runners -----------------------------------------------------------


class SubprocessTrialRunner:
    """Run one trial harness (``python -m sparkdl_tpu_torch.perf.trial
    <bench>``) as a bounded subprocess with the overrides as settings on
    its command line (not its environment), and read the trial's metrics
    back from the ledger line the harness itself appended to
    ``history_path`` (default :data:`~sparkdl_tpu_torch.observe.perf.
    HISTORY_PATH`, else a fresh temporary file) — the autotuner consumes
    the record a regression gate would read, not a private side
    channel."""

    bench = None                 # registry bench key
    ledger_bench = None          # the `bench` tag its harness writes
    primary_metric = None

    def __init__(self, *, history_path=None, extra_args=(), timeout=1800):
        from sparkdl_tpu_torch.observe import perf as operf

        self.history_path = (
            history_path or operf.default_history_path()
            or os.path.join(tempfile.mkdtemp(prefix="sparkdl-autotune-"),
                            "history.jsonl"))
        self.extra_args = list(extra_args)
        self.timeout = timeout
        self.device_kind = None

    def command(self, overrides):
        return [sys.executable, "-m", "sparkdl_tpu_torch.perf.trial",
                self.bench, "--settings", json.dumps(overrides),
                "--history", self.history_path]

    def attribution(self):
        """Breakdown-fractions report used for pruning, or None."""
        return None

    def _bounded_run(self, args, env):
        """subprocess with a REAL timeout: a child wedged in a CUDA call
        can survive the kill-then-communicate path of ``subprocess.run``,
        so kill the whole process group and abandon the pipes after a
        grace period. A timeout is a failed TRIAL (TrialError), never a
        crashed search."""
        import signal

        p = subprocess.Popen(
            args, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
        )
        try:
            out, err = p.communicate(timeout=self.timeout)
            return p.returncode, out, err
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                p.kill()
            try:
                p.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            raise TrialError(
                f"{self.bench} trial timed out after {self.timeout}s "
                "(killed)")

    def run(self, overrides):
        from sparkdl_tpu_torch.observe import perf as operf

        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        before = len(operf.read_history(self.history_path))
        rc, _, err = self._bounded_run(
            self.command(overrides) + self.extra_args, env)
        if rc != 0:
            raise TrialError(
                f"{self.bench} trial exited {rc}: {err.strip()[-400:]}")
        # Attribute ONLY a line this harness appended during this trial
        # (bench tag checked): a shared ledger's concurrent writer must
        # never back a "verified" profile with its numbers.
        new = [e for e in operf.read_history(self.history_path)[before:]
               if self.ledger_bench is None
               or e.get("bench") == self.ledger_bench]
        if not new:
            raise TrialError(
                f"{self.bench} trial appended no "
                f"bench={self.ledger_bench!r} ledger line to "
                f"{self.history_path} (ledger unwritable, or a "
                "concurrent writer raced the trial?)")
        entry = new[-1]
        self.device_kind = entry.get("device_kind")
        metrics = entry.get("metrics") or {}
        if self.primary_metric not in metrics:
            raise TrialError(
                f"{self.bench} ledger line is missing the primary "
                f"metric {self.primary_metric!r}")
        return metrics


class ServeRunner(SubprocessTrialRunner):
    """JAX's serve traffic through the port's paged int8 engine behind a
    ``FleetFrontend`` over HTTP streaming (:func:`~sparkdl_tpu_torch.
    perf.trial.serve`)."""

    bench = "serve"
    ledger_bench = "trial:serve"
    primary_metric = "serve_tokens_per_sec"


class TrainRunner(SubprocessTrialRunner):
    """A few timed LoRA steps (:func:`~sparkdl_tpu_torch.perf.trial.
    train`); the step time is the primary metric."""

    bench = "train"
    ledger_bench = "trial:train"
    primary_metric = "train_step_ms"

    def attribution(self):
        # Static, by construction rather than measurement (the JAX
        # cpu-proxy runner's declaration): one process, no input
        # pipeline, no collective, no host callback.
        return {
            "source": "static:perf.trial train, one process",
            "fractions": {"compute": 1.0, "data_wait": 0.0,
                          "collective": 0.0, "host_callback": 0.0},
        }


class GbdtRunner(SubprocessTrialRunner):
    """The JAX ``gbdt_bench.py`` harness on the port's
    ``XgboostClassifier`` (:func:`~sparkdl_tpu_torch.perf.trial.gbdt`);
    rows x trees a second of a fit is the primary metric, and the
    predict throughput rides the whole-record verification."""

    bench = "gbdt"
    ledger_bench = "gbdt_bench"
    primary_metric = "gbdt_fit_rows_per_sec"


RUNNERS = {"serve": ServeRunner, "train": TrainRunner, "gbdt": GbdtRunner}

# benches of the JAX autotuner this port refuses, and why
REFUSED_BENCHES = {
    "attention": "the attention trial tunes the TPU flash tiles "
                 "SPARKDL_TPU_FLASH_BLOCK_Q and _KV; the Hopper flash "
                 "kernels' tiles are fixed, so there is nothing to tune",
}


def make_runner(bench, **kw):
    """The trial runner of ``bench``; a refused bench raises
    NotImplementedError naming why."""
    if bench in REFUSED_BENCHES:
        raise NotImplementedError(
            f"autotune --bench {bench}: {REFUSED_BENCHES[bench]}")
    return RUNNERS[bench](**kw)


# -- space derivation + pruning ---------------------------------------------


def derive_space(bench, *, knob_names=None, value_overrides=None):
    """The declared search space: ``[(Knob, [values]), ...]`` from the
    registry's tunable settings for ``bench``. ``knob_names`` restricts
    (and may name any tunable setting — the operator widening the space
    past the declared bench mapping is a decision, not an error);
    ``value_overrides`` (name → list of values or their command-line
    spellings) replaces a setting's declared trial values."""
    value_overrides = dict(value_overrides or {})
    if knob_names:
        ks = []
        for name in knob_names:
            kb = knob_reg.get(name)
            if kb is None or not kb.tunable:
                raise SystemExit(
                    f"autotune: {name} is not a registered tunable "
                    "setting (see sparkdl_tpu_torch/utils/knobs.py)")
            ks.append(kb)
    else:
        ks = knob_reg.tunable_knobs(bench)
    space = []
    consumed = set()
    for kb in ks:
        if kb.name in value_overrides:
            consumed.add(kb.name)
            values = [knob_reg.parse_value(kb, v)
                      for v in value_overrides[kb.name]]
        else:
            values = list(kb.trial_values)
        if values:
            space.append((kb, values))
    unused = sorted(set(value_overrides) - consumed)
    if unused:
        # the loud-accounting contract: a typo'd --values must not
        # silently measure the declared space instead
        raise SystemExit(
            f"autotune: --values for {unused} match no knob in the "
            f"search space ({sorted(kb.name for kb in ks)}); check "
            "the spelling or add --knob")
    return space


def prune_space(space, report, *, min_fraction=MIN_COMPONENT_FRACTION,
                compute_bound=COMPUTE_BOUND_FRACTION):
    """Drop knobs whose gating component a measured (or declared)
    report shows is immaterial. Returns ``(kept, pruned)`` where
    ``pruned`` is ``[(knob name, reason), ...]`` — every drop is
    visible, nothing is silently capped."""
    fractions = (report or {}).get("fractions") or {}
    kept, pruned = [], []
    for kb, values in space:
        if kb.component:
            f = fractions.get(kb.component)
            if (f is None and kb.component == "data_wait"
                    and fractions.get("compute", 0.0) >= compute_bound):
                # the headline pruning rule: a compute-bound step has
                # no data-wait to hide even when the report carries no
                # explicit data_wait row
                f = 0.0
            if f is not None and f < min_fraction:
                pruned.append((kb.name,
                               f"{kb.component} fraction {f:.3f} < "
                               f"{min_fraction:g} "
                               f"(source: {report.get('source')})"))
                continue
        kept.append((kb, values))
    return kept, pruned


def _non_default(kb, values):
    return [v for v in values if v != kb.default]


# -- judging -----------------------------------------------------------------


def judge(base_metrics, cand_metrics, primary, *, floor=DEFAULT_FLOOR,
          iqr_k=DEFAULT_IQR_K):
    """One compare-gate verdict between two ledger-shaped metric maps:
    ``(decision, delta, threshold)`` on the PRIMARY metric, through
    the exact :func:`observe.compare.compare_records` math the CI
    gate runs — medians of rep samples, IQR-aware thresholds."""
    report = compare_records({"metrics": base_metrics},
                             {"metrics": cand_metrics},
                             floor=floor, iqr_k=iqr_k)
    row = next((r for r in report["metrics"] if r["metric"] == primary),
               None)
    if row is None:
        return "failed", None, None
    return row["status"], row["delta"], row["threshold"]


# -- the search --------------------------------------------------------------


def autotune(runner, space, *, floor=DEFAULT_FLOOR, iqr_k=DEFAULT_IQR_K,
             attribution=None, max_trials=None, log=logger.info):
    """Greedy coordinate-descent search; returns a
    :class:`SearchResult`. ``attribution`` overrides the runner's own
    report (an operator feeding a real telemetry ``perf.json``)."""
    report = attribution if attribution is not None \
        else runner.attribution()
    space, pruned = prune_space(space, report)
    for name, reason in pruned:
        log(f"pruned {name}: {reason}")
    plan = [(kb, v) for kb, values in space
            for v in _non_default(kb, values)]
    space_size = 1
    for kb, values in space:
        space_size *= len(set(values) | {kb.default})
    n_trials = 1 + len(plan)     # baseline + one per candidate value
    log(f"trial plan: {n_trials} measured trial(s) "
        f"(1 baseline + {len(plan)} candidate(s)) over "
        f"{len(space)} knob(s); configuration space size {space_size}; "
        f"pruned {len(pruned)} knob(s)")
    if max_trials is not None and n_trials > max_trials:
        raise SystemExit(
            f"autotune: trial plan needs {n_trials} trials but "
            f"--max-trials={max_trials}; narrow the space with "
            "--knob/--values instead of silently truncating")

    log("measuring baseline (defaults)")
    baseline = runner.run({})
    primary = runner.primary_metric
    best_metrics, best_overrides = baseline, {}
    trials = []
    for kb, values in space:
        adopted = None
        for v in _non_default(kb, values):
            overrides = dict(best_overrides)
            overrides[kb.name] = v
            try:
                metrics = runner.run(overrides)
            except TrialError as e:
                log(f"trial {kb.name}={v} FAILED: {e}")
                trials.append(Trial(overrides=overrides, error=str(e)))
                continue
            decision, delta, thr = judge(
                best_metrics, metrics, primary,
                floor=floor, iqr_k=iqr_k)
            trials.append(Trial(overrides=overrides, metrics=metrics,
                                decision=decision, delta=delta,
                                threshold=thr))
            log(f"trial {kb.name}={v}: {decision}"
                + (f" ({delta:+.1%} vs thr {thr:.1%})"
                   if delta is not None else ""))
            if decision == "improved" and (
                    adopted is None or delta > adopted[2]):
                adopted = (v, metrics, delta)
        if adopted is not None:
            v, metrics, delta = adopted
            best_overrides[kb.name] = v
            best_metrics = metrics
            log(f"adopted {kb.name}={v} ({delta:+.1%})")
    return SearchResult(
        bench=runner.bench, primary_metric=primary, baseline=baseline,
        trials=trials, best_overrides=best_overrides,
        best_metrics=best_metrics, pruned=pruned,
        space_size=space_size,
        device_kind=getattr(runner, "device_kind", None),
    )


def verify_and_emit(runner, result, *, floor=DEFAULT_FLOOR,
                    iqr_k=DEFAULT_IQR_K, log=logger.info):
    """The proof-or-degrade step: re-measure defaults and the winner
    fresh, pass them through the compare gate, and emit the profile
    doc — ``verified`` with the knobs on a pass (ties included: the
    contract is *no worse*, and a tie still pins the searched space),
    ``degraded`` with empty knobs on a regression."""
    evidence = {
        "primary_metric": result.primary_metric,
        "baseline": result.baseline,
        "pruned": [list(p) for p in result.pruned],
        "space_size": result.space_size,
        "trials": [
            {"overrides": t.overrides, "decision": t.decision,
             "delta": t.delta, "threshold": t.threshold,
             **({"error": t.error} if t.error else {})}
            for t in result.trials
        ],
    }
    if not result.best_overrides:
        log("search found no improving knob: defaults are the profile")
        evidence["verification"] = "skipped (empty winner = defaults)"
        return profile_mod.make_profile(
            {}, device_kind=result.device_kind, bench=result.bench,
            status=profile_mod.STATUS_VERIFIED, evidence=evidence)

    log("verification trial: fresh default run")
    v_default = runner.run({})
    log("verification trial: fresh winner run "
        f"({result.best_overrides})")
    v_winner = runner.run(result.best_overrides)
    report = compare_records({"metrics": v_default},
                             {"metrics": v_winner},
                             floor=floor, iqr_k=iqr_k)
    row = next((r for r in report["metrics"]
                if r["metric"] == result.primary_metric), None)
    evidence["verification"] = {
        "default": v_default, "winner": v_winner,
        "primary": row, "regressions": report["regressions"],
    }
    # "no worse" means the WHOLE record: a winner that improves the
    # primary but regresses a co-measured metric (gbdt predict
    # throughput, serve queue wait...) must not verify. Secondary
    # metrics count only when the compare gate's sample protection is
    # live on them (>= 4 rep samples on either side) — degrading a
    # real winner over one unprotected timed invocation would violate
    # the module's own never-a-single-invocation rule.
    def _protected(name):
        for side in (v_default, v_winner):
            samples = (side.get(name) or {}).get("samples") or ()
            if len(samples) >= 4:
                return True
        return False

    secondary_regressions = [
        r["metric"] for r in report["metrics"]
        if r["status"] == "regression"
        and r["metric"] != result.primary_metric
        and _protected(r["metric"])
    ]
    regressed = (row is None or row["status"] == "regression"
                 or bool(secondary_regressions))
    if regressed:
        log("VERIFICATION REGRESSED: degrading to defaults "
            f"(candidate was {result.best_overrides})")
        return profile_mod.make_profile(
            {}, device_kind=result.device_kind, bench=result.bench,
            status=profile_mod.STATUS_DEGRADED,
            candidate_knobs=result.best_overrides, evidence=evidence)
    log(f"verification passed ({row['delta']:+.1%} on "
        f"{result.primary_metric}); emitting verified profile")
    return profile_mod.make_profile(
        result.best_overrides, device_kind=result.device_kind,
        bench=result.bench, status=profile_mod.STATUS_VERIFIED,
        evidence=evidence)


# -- CLI ---------------------------------------------------------------------


def _parse_values(specs):
    out = {}
    for spec in specs or ():
        name, _, vals = spec.partition("=")
        if not vals:
            raise SystemExit(
                f"autotune: --values wants NAME=v1,v2 (got {spec!r})")
        out[name] = [v for v in vals.split(",")]
    return out


def _load_attribution(path):
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"autotune: unreadable attribution {path}: {e}")
    # accept a perf.json attribution doc or any breakdown doc — both
    # carry the fractions map the pruner reads
    if not isinstance(doc.get("fractions"), dict):
        raise SystemExit(
            f"autotune: {path} has no 'fractions' map (want an "
            "observe.perf breakdown/attribution document)")
    doc.setdefault("source", path)
    return doc


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.perf.autotune",
        description="Search the registered settings with measured trials; "
                    "emit a verified per-card profile the launcher "
                    "pre-flight applies.")
    ap.add_argument("--bench", choices=sorted(RUNNERS) +
                    sorted(REFUSED_BENCHES), default="serve")
    ap.add_argument("--knob", action="append", default=None,
                    help="restrict the space to this setting (repeatable)")
    ap.add_argument("--values", action="append", default=None,
                    metavar="NAME=v1,v2",
                    help="override a setting's trial values (repeatable)")
    ap.add_argument("--floor", type=float, default=DEFAULT_FLOOR)
    ap.add_argument("--iqr-k", type=float, default=DEFAULT_IQR_K)
    ap.add_argument("--attribution", default=None,
                    help="observe.perf breakdown JSON used for pruning "
                    "(default: the runner's own report)")
    ap.add_argument("--history", default=None,
                    help="ledger path for trial lines (default: "
                    "observe.perf.HISTORY_PATH, else a temporary file)")
    ap.add_argument("--out", default=None,
                    help="profile output path ('-' or absent: stdout "
                    "only)")
    ap.add_argument("--profile-dir", default=None,
                    help="write the profile to DIR/<card kind>/<bench>.json "
                    "(the layout perf.profile.PROFILE reads)")
    ap.add_argument("--trial-timeout", type=float, default=1800)
    ap.add_argument("--max-trials", type=int, default=None,
                    help="refuse (loudly) a plan larger than this — "
                    "never a silent cap")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the (pruned) trial plan and exit")
    ap.add_argument("--bench-arg", action="append", default=None,
                    help="extra argv token forwarded to the trial harness "
                    "(repeatable: --bench-arg=--layers=8)")
    args = ap.parse_args(argv)

    space = derive_space(args.bench, knob_names=args.knob,
                         value_overrides=_parse_values(args.values))
    runner = make_runner(args.bench, history_path=args.history,
                         extra_args=list(args.bench_arg or ()),
                         timeout=args.trial_timeout)
    if not space:
        raise SystemExit(
            f"autotune: no tunable settings registered for bench "
            f"{args.bench!r}")
    attribution = (_load_attribution(args.attribution)
                   if args.attribution else None)

    if args.dry_run:
        report = attribution if attribution is not None \
            else runner.attribution()
        kept, pruned = prune_space(space, report)
        plan = {
            "bench": args.bench,
            "knobs": {kb.name: _non_default(kb, values)
                      for kb, values in kept},
            "pruned": [list(p) for p in pruned],
            "trials": 1 + sum(len(_non_default(kb, v))
                              for kb, v in kept),
        }
        print(json.dumps(plan, indent=2, sort_keys=True))
        return 0

    result = autotune(runner, space, floor=args.floor,
                      iqr_k=args.iqr_k, attribution=attribution,
                      max_trials=args.max_trials)
    doc = verify_and_emit(runner, result, floor=args.floor,
                          iqr_k=args.iqr_k)
    path = args.out if args.out not in (None, "-") else None
    if path is None and args.profile_dir:
        try:
            path = profile_mod.profile_path(doc["device_kind"], args.bench,
                                            args.profile_dir)
        except profile_mod.ProfileError as e:
            # an unkeyable card must not discard a finished search:
            # print the document, name the problem, let the operator
            # --out it somewhere explicit
            print(json.dumps(doc, indent=2, sort_keys=True))
            print(f"autotune: could not key the profile ({e}); the "
                  "document is printed above — rerun with an explicit "
                  "--out to keep it", file=sys.stderr)
            return 1
    if path is None:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    profile_mod.save_profile(doc, path)
    print(json.dumps({"profile": path, "status": doc["status"],
                      "knobs": doc["knobs"],
                      **({"candidate_knobs": doc["candidate_knobs"]}
                         if "candidate_knobs" in doc else {})},
                     indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    # the search's log on stderr (an in-process caller keeps its own)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sys.exit(main())
