"""Launcher pre-flight lint: catch ERROR-class bugs on the driver before
``HorovodRunner`` spawns a single worker.

Counterpart of ``sparkdl_tpu/analysis/preflight.py``. Off by default
(:data:`ENABLED`, the JAX package's ``SPARKDL_TPU_PREFLIGHT_LINT``, read
at call time), so the ``run`` signature and the launch latency are
untouched. When it is on, the launcher calls :func:`preflight_lint` with
the exact ``(main, kwargs)`` it is about to cloudpickle, before the
supervisor loop, the slot claims and any spawn; ``HorovodRunner(np=-1)``
calls it before running ``main`` in-process. It

1. lints ``main`` for the captures the AST rule
   (:mod:`sparkdl_tpu_torch.analysis.selflint`) can only guess at: a live
   ``SparkContext``/``SparkSession`` (unpicklable, the gang dies at
   deserialization) or a ``torch.Tensor`` on a device other than the CPU
   (its buffers ride the pickle to every rank and pin the driver's
   card), in its closure or its globals, those of the functions nested
   in it included; the payload's values (``kwargs`` and each rank's
   ``per_rank_kwargs`` entry) take the same rule;
2. runs the graph passes over every step registered with
   :func:`register` (a callable and example arguments, traced here on
   ``meta`` tensors, every rank of its ``mesh=`` when given, or a
   :class:`~sparkdl_tpu_torch.analysis.trace.Trace`), and prices each
   one's collectives (:func:`~sparkdl_tpu_torch.analysis.comms.
   comms_report`); the launcher hands the reports
   (:func:`take_comms_reports`) to the gang's telemetry, which writes
   them to the run directory as ``comms_report.json``::

       analysis.register_preflight(step, batch, mesh={"data": 2})
       HorovodRunner(np=2).run(main)

With :data:`FIX` on as well (the JAX package's
``SPARKDL_TPU_PREFLIGHT_FIX``, read at call time), each registered
*callable* goes through the verified fix engine
(:func:`~sparkdl_tpu_torch.analysis.fixes.fix_program`, ``apply=True``)
first: a verified fix REPLACES the registered entry (step and example
arguments), so a later lint sees the repaired step, and the step's
findings are those left after the fixes; a fix that cannot be verified
degrades to its finding. The reports (:func:`take_fixit_reports`) land
in the run directory as ``fixit_report.json`` beside the comms reports.
A registered :class:`~sparkdl_tpu_torch.analysis.trace.Trace` cannot be
fixed (there is no step to rewrite) and is linted as it is, with a
warning. The repair covers the step registered in this process: a worker
``main`` that builds its own step applies the reported fix itself
(``lower_train_step(donate_argnums=...)``, a 0-d tensor for the scalar,
the cast).

Any ERROR raises :class:`PreflightLintError` before anything is spawned;
WARNING and INFO findings are logged. A step the lint cannot trace is
logged and the launch goes on, as in the JAX package.

The JAX pre-flight's 64-bit payload rule stays out: JAX canonicalizes a
float64 leaf to float32 inside ``jit`` without a word, torch keeps a
float64 tensor as it is, so a 64-bit payload is no silent bug here (a
64-bit *step input* is the ``silent-canonicalization`` pass's, on a
registered step).
"""

import logging
import sys
import types

from sparkdl_tpu_torch.analysis.core import Finding, Severity

# the switch (the JAX package's SPARKDL_TPU_PREFLIGHT_LINT), read at
# call time
ENABLED = False

# the fix engine over the registered steps, with ENABLED (the JAX
# package's SPARKDL_TPU_PREFLIGHT_FIX), read at call time
FIX = False

RULE_ID = "pickle-closure-capture"

logger = logging.getLogger("HorovodRunner")

# (step or trace, example args, lint options) registered for the next
# launches, driver-side and never pickled
_REGISTERED = []

# the comms reports of the newest preflight_lint run, drained by the
# launcher into the gang's run directory
_COMMS_REPORTS = []

# the fixit reports of the newest preflight_lint run (one a fixed
# registered step), drained the same way into fixit_report.json
_FIXIT_REPORTS = []


class PreflightLintError(RuntimeError):
    """ERROR-severity findings in the pre-flight lint; the gang was
    never launched. ``.findings`` carries the full finding list
    (most-severe first — WARNINGs ride along for context)."""

    def __init__(self, findings):
        self.findings = sorted(findings, key=lambda f: -int(f.severity))
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            "pre-flight lint found ERROR-severity problems; refusing "
            "to launch the gang (set sparkdl_tpu_torch.analysis."
            f"preflight.ENABLED = False to skip the lint):\n{lines}")


def register(obj, *args, **opts):
    """Register a driver-side step for the pre-flight's graph lint: a
    callable plus example arguments (traced at pre-flight time, nothing
    run on the card), or a :class:`~sparkdl_tpu_torch.analysis.trace.
    Trace` (:func:`~sparkdl_tpu_torch.parallel.train.lower_train_step`'s).
    ``opts`` go to the lint (``mesh=``, ``params=``, ``shardings=``,
    ``device=``, ``passes=``, ``options=``...). Returns ``obj``."""
    from sparkdl_tpu_torch.analysis.trace import Trace

    if not (isinstance(obj, Trace) or callable(obj)):
        raise TypeError(f"register_preflight takes a step (a callable and "
                        f"its example arguments) or a Trace, not "
                        f"{type(obj).__name__}")
    _REGISTERED.append((obj, args, opts))
    return obj


def clear():
    """Drop every registered step."""
    _REGISTERED.clear()


def take_comms_reports():
    """Drain the comms reports the last pre-flight produced."""
    out = list(_COMMS_REPORTS)
    _COMMS_REPORTS.clear()
    return out


def take_fixit_reports():
    """Drain the fixit reports the last pre-flight produced."""
    out = list(_FIXIT_REPORTS)
    _FIXIT_REPORTS.clear()
    return out


def fix_enabled():
    """Whether the pre-flight runs the fix engine (:data:`FIX`)."""
    return bool(FIX)


register_preflight = register


def _classify(name, value, via):
    tname = type(value).__name__
    mod = getattr(type(value), "__module__", "") or ""
    if tname in ("SparkContext", "SparkSession") and \
            mod.startswith("pyspark"):
        return Finding(
            rule_id=RULE_ID, severity=Severity.ERROR, op=tname,
            location="",
            message=(
                f"main captures the live {tname} {name!r} via {via}: "
                "SparkContext/SparkSession are not picklable, so every "
                "worker dies deserializing the payload. Create Spark "
                "handles inside main() on the driver only, never "
                "capture them."))
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor) \
            and value.device.type != "cpu":
        return Finding(
            rule_id=RULE_ID, severity=Severity.ERROR, op="torch.Tensor",
            location="",
            message=(
                f"main captures the {value.device} tensor {name!r} "
                f"(shape {tuple(value.shape)}) via {via}: its buffers "
                "ride the cloudpickle to every rank and pin the "
                "driver's device. Build tensors inside main() from host "
                "data."))
    return None


def _global_refs(code):
    """Globals referenced by ``code`` OR any function nested in it
    (nested code objects ride co_consts): a capture inside a helper def
    pickles exactly the same way."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _global_refs(const)
    return names


def _closure_findings(main):
    """Runtime pickling-contract check on the actual function object:
    unlike the AST rule (which sees source), this sees the live
    captures cloudpickle would serialize."""
    findings = []
    code = getattr(main, "__code__", None)
    closure = getattr(main, "__closure__", None) or ()
    freevars = getattr(code, "co_freevars", ()) if code else ()
    for name, cell in zip(freevars, closure):
        try:
            value = cell.cell_contents
        except ValueError:
            continue
        f = _classify(name, value, "its closure")
        if f:
            findings.append(f)
    if code is not None:
        g = getattr(main, "__globals__", {})
        for name in sorted(_global_refs(code)):
            if name in g:
                f = _classify(name, g[name], "a module global")
                if f:
                    findings.append(f)
    return findings


def _payload_findings(kwargs, where):
    findings = []
    for name, value in sorted((kwargs or {}).items()):
        f = _classify(name, value, where)
        if f:
            findings.append(f)
    return findings


def _lint_registered():
    """The graph passes' findings over every registered step (after the
    fix engine's, with :data:`FIX`); their comms reports go to
    :data:`_COMMS_REPORTS`, the fixit reports to :data:`_FIXIT_REPORTS`."""
    from sparkdl_tpu_torch.analysis import (
        _context_for,
        _lowered_context,
        run_passes,
    )
    from sparkdl_tpu_torch.analysis.comms import comms_report
    from sparkdl_tpu_torch.analysis.trace import Trace

    do_fix = fix_enabled()
    findings = []
    for index, (obj, args, opts) in enumerate(list(_REGISTERED)):
        opts = dict(opts)
        passes = opts.pop("passes", None)
        try:
            if isinstance(obj, Trace):
                if do_fix:
                    logger.warning(
                        "pre-flight fix: registered trace %r has no step "
                        "to rewrite; register the callable and its example "
                        "arguments to enable the fixes; linting it unfixed",
                        obj.fn_name)
                ctx = _lowered_context(obj, **opts)
                step_findings = run_passes(ctx, passes=passes)
            elif do_fix and passes is None:
                ctx, step_findings = _fix_registered(index, obj, args, opts)
            else:
                ctx = _context_for(obj, args, **opts)
                step_findings = run_passes(ctx, passes=passes)
        except Exception as e:  # noqa: BLE001 - a user step's own fault
            logger.warning("pre-flight lint could not trace %r (%s: %s); "
                           "launching anyway", obj, type(e).__name__, e)
            continue
        findings.extend(step_findings)
        report = comms_report(ctx.trace, name=ctx.fn_name)
        _COMMS_REPORTS.append(report)
        t = report["totals"]
        logger.info(
            "pre-flight comms budget [%s]: %d collective(s), %.2f MiB a "
            "device on the wire, ~%.3f ms a step predicted (%s, ring "
            "assumption)", ctx.fn_name, t["count"],
            t["wire_bytes_per_device"] / 2**20, t["predicted_s"] * 1e3,
            report["device_kind"])
    return findings


def _fix_registered(index, obj, args, opts):
    """The fix engine over registered step ``index``; a verified fix
    replaces the entry. Returns ``(context, findings after the fixes)``."""
    from sparkdl_tpu_torch.analysis.fixes import fix_program

    # a name= in the register() options wins over the step's own
    name = opts.pop("name", None) or getattr(obj, "__name__",
                                             f"registered[{index}]")
    result = fix_program(obj, args, apply=True, name=name, **opts)
    _FIXIT_REPORTS.append(result.report)
    if result.fn is not obj:
        _REGISTERED[index] = (result.fn, result.example_args,
                              dict(opts, name=name))
        logger.warning(
            "pre-flight fix repaired registered step %s; a worker main "
            "that builds this step itself must apply the reported fix "
            "(lower_train_step(donate_argnums=...) and the like, from "
            "fixit_report.json) for the gang to benefit", name)
    return result.ctx, result.findings_after


def preflight_lint(main, kwargs, per_rank_kwargs=None):
    """Run the pre-flight lint; returns the findings (possibly empty)
    or raises :class:`PreflightLintError` on any ERROR. No-op (returns
    None) unless :data:`ENABLED`. ``kwargs`` and each entry of
    ``per_rank_kwargs`` (the launcher's rank-private payloads) get the
    same payload check, as in the JAX package; here that check is the
    capture rule on their values (module docstring)."""
    # cleared on every call: a refused or lint-off launch must never hand
    # an earlier launch's reports to its run directory
    _COMMS_REPORTS.clear()
    _FIXIT_REPORTS.clear()
    if not ENABLED:
        return None
    findings = _payload_findings(kwargs, "run() kwargs")
    for r, own in enumerate(per_rank_kwargs or ()):
        findings.extend(_payload_findings(own, f"per_rank_kwargs[{r}]"))
    findings.extend(_closure_findings(main))
    findings.extend(_lint_registered())
    findings.sort(key=lambda f: -int(f.severity))
    for f in findings:
        if f.severity < Severity.ERROR:
            logger.warning("pre-flight lint: %s", f)
    if any(f.severity >= Severity.ERROR for f in findings):
        _COMMS_REPORTS.clear()   # no gang, no run directory
        _FIXIT_REPORTS.clear()
        raise PreflightLintError(findings)
    return findings
