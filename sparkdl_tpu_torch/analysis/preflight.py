"""Launcher pre-flight lint: catch ERROR-class pickling bugs on the
driver before ``HorovodRunner`` spawns a single worker.

Counterpart of ``sparkdl_tpu/analysis/preflight.py``. Off by default
(:data:`ENABLED`, the JAX package's ``SPARKDL_TPU_PREFLIGHT_LINT``, read
at call time), so the ``run`` signature and the launch latency are
untouched. When it is on, the launcher calls :func:`preflight_lint` with
the exact ``(main, kwargs)`` it is about to cloudpickle, before the
supervisor loop, the slot claims and any spawn; ``HorovodRunner(np=-1)``
calls it before running ``main`` in-process. It lints ``main`` for the
captures the AST rule (:mod:`sparkdl_tpu_torch.analysis.selflint`) can
only guess at: a live ``SparkContext``/``SparkSession`` (unpicklable, the
gang dies at deserialization) or a ``torch.Tensor`` on a device other
than the CPU (its buffers ride the pickle to every rank and pin the
driver's card), in its closure or its globals, those of the functions
nested in it included; a finding raises :class:`PreflightLintError`.

Not ported: the graph passes over registered jitted steps, their comms
budget and the fix engine (:func:`register` raises), and the 64-bit
payload rule: JAX canonicalizes a float64 leaf to float32 inside ``jit``
without a word, torch keeps a float64 tensor as it is, so a 64-bit
payload is no silent bug here. The payload's values (``kwargs`` and,
for a gang of rank-private payloads, each rank's ``per_rank_kwargs``
entry) take the capture rule in its place: a device tensor or a live
Spark handle shipped as a value pickles as badly as one captured.
"""

import sys
import types

from sparkdl_tpu_torch.analysis.core import Finding, Severity

# the switch (the JAX package's SPARKDL_TPU_PREFLIGHT_LINT), read at
# call time
ENABLED = False

RULE_ID = "pickle-closure-capture"


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
    """The JAX package's registration of a jitted step for the graph
    passes; those passes (and their comms budget and fix engine) lint
    XLA programs and have no PyTorch counterpart."""
    raise NotImplementedError(
        "analysis.register (register_preflight) is not ported: the "
        "pre-flight's graph passes, comms budget and fix engine read "
        "jaxprs and compiled XLA programs, which a PyTorch step does "
        "not have")


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


def preflight_lint(main, kwargs, per_rank_kwargs=None):
    """Run the pre-flight lint; returns the findings (possibly empty)
    or raises :class:`PreflightLintError` on any ERROR. No-op (returns
    None) unless :data:`ENABLED`. ``kwargs`` and each entry of
    ``per_rank_kwargs`` (the launcher's rank-private payloads) get the
    same payload check, as in the JAX package; here that check is the
    capture rule on their values (module docstring)."""
    if not ENABLED:
        return None
    # every capture is an ERROR
    findings = _payload_findings(kwargs, "run() kwargs")
    for r, own in enumerate(per_rank_kwargs or ()):
        findings.extend(_payload_findings(own, f"per_rank_kwargs[{r}]"))
    findings.extend(_closure_findings(main))
    if findings:
        raise PreflightLintError(findings)
    return findings
