"""Pass framework for static analysis of a traced PyTorch step.

Counterpart of ``sparkdl_tpu/analysis/core.py``. The unit of work is a
:class:`GraphContext`: one traced step (a
:class:`~sparkdl_tpu_torch.analysis.trace.Trace`, which stands where the
JAX package holds a jaxpr and the lowered and compiled module texts),
the per-rank traces of a gang when there are several, and whatever side
information the caller can supply (the parameters' layout, the example
arguments). A *pass* is a function ``(ctx) -> iterable[Finding]``
registered under a stable rule id (:func:`register_pass`); a pass whose
required field is missing from the context does not run. The same
records serve the reshard pre-flight (:class:`ParamInfo`) and the AST
lints, whose rules join the catalog through :func:`register_rule_info`.

Severity contract (the CLI's exit code and the launcher's pre-flight key
off it): ``ERROR`` — the gang will deadlock, compute other numbers than
it should, or spend card hours for nothing; the pre-flight refuses the
launch. ``WARNING`` — heuristic or performance: worth a look, never
blocks. ``INFO`` — a diagnostic.
"""

import enum
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    @classmethod
    def parse(cls, name):
        try:
            return cls[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown severity {name!r}; expected one of "
                f"{[s.name.lower() for s in cls]}")


@dataclass(frozen=True)
class Finding:
    """One diagnostic."""

    rule_id: str
    severity: Severity
    op: str          # the offending parameter or name ("" if none)
    location: str    # "file:line" when known, else ""
    message: str

    def __str__(self):
        loc = f" [{self.location}]" if self.location else ""
        op = f" {self.op}:" if self.op else ""
        return (f"{self.severity.name:7s} {self.rule_id}{loc}{op} "
                f"{self.message}")

    def to_dict(self):
        return {
            "rule_id": self.rule_id,
            "severity": self.severity.name,
            "op": self.op,
            "location": self.location,
            "message": self.message,
        }


@dataclass
class ParamInfo:
    """One parameter leaf: its full (unsharded) shape and dtype (a
    numpy-style name, ``"bfloat16"``), the mesh axes of size > 1 its
    layout splits it over (``sharded_axes``), the per-dimension layout
    as data (``spec``: one tuple of axis names a dim, ``()`` for a whole
    dim) and the sorted ``(axis, size)`` pairs of the mesh it was laid
    out on (``mesh_axes``), from which the reshard plan recomputes the
    split of every dim under any target mesh."""

    path: str
    shape: tuple
    dtype: str
    sharded_axes: tuple
    spec: tuple = ()
    mesh_axes: tuple = ()

    @property
    def elements(self):
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclass
class GraphContext:
    """Everything a pass may look at. Every field is optional: passes
    name what they require and are skipped when it is absent.

    ``trace``: the step's :class:`~sparkdl_tpu_torch.analysis.trace.
    Trace` (of the first rank, when a mesh was traced rank by rank);
    ``traces``: ``{rank: Trace}`` of every traced rank, for the cross-
    rank checks; ``memory_stats``: the trace's static budget in the
    keys of the JAX package's ``memory_analysis`` dict
    (:meth:`~sparkdl_tpu_torch.analysis.trace.Trace.memory_stats`)."""

    fn_name: str = "<fn>"
    trace: object = None
    traces: dict = None
    param_info: list = None       # list[ParamInfo] of the step's params
    example_args: tuple = None    # the arguments the step was traced with
    fn: object = None             # the callable itself
    memory_stats: dict = None
    options: dict = field(default_factory=dict)


@dataclass(frozen=True)
class GraphPass:
    rule_id: str
    fn: object
    requires: tuple
    doc: str
    severities: tuple = ()


_REGISTRY = {}

# The rules that are not graph passes (the AST lints, the pickling
# contract, the reshard pre-flight) announce themselves here, as the JAX
# package's do, so that ``--list-rules`` covers every rule.
_EXTRA_RULES = {}


def register_rule_info(rule_id, severities, doc):
    """Catalog entry for one rule: the severities it can emit and a
    one-line description."""
    _EXTRA_RULES[rule_id] = (tuple(severities), doc)


def register_pass(rule_id, requires=(), severities=()):
    """Register ``fn(ctx) -> iterable[Finding]`` under ``rule_id``.
    ``requires`` names :class:`GraphContext` fields that must be set for
    the pass to run (it is skipped otherwise); ``severities`` names the
    levels the pass can emit (catalog metadata for ``--list-rules``)."""

    def deco(fn):
        _REGISTRY[rule_id] = GraphPass(
            rule_id=rule_id, fn=fn, requires=tuple(requires),
            doc=" ".join((fn.__doc__ or "").strip().split("\n\n")[0]
                         .split()),
            severities=tuple(severities))
        return fn

    return deco


def all_passes():
    """rule_id -> GraphPass, registration order preserved."""
    _load_builtin_passes()
    return dict(_REGISTRY)


def rule_catalog():
    """The whole rule surface: every graph pass and every other rule
    (the AST lints, the pickling contract, the reshard pre-flight), as
    ``rule_id -> (severities, one_liner)`` in registration order."""
    _load_builtin_passes()
    # imported for their register_rule_info side effects
    from sparkdl_tpu_torch.analysis import (  # noqa: F401
        comms,
        concur,
        selflint,
    )

    out = {rule_id: (p.severities, p.doc) for rule_id, p in _REGISTRY.items()}
    out.update(_EXTRA_RULES)
    return out


def _load_builtin_passes():
    # imported for their registrations; lazily, so that importing the
    # package stays light for the launcher
    from sparkdl_tpu_torch.analysis import (  # noqa: F401
        passes_collectives,
        passes_comms,
        passes_donation,
        passes_dtype,
        passes_host,
    )


def run_passes(ctx, passes=None):
    """Run ``passes`` (default: all registered; rule ids or
    :class:`GraphPass` objects) over ``ctx``; findings come back sorted
    most severe first, in source order within a severity."""
    _load_builtin_passes()
    if passes is None:
        selected = list(_REGISTRY.values())
    else:
        selected = []
        for p in passes:
            if isinstance(p, str):
                if p not in _REGISTRY:
                    raise ValueError(f"unknown pass {p!r}; registered: "
                                     f"{sorted(_REGISTRY)}")
                selected.append(_REGISTRY[p])
            else:
                selected.append(p)
    findings = []
    for p in selected:
        if any(getattr(ctx, r, None) is None for r in p.requires):
            continue
        findings.extend(p.fn(ctx))
    return sorted(findings, key=lambda f: -int(f.severity))


def max_severity(findings):
    return max((f.severity for f in findings), default=None)
