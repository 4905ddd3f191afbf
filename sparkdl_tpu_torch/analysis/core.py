"""The records of the reshard pre-flight: a parameter leaf as data
(:class:`ParamInfo`) and a diagnostic (:class:`Finding`) with its
:class:`Severity`.

Counterpart of ``sparkdl_tpu/analysis/core.py`` (those three, and the
catalog of the AST rules, :func:`register_rule_info` and
:func:`rule_catalog`; the pass registry and ``GraphContext`` serve graph
passes this port does not have). Severity contract: ``ERROR`` refuses,
``WARNING`` never blocks, ``INFO`` is a diagnostic.
"""

import enum
from dataclasses import dataclass


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


# The rules of the AST lints (the concurrency lint, the pickling
# contract) announce themselves here, as the JAX package's non-graph
# rules do, so that ``--list-rules`` covers them.
_EXTRA_RULES = {}


def register_rule_info(rule_id, severities, doc):
    """Catalog entry for one rule: the severities it can emit and a
    one-line description."""
    _EXTRA_RULES[rule_id] = (tuple(severities), doc)


def rule_catalog():
    """Every registered rule, ``rule_id -> (severities, one_liner)``."""
    # imported for their register_rule_info side effects
    from sparkdl_tpu_torch.analysis import concur, selflint  # noqa: F401

    return dict(_EXTRA_RULES)
