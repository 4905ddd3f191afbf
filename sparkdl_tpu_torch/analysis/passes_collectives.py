"""Collective-safety passes: gang deadlocks and full-param gathers.

Counterpart of ``sparkdl_tpu/analysis/passes_collectives.py``. A gang
dies two ways that run cleanly on one rank:

- ranks disagree on the *order* of collectives (a collective under a
  branch on the rank, a loop whose trip count is read from the card) and
  every rank blocks in a different collective, for good: NCCL collectives
  have no timeout;
- a tensor-parallel (or ZeRO-3) parameter is all-gathered whole every
  step: the numbers are right, the bytes and the memory are those of the
  unsharded weight.

The JAX package finds the first in one program's ``cond`` branches and
``while`` bodies; here each rank's step is traced as that rank
(:func:`~sparkdl_tpu_torch.analysis.trace.trace_step` with a mesh and a
rank), so ``lint_fn(mesh=...)`` and ``lint_gang`` compare the ranks'
collective sequences directly, and a rank's branch shows as the
divergence it causes.
"""

import re

from sparkdl_tpu_torch.analysis.core import Finding, Severity, register_pass
from sparkdl_tpu_torch.analysis.trace import (
    CollectiveEvent,
    OpEvent,
    hlo_dtype_of_name,
)

# ops that move a tensor's data into another storage and compute nothing
_MOVES = {"aten.clone.default", "aten._unsafe_view.default",
          "aten._to_copy.default", "aten.contiguous.default",
          "aten.cat.default", "aten.stack.default", "aten.copy_.default"}


def _names(params):
    head = ", ".join(p.path for p in params[:4])
    return head + (f", +{len(params) - 4} more" if len(params) > 4 else "")


def _at(trace, i):
    cols = trace.collectives
    if i >= len(cols):
        return "<end of program>"
    c = cols[i]
    where = f" at {c.location}" if c.location else ""
    return f"{c.kind}({c.axis})[{c.dtype}]{where}"


def check_gang_consistency(traces, names=None):
    """Cross-rank divergence: every rank of a gang must issue the SAME
    ordered collective sequence. Give one
    :class:`~sparkdl_tpu_torch.analysis.trace.Trace` per rank; a mismatch
    is an ERROR naming the first diverging position, both ranks'
    collectives there and their source lines."""
    if not traces:
        return []
    names = names or [f"rank {i}" for i in range(len(traces))]
    base = traces[0].signature()
    findings = []
    for name, trace in zip(names[1:], traces[1:]):
        sig = trace.signature()
        if sig == base:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(base, sig)) if a != b),
                   min(len(base), len(sig)))
        findings.append(Finding(
            rule_id="collective-consistency",
            severity=Severity.ERROR,
            op="gang",
            location="",
            message=(
                f"{names[0]} and {name} diverge at collective #{pos}: "
                f"{_at(traces[0], pos)} vs {_at(trace, pos)} — a gang "
                "whose ranks disagree on the collective order deadlocks at "
                "the first mismatch (NCCL collectives never time out)."),
        ))
    return findings


@register_pass("collective-consistency", requires=("trace",),
               severities=("ERROR", "WARNING"))
def collective_consistency(ctx):
    """Flag ranks that issue divergent collective sequences (gang
    deadlock), and a traced gang step whose control flow reads the card
    before its collectives end."""
    traces = ctx.traces or {ctx.trace.rank: ctx.trace}
    ranks = sorted(traces)
    # one finding a distinct sequence: the first rank that issues it
    # stands for the others
    firsts = {}
    for r in ranks:
        firsts.setdefault(traces[r].signature(), []).append(r)
    heads = [rs[0] for rs in firsts.values()]
    names = [f"rank {rs[0]}" + (f" (and {len(rs) - 1} more rank(s) with "
                                f"its sequence)" if len(rs) > 1 and i else "")
             for i, rs in enumerate(firsts.values())]
    findings = check_gang_consistency([traces[r] for r in heads],
                                      names=names)
    stopped = next((traces[r] for r in ranks
                    if traces[r].world > 1 and traces[r].stopped), None)
    if stopped is not None:
        s = stopped.stopped
        findings.append(Finding(
            rule_id="collective-consistency",
            severity=Severity.WARNING,
            op=s.op,
            location=s.location,
            message=(
                f"the step of rank {stopped.rank} of {stopped.world} reads "
                f"a card value on the host ({s.kind}) and its trace ends "
                f"there after {len(stopped.collectives)} collective(s): if "
                "the rest of the step's collectives depend on that value (a "
                "loop's trip count, a branch), a rank whose value differs "
                "takes another path and the gang deadlocks. Keep the "
                "collective order independent of card data, or make the "
                "value the same on every rank first."),
        ))
    return findings


def _leaf_path(path):
    """A traced input's path as a parameter's name: ``args[0]['w']`` ->
    ``w``, ``args[0]['llama']['w']`` -> ``llama.w``; a module's
    parameter keeps its name."""
    path = re.sub(r"^args\[\d+\]", "", path)
    path = re.sub(r"\[(?:'([^']*)'|(\d+))\]", lambda m: "." + (
        m.group(1) if m.group(1) is not None else m.group(2)), path)
    return path.lstrip(".")


def _param_storages(trace, paths):
    """The storages of ``trace`` that hold the data of the inputs named
    ``paths``: the inputs' own, and every storage a view, copy, cast,
    concatenation or collective makes from one (a key is dropped where
    a fresh allocation takes it again)."""
    held = {i.storage for i in trace.inputs
            if i.path in paths or _leaf_path(i.path) in paths}
    for e in trace.events:
        if isinstance(e, OpEvent):
            held.difference_update(e.allocs)
            if (e.view or e.name in _MOVES) and held.intersection(e.reads):
                held.update(e.out_storages)
        elif isinstance(e, CollectiveEvent) and e.out_storage is not None:
            held.discard(e.out_storage)
            if held.intersection(e.reads):
                held.add(e.out_storage)
    return held


@register_pass("full-param-allgather", requires=("trace", "param_info"),
               severities=("ERROR", "WARNING"))
def full_param_allgather(ctx):
    """Flag all-gathers that make a whole copy of a sharded parameter.

    An all-gather that sends a parameter's data (its local shard, or a
    view, copy, cast or concatenation of it: ZeRO-3's flat buffer) has
    its result matched in every form the step carries it on in (the
    views, reshapes and copies of it: the port's gathers concatenate
    along dim 0 and lay the result out after), against each parameter
    that its layout splits over a mesh axis of size > 1 (tensor
    parallelism's ``model``, ZeRO-3's ``fsdp``). A gather of an
    activation is not matched, whatever shape it takes on:

    - ERROR — a form is *exactly* the parameter's whole (dtype, shape);
    - WARNING — the same dims in another order (a transposed whole);
    - ``ctx.options["allgather_max_elements"]``, when set: any gather of
      a sharded parameter's dtype at or above that many elements is a
      WARNING (off by default).
    """
    sharded = [p for p in ctx.param_info if p.sharded_axes]
    if not sharded:
        return []
    by_shape, by_sorted = {}, {}
    for p in sharded:
        dt = hlo_dtype_of_name(p.dtype)
        by_shape.setdefault((dt, tuple(p.shape)), []).append(p)
        by_sorted.setdefault((dt, tuple(sorted(p.shape))), []).append(p)
    dtypes = {hlo_dtype_of_name(p.dtype) for p in sharded}
    bound = ctx.options.get("allgather_max_elements")
    weights = _param_storages(ctx.trace, {p.path for p in sharded})
    findings = []
    for col in ctx.trace.collectives:
        if col.kind != "all-gather":
            continue
        exact = relaid = None
        for dtype, shape in col.forms if weights.intersection(col.reads) \
                else ():
            exact = exact or by_shape.get((dtype, shape))
            relaid = relaid or by_sorted.get((dtype, tuple(sorted(shape))))
        dtype, shape = col.dtype, col.shape
        n = 1
        for d in shape:
            n *= d
        if exact:
            names = _names(exact)
            findings.append(Finding(
                rule_id="full-param-allgather", severity=Severity.ERROR,
                op="all-gather", location=col.location,
                message=(
                    f"all-gather on {col.axis} (result {dtype}"
                    f"{list(shape)}) makes the whole of sharded param(s) "
                    f"[{names}] ({exact[0].dtype}{list(exact[0].shape)}): "
                    "the unsharded weight is rebuilt every step, with its "
                    "bytes on the wire and in memory. Keep the weight "
                    "sharded and move the activations instead."),
            ))
        elif relaid:
            names = _names(relaid)
            findings.append(Finding(
                rule_id="full-param-allgather", severity=Severity.WARNING,
                op="all-gather", location=col.location,
                message=(
                    f"all-gather on {col.axis} (result {dtype}"
                    f"{list(shape)}) makes the whole dims, reordered, of "
                    f"sharded param(s) [{names}] — likely a transposed "
                    "whole copy of the weight."),
            ))
        elif bound is not None and dtype in dtypes and n >= bound:
            findings.append(Finding(
                rule_id="full-param-allgather", severity=Severity.WARNING,
                op="all-gather", location=col.location,
                message=(
                    f"all-gather result {dtype}{list(shape)} ({n} "
                    f"elements) reaches the configured bound ({bound}) — "
                    "check it is an activation, not a regathered weight."),
            ))
    return findings
