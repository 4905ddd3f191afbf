"""Communication and memory budget passes: memory overcommit and
unhidden collectives.

Counterpart of ``sparkdl_tpu/analysis/passes_comms.py``, two of its
three passes:

- ``hbm-overcommit`` — the traced step's static peak (its inputs, its
  outputs and the peak of its temporaries,
  :meth:`~sparkdl_tpu_torch.analysis.trace.Trace.memory_stats`), or the
  parameter and optimizer state re-laid onto a *target* mesh, does not
  fit the card's memory: an OOM a small trial never sees;
- ``unoverlapped-collective`` — collectives with no compute to hide
  under serialize the step behind the wire; the predicted hideable
  seconds are the target list for overlap work (the static twin of the
  measured ``overlap_efficiency``).

The third, ``implicit-reshard`` (arrays fed to a compiled program in
another layout than it was lowered for, resharded by XLA in silence), has
no counterpart: an eager PyTorch step fed a tensor laid out otherwise
fails with a shape error and never reshards in silence.
"""

import itertools

from sparkdl_tpu_torch.analysis import comms as comms_mod
from sparkdl_tpu_torch.analysis.core import Finding, Severity, register_pass
from sparkdl_tpu_torch.analysis.trace import CollectiveEvent


@register_pass("hbm-overcommit", requires=("memory_stats",),
               severities=("ERROR", "WARNING"))
def hbm_overcommit(ctx):
    """Flag steps whose static peak memory (the trace's, plus the
    parameter and optimizer state re-laid onto a target mesh when one is
    given) overcommits the card."""
    from sparkdl_tpu_torch.observe import perf

    stats = ctx.memory_stats
    capacity = ctx.options.get("hbm_bytes_per_device")
    if capacity is None:
        capacity = perf.hbm_capacity_bytes(ctx.options.get("device_kind"))
    if not capacity:
        return []     # no card budget to compare against (the CPU)
    headroom = float(ctx.options.get("hbm_headroom_fraction", 0.9))
    peak = (stats.get("argument_size_in_bytes", 0)
            + stats.get("output_size_in_bytes", 0)
            + stats.get("temp_size_in_bytes", 0)
            - stats.get("alias_size_in_bytes", 0))
    findings = []
    frac = peak / capacity
    if frac > 1.0:
        severity, verb = Severity.ERROR, "exceeds"
    elif frac > headroom:
        severity, verb = Severity.WARNING, "crowds"
    else:
        severity = None
    if severity is not None:
        findings.append(Finding(
            rule_id="hbm-overcommit", severity=severity, op="step",
            location="",
            message=(
                f"static peak {peak / 2**30:.2f} GiB (inputs + outputs + "
                f"peak temporaries of the traced step) {verb} the card's "
                f"{capacity / 2**30:.2f} GiB ({frac:.0%}): this step "
                + ("OOMs at its first call." if frac > 1.0 else
                   "leaves no headroom for the allocator's "
                   "fragmentation.")),
        ))
    # the elastic question: does the state still fit on the target mesh?
    target_axes = ctx.options.get("target_mesh_axes")
    if target_axes and ctx.param_info:
        source_axes = {}
        for info in ctx.param_info:
            source_axes.update(dict(info.mesh_axes))
        plan = comms_mod.reshard_plan(
            ctx.param_info, source_axes, dict(target_axes),
            local_device_count=ctx.options.get("local_device_count"),
            hbm_bytes=capacity,
            state_multiplier=float(ctx.options.get("state_multiplier", 3.0)))
        findings.extend(plan.problems)
    return findings


def _unhidden(trace):
    """The collectives of ``trace`` that no compute hides: an async one
    with no compute between its issue and its wait (or never waited
    for), and a sync one whose result the next compute reads (or after
    which nothing computes)."""
    events = trace.events     # in index order
    out = []
    for pos, col in enumerate(events):
        if not isinstance(col, CollectiveEvent):
            continue
        if not col.async_op:
            if col.feeds_next is not False:
                out.append(col)
            continue
        between = itertools.takewhile(
            lambda e, end=col.wait_index: end is None or e.index < end,
            itertools.islice(events, pos + 1, None))
        if not any(getattr(e, "compute", False) for e in between):
            out.append(col)
    return out


@register_pass("unoverlapped-collective", requires=("trace",),
               severities=("INFO",))
def unoverlapped_collective(ctx):
    """Report collectives the step serializes against its compute, with
    the predicted seconds that overlap could hide (the static twin of
    the measured overlap_efficiency).

    Hidden (silent): an async collective with compute between its issue
    and its wait, and a sync one whose result the next compute does not
    read. Reported: a sync collective whose result the next compute
    reads, an async one with nothing between issue and wait, and one
    after which the step computes nothing."""
    from sparkdl_tpu_torch.observe import perf

    cols = ctx.trace.collectives
    unhidden = _unhidden(ctx.trace)
    if not unhidden:
        return []
    kind_key = ctx.options.get("device_kind") or "h100"
    ici = perf.peak_interconnect_bytes_per_sec(kind_key)
    n_devices = ctx.options.get("n_devices")
    # one finding a signature: a ring issues many identical hops
    groups = {}
    for col in unhidden:
        groups.setdefault((col.kind, col.dtype, col.shape, col.async_op),
                          []).append(col)
    findings = []
    total_s = 0.0
    for (kind, dtype, shape, was_async), members in groups.items():
        n = comms_mod.group_size_of(members[0], n_devices=n_devices)
        wire = comms_mod.collective_wire_bytes(
            kind, members[0].result_bytes, n)
        secs = len(members) * (wire / ici if ici else 0.0)
        total_s += secs
        findings.append(Finding(
            rule_id="unoverlapped-collective", severity=Severity.INFO,
            op=kind, location=members[0].location,
            message=(
                f"{len(members)}x {kind} {dtype}{list(shape)}"
                + (f" (group size {n})" if n else "")
                + (" issued async but with no compute between issue and "
                   "wait" if was_async else " is barrier-style (sync)")
                + f": ~{len(members) * wire / 2**20:.2f} MiB on the wire, "
                  f"~{secs * 1e3:.2f} ms predicted hideable under compute "
                  "by an async issue and a later wait."),
        ))
    findings.insert(0, Finding(
        rule_id="unoverlapped-collective", severity=Severity.INFO,
        op="step", location="",
        message=(
            f"{len(unhidden)} of {len(cols)} collective(s) have no compute "
            f"to hide under — ~{total_s * 1e3:.2f} ms/step predicted "
            f"hideable on {kind_key} (interconnect {ici:.2e} B/s, ring "
            "assumption)."),
    ))
    return findings
