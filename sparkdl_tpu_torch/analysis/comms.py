"""Static communication and resharding cost model.

Counterpart of ``sparkdl_tpu/analysis/comms.py``:

- :func:`comms_report` — price every collective of a traced step
  (:class:`~sparkdl_tpu_torch.analysis.trace.Trace`; the JAX package
  reads them from the compiled HLO) in bytes on the wire a device under
  the ring assumption, then in seconds against the card's interconnect
  row of :data:`sparkdl_tpu_torch.observe.perf.PEAK_TABLE` (the H100's
  NVLink unless the caller names another kind). The report keeps the
  JAX package's schema, ``sparkdl_tpu.analysis.comms_report/1``, key for
  key and in its dtype spelling (``"f32"``), so either package's readers
  (``observe.doctor``'s predicted-vs-measured section) take it; the
  launcher's pre-flight writes it to the run directory as
  ``comms_report.json``.
- :func:`reshard_plan` and what rides it (:class:`ReshardPreflightError`,
  :class:`ReshardPlan`, :func:`param_info_from_sidecar`,
  :func:`shrink_mesh`, and the gang-sharding registry that the
  supervisor's pre-flight of an elastic relaunch reads:
  :func:`register_gang_sharding`, :func:`registered_gang_sharding`,
  :func:`clear_gang_sharding`, :func:`check_relaunch_np`), with the same
  byte arithmetic and the same finding messages. The per-device memory
  budget defaults to the CUDA device's total memory, and to none (no
  check) on the CPU.

Ring assumption, as the JAX module states it: every collective is priced
as its bandwidth-optimal ring variant, each device sending and receiving
``(n-1)/n`` of the data a pass, all-reduce paying two passes.
"""

import json
from dataclasses import dataclass, field

from sparkdl_tpu_torch.analysis.core import (
    Finding,
    ParamInfo,
    Severity,
    register_rule_info,
)

COMMS_SCHEMA = "sparkdl_tpu.analysis.comms_report/1"

register_rule_info(
    "reshard-infeasible", ("ERROR",),
    "Elastic-relaunch pre-flight: the sharding tree cannot be re-laid onto "
    "the target mesh (indivisible dim, fractional-host placement, or "
    "restore high-water over the memory budget).")

# numpy-style dtype name -> bytes, for ParamInfo trees
DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1,
    "uint64": 8, "uint32": 4, "uint16": 2, "uint8": 1, "bool": 1,
    "complex64": 8, "complex128": 16,
}


def param_nbytes(info):
    """Full (unsharded) bytes of one :class:`ParamInfo` leaf."""
    return info.elements * DTYPE_BYTES.get(info.dtype, 4)


def collective_wire_bytes(kind, result_bytes, group_size):
    """Per-device bytes on the wire for one collective, given its RESULT
    size in bytes and its group size, under the ring assumption (the JAX
    package's function):

    - ``all-reduce``: ``2 * (n-1)/n * payload``;
    - ``all-gather``: the result is the gathered whole, each device
      receives the other ``n-1`` shards: ``(n-1)/n * whole``;
    - ``reduce-scatter``: the result is one shard, each device ships
      ``n-1`` of them: ``(n-1) * shard``;
    - ``all-to-all``: ``(n-1)/n * payload``;
    - ``collective-permute`` / ``collective-broadcast``: one payload
      copy, whatever the group size.

    ``group_size <= 1`` (or unknown, ``None``) proves no traffic: 0,
    except for permute and broadcast."""
    n = group_size or 0
    if kind in ("collective-permute", "collective-broadcast"):
        return float(result_bytes) if n != 1 else 0.0
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return float((n - 1) * result_bytes)
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)


def group_size_of(col, n_devices=None):
    """Participant count of one traced collective
    (:class:`~sparkdl_tpu_torch.analysis.trace.CollectiveEvent`): the
    size of its group, or ``n_devices`` when it has none."""
    return col.group_size or n_devices


def comms_report(trace, *, n_devices=None, device_kind=None,
                 ici_bytes_per_sec=None, name=None):
    """Price every collective of a traced step. Returns the comms report
    (schema ``sparkdl_tpu.analysis.comms_report/1``)::

        {"schema": ..., "name": ..., "device_kind": ...,
         "ici_bytes_per_sec": float,
         "assumptions": {"algorithm": "ring", "serialized": True,
                         "n_devices": ...},
         "collectives": [{"index", "kind", "dtype", "shape",
                          "group_size", "async_start",
                          "result_bytes", "wire_bytes_per_device",
                          "predicted_s"}, ...],
         "totals": {"count", "wire_bytes_per_device", "predicted_s",
                    "by_kind": {kind: {"count", "wire_bytes_per_device",
                                       "predicted_s"}}}}

    ``predicted_s`` divides a device's wire bytes by the interconnect
    row of ``device_kind`` (default ``"h100"``: the card the port runs
    on, whatever device prices it) in
    :data:`sparkdl_tpu_torch.observe.perf.PEAK_TABLE`, or by
    ``ici_bytes_per_sec``; the total assumes the collectives run one
    after another. ``n_devices`` defaults to the traced world."""
    from sparkdl_tpu_torch.observe import perf

    if n_devices is None:
        n_devices = trace.world
    kind = device_kind or "h100"
    ici = (float(ici_bytes_per_sec) if ici_bytes_per_sec
           else perf.peak_interconnect_bytes_per_sec(kind))
    entries, by_kind = [], {}
    for col in trace.collectives:
        n = group_size_of(col, n_devices=n_devices)
        wire = collective_wire_bytes(col.kind, col.result_bytes, n)
        secs = wire / ici if ici else None
        entries.append({
            "index": col.index, "kind": col.kind, "dtype": col.dtype,
            "shape": list(col.shape), "group_size": n,
            "async_start": col.async_op, "result_bytes": col.result_bytes,
            "wire_bytes_per_device": wire, "predicted_s": secs})
        agg = by_kind.setdefault(col.kind, {
            "count": 0, "wire_bytes_per_device": 0.0, "predicted_s": 0.0})
        agg["count"] += 1
        agg["wire_bytes_per_device"] += wire
        agg["predicted_s"] += secs or 0.0
    return {
        "schema": COMMS_SCHEMA,
        "name": name or trace.fn_name,
        "device_kind": kind,
        "ici_bytes_per_sec": ici,
        "assumptions": {"algorithm": "ring", "serialized": True,
                        "n_devices": n_devices},
        "collectives": entries,
        "totals": {
            "count": len(entries),
            "wire_bytes_per_device": sum(
                e["wire_bytes_per_device"] for e in entries),
            "predicted_s": sum(e["predicted_s"] or 0.0 for e in entries),
            "by_kind": by_kind,
        },
    }


def write_report(report, path):
    """Write one comms report, or a list of them, as JSON under
    ``{"reports": [...]}`` (the run directory's ``comms_report.json``
    shape)."""
    doc = report if isinstance(report, dict) and "reports" in report \
        else {"reports": report if isinstance(report, list) else [report]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return path


def device_memory_bytes():
    """The current CUDA device's total memory in bytes, or None without
    one (the CPU has no budget to check against)."""
    import torch

    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return float(props.total_memory)


class ReshardPreflightError(RuntimeError):
    """The reshard pre-flight proved the target mesh infeasible.
    ``.findings`` names every failing param or axis, most severe first;
    ``.plan`` carries the full :class:`ReshardPlan`."""

    def __init__(self, findings, plan=None):
        self.findings = sorted(findings, key=lambda f: -int(f.severity))
        self.plan = plan
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            "resharded restore refused: the recorded sharding tree cannot "
            f"be re-laid onto the target mesh:\n{lines}")


def _dim_partitions(spec_entry, axes):
    n = 1
    for a in (spec_entry or ()):
        n *= int(axes.get(a, 1))
    return n


def _shard_factor(info, axes):
    """How many ways ``axes`` split this leaf (product over dims)."""
    factor = 1
    for dim in range(len(info.shape)):
        spec = info.spec[dim] if dim < len(info.spec) else ()
        factor *= _dim_partitions(spec, axes)
    return factor


@dataclass
class ReshardPlan:
    """Feasibility verdict and sizing for re-laying one sharding tree
    onto a target mesh. ``problems`` are :class:`Finding` s (ERROR =
    infeasible); byte figures are for the whole tree (params plus
    ``state_multiplier`` x for optimizer state of the params' shapes)."""

    source_axes: dict
    target_axes: dict
    problems: list = field(default_factory=list)
    state_bytes_total: int = 0
    per_device_bytes_source: int = 0
    per_device_bytes_target: int = 0
    transfer_bytes_per_device: int = 0
    restore_high_water_bytes: int = 0
    hbm_bytes: float = None

    @property
    def feasible(self):
        return not any(p.severity >= Severity.ERROR for p in self.problems)

    def to_dict(self):
        return {
            "source_axes": dict(self.source_axes),
            "target_axes": dict(self.target_axes),
            "feasible": self.feasible,
            "problems": [p.to_dict() for p in self.problems],
            "state_bytes_total": self.state_bytes_total,
            "per_device_bytes_source": self.per_device_bytes_source,
            "per_device_bytes_target": self.per_device_bytes_target,
            "transfer_bytes_per_device": self.transfer_bytes_per_device,
            "restore_high_water_bytes": self.restore_high_water_bytes,
            "hbm_bytes": self.hbm_bytes,
        }


def reshard_plan(param_info, source_axes, target_axes, *,
                 local_device_count=None, hbm_bytes=None,
                 state_multiplier=3.0):
    """Check that ``param_info`` (:class:`ParamInfo` leaves with
    ``spec``: :func:`sparkdl_tpu_torch.parallel.sharding.sharding_tree_info`)
    can be re-laid onto ``target_axes`` (mesh axis name -> size).

    Checks, in order:

    1. **Divisibility**: every split dim of every leaf divides by the
       product of its spec axes' target sizes (an axis absent from the
       target counts as 1, replicated). An indivisible leaf is an ERROR
       naming the param and the axis.
    2. **Per-host placement**: with ``local_device_count`` given, the
       target mesh is a whole number of hosts.
    3. **Restore high water**: while a restore re-lays the tree a device
       holds its new shard plus, at worst, one old shard of everything;
       over ``hbm_bytes`` (default :func:`device_memory_bytes`) is an
       ERROR.

    ``state_multiplier`` scales the params' bytes to the whole train
    state (params + AdamW's two moments = 3.0); 1.0 for a tree that is
    the state.
    """
    if hbm_bytes is None:
        hbm_bytes = device_memory_bytes()
    problems = []
    total = 0
    src_dev = 0.0
    tgt_dev = 0.0
    for info in param_info or []:
        nbytes = param_nbytes(info) * state_multiplier
        total += nbytes
        src_dev += nbytes / _shard_factor(info, source_axes)
        for dim in range(len(info.shape)):
            spec = info.spec[dim] if dim < len(info.spec) else ()
            parts = _dim_partitions(spec, target_axes)
            if parts > 1 and info.shape[dim] % parts:
                axes_s = "/".join(spec)
                problems.append(Finding(
                    rule_id="reshard-infeasible",
                    severity=Severity.ERROR,
                    op=info.path,
                    location="",
                    message=(
                        f"param {info.path} dim {dim} (size "
                        f"{info.shape[dim]}) does not divide by "
                        f"{parts} (target mesh axis '{axes_s}'): the "
                        "shrunken mesh cannot shard this leaf; change "
                        "the target np or reshape the param."),
                ))
        tgt_dev += nbytes / _shard_factor(info, target_axes)
    mesh_size = 1
    for v in target_axes.values():
        mesh_size *= int(v)
    if local_device_count and mesh_size % int(local_device_count):
        problems.append(Finding(
            rule_id="reshard-infeasible",
            severity=Severity.ERROR,
            op="mesh",
            location="",
            message=(
                f"target mesh of {mesh_size} device(s) is not a whole "
                f"number of hosts ({local_device_count} local "
                "device(s) each): a gang cannot claim a fraction of a "
                "host's chips."),
        ))
    # the worst case: the new (target) shard of everything and one old
    # (source) shard of everything resident at once
    high_water = int(tgt_dev + src_dev)
    if hbm_bytes and high_water > hbm_bytes:
        problems.append(Finding(
            rule_id="reshard-infeasible",
            severity=Severity.ERROR,
            op="hbm",
            location="",
            message=(
                f"restore high-water {high_water / 2**30:.2f} GiB "
                f"(new shard {tgt_dev / 2**30:.2f} + old shard "
                f"{src_dev / 2**30:.2f}) exceeds the per-device HBM "
                f"budget {hbm_bytes / 2**30:.2f} GiB: this shrink "
                "OOMs mid-restore. Target a larger np or stream the "
                "restore."),
        ))
    return ReshardPlan(
        source_axes=dict(source_axes),
        target_axes=dict(target_axes),
        problems=problems,
        state_bytes_total=int(total),
        per_device_bytes_source=int(src_dev),
        per_device_bytes_target=int(tgt_dev),
        transfer_bytes_per_device=int(tgt_dev),
        restore_high_water_bytes=high_water,
        hbm_bytes=hbm_bytes,
    )


def param_info_from_sidecar(doc):
    """:class:`ParamInfo` list from a checkpoint's sharding-tree sidecar
    (:data:`sparkdl_tpu_torch.utils.checkpoint.SHARDING_TREE_SCHEMA`),
    so :func:`reshard_plan` can price a restore from what the run
    persisted. An axis name absent from the recorded ``mesh_axes``
    counts as unsplit (size 1)."""
    from sparkdl_tpu_torch.utils.checkpoint import sidecar_mesh_axes

    sizes = sidecar_mesh_axes(doc)
    mesh_axes = tuple(sorted(sizes.items()))
    out = []
    for p in doc.get("params") or []:
        spec = tuple(tuple(str(n) for n in (dims or ()))
                     for dims in (p.get("spec") or ()))
        out.append(ParamInfo(
            path=str(p.get("path", "")),
            shape=tuple(int(d) for d in p.get("shape") or ()),
            dtype=str(p.get("dtype", "float32")),
            sharded_axes=tuple(n for dims in spec for n in dims
                               if sizes.get(n, 1) > 1),
            spec=spec,
            mesh_axes=mesh_axes,
        ))
    return out


def shrink_mesh(source_axes, target_np):
    """A mesh for ``target_np`` ranks from ``source_axes``: ``model`` and
    ``seq`` (the axes that change the program) are kept, the data-like
    axes absorb the change, ``fsdp`` kept when the remainder still
    divides by it, else folded into ``data``. Returns ``(axes, None)``
    or ``(None, reason)``. Works both ways: a shrink after a preemption
    and the grow back."""
    model = int(source_axes.get("model", 1))
    seq = int(source_axes.get("seq", 1))
    fixed = model * seq
    if target_np < fixed or target_np % fixed:
        return None, (
            f"target np={target_np} is not a multiple of the "
            f"preserved model*seq axes ({model}*{seq}={fixed})")
    remaining = target_np // fixed
    fsdp = int(source_axes.get("fsdp", 1))
    if fsdp > 1 and remaining % fsdp == 0:
        return ({"data": remaining // fsdp, "fsdp": fsdp,
                 "seq": seq, "model": model}, None)
    return ({"data": remaining, "fsdp": 1, "seq": seq, "model": model},
            None)


# -- the gang's sharding tree (the supervisor's pre-flight input) -------------

_GANG_SHARDING = None


def register_gang_sharding(param_info, source_axes, *,
                           local_device_count=None, hbm_bytes=None,
                           state_multiplier=3.0):
    """Register the running gang's sharding tree (:class:`ParamInfo`
    leaves) and mesh axes, so that the supervisor can check an elastic
    relaunch at another world size before it relaunches
    (:func:`check_relaunch_np`). Driver-side, never pickled; the wrapper
    :func:`sparkdl_tpu_torch.analysis.register_gang_sharding` builds both
    from a model or a state dict and a mesh."""
    global _GANG_SHARDING
    _GANG_SHARDING = {
        "param_info": list(param_info),
        "source_axes": dict(source_axes),
        "local_device_count": local_device_count,
        "hbm_bytes": hbm_bytes,
        "state_multiplier": state_multiplier,
    }
    return _GANG_SHARDING


def registered_gang_sharding():
    return _GANG_SHARDING


def clear_gang_sharding():
    """Drop the registered tree."""
    global _GANG_SHARDING
    _GANG_SHARDING = None


def note_gang_axes(axes):
    """The supervisor's hook: the registered gang now runs on ``axes``
    (an elastic relaunch's target mesh), the source of the next
    relaunch's pre-flight and restart context. No-op without a
    registered tree."""
    if _GANG_SHARDING is not None and axes:
        _GANG_SHARDING["source_axes"] = dict(axes)


def check_relaunch_np(target_np):
    """The supervisor's pre-flight of relaunching the registered gang at
    ``target_np`` ranks: the :class:`ReshardPlan`, or None when no tree
    is registered (nothing provable; the relaunch goes unchecked).
    Raises :class:`ReshardPreflightError` naming the failing leaf or axis
    when :func:`shrink_mesh` finds no mesh or the plan is infeasible."""
    reg = _GANG_SHARDING
    if reg is None:
        return None
    target_axes, reason = shrink_mesh(reg["source_axes"], int(target_np))
    if target_axes is None:
        raise ReshardPreflightError([Finding(
            rule_id="reshard-infeasible",
            severity=Severity.ERROR,
            op="mesh",
            location="",
            message=f"no target mesh for np={target_np}: {reason}",
        )])
    plan = reshard_plan(
        reg["param_info"], reg["source_axes"], target_axes,
        local_device_count=reg["local_device_count"],
        hbm_bytes=reg["hbm_bytes"],
        state_multiplier=reg["state_multiplier"],
    )
    if not plan.feasible:
        raise ReshardPreflightError(plan.problems, plan=plan)
    return plan
