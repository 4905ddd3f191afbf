"""Resharding feasibility: can a recorded sharding tree be re-laid onto
a target mesh, and what does that cost a device.

Counterpart of the reshard half of ``sparkdl_tpu/analysis/comms.py``
(:class:`ReshardPreflightError`, :class:`ReshardPlan`,
:func:`reshard_plan`, :func:`param_info_from_sidecar`,
:func:`shrink_mesh`, and the gang-sharding registry that the
supervisor's pre-flight of an elastic relaunch reads:
:func:`register_gang_sharding`, :func:`registered_gang_sharding`,
:func:`clear_gang_sharding`, :func:`check_relaunch_np`), with the same
byte arithmetic and the same finding messages. The collective pricing over HLO and ``comms_report`` have no
PyTorch counterpart and are not ported. The per-device memory budget
defaults to the CUDA device's total memory, and to none (no check) on
the CPU.
"""

from dataclasses import dataclass, field

from sparkdl_tpu_torch.analysis.core import Finding, ParamInfo, Severity

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
