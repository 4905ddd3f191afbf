"""``sparkdl_tpu_torch.analysis``: static lints of a PyTorch step over
its trace, run on the driver before a gang spends card time.

Counterpart of ``sparkdl_tpu/analysis/__init__.py``. The JAX package
reads a jaxpr and the lowered and compiled modules; here a step is run
once on ``meta`` tensors under a recording dispatch mode
(:mod:`~sparkdl_tpu_torch.analysis.trace`: every ATen op, every
collective of the port's ``hvd`` and ``Mesh``, every kernel launch, the
live bytes), which allocates no card memory, and the graph passes read
that trace: ``collective-consistency`` (ranks that issue their
collectives in different orders), ``full-param-allgather`` (a sharded
weight gathered whole), ``host-sync-in-step`` (a card value read on the
host), ``silent-canonicalization`` (64-bit floats in the step),
``undonated-step-buffers`` (state replaced instead of updated in place),
``hbm-overcommit`` and ``unoverlapped-collective``.

Entry points:

- :func:`lint_fn` — trace a step (every rank of ``mesh``, when given)
  and run every pass; :func:`lint_lowered` — lint a trace the caller
  already has (from
  :func:`sparkdl_tpu_torch.parallel.train.lower_train_step`);
  :func:`lint_gang` — cross-rank collective consistency over one step
  per rank (the ``per_rank_kwargs`` case);
- :func:`fix_program` — the verified fix engine
  (:mod:`~sparkdl_tpu_torch.analysis.fixes`): a fixable finding gets a
  :class:`Fix` (:data:`FIX_ACTIONS`: donate the carried state, hoist a
  Python scalar, narrow a 64-bit argument), applied only with its four
  proofs, reported under :data:`FIXIT_SCHEMA`;
- the launcher's pre-flight
  (:mod:`~sparkdl_tpu_torch.analysis.preflight`): with ``ENABLED``, the
  steps given to :func:`register_preflight` are linted before any
  spawn, an ERROR refuses the launch, and their comms reports land in
  the gang's run directory as ``comms_report.json``; with ``FIX`` too,
  each registered callable goes through :func:`fix_program` first and
  its report lands there as ``fixit_report.json``;
- the reshard half (``ParamInfo``, ``reshard_plan`` and the
  gang-sharding registry of :mod:`~sparkdl_tpu_torch.analysis.comms`)
  that the checkpoint's resharded restore and the supervisor's elastic
  pre-flight run, and :func:`register_gang_sharding`;
- the AST lints over the port's own code,
  :mod:`~sparkdl_tpu_torch.analysis.concur` and
  :mod:`~sparkdl_tpu_torch.analysis.selflint`, and the CLI
  (``python -m sparkdl_tpu_torch.analysis``).

``lint_compiled`` has no counterpart: an eager PyTorch step has no
compiled executable. Importing this package imports no graph pass: the
launcher touches it on every gang start.
"""

import math

from sparkdl_tpu_torch.analysis.core import (
    Finding,
    GraphContext,
    ParamInfo,
    Severity,
    all_passes,
    max_severity,
    register_pass,
    run_passes,
)
from sparkdl_tpu_torch.analysis.fixes import (
    FIX_ACTIONS,
    FIXIT_SCHEMA,
    Fix,
    fix_program,
)
from sparkdl_tpu_torch.analysis.preflight import (
    PreflightLintError,
    register_preflight,
)


def param_info_from(params, shardings=None, mesh=None):
    """:class:`ParamInfo` list of a step's parameters, what the
    full-param-allgather and donation passes match against.

    ``params``: a model (its ``state_dict()``; ``shardings`` and ``mesh``
    default to its ``tp_specs`` and ``mesh``) or a state dict of this
    rank's leaves. ``shardings``: leaf name -> spec (one entry a dim: an
    axis name, a tuple of them, or None; absent: whole). ``mesh``: a
    :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` or an axis-size dict;
    each leaf's whole shape is its local shape times its dims' splits,
    and only axes of size > 1 count as sharded. Without a mesh the leaves
    are taken as whole and every named axis counts as sharded, as the
    JAX function takes a bare ``PartitionSpec``."""
    from sparkdl_tpu_torch.analysis.trace import _as_mesh
    from sparkdl_tpu_torch.parallel.sharding import (
        _names,
        sharding_tree_info,
    )

    if hasattr(params, "state_dict"):
        model = params
        params = model.state_dict()
        if shardings is None:
            shardings = getattr(model, "tp_specs", None)
        if mesh is None:
            mesh = getattr(model, "mesh", None)
    shardings = dict(shardings or {})
    if mesh is not None:
        return sharding_tree_info(dict(params), shardings, _as_mesh(mesh))
    out = []
    for name, leaf in params.items():
        dims = [tuple(str(a) for a in _names(entry))
                for entry in tuple(shardings.get(name, ()) or ())]
        dims = (dims + [()] * leaf.ndim)[:leaf.ndim]
        out.append(ParamInfo(
            path=name, shape=tuple(int(d) for d in leaf.shape),
            dtype=str(leaf.dtype).rpartition(".")[2],
            sharded_axes=tuple(a for axes in dims for a in axes),
            spec=tuple(dims)))
    return out


def _context_for(fn, args, *, params=None, shardings=None, mesh=None,
                 rank=None, device=None, name=None, options=None):
    """The :class:`GraphContext` of ``fn(*args)``: traced as ``rank``, or,
    with a ``mesh`` and no rank, as every rank of it."""
    from sparkdl_tpu_torch.analysis.trace import _as_mesh, trace_step

    if mesh is not None and rank is None:
        m = _as_mesh(mesh)
        ranks = range(math.prod(m.shape.values()))
    else:
        m, ranks = mesh, [rank]
    traces = {}
    for r in ranks:
        t = trace_step(fn, *args, mesh=m, rank=r, device=device, name=name)
        traces[t.rank] = t
    first = traces[min(traces)]
    info = None
    if params is not None:
        info = param_info_from(params, shardings, m)
    opts = {"n_devices": first.world, **(options or {})}
    return GraphContext(
        fn_name=first.fn_name, trace=first, traces=traces, param_info=info,
        example_args=tuple(args), fn=fn, memory_stats=first.memory_stats(),
        options=opts)


def lint_fn(fn, *args, params=None, shardings=None, mesh=None, rank=None,
            device=None, passes=None, name=None, options=None):
    """Trace ``fn(*args)`` (:func:`~sparkdl_tpu_torch.analysis.trace.
    trace_step`) and run the graph passes; findings come back most severe
    first.

    With ``mesh`` (a Mesh or an axis-size dict) and no ``rank``, the step
    is traced once as every rank of the mesh and the ranks' collective
    sequences are compared (the JAX function's cond-branch check, across
    ranks here). ``params`` / ``shardings`` (:func:`param_info_from`)
    feed the full-param-allgather and donation passes; ``device``: what
    the step's tensors stand for (``"cuda"`` by default, ``"cpu"``);
    ``options``: pass settings (``hbm_bytes_per_device``,
    ``donation_min_elements``, ...)."""
    ctx = _context_for(fn, args, params=params, shardings=shardings,
                       mesh=mesh, rank=rank, device=device, name=name,
                       options=options)
    return run_passes(ctx, passes=passes)


def _lowered_context(trace, *, params=None, shardings=None, mesh=None,
                     name=None, options=None):
    info = None
    if params is not None:
        info = param_info_from(params, shardings, mesh)
    return GraphContext(
        fn_name=name or trace.fn_name, trace=trace,
        traces={trace.rank: trace}, param_info=info,
        memory_stats=trace.memory_stats(),
        options={"n_devices": trace.world, **(options or {})})


def lint_lowered(trace, *, params=None, shardings=None, mesh=None,
                 passes=None, name=None, options=None):
    """Lint a trace the caller already has (the JAX function lints a
    ``Lowered``): :func:`~sparkdl_tpu_torch.parallel.train.
    lower_train_step`'s, or :func:`~sparkdl_tpu_torch.analysis.trace.
    trace_step`'s."""
    ctx = _lowered_context(trace, params=params, shardings=shardings,
                           mesh=mesh, name=name, options=options)
    return run_passes(ctx, passes=passes)


def lint_gang(fns_or_traces, args_per_rank=None, names=None, mesh=None,
              device=None):
    """Cross-rank collective consistency: one step per rank. Pass
    :class:`~sparkdl_tpu_torch.analysis.trace.Trace` objects, or
    callables plus ``args_per_rank`` (one args tuple a rank), each traced
    here as rank i of ``mesh`` (default: one ``data`` axis of
    ``len(fns_or_traces)`` ranks)."""
    from sparkdl_tpu_torch.analysis.passes_collectives import (
        check_gang_consistency,
    )
    from sparkdl_tpu_torch.analysis.trace import Trace, trace_step

    items = list(fns_or_traces)
    if mesh is None:
        mesh = {"data": max(len(items), 1)}
    traces = []
    for i, obj in enumerate(items):
        if isinstance(obj, Trace):
            traces.append(obj)
        else:
            args = args_per_rank[i] if args_per_rank else ()
            traces.append(trace_step(obj, *args, mesh=mesh, rank=i,
                                     device=device))
    return check_gang_consistency(traces, names=names)


def register_gang_sharding(model_or_params, specs=None, mesh=None, *,
                           local_device_count=None, hbm_bytes=None,
                           state_multiplier=3.0):
    """Register the gang's sharding tree for the supervisor's pre-flight
    of an elastic relaunch at another world size
    (``supervisor.RetryPolicy.relaunch_np``, or the elastic
    controller's target): before relaunching, the supervisor runs
    :func:`~sparkdl_tpu_torch.analysis.comms.check_relaunch_np` against
    it and refuses an infeasible target with a typed
    :class:`~sparkdl_tpu_torch.analysis.comms.ReshardPreflightError`
    instead of a failure mid-restore.

    ``model_or_params``: a model (its ``state_dict()``; ``specs`` and
    ``mesh`` default to its ``tp_specs`` and ``mesh``) or a state dict of
    this rank's leaves. ``specs``: leaf name -> spec (absent: whole).
    ``mesh``: a :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` or an
    axis-size dict (``{"data": 2}``; absent axes are 1): the driver holds
    no process group, so a dict is how it names the gang's mesh.
    ``local_device_count`` is explicit only: the driver's card count is
    not the gang's count a host. Driver-side, never pickled::

        analysis.register_gang_sharding(model, mesh={"data": 2})
        HorovodRunner(np=-2).run(main)
    """
    from sparkdl_tpu_torch.analysis import comms
    from sparkdl_tpu_torch.analysis.trace import _as_mesh
    from sparkdl_tpu_torch.parallel.sharding import sharding_tree_info

    params = model_or_params
    if hasattr(model_or_params, "state_dict"):
        params = model_or_params.state_dict()
        if specs is None:
            specs = getattr(model_or_params, "tp_specs", None)
        if mesh is None:
            mesh = getattr(model_or_params, "mesh", None)
    if mesh is None:
        raise ValueError("register_gang_sharding needs the gang's mesh: a "
                         "Mesh or an axis-size dict such as {'data': 2}")
    mesh = _as_mesh(mesh)
    info = sharding_tree_info(dict(params), dict(specs or {}), mesh)
    axes = {str(a): int(n) for a, n in dict(mesh.shape).items()}
    return comms.register_gang_sharding(
        info, axes, local_device_count=local_device_count,
        hbm_bytes=hbm_bytes, state_multiplier=state_multiplier)


__all__ = [
    "Finding", "GraphContext", "ParamInfo", "Severity", "all_passes",
    "max_severity", "register_pass", "run_passes", "lint_fn",
    "lint_lowered", "lint_gang", "param_info_from", "PreflightLintError",
    "register_preflight", "register_gang_sharding", "Fix", "FIX_ACTIONS",
    "FIXIT_SCHEMA", "fix_program",
]
