"""``sparkdl_tpu_torch.analysis``: the reshard half of the JAX package's
``analysis`` (``ParamInfo``, ``Finding``, ``Severity`` of ``core``, and
``ReshardPreflightError``, ``reshard_plan``, ``param_info_from_sidecar``,
``shrink_mesh`` and the gang-sharding registry of ``comms``), which the
checkpoint's resharded restore and the supervisor's pre-flight of an
elastic relaunch run, and :func:`register_gang_sharding`. The graph
passes over jaxprs and HLO and ``comms_report`` have no PyTorch
counterpart and are not ported. The AST lints over the port's own
code, :mod:`~sparkdl_tpu_torch.analysis.concur` (concurrency) and
:mod:`~sparkdl_tpu_torch.analysis.selflint` (the pickling contract), and
the launcher's pre-flight (:mod:`~sparkdl_tpu_torch.analysis.preflight`)
are ported; ``python -m sparkdl_tpu_torch.analysis --concur|--self``
runs the lints."""

from sparkdl_tpu_torch.analysis.core import Finding, ParamInfo, Severity
from sparkdl_tpu_torch.analysis.preflight import (
    PreflightLintError,
    register_preflight,
)


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
    from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh
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
    if not isinstance(mesh, Mesh):
        unknown = sorted(set(mesh) - set(AXES))
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                             f"{list(AXES)}")
        mesh = Mesh(AXES, tuple(int(mesh.get(a, 1)) for a in AXES))
    info = sharding_tree_info(dict(params), dict(specs or {}), mesh)
    axes = {str(a): int(n) for a, n in dict(mesh.shape).items()}
    return comms.register_gang_sharding(
        info, axes, local_device_count=local_device_count,
        hbm_bytes=hbm_bytes, state_multiplier=state_multiplier)


__all__ = ["Finding", "ParamInfo", "PreflightLintError", "Severity",
           "register_gang_sharding", "register_preflight"]
