"""``sparkdl_tpu_torch.analysis``: the reshard half of the JAX package's
``analysis`` (``ParamInfo``, ``Finding``, ``Severity`` of ``core``, and
``ReshardPreflightError``, ``reshard_plan``, ``param_info_from_sidecar``
and ``shrink_mesh`` of ``comms``), which the checkpoint's resharded
restore runs. The graph passes over jaxprs and HLO and ``comms_report``
have no PyTorch counterpart and are not ported."""

from sparkdl_tpu_torch.analysis.core import Finding, ParamInfo, Severity

__all__ = ["Finding", "ParamInfo", "Severity"]
