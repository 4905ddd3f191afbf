"""Host-sync-in-step pass.

Counterpart of ``sparkdl_tpu/analysis/passes_host.py``. There a host
callback inside the jitted step forces a device-to-host round trip every
step. In an eager PyTorch step the same stall is a value the host reads
from the card: ``.item()``, ``bool()`` and ``int()`` of a card tensor
(``_local_scalar_dense``), a copy from the card to the host (``.cpu()``,
``.numpy()``, ``.tolist()``), and an op whose output shape depends on the
data (``nonzero``, boolean masking, ``unique``), which must read the
card to size its result. The host waits for the card to drain, every
step, and on a gang every rank waits together. The trace ends at the
first such read (:mod:`~sparkdl_tpu_torch.analysis.trace`). A Python
scalar riding in as an argument is the softer cousin, as in the JAX
package.
"""

import torch.utils._pytree as pytree

from sparkdl_tpu_torch.analysis.core import Finding, Severity, register_pass

_RULE = "host-sync-in-step"


@register_pass(_RULE, severities=("ERROR", "WARNING", "INFO"))
def host_sync_in_step(ctx):
    """Flag card-to-host reads inside the step and Python-scalar
    arguments."""
    findings = []
    trace = ctx.trace
    if trace is not None and trace.stopped is not None:
        s = trace.stopped
        if trace.device != "cpu":
            findings.append(Finding(
                rule_id=_RULE, severity=Severity.ERROR, op=s.op,
                location=s.location,
                message=(
                    f"{s.kind} `{s.op}` reads a card value on the host "
                    "inside the step: the host waits for the card to drain "
                    "every step (every rank of a gang stalls together), "
                    "and the trace ends here. Keep the value on the card "
                    "(masks and torch.where of fixed shape), or read it "
                    "outside the step on a metrics cadence."),
            ))
        else:
            findings.append(Finding(
                rule_id=_RULE, severity=Severity.INFO, op=s.op,
                location=s.location,
                message=(
                    f"{s.kind} `{s.op}` reads a value of the step on the "
                    "host; traced for the CPU this waits for nothing, but "
                    "the trace ends here and the rest of the step was not "
                    "linted."),
            ))
    if ctx.example_args is not None:
        findings.extend(_scalar_findings(ctx.example_args))
    return findings


def _scalar_findings(args):
    findings = []
    for path, leaf in pytree.tree_leaves_with_path(tuple(args)):
        if isinstance(leaf, bool) or not isinstance(leaf, (int, float)):
            continue
        key = pytree.keystr(path) or "<arg>"
        findings.append(Finding(
            rule_id=_RULE, severity=Severity.WARNING,
            op=type(leaf).__name__, location="",
            message=(
                f"argument {key} is a Python {type(leaf).__name__}: it "
                "enters every op as a weakly typed scalar (the tensor's "
                "dtype wins, so 0.1 in bfloat16 math is 0.10009765625), "
                "and a step captured in a CUDA graph or compiled bakes its "
                "value in. Pass a 0-d tensor with an explicit dtype "
                "instead."),
        ))
    return findings
