"""The 64-bit pass, under the JAX package's rule id.

Counterpart of ``sparkdl_tpu/analysis/passes_dtype.py``. JAX with
``jax_enable_x64`` off *canonicalizes* every 64-bit value to 32 bits at
trace time, silently (the bug class where payload sizes above 2**24
rounded for months). torch does not canonicalize: it *promotes*. A
float64 (or complex128) tensor that enters the step keeps its width,
and every op it meets computes in 64 bits, at a fraction of the card's
float32 rate and twice the bytes, with results that leave the step
wider than the rest of the model. So under the same rule id,
``silent-canonicalization``, this pass flags:

1. **arguments** — a 64-bit floating leaf among the step's inputs (its
   arguments, the parameters and buffers of its modules, its
   optimizer's state): ERROR;
2. **compute** — ops of the traced step that compute in float64 or
   complex128 (a 64-bit constant or tensor made inside the step widens
   everything it touches): WARNING, with the first op's source line.

Integer 64-bit values are torch's index dtype and are not flagged. The
launcher's payload check (``preflight``) stays as it is: a float64 leaf
of ``run()``'s kwargs is no silent bug in torch.
"""

import numpy as np
import torch
import torch.utils._pytree as pytree

from sparkdl_tpu_torch.analysis.core import Finding, Severity, register_pass

_RULE = "silent-canonicalization"

_64BIT = ("float64", "complex128")


def _leaf_dtype(leaf):
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return None    # Python scalars are weakly typed: not ours
    return str(np.dtype(dt) if isinstance(dt, np.dtype) else dt
               ).rpartition(".")[2]


def payload_findings(tree, where="argument"):
    """ERRORs for the 64-bit floating leaves (tensors, numpy arrays) of
    a pytree headed for a step."""
    findings = []
    for path, leaf in pytree.tree_leaves_with_path(tree):
        dt = _leaf_dtype(leaf)
        if dt in _64BIT:
            key = pytree.keystr(path) or "<root>"
            findings.append(_arg_finding(where, key, dt))
    return findings


def _arg_finding(where, key, dt):
    return Finding(
        rule_id=_RULE, severity=Severity.ERROR, op=dt, location="",
        message=(
            f"{where} {key} is {dt}: torch keeps it 64 bits wide and every "
            "op it enters computes in 64 bits (on the card a fraction of "
            "the float32 rate, at twice the bytes) and hands 64-bit results "
            "on. Cast it to float32 (or bfloat16) before the step."))


@register_pass(_RULE, requires=("trace",), severities=("ERROR", "WARNING"))
def silent_canonicalization(ctx):
    """Flag 64-bit floating inputs and in-step 64-bit compute (torch
    promotes where JAX canonicalizes)."""
    trace = ctx.trace
    findings = [_arg_finding("input", i.path, i.dtype)
                for i in trace.inputs if i.dtype in _64BIT]
    if ctx.example_args is not None:
        # the numpy leaves (the tensors are among the trace's inputs)
        findings.extend(payload_findings(pytree.tree_map(
            lambda x: None if isinstance(x, torch.Tensor) else x,
            tuple(ctx.example_args))))
    if trace.f64_ops:
        first = trace.f64_ops[0]
        findings.append(Finding(
            rule_id=_RULE, severity=Severity.WARNING,
            op=first.name, location=first.location,
            message=(
                f"{len(trace.f64_ops)} op(s) of the step compute in 64 bits "
                f"(the first `{first.name}`, output "
                f"{first.outputs[0][1] if first.outputs else '?'}): torch "
                "promotes to the widest operand, so one 64-bit constant or "
                "tensor widens everything downstream of it. Make it 32 bits "
                "explicitly if this is not intended."),
        ))
    return findings
