"""Step-buffer pass: carried state that a step replaces instead of
updating in place doubles its peak.

Counterpart of ``sparkdl_tpu/analysis/passes_donation.py``. A train step
is an in-place update by nature: params and optimizer state go in, their
replacements come out. JAX reuses the input buffers only when the caller
donates them (``donate_argnums``). In torch the equivalent is the
update itself: ``make_train_step`` and every ``torch.optim`` optimizer
write the parameters and moments in place, and nothing is doubled. A
*functional* step — ``return p - lr * g, m2`` — builds new tensors of
the state's shapes while the old ones are still alive, so at its peak
the card holds old AND new copies of everything params-sized. The pass
reads the trace: its inputs, which of them the step wrote in place, and
its outputs.

- **WARNING** (precise, needs ``param_info``): an input that was never
  written in place, whose (dtype, shape) matches a parameter leaf, and
  for which an output of that signature remains to be its replacement
  (the outputs that are new tensors are the budget, as the JAX pass's
  output multiset is: it counts every optimizer tree of the params'
  shapes, AdamW's two moments both, and keeps inference forwards, whose
  params have no same-shaped output, silent). The message totals the
  doubled bytes.
- **INFO** (heuristic, no ``param_info``): the step writes *no* input in
  place and returns new tensors the shape of large inputs
  (>= ``options["donation_min_elements"]``, default 2**24 elements): the
  functional-step pattern. A step that updates anything in place made
  its choice; the heuristic stays quiet there.
"""

from sparkdl_tpu_torch.analysis.core import Finding, Severity, register_pass
from sparkdl_tpu_torch.analysis.comms import DTYPE_BYTES

_RULE = "undonated-step-buffers"

DEFAULT_MIN_ELEMENTS = 1 << 24


def _elements(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _nbytes(shape, dtype):
    return _elements(shape) * DTYPE_BYTES.get(dtype, 4)


def _budget(trace):
    """Replacement slots per (dtype, shape): the step's outputs that are
    new tensors (an input handed back is no new buffer)."""
    inputs = {i.storage for i in trace.inputs}
    budget = {}
    for out in trace.outputs:
        path, shape, dtype = out[:3]
        if len(out) > 3 and out[3] in inputs:
            continue
        key = (dtype, tuple(shape))
        budget[key] = budget.get(key, 0) + 1
    return budget


@register_pass(_RULE, requires=("trace",), severities=("WARNING", "INFO"))
def undonated_step_buffers(ctx):
    """Flag params/opt_state-sized step inputs that the step replaces
    instead of updating in place (peak memory holds old + new)."""
    trace = ctx.trace
    if not trace.inputs:
        return []
    budget = _budget(trace)
    if ctx.param_info:
        sigs = {(p.dtype, tuple(p.shape)) for p in ctx.param_info}
        matched = []
        for i in trace.inputs:
            key = (i.dtype, tuple(i.shape))
            if i.written or key not in sigs or budget.get(key, 0) <= 0:
                continue
            budget[key] -= 1
            matched.append(i)
        if not matched:
            return []
        total = sum(_nbytes(i.shape, i.dtype) for i in matched)
        head = ", ".join(f"{i.path} {i.dtype}{list(i.shape)}"
                         for i in matched[:4])
        more = "" if len(matched) <= 4 else f", +{len(matched) - 4} more"
        return [Finding(
            rule_id=_RULE, severity=Severity.WARNING, op=trace.fn_name,
            location="",
            message=(
                f"{len(matched)} step input(s) matching parameter leaves "
                f"are replaced, not updated in place ({head}{more}; "
                f"{total / 2**20:.1f} MiB): the step returns new tensors "
                "of their shapes while the old ones are alive, so at peak "
                "the card holds old AND new copies of everything "
                "params/opt_state-sized. Update the state in place "
                "(param.add_, an optimizer's step, as make_train_step "
                "does)."),
        )]
    if any(i.written for i in trace.inputs):
        return []
    min_elements = int(ctx.options.get("donation_min_elements",
                                       DEFAULT_MIN_ELEMENTS))
    big = []
    for i in trace.inputs:
        key = (i.dtype, tuple(i.shape))
        if _elements(i.shape) < min_elements or budget.get(key, 0) <= 0:
            continue
        budget[key] -= 1
        big.append(i)
    if not big:
        return []
    head = ", ".join(f"{i.path} {i.dtype}{list(i.shape)}" for i in big[:4])
    more = "" if len(big) <= 4 else f", +{len(big) - 4} more"
    total = sum(_nbytes(i.shape, i.dtype) for i in big)
    return [Finding(
        rule_id=_RULE, severity=Severity.INFO, op=trace.fn_name, location="",
        message=(
            f"no input is updated in place, and {len(big)} large input(s) "
            f"({head}{more}; {total / 2**20:.1f} MiB) come back as new "
            "tensors of their shapes: if this step carries params or "
            "optimizer state, update them in place or peak memory "
            "doubles. Ignore for programs whose inputs must survive the "
            "call."),
    )]
