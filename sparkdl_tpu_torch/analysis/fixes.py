"""Verified fixes: turn the graph lints' findings into applied,
checked rewrites of a PyTorch step.

Counterpart of ``sparkdl_tpu/analysis/fixes.py``, with its names, rule
ids, action ids and report schema. The passes *see* waste (a step that
replaces its state instead of updating it, a Python scalar riding in as
an argument, a 64-bit argument); a finding whose rule has a registered
*fixer* gets a machine-applicable :class:`Fix` (action id,
preconditions, predicted effect), and :func:`fix_program` applies it
where the step is built, then traces the fixed step again
(:mod:`~sparkdl_tpu_torch.analysis.trace`). What each action does to a
PyTorch step (:data:`FIX_ACTIONS`):

- ``donate-step-buffers`` (``undonated-step-buffers``): the fixed step
  writes each replacement of a carried input into that input's storage
  *at the op that produces it*, once the step reads the input no more,
  and hands the input on in the replacement's place. The plan comes
  from the trace's op order (each output's producing op, each input's
  last read); a ``TorchDispatchMode`` carries it out when the step
  runs. Copying the outputs back after the step would save nothing (old
  and new are both alive at its peak); proof 4 refuses such a fix. The
  donated tensors hold the replacements after the call. Per argument,
  as JAX donates: every tensor of a donated argument needs a
  replacement. An argument degrades when one of its tensors is read
  after its replacement is made, is a view or shares storage with
  another input, or requires grad (a leaf autograd still needs); a run
  that reads a donated input after its write raises, and a run whose op
  sequence misses the plan raises while the fix is verified (a warning
  after);
- ``hoist-weak-scalar`` (the WARNING on a Python-scalar argument): the
  fixed step closes over a 0-d tensor on the step's device in the
  scalar's place and drops it from the signature. Its dtype is the
  first of float32, bfloat16, float16, float64 (int64, int32 for an
  int) under which every traced op's output dtypes are the original
  step's: torch's type promotion unchanged. A card read (``.item()``,
  the ERROR) is not auto-fixable and stays among the unfixable
  findings; a scalar nested in a container degrades;
- ``narrow-64bit-payload`` (``silent-canonicalization``'s ERROR on an
  argument): float64 -> float32 and complex128 -> complex64, an
  explicit cast, logged. torch's pass never flags int64 (torch's index
  dtype), so an int64 argument is neither flagged nor narrowed, where
  the JAX engine narrows one that round-trips and degrades on one that
  does not. A 64-bit leaf of a module's state degrades (cast the
  module);
- ``daemonize-unjoined-thread`` (``thread-lifecycle``): a suggestion,
  rendered by ``--concur`` (``concur.render_suggestions``), never
  applied.

Nothing is trusted: every applied fix carries four proofs, and a fix
that cannot produce all four **degrades to the original finding**, the
step untouched:

1. **finding eliminated**: the originating pass, run on the fixed
   step's trace, no longer reports the targeted findings;
2. **no new errors**: the whole registry raises no ERROR the step did
   not have;
3. **numeric equivalence**: both steps run on deep copies of the
   example arguments (at most ``options["fix_equiv_max_elements"]``
   elements, default ``1 << 22``; the modules and optimizers they hold
   are put back after each run) and agree leaf for leaf within
   ``64 * eps`` of the output's dtype, dtype included (a narrowing fix's
   outputs are held to the narrowed dtypes: torch promotes where JAX
   canonicalizes, so the fix changes them by design);
4. **budget delta**: the traced live-bytes peak
   (:meth:`~sparkdl_tpu_torch.analysis.trace.Trace.static_budget_bytes`)
   and the :func:`~sparkdl_tpu_torch.analysis.comms.comms_report`
   totals are computed before and after, the peak did not rise, and it
   fell by at least the fix's predicted ``peak_hbm_bytes_saved``.

The report (schema ``sparkdl_tpu.analysis.fixit_report/1``) is shared
by the CLI (``--fix``, ``--dry-run``), the launcher's pre-flight
(:data:`sparkdl_tpu_torch.analysis.preflight.FIX`), the gang's run
directory (``fixit_report.json``) and ``observe.doctor``.
"""

import logging
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from sparkdl_tpu_torch.analysis.core import Severity, run_passes

logger = logging.getLogger("HorovodRunner")

FIXIT_SCHEMA = "sparkdl_tpu.analysis.fixit_report/1"

# The fixable-rule catalog: rule id -> (action id, one-liner). The CLI's
# --list-rules marks these; the README's port section documents each.
FIX_ACTIONS = {
    "undonated-step-buffers": (
        "donate-step-buffers",
        "write each replacement of a carried input into that input's "
        "storage at the op that produces it, once the step reads the "
        "input no more",
    ),
    "host-sync-in-step": (
        "hoist-weak-scalar",
        "close Python-scalar arguments over as 0-d tensors on the step's "
        "device, of a dtype that leaves every op's type promotion as it "
        "was (card reads are not auto-fixable)",
    ),
    "silent-canonicalization": (
        "narrow-64bit-payload",
        "explicitly cast float64 / complex128 argument leaves to float32 "
        "/ complex64 (logged)",
    ),
    # source-level, from the concurrency lint: the engine rewrites no
    # source file, so --concur renders the action as a suggestion a site
    # (concur.render_suggestions)
    "thread-lifecycle": (
        "daemonize-unjoined-thread",
        "suggest daemon=True (or a shutdown-path join) for a "
        "non-daemon helper thread that is never joined",
    ),
}

# the narrowing fixer's casts (torch's pass flags no integer)
_NARROW_DTYPE = {"float64": "float32", "complex128": "complex64"}

# Application order when several rules propose fixes on one step:
# argument transforms first (they change the signature the donation
# plan maps onto), the donation last.
_ACTION_ORDER = (
    "narrow-64bit-payload", "hoist-weak-scalar", "donate-step-buffers",
)

DEFAULT_EQUIV_MAX_ELEMENTS = 1 << 22

# dtypes tried, in order, for a hoisted scalar's 0-d tensor
_HOIST_DTYPES = {
    float: (torch.float32, torch.bfloat16, torch.float16, torch.float64),
    int: (torch.int64, torch.int32),
}


class DonationError(RuntimeError):
    """A donated step's run left its plan: a donated input read after
    its replacement was written into it, a replacement that carries
    autograd history, or (while the fix is verified) an op sequence that
    never reached a planned write."""


@dataclass(frozen=True)
class Fix:
    """One machine-applicable remediation, attached to the findings it
    targets. ``preconditions`` are the clauses the fixer CHECKED before
    proposing (a fix whose precondition fails is never constructed: it
    degrades instead); ``predicted_effect`` is the static claim the
    budget-delta proof audits; ``data`` the action's machine payload
    (argnums, leaf paths, dtypes)."""

    rule_id: str
    action: str
    description: str
    preconditions: tuple
    predicted_effect: dict
    data: dict = field(default_factory=dict)
    targets: tuple = ()   # finding dicts this fix eliminates

    def to_dict(self):
        return {
            "rule_id": self.rule_id,
            "action": self.action,
            "description": self.description,
            "preconditions": list(self.preconditions),
            "predicted_effect": dict(self.predicted_effect),
            "data": dict(self.data),
            "targets": [dict(t) for t in self.targets],
        }


@dataclass
class FixAttempt:
    """One rule's remediation attempt: a verified (and applied) Fix with
    its four proofs, or a degrade (the original findings stand)."""

    rule_id: str
    action: str
    fix: Fix = None
    verified: bool = False
    applied: bool = False
    degraded: bool = False
    degrade_reason: str = None
    proofs: dict = field(default_factory=dict)
    findings: tuple = ()   # the findings this attempt was about

    def to_dict(self):
        out = {
            "rule_id": self.rule_id,
            "action": self.action,
            "verified": self.verified,
            "applied": self.applied,
            "degraded": self.degraded,
            "proofs": self.proofs,
            "findings": [f.to_dict() for f in self.findings],
        }
        if self.fix is not None:
            out["fix"] = self.fix.to_dict()
        if self.degrade_reason:
            out["degrade_reason"] = self.degrade_reason
        return out


@dataclass
class FixitResult:
    """What :func:`fix_program` hands back: the (possibly rewritten)
    step and its example arguments, its trace (``lowered``: where the
    JAX engine hands back the re-lowered module), the before/after
    findings and the machine-readable report."""

    fn: object
    example_args: tuple
    lowered: object
    ctx: object
    findings_before: list
    findings_after: list
    attempts: list
    report: dict


@dataclass
class _Env:
    """How the engine traces a step: the caller's lint settings."""

    params: object = None
    shardings: object = None
    mesh: object = None
    rank: object = None
    device: object = None
    name: str = None
    options: dict = None
    # id(fn) -> (fn, args, context) of the steps traced already
    made: dict = field(default_factory=dict)

    def context(self, fn, args):
        """The context of ``fn(*args)``, traced once for these objects."""
        from sparkdl_tpu_torch.analysis import _context_for

        args = tuple(args)
        hit = self.made.get(id(fn))
        if hit is not None and hit[0] is fn and len(hit[1]) == len(args) \
                and all(a is b for a, b in zip(hit[1], args)):
            return hit[2]
        ctx = _context_for(
            fn, args, params=self.params, shardings=self.shardings,
            mesh=self.mesh, rank=self.rank, device=self.device,
            name=self.name, options=self.options)
        self.made[id(fn)] = (fn, args, ctx)
        return ctx


# -- fixers -------------------------------------------------------------------
#
# A fixer inspects the current step's context, that rule's findings and
# the engine's trace settings, and returns ``(Fix, transform)`` --
# ``transform(fn, args) -> (fn2, args2)`` -- or ``(None, reason)`` to
# degrade. Fixers apply nothing: the engine owns application and proof.

_FIXERS = {}


def register_fixer(rule_id):
    def deco(fn):
        _FIXERS[rule_id] = fn
        return fn
    return deco


# -- the donation plan --------------------------------------------------------


@dataclass(frozen=True)
class _Write:
    """One planned write: argument leaf ``leaf`` (its index among the
    arguments' tensor leaves, ``path`` its name) takes the ``position``-th
    tensor output of the ``occurrence``-th op of signature ``key`` (op
    name, output specs), event ``event`` of the trace."""

    leaf: int
    path: str
    key: tuple
    occurrence: int
    position: int
    event: int
    nbytes: int


def _tensor_leaves(args):
    """``[(argnum, path, tensor)]`` of the arguments' tensor leaves, in
    the order a trace's ``arg_storages`` lists them."""
    out = []
    for path, leaf in pytree.tree_leaves_with_path(tuple(args)):
        if isinstance(leaf, torch.Tensor):
            out.append((path[0].idx, f"args{pytree.keystr(path)}", leaf))
    return out


def _storage_id(t):
    return t.untyped_storage()._cdata


def _module_tensors(fn, args):
    """Every tensor of the modules and optimizers the step holds."""
    from sparkdl_tpu_torch.analysis.trace import _state_of

    modules, optimizers = _state_of(fn, args)
    out = []
    for m in modules:
        out.extend(m.parameters())
        out.extend(m.buffers())
    for opt in optimizers:
        for st in opt.state.values():
            out.extend(v for v in st.values() if isinstance(v, torch.Tensor))
    return out


def _leaf_refusal(t, others):
    """Why argument tensor ``t`` cannot be written in place, or None."""
    if t.requires_grad:
        return "requires grad: a leaf autograd still needs"
    if t._base is not None or t.untyped_storage().nbytes() != \
            t.numel() * t.element_size():
        return "is a view of a larger storage"
    if t.device.type != "meta":
        sid = _storage_id(t)
        if any(o is not t and o.device == t.device and
               _storage_id(o) == sid for o in others):
            return "shares its storage with another input"
    return None


def _slots(trace):
    """``{(dtype, shape): [slot]}`` of the outputs a donated input can
    take: new tensors whose storage an op allocated at their shape. A
    slot: ``(event, key, occurrence, position, nbytes, reads)``."""
    from sparkdl_tpu_torch.analysis.trace import OpEvent

    inputs = {i.storage for i in trace.inputs}
    wanted = {}
    for path, shape, dtype, storage in trace.outputs:
        if storage not in inputs:
            wanted.setdefault(storage, (tuple(shape), dtype))
    seen, producer = {}, {}
    for e in trace.events:
        if not isinstance(e, OpEvent):
            continue
        key = (e.name, e.outputs)
        n = seen.get(key, 0)
        seen[key] = n + 1
        for storage in e.allocs:
            if storage in wanted:
                producer[storage] = (e, key, n)
    out = {}
    for storage, (shape, dtype) in wanted.items():
        hit = producer.get(storage)
        if hit is None:
            continue
        e, key, n = hit
        position = e.out_storages.index(storage)
        if e.outputs[position] != (shape, dtype):
            continue   # the output is a view of another shape of it
        nbytes = int(np.prod(shape, dtype=np.int64)) * \
            _itemsize(dtype)
        out.setdefault((dtype, shape), []).append(
            (e.index, key, n, position, nbytes, set(e.reads)))
    for slots in out.values():
        slots.sort(key=lambda s: s[0])
    return out


def _itemsize(dtype_name):
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()


def _last_reads(trace):
    """``{storage: event index of its last read}``."""
    out = {}
    for e in trace.events:
        for storage in getattr(e, "reads", ()):
            out[storage] = e.index
    return out


def plan_donation(trace, fn, example_args, *, argnums=None, flagged=None):
    """The donation plan of ``fn(*example_args)`` from its ``trace``.

    ``argnums``: the arguments to donate (each must be donatable whole,
    else the reason is returned); None: every argument with a leaf that
    ``flagged(shape, dtype)`` picks, skipping those only partly
    donatable. Returns ``(writes, donated argnums, skipped {argnum:
    reason}, reason or None)``."""
    if not trace.complete:
        return [], (), {}, (
            f"the trace ended at a host read ({trace.stopped.op}): the "
            "rest of the step's op order is unknown")
    leaves = _tensor_leaves(example_args)
    if len(leaves) != len(trace.arg_storages):
        return [], (), {}, (
            f"the trace lists {len(trace.arg_storages)} argument tensors, "
            f"the arguments hold {len(leaves)}")
    by_storage = {i.storage: i for i in trace.inputs}
    slots = _slots(trace)
    last = _last_reads(trace)
    others = [t for _, _, t in leaves] + _module_tensors(fn, example_args)
    storages = [s for _, s in trace.arg_storages]
    by_arg = {}
    for i, (argnum, path, t) in enumerate(leaves):
        by_arg.setdefault(argnum, []).append(i)
    if argnums is None:
        def undonated(i):
            info = by_storage[storages[i]]
            return not info.written and flagged(tuple(info.shape),
                                                info.dtype)

        candidates = [a for a, idxs in sorted(by_arg.items())
                      if any(undonated(i) for i in idxs)]
    else:
        candidates = sorted(set(int(a) for a in argnums))
        missing = [a for a in candidates if a not in by_arg]
        if missing:
            return [], (), {}, f"argument(s) {missing} hold no tensor"
    remaining = {k: list(v) for k, v in slots.items()}
    writes, donated, skipped = [], [], {}
    for argnum in candidates:
        trial = {k: list(v) for k, v in remaining.items()}
        planned, reason = [], None
        for i in by_arg[argnum]:
            _, path, t = leaves[i]
            info = by_storage[storages[i]]
            if storages.count(storages[i]) > 1:
                reason = (f"{path} shares its storage with another input "
                          "(passed twice)")
                break
            if info.written:
                continue   # updated in place already
            refusal = _leaf_refusal(t, others)
            if refusal:
                reason = f"{path} {refusal}"
                break
            sig = (info.dtype, tuple(info.shape))
            read = last.get(info.storage, -1)
            eligible = [s for s in trial.get(sig, ()) if s[0] >= read]
            if not eligible:
                reason = (f"{path} has no replacement made after its last "
                          "read (a later read of the input, or no output of "
                          f"{info.dtype}{list(info.shape)} left)")
                break
            # the op that reads the input to make its replacement, else
            # the earliest replacement made after the last read
            direct = [s for s in eligible if info.storage in s[5]]
            slot = (direct or eligible)[0]
            trial[sig].remove(slot)
            event, key, n, position, nbytes, _ = slot
            planned.append(_Write(i, path, key, n, position, event, nbytes))
        if reason is None:
            remaining = trial
            writes.extend(planned)
            donated.append(argnum)
        else:
            skipped[argnum] = reason
    if not donated:
        if argnums is not None or skipped:
            return [], (), skipped, (
                "argument(s) " + "; ".join(
                    f"{a}: {r}" for a, r in sorted(skipped.items()))
                + ": donating a partial argument is not expressible, so "
                "the argument is only partially coverable")
        return [], (), {}, ("no Python argument maps onto the undonated "
                            "buffers")
    if argnums is not None and skipped:
        return [], (), skipped, "; ".join(
            f"argument {a}: {r}" for a, r in sorted(skipped.items()))
    return writes, tuple(sorted(donated)), skipped, None


def predicted_peak(trace, writes=()):
    """The traced live-bytes peak with ``writes`` done: each planned
    replacement's bytes leave the live set once the op that makes it has
    run (its write lands in the input's storage)."""
    from sparkdl_tpu_torch.analysis.trace import KernelEvent, OpEvent

    done = sorted((w.event, w.nbytes) for w in writes)
    peak, freed, j = trace.argument_bytes, 0, 0
    for e in trace.events:
        if not isinstance(e, (OpEvent, KernelEvent)):
            continue
        while j < len(done) and done[j][0] < e.index:
            freed += done[j][1]
            j += 1
        peak = max(peak, e.live - freed)
    return peak


def _call_tensors(args, kwargs):
    """The tensors of an ATen call's arguments (each a tensor, or a list
    of them)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class _Donating(TorchDispatchMode):
    """Carries out a donation plan while the step runs (module
    docstring): counts the ops the trace records, keyed by name and
    output specs, writes each planned replacement into its input at its
    op, and refuses a later read of a donated input. Once the last
    planned write is done, an op costs only that check."""

    def __init__(self, writes, inputs, cpu_run):
        super().__init__()
        self.points = {}
        for w in writes:
            name, specs = w.key
            key = (name, tuple((shape, getattr(torch, dtype))
                               for shape, dtype in specs))
            self.points.setdefault((key, w.occurrence), []).append(
                (w, inputs[w.leaf]))
        self.cpu_run = cpu_run
        self.tainted = {_storage_id(t) for t in inputs}
        self.seen = {}
        self.names = {}
        # id -> weakref of the donated inputs and their earlier views (by
        # id: a tensor's == is elementwise); input storage -> its views
        self.stale = {}
        self.aliases = {_storage_id(inputs[w.leaf]): {} for w in writes}

    def _counted(self, tensors, kwargs):
        if not self.cpu_run and any(t.device.type != "cpu"
                                    for t in tensors):
            return True
        if any(_storage_id(t) in self.tainted for t in tensors):
            return True
        target = kwargs.get("device")
        return target is not None and (
            torch.device(target).type != "cpu" or self.cpu_run)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = _call_tensors(args, kwargs)
        for t in tensors if self.stale else ():
            hit = self.stale.get(id(t))
            if hit is not None and hit() is t:
                raise DonationError(
                    f"{func} reads a donated input after its replacement "
                    "was written into it")
        out = func(*args, **kwargs)
        if not self.points or not self._counted(tensors, kwargs):
            return out
        single = isinstance(out, torch.Tensor)
        leaves = [out] if single else list(out) if isinstance(
            out, (tuple, list)) else []
        outs = [(j, t) for j, t in enumerate(leaves)
                if isinstance(t, torch.Tensor)]
        for _, t in outs:
            sid = _storage_id(t)
            self.tainted.add(sid)
            views = self.aliases.get(sid)
            if views is not None:
                views[id(t)] = weakref.ref(t)
        name = self.names.get(func)
        if name is None:
            name = self.names[func] = str(func)
        key = (name, tuple((t.shape, t.dtype) for _, t in outs))
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        hits = self.points.pop((key, n), None)
        if not hits:
            return out
        for w, inp in hits:
            j, res = outs[w.position]
            if res.requires_grad:
                raise DonationError(
                    f"{w.path}: its replacement ({func}) carries autograd "
                    "history; a donated input is handed on detached")
            with torch.no_grad():
                inp.copy_(res)
            leaves[j] = inp.detach()
            self.stale[id(inp)] = weakref.ref(inp)
            self.stale.update(self.aliases.pop(_storage_id(inp), {}))
        return leaves[0] if single else type(out)(leaves)


class DonatedStep:
    """``fn`` with the arguments of a donation plan updated in place
    (:data:`FIX_ACTIONS`' ``donate-step-buffers``): called as ``fn``.
    ``strict`` (on while the fix is verified) raises when the run misses
    a planned write; otherwise that is a warning (the results are right,
    the memory is not saved). ``func`` is the wrapped step (where a
    trace finds the modules it holds)."""

    def __init__(self, func, writes, argnums):
        self.func = func
        self.writes = tuple(writes)
        self.argnums = tuple(argnums)
        self.strict = False
        self.__name__ = getattr(func, "__name__", "<fn>")
        self.__qualname__ = getattr(func, "__qualname__", self.__name__)

    def __call__(self, *args):
        if not self.writes:
            return self.func(*args)
        inputs = [t for _, _, t in _tensor_leaves(args)]
        mode = _Donating(self.writes, inputs, cpu_run=all(
            t.device.type == "cpu" for t in inputs))
        with mode:
            out = self.func(*args)
        if mode.points:
            missed = sorted(w.path for hits in mode.points.values()
                            for w, _ in hits)
            msg = (f"{self.__name__}: the run's op sequence differs from "
                   f"the trace's; not donated: {missed}")
            if self.strict:
                raise DonationError(msg)
            logger.warning("fixit donate-step-buffers: %s", msg)
        return out


def donate(step, example_args, donate_argnums, *, mesh=None, rank=None,
           device=None):
    """``step`` with the arguments ``donate_argnums`` donated
    (:class:`DonatedStep`), planned from a trace of ``step(*example_args)``
    (the manual seam of ``lower_train_step(donate_argnums=)``). Raises
    ValueError when an argument cannot be donated whole, naming why."""
    from sparkdl_tpu_torch.analysis.trace import trace_step

    trace = trace_step(step, *example_args, mesh=mesh, rank=rank,
                       device=device)
    writes, donated, _, reason = plan_donation(
        trace, step, example_args, argnums=donate_argnums)
    if reason:
        raise ValueError(f"cannot donate argument(s) "
                         f"{tuple(donate_argnums)}: {reason}")
    return DonatedStep(step, writes, donated)


@register_fixer("undonated-step-buffers")
def _fix_donation(ctx, findings, env):
    """Plan, from the step's trace, which arguments' replacements can be
    written into them at the op that makes them (:func:`plan_donation`),
    all-or-nothing per Python argument as JAX donates; an argument only
    partly coverable (a read after the last replacement, a view, a
    shared storage, a leaf that requires grad) is skipped, and with no
    argument left the fix degrades."""
    from sparkdl_tpu_torch.analysis import passes_donation as donation_mod

    if ctx.fn is None or ctx.example_args is None or ctx.trace is None:
        return None, ("the step's callable and example arguments are not "
                      "available to trace again")
    if ctx.param_info:
        sigs = {(i.dtype, tuple(i.shape)) for i in ctx.param_info}

        def flagged(shape, dtype):
            return (dtype, shape) in sigs
    else:
        min_elements = int(ctx.options.get(
            "donation_min_elements", donation_mod.DEFAULT_MIN_ELEMENTS))

        def flagged(shape, dtype):
            return donation_mod._elements(shape) >= min_elements
    writes, donated, skipped, reason = plan_donation(
        ctx.trace, ctx.fn, ctx.example_args, flagged=flagged)
    if reason:
        return None, reason
    saved = predicted_peak(ctx.trace) - predicted_peak(ctx.trace, writes)
    fix = Fix(
        rule_id="undonated-step-buffers",
        action="donate-step-buffers",
        description=(
            f"donate argument(s) {list(donated)}: write each of their "
            f"{len(writes)} replacement(s) into its input's storage at the "
            "op that makes it, so the carried state is updated in place"
            + (f" (skipped: {skipped})" if skipped else "")),
        preconditions=(
            "the trace is complete and lists every argument tensor",
            "every tensor of each donated argument has a same-(dtype, "
            "shape) replacement made by an op at or after its last read",
            "no donated tensor is a view, shares its storage or requires "
            "grad",
        ),
        predicted_effect={
            "peak_hbm_bytes_saved": int(saved),
            "donate_argnums": list(donated),
        },
        data={"donate_argnums": list(donated)},
        targets=tuple(f.to_dict() for f in findings),
    )

    def transform(fn, example_args):
        return DonatedStep(fn, writes, donated), example_args

    return fix, transform


def _dtypes_of(trace):
    return [tuple(dt for _, dt in e.outputs) for e in trace.ops]


@register_fixer("host-sync-in-step")
def _fix_weak_scalars(ctx, findings, env):
    """Hoist the Python-scalar arguments out of the signature: the fixed
    step closes over 0-d tensors on the step's device (module
    docstring). Only the WARNING scalar findings are fixable; a card
    read inside the step needs moving by hand."""
    scalar_findings = [f for f in findings if f.op in ("int", "float")]
    if not scalar_findings:
        return None, ("card reads cannot be auto-removed; move them out "
                      "of the step (or onto a metrics cadence outside it)")
    if ctx.fn is None or ctx.example_args is None:
        return None, ("the step's callable and example arguments are not "
                      "available to trace again")

    def scalar(x):
        return isinstance(x, (int, float)) and not isinstance(x, bool)

    top_level = {i for i, a in enumerate(ctx.example_args) if scalar(a)}
    n_scalar_leaves = sum(
        1 for leaf in pytree.tree_leaves(tuple(ctx.example_args))
        if scalar(leaf))
    if n_scalar_leaves != len(top_level):
        return None, (
            "a Python scalar is nested inside a container argument; "
            "hoisting it would change the argument tree: pass a 0-d "
            "tensor with an explicit dtype instead")
    hoisted = {i: ctx.example_args[i] for i in sorted(top_level)}
    devices = [t.device for t in pytree.tree_leaves(tuple(ctx.example_args))
               if isinstance(t, torch.Tensor)]
    device = devices[0] if devices else torch.device("cpu")
    want = _dtypes_of(ctx.trace) if ctx.trace is not None else None

    def build(dtypes):
        consts = {i: torch.tensor(v, dtype=dtypes[i], device=device)
                  for i, v in hoisted.items()}
        made = {}

        def transform(fn, example_args):
            # the same step again: the one traced for the dtype's choice
            key = (id(fn), tuple(id(a) for a in example_args))
            if key in made:
                return made[key]
            n = len(example_args)

            def hoisted_fn(*rest):
                it = iter(rest)
                full = tuple(consts[i] if i in consts else next(it)
                             for i in range(n))
                return fn(*full)

            hoisted_fn.__name__ = getattr(fn, "__name__", "<fn>")
            pruned = tuple(a for i, a in enumerate(example_args)
                           if i not in consts)
            made[key] = hoisted_fn, pruned
            return hoisted_fn, pruned

        return transform

    # each scalar's first dtype that keeps every op's output dtypes (the
    # others at their first); the last trial is the fix's own step
    chosen = {i: _HOIST_DTYPES[type(v)][0] for i, v in hoisted.items()}
    for i, v in hoisted.items():
        for dt in _HOIST_DTYPES[type(v)]:
            transform = build({**chosen, i: dt})
            try:
                got = _dtypes_of(env.context(
                    *transform(ctx.fn, ctx.example_args)).trace)
            except Exception:  # noqa: BLE001 - tried and refused below
                continue
            if want is None or got == want:
                chosen[i] = dt
                break
        else:
            return None, (
                f"no 0-d tensor dtype for argument {i} ({v!r}) leaves "
                "every op's type promotion as the Python scalar's")
    names = {str(k): str(dt).rpartition(".")[2] for k, dt in chosen.items()}
    fix = Fix(
        rule_id="host-sync-in-step",
        action="hoist-weak-scalar",
        description=(
            f"close over argument position(s) {sorted(hoisted)} as 0-d "
            f"tensors on {device} (values {list(hoisted.values())!r}, "
            f"dtypes {names})"),
        preconditions=(
            "every flagged scalar is a whole top-level positional argument "
            "(nested scalars degrade)",
            "the scalar is constant across calls: the fixed signature DROPS "
            "the argument, so a caller feeding a varying value (an lr "
            "schedule, say) fails loudly on arity, never silently frozen",
            "every traced op's output dtypes are the original step's",
        ),
        predicted_effect={
            "hoisted_args": len(hoisted),
            "retrace_on_type_change_removed": True,
        },
        data={"argnums": sorted(hoisted),
              "values": {str(k): v for k, v in hoisted.items()}},
        targets=tuple(f.to_dict() for f in scalar_findings),
    )
    return fix, transform


def _leaf_dtype(leaf):
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return None
    return str(dt).rpartition(".")[2]


@register_fixer("silent-canonicalization")
def _fix_narrow_64bit(ctx, findings, env):
    """Narrow the 64-bit floating argument leaves (tensors and numpy
    arrays) with an explicit, logged cast (module docstring)."""
    arg_findings = [f for f in findings
                    if f.severity == Severity.ERROR
                    and f.op in _NARROW_DTYPE]
    if not arg_findings:
        return None, ("only 64-bit argument leaves are mechanically "
                      "narrowable; 64-bit compute made inside the step (the "
                      "WARNING) needs the constant or tensor made 32 bits "
                      "in source")
    if ctx.example_args is None:
        return None, "no example arguments to rewrite"
    if ctx.trace is not None:
        arg_storages = {s for _, s in ctx.trace.arg_storages}
        held = [i.path for i in ctx.trace.inputs
                if i.dtype in _NARROW_DTYPE and i.storage not in arg_storages]
        if held:
            return None, (
                f"64-bit leaves live in the step's modules or optimizer "
                f"({held[:3]}): cast the module (model.float()), not an "
                "argument")
    paths_leaves = pytree.tree_leaves_with_path(tuple(ctx.example_args))
    casts = []   # (flat index, path, src, dst)
    for i, (path, leaf) in enumerate(paths_leaves):
        dt = _leaf_dtype(leaf)
        if dt in _NARROW_DTYPE:
            casts.append((i, f"args{pytree.keystr(path)}", dt,
                          _NARROW_DTYPE[dt]))
    if not casts:
        return None, "no 64-bit leaves found in the example arguments"

    def transform(fn, example_args, log=True):
        lv, spec = pytree.tree_flatten(tuple(example_args))
        for i, path, src, dst in casts:
            if log:
                logger.info("fixit narrow-64bit-payload: casting %s %s -> "
                            "%s (explicit)", path, src, dst)
            if isinstance(lv[i], torch.Tensor):
                lv[i] = lv[i].to(getattr(torch, dst))
            else:
                lv[i] = np.asarray(lv[i]).astype(dst)
        return fn, tuple(pytree.tree_unflatten(lv, spec))

    leaves = [leaf for _, leaf in paths_leaves]
    bytes_halved = sum(int(leaves[i].nbytes) // 2 for i, _, _, _ in casts)
    targets = list(arg_findings)
    compute = [f for f in findings if f.severity == Severity.WARNING]
    if compute and ctx.fn is not None:
        # the 64-bit compute WARNING goes too when the narrowed step's
        # trace computes nothing in 64 bits (the arguments were its cause)
        fn2, args2 = transform(ctx.fn, ctx.example_args, log=False)
        try:
            if not env.context(fn2, args2).trace.f64_ops:
                targets.extend(compute)
        except Exception:  # noqa: BLE001 - proof 1 then judges the fix
            pass
    fix = Fix(
        rule_id="silent-canonicalization",
        action="narrow-64bit-payload",
        description=(
            f"explicitly cast {len(casts)} argument leaf/leaves to 32 bits "
            "(float64 -> float32, complex128 -> complex64), logged per "
            "leaf"),
        preconditions=(
            "every 64-bit floating input of the step is an argument leaf",
            "the step's outputs narrow with them (float64 -> float32, "
            "complex128 -> complex64), as numeric equivalence checks",
        ),
        predicted_effect={
            "narrowed_leaves": len(casts),
            "payload_bytes_saved": bytes_halved,
        },
        data={"casts": [{"path": p, "from": src, "to": dst}
                        for _, p, src, dst in casts]},
        targets=tuple(f.to_dict() for f in targets),
    )
    return fix, transform


# -- the proofs ---------------------------------------------------------------


def donated_bytes_static(trace):
    """Bytes of the step's inputs that it updates in place (its trace's
    written inputs): the state whose replacements reuse their inputs'
    storage, as donated buffers alias in the JAX package."""
    if trace is None:
        return 0
    return sum(int(np.prod(i.shape, dtype=np.int64)) * _itemsize(i.dtype)
               for i in trace.inputs if i.written)


def peak_bytes(memory_stats):
    """Static peak from a trace's ``memory_stats()``: argument + output +
    temp - alias, THE one spelling of the formula (the budget-delta proof
    and ``chip_smoke.py`` phase 33 call it). A trace counts an output
    that is an input once, so its alias figure is 0."""
    if not memory_stats:
        return None
    return (memory_stats.get("argument_size_in_bytes", 0)
            + memory_stats.get("output_size_in_bytes", 0)
            + memory_stats.get("temp_size_in_bytes", 0)
            - memory_stats.get("alias_size_in_bytes", 0))


def _copy_leaf(x):
    if isinstance(x, torch.Tensor):
        out = x.detach().clone()
        return out.requires_grad_(x.requires_grad) if x.is_leaf else out
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def _copy_args(example_args):
    """A deep copy of every tensor and array leaf, so a donated step run
    for equivalence writes into the COPY, never the caller's tensors."""
    return pytree.tree_map(_copy_leaf, tuple(example_args))


class _StateKept:
    """The modules' and optimizers' state the step holds, put back after
    each equivalence run: a PyTorch step may update it in place, and
    both runs must start from the same state (and the caller's state
    must not move)."""

    def __init__(self, fn, args):
        from sparkdl_tpu_torch.analysis.trace import _state_of

        modules, optimizers = _state_of(fn, args)
        self.tensors = []
        seen = set()
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                if id(t) not in seen:
                    seen.add(id(t))
                    self.tensors.append((t, t.detach().clone()))
        self.optimizers = []
        for opt in optimizers:
            state = {p: {k: (v.detach().clone()
                             if isinstance(v, torch.Tensor) else v)
                         for k, v in st.items()}
                     for p, st in opt.state.items()}
            grads = [(p, p.grad) for g in opt.param_groups
                     for p in g["params"]]
            self.optimizers.append((opt, state, grads))

    def restore(self):
        with torch.no_grad():
            for t, saved in self.tensors:
                t.copy_(saved)
        for opt, state, grads in self.optimizers:
            opt.state.clear()
            for p, st in state.items():
                opt.state[p] = {k: (v.clone() if isinstance(v, torch.Tensor)
                                    else v) for k, v in st.items()}
            for p, g in grads:
                p.grad = g


def _args_concrete_and_small(example_args, max_elements):
    total = 0
    for leaf in pytree.tree_leaves(tuple(example_args)):
        if isinstance(leaf, (int, float, bool, complex, str)) or leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            if leaf.is_meta:
                return False, "abstract (shape-only, meta) argument leaf"
            total += leaf.numel()
        elif isinstance(leaf, np.ndarray):
            total += leaf.size
        else:
            return False, f"non-array argument leaf ({type(leaf).__name__})"
    if total > max_elements:
        return False, (f"example args hold {total} elements "
                       f"(> fix_equiv_max_elements={max_elements})")
    return True, None


def _equiv_tolerance(dtype):
    return 64 * torch.finfo(dtype).eps


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return None


def _numeric_equivalence(orig_fn, orig_args, fixed_fn, fixed_args,
                         max_elements=None, narrowed=None):
    """Run both steps on copies of the example arguments and compare
    leaf for leaf, dtype included (``narrowed``: the dtype map a
    narrowing fix applies to the outputs). Returns the proof dict."""
    ok, reason = _args_concrete_and_small(
        orig_args, max_elements or DEFAULT_EQUIV_MAX_ELEMENTS)
    if not ok:
        return {"ok": False, "reason": reason}
    kept = _StateKept(orig_fn, orig_args)
    strict = getattr(fixed_fn, "strict", None)
    try:
        try:
            ref = orig_fn(*_copy_args(orig_args))
        finally:
            kept.restore()
        if strict is not None:
            fixed_fn.strict = True
        try:
            got = fixed_fn(*_copy_args(fixed_args))
        finally:
            kept.restore()
            if strict is not None:
                fixed_fn.strict = strict
    except Exception as e:  # noqa: BLE001 - the proof's own verdict
        return {"ok": False,
                "reason": f"execution failed ({type(e).__name__}: {e})"}
    ref_leaves, ref_spec = pytree.tree_flatten(ref)
    got_leaves, got_spec = pytree.tree_flatten(got)
    if ref_spec != got_spec:
        return {"ok": False, "reason": "output tree structure differs"}
    max_diff = 0.0
    for r, g in zip(ref_leaves, got_leaves):
        rt, gt = _as_tensor(r), _as_tensor(g)
        if rt is None or gt is None:
            if (rt is None) != (gt is None) or r != g:
                return {"ok": False, "reason": f"output {r!r} -> {g!r}"}
            continue
        want = rt.dtype
        name = str(want).rpartition(".")[2]
        if narrowed and name in narrowed:
            want = getattr(torch, narrowed[name])
        if gt.dtype != want:
            return {"ok": False,
                    "reason": f"output dtype drift {rt.dtype} -> {gt.dtype}"}
        if rt.shape != gt.shape:
            return {"ok": False, "reason": f"output shape drift "
                    f"{tuple(rt.shape)} -> {tuple(gt.shape)}"}
        gt = gt.to(rt.device)   # compared where they are, leaf by leaf
        if want.is_floating_point or want.is_complex:
            tol = _equiv_tolerance(want)
            wide = torch.complex128 if want.is_complex else torch.float64
            rw, gw = rt.to(wide), gt.to(wide)
            diff = float((rw - gw).abs().max()) if rw.numel() else 0.0
            if not torch.allclose(rw, gw, rtol=tol, atol=tol,
                                  equal_nan=True):
                return {"ok": False,
                        "reason": "numeric mismatch beyond tolerance",
                        "max_abs_diff": diff}
            max_diff = max(max_diff, diff)
        elif not torch.equal(rt, gt):
            return {"ok": False,
                    "reason": f"exact mismatch on {want} output"}
    return {"ok": True, "max_abs_diff": max_diff,
            "checked_leaves": len(ref_leaves)}


def _budget_delta(before_ctx, after_ctx, name, predicted_saved=None):
    """Before/after static budgets: the traced peak and the priced comms
    totals. ``ok`` requires both sides computable, the peak not risen,
    and, where the fix predicts ``predicted_saved`` bytes, a fall of at
    least that (a donation that only copies back saves nothing)."""
    from sparkdl_tpu_torch.analysis import comms as comms_mod

    out = {"ok": False}
    peak_b = peak_bytes(before_ctx.memory_stats)
    peak_a = peak_bytes(after_ctx.memory_stats)
    out["memory"] = {
        "peak_bytes_before": peak_b,
        "peak_bytes_after": peak_a,
        "peak_bytes_delta": (peak_a - peak_b)
        if peak_a is not None and peak_b is not None else None,
    }
    comms = None
    if before_ctx.trace is not None and after_ctx.trace is not None:
        try:
            rb = comms_mod.comms_report(before_ctx.trace, name=name)
            ra = comms_mod.comms_report(after_ctx.trace, name=name)
            comms = {
                "wire_bytes_per_device_before":
                    rb["totals"]["wire_bytes_per_device"],
                "wire_bytes_per_device_after":
                    ra["totals"]["wire_bytes_per_device"],
                "predicted_s_before": rb["totals"]["predicted_s"],
                "predicted_s_after": ra["totals"]["predicted_s"],
            }
        except Exception as e:  # noqa: BLE001 - pricing is evidence only
            comms = {"error": f"{type(e).__name__}: {e}"}
    out["comms"] = comms
    if peak_b is None or peak_a is None or comms is None \
            or "error" in comms:
        out["reason"] = "before/after budgets not both computable"
        return out
    if peak_a > peak_b * 1.01 + 4096:
        out["reason"] = f"peak regressed {peak_b} -> {peak_a} bytes"
        return out
    if predicted_saved and peak_b - peak_a < predicted_saved * 0.99 - 4096:
        out["reason"] = (f"peak fell {peak_b - peak_a} bytes, short of the "
                         f"predicted {predicted_saved}")
        return out
    out["ok"] = True
    return out


def _error_sigs(findings):
    return {(f.rule_id, f.op) for f in findings
            if f.severity >= Severity.ERROR}


# -- the engine ---------------------------------------------------------------


def fix_program(fn, example_args, *, params=None, shardings=None,
                mesh=None, options=None, name=None, apply=True, ctx=None,
                findings=None, rank=None, device=None):
    """Run the fix engine over one step: lint it, propose a fix per
    fixable rule (in ``_ACTION_ORDER``), verify each candidate with the
    four proofs and (``apply=True``) advance to the fixed step when they
    hold. A fix that cannot be verified degrades: the attempt is
    reported, the original findings stand, the step is left as it was.

    ``params``, ``shardings``, ``mesh``, ``rank``, ``device`` and
    ``options`` are :func:`~sparkdl_tpu_torch.analysis.lint_fn`'s (the
    trace's settings; ``options["fix_equiv_max_elements"]`` bounds the
    equivalence runs). ``ctx`` / ``findings`` let a caller that already
    traced the step (the CLI's ``--graft``) skip the duplicate trace.

    Returns a :class:`FixitResult`; ``result.report`` is the
    ``sparkdl_tpu.analysis.fixit_report/1`` document."""
    options = dict(options or {})
    name = name or getattr(fn, "__name__", "<fn>")
    env = _Env(params=params, shardings=shardings, mesh=mesh, rank=rank,
               device=device, name=name, options=options)
    if ctx is None:
        ctx = env.context(fn, example_args)
    if findings is None:
        findings = run_passes(ctx)
    findings_before = list(findings)

    cur_fn, cur_args, cur_ctx = fn, tuple(example_args), ctx
    cur_findings = list(findings)
    attempts = []
    max_elements = int(options.get("fix_equiv_max_elements",
                                   DEFAULT_EQUIV_MAX_ELEMENTS))
    rules_with_findings = {f.rule_id for f in cur_findings}
    ordered_rules = [
        rule for action in _ACTION_ORDER
        for rule, (a, _) in FIX_ACTIONS.items()
        if a == action and rule in rules_with_findings
    ]
    for rule in ordered_rules:
        rule_findings = [f for f in cur_findings if f.rule_id == rule]
        if not rule_findings:
            continue
        action = FIX_ACTIONS[rule][0]
        attempt = FixAttempt(rule_id=rule, action=action,
                             findings=tuple(rule_findings))
        attempts.append(attempt)
        fixer = _FIXERS.get(rule)
        try:
            fix, transform = fixer(cur_ctx, rule_findings, env)
        except Exception as e:  # noqa: BLE001 - a fixer's fault degrades
            fix, transform = None, f"fixer crashed ({type(e).__name__}: {e})"
        if fix is None:
            attempt.degraded = True
            attempt.degrade_reason = transform
            logger.warning("fixit %s/%s degraded to the original "
                           "finding(s): %s", rule, action, transform)
            continue
        attempt.fix = fix
        # the candidate step and its trace, before anything runs
        try:
            cand_fn, cand_args = transform(cur_fn, cur_args)
            cand_ctx = env.context(cand_fn, cand_args)
        except Exception as e:  # noqa: BLE001 - the candidate's fault
            attempt.degraded = True
            attempt.degrade_reason = (
                f"fixed step failed to trace ({type(e).__name__}: {e})")
            logger.warning("fixit %s/%s degraded: %s", rule, action,
                           attempt.degrade_reason)
            continue

        # proof 1: the originating pass no longer emits the targets
        remaining = run_passes(cand_ctx, passes=[rule])
        target_sigs = {(t["rule_id"], t["severity"], t["op"])
                       for t in fix.targets}
        still = [f for f in remaining
                 if (f.rule_id, f.severity.name, f.op) in target_sigs]
        proof1 = {"ok": not still, "remaining": len(still)}

        # proof 2: the full registry, no NEW ERROR findings
        cand_findings = run_passes(cand_ctx)
        new_errors = sorted(
            _error_sigs(cand_findings) - _error_sigs(cur_findings))
        proof2 = {"ok": not new_errors,
                  "new_errors": [list(s) for s in new_errors]}

        # proof 3: numeric equivalence against the unfixed step
        proof3 = _numeric_equivalence(
            cur_fn, cur_args, cand_fn, cand_args,
            max_elements=max_elements,
            narrowed=(_NARROW_DTYPE if action == "narrow-64bit-payload"
                      else None))

        # proof 4: the budget delta (peak and comms)
        proof4 = _budget_delta(
            cur_ctx, cand_ctx, name,
            predicted_saved=fix.predicted_effect.get("peak_hbm_bytes_saved"))

        attempt.proofs = {
            "finding_eliminated": proof1,
            "no_new_errors": proof2,
            "numeric_equivalence": proof3,
            "budget_delta": proof4,
        }
        attempt.verified = all(p.get("ok") for p in attempt.proofs.values())
        if not attempt.verified:
            attempt.degraded = True
            failed = [k for k, p in attempt.proofs.items()
                      if not p.get("ok")]
            attempt.degrade_reason = (
                "verification failed (" + ", ".join(failed) + "); the "
                "original finding stands")
            logger.warning("fixit %s/%s degraded: %s", rule, action,
                           attempt.degrade_reason)
            continue
        # verified: advance. ``applied`` records whether the caller asked
        # for the fixed step (a dry run proves the same, hands it back)
        attempt.applied = bool(apply)
        cur_fn, cur_args, cur_ctx = cand_fn, cand_args, cand_ctx
        cur_findings = cand_findings
        logger.info("fixit %s/%s %s: %s", rule, action,
                    "applied" if apply else "verified (dry-run)",
                    fix.description)

    # "unfixable": the findings no VERIFIED fix targeted, by identity (a
    # card read shares host-sync-in-step with the hoistable scalars but
    # survives the hoist)
    fixed_targets = [dict(t) for a in attempts if a.verified and a.fix
                     for t in a.fix.targets]
    unfixable = [f for f in findings_before
                 if f.to_dict() not in fixed_targets]
    report = {
        "schema": FIXIT_SCHEMA,
        "name": name,
        "mode": "apply" if apply else "dry-run",
        "fixes": [a.to_dict() for a in attempts],
        "unfixable": [f.to_dict() for f in unfixable],
        "findings_before": [f.to_dict() for f in findings_before],
        "findings_after": [f.to_dict() for f in cur_findings],
        "summary": {
            "proposed": len(attempts),
            "verified": sum(1 for a in attempts if a.verified),
            "applied": sum(1 for a in attempts if a.applied),
            "degraded": sum(1 for a in attempts if a.degraded),
            "findings_before": len(findings_before),
            "findings_after": len(cur_findings),
        },
    }
    if not apply:
        # a dry run hands the ORIGINAL step back (its trace too)
        cur_fn, cur_args, cur_ctx = fn, tuple(example_args), ctx
    return FixitResult(
        fn=cur_fn,
        example_args=cur_args,
        lowered=cur_ctx.trace,
        ctx=cur_ctx,
        findings_before=findings_before,
        findings_after=cur_findings,
        attempts=attempts,
        report=report,
    )


def render_fixit_text(report):
    """Human-readable fixit table (the CLI's text mode and
    ``observe.doctor`` render the same report)."""
    s = report.get("summary", {})
    lines = [
        f"fixit [{report.get('name')}] ({report.get('mode')}): "
        f"{s.get('proposed', 0)} fix(es) proposed, "
        f"{s.get('verified', 0)} verified, "
        f"{s.get('applied', 0)} applied, "
        f"{s.get('degraded', 0)} degraded; findings "
        f"{s.get('findings_before', 0)} -> {s.get('findings_after', 0)}"
    ]
    for entry in report.get("fixes", ()):
        state = ("applied" if entry.get("applied")
                 else "verified" if entry.get("verified")
                 else "degraded")
        line = f"  [{state}] {entry['rule_id']} -> {entry['action']}"
        fix = entry.get("fix")
        if fix:
            line += f": {fix['description']}"
        if entry.get("degrade_reason"):
            line += f" ({entry['degrade_reason']})"
        lines.append(line)
        proofs = entry.get("proofs") or {}
        if proofs:
            mem = (proofs.get("budget_delta") or {}).get("memory") or {}
            delta = mem.get("peak_bytes_delta")
            bits = [f"{k}={'ok' if (v or {}).get('ok') else 'FAIL'}"
                    for k, v in proofs.items()]
            if delta is not None:
                bits.append(f"peak {delta / 2**20:+.2f} MiB")
            lines.append("      proofs: " + ", ".join(bits))
    return "\n".join(lines)
