"""Trace one call of a PyTorch step without running it: the program the
graph passes read.

Counterpart of ``sparkdl_tpu/analysis/jaxpr_walk.py`` and
``sparkdl_tpu/analysis/hlo.py``: there the passes read the step's jaxpr
and its lowered and compiled module texts; an eager PyTorch step has
none, so :func:`trace_step` runs the step once on ``meta`` tensors under
a recording ``TorchDispatchMode`` and keeps what it saw, in program
order, as a :class:`Trace`:

- every ATen op (:class:`OpEvent`): its name, the shapes and dtypes of
  its tensor inputs and outputs, whether it writes an input in place or
  returns a view of one, its FLOPs (the formula table of
  ``torch.utils.flop_counter``, FlopCounterMode's own) and the first
  source line outside torch and this package;
- every collective the port's ``hvd`` and ``Mesh`` issue
  (:class:`CollectiveEvent`): kind, axis, the ranks of its group, shape,
  dtype, bytes, async issue and wait, source line. They are recorded in
  place of the ``torch.distributed`` call, which never runs: with a
  ``mesh`` (a :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` or an
  axis-size dict) and a ``rank``, ``hvd.rank()``, ``hvd.size()`` and the
  mesh's coordinates answer for that rank, and each collective returns
  a meta result of its shape. A direct ``torch.distributed`` call in
  the step raises :class:`TracedCollectiveError`, which names it;
- every kernel launch the port's wrappers would make
  (:class:`KernelEvent`, named as the kernel table of ``PERF.md`` names
  them: B1-B6), with the kernel's own FLOPs and bytes;
- the live bytes over the step: the inputs, plus each tensor allocated,
  less each one freed (a storage's lifetime is its C++ lifetime, the
  autograd graph's saved tensors included). Their peak is the static
  budget (:meth:`Trace.memory_stats`).

Each input tensor stands for a tensor on the trace's ``device`` (the
card unless the caller names the CPU), whatever device it is given on,
so a CPU test lints a step as it would run on the card and a trace on
the card allocates no card memory: the model's parameters and buffers
and its optimizer's state are swapped for meta copies for the call and
put back after it, and a tensor met on the card during the call is met
as a meta copy. An optimizer's step counters, which torch keeps on the
host, stay host tensors (copies). A tensor the step makes on the host
runs on the host.

A value the host reads from the card ends the trace where it is read
(:class:`HostSync`): ``.item()``, ``bool()``, ``int()`` and the other
scalar reads, a copy from the card to the host, and an op whose output
shape depends on the data (``nonzero``, boolean masking, ``unique``). A
meta tensor has no value to give, and the program the host runs past
that point depends on it.
"""

import dataclasses
import math
import os
import sys
import threading
import time
import weakref

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import sparkdl_tpu_torch

aten = torch.ops.aten

# one trace at a time in a process: a trace swaps process-wide state (the
# hvd state, torch.distributed's collectives) for its call
_LOCK = threading.Lock()

# ops whose output shape (or value on the host) depends on the data
_DATA_DEPENDENT = {
    aten._local_scalar_dense.default: "scalar read",
    aten.equal.default: "scalar read",
    aten.is_nonzero.default: "scalar read",
    aten.nonzero.default: "data-dependent shape",
    aten.masked_select.default: "data-dependent shape",
    aten.unique_consecutive.default: "data-dependent shape",
    aten._unique2.default: "data-dependent shape",
    aten.unique_dim.default: "data-dependent shape",
    aten.bincount.default: "data-dependent shape",
    aten.repeat_interleave.Tensor: "data-dependent shape",
}

# ops that carry an all-gather's result on in another shape (besides
# the views, which the schema marks): its forms, which the
# full-param-allgather pass matches against the parameters
_SHAPE_OPS = {aten.clone.default, aten._unsafe_view.default,
              aten._to_copy.default, aten.contiguous.default}

# ops that move or make data and compute nothing (for the overlap pass)
_NOT_COMPUTE = {aten._to_copy.default, aten.copy_.default,
                aten.clone.default, aten.detach.default,
                aten.lift_fresh.default, aten.empty.memory_format,
                aten.empty_like.default, aten.empty_strided.default,
                aten.new_empty.default, aten.zeros.default,
                aten.zeros_like.default, aten.new_zeros.default,
                aten.ones_like.default, aten.fill_.Scalar,
                aten.zero_.default, aten._unsafe_view.default}

_HLO_DTYPES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}


def hlo_dtype(dtype):
    """The HLO spelling of a torch dtype (``torch.float32`` -> ``"f32"``),
    the vocabulary of the JAX package's comms report."""
    return _HLO_DTYPES.get(dtype, str(dtype).rpartition(".")[2])


def hlo_dtype_of_name(name):
    """The HLO spelling of a numpy-style dtype name (``"bfloat16"`` ->
    ``"bf16"``), a :class:`~sparkdl_tpu_torch.analysis.core.ParamInfo`'s
    dtype against a collective's."""
    dtype = getattr(torch, str(name), None)
    return hlo_dtype(dtype) if isinstance(dtype, torch.dtype) else str(name)


def dtype_name(dtype):
    """The numpy-style name of a torch dtype (``"bfloat16"``), as
    :class:`~sparkdl_tpu_torch.analysis.core.ParamInfo` spells it."""
    return str(dtype).rpartition(".")[2]


class TracedCollectiveError(RuntimeError):
    """A ``torch.distributed`` call in a traced step that does not come
    through the port's ``hvd`` or ``Mesh`` collectives on the trace's
    groups: a trace runs no collective, and records only those."""


class _TraceEnded(BaseException):
    """Raised inside the traced call where the host reads a value from
    the card; :func:`trace_step` catches it. A BaseException so that a
    step's own ``except Exception`` cannot swallow it."""


@dataclasses.dataclass
class OpEvent:
    index: int
    name: str                # "aten.mm.default"
    inputs: tuple            # ((shape, dtype name), ...) of tensor args
    outputs: tuple
    writes: bool             # writes an input in place (or out=)
    view: bool               # its output is a view of an input
    flops: int
    location: str
    compute: bool = False    # work a collective could hide under
    # the storages it reads (its tensor inputs), those of its tensor
    # outputs, those it allocated, and the live bytes after it: what
    # the fix engine's donation plan reads (a storage's key is only
    # unique while it lives: an input's, or an output alive at the end)
    reads: tuple = ()
    out_storages: tuple = ()
    allocs: tuple = ()
    live: int = 0


@dataclasses.dataclass
class CollectiveEvent:
    index: int
    kind: str                # "all-reduce", "all-gather", ...
    axis: str                # the mesh axis, or "world"
    ranks: tuple             # the global ranks of this rank's group
    shape: tuple             # the result's
    dtype: str               # HLO spelling, "f32"
    result_bytes: int
    async_op: bool
    location: str
    wait_index: int = None   # event index of an async op's wait
    # a sync collective's: whether the next compute reads its result
    # (None: nothing computes after it)
    feeds_next: bool = None
    # (dtype, shape) of the result and of every view, reshape or copy
    # the step carries an all-gather's result on in
    forms: list = dataclasses.field(default_factory=list)
    reads: tuple = ()        # the storages it sends from
    out_storage: int = None  # the result's storage

    @property
    def group_size(self):
        return len(self.ranks)


@dataclasses.dataclass
class KernelEvent:
    index: int
    kernel: str              # "B1"
    name: str                # "flash_fwd"
    inputs: tuple
    outputs: tuple
    flops: int
    nbytes: int
    location: str
    compute: bool = True
    reads: tuple = ()
    live: int = 0


@dataclasses.dataclass
class HostSync:
    index: int
    op: str
    kind: str                # "scalar read", "copy to host", ...
    location: str


@dataclasses.dataclass
class InputInfo:
    path: str                # "model.layers.0.attn.q_proj.kernel", "args[1]"
    shape: tuple
    dtype: str
    storage: int             # the meta copy's storage
    written: bool = False


@dataclasses.dataclass(frozen=True)
class TracedGroup:
    """A trace's stand-in for a process group: ``axis`` and the global
    ``ranks`` of the traced rank's slice."""

    axis: str
    ranks: tuple

    def size(self):
        return len(self.ranks)


@dataclasses.dataclass
class Trace:
    """One traced call of a step (module docstring)."""

    fn_name: str
    device: str
    rank: int = 0
    world: int = 1
    axes: dict = None
    events: list = dataclasses.field(default_factory=list)
    inputs: list = dataclasses.field(default_factory=list)
    # (path, shape, dtype name, storage) of the step's tensor outputs
    outputs: list = dataclasses.field(default_factory=list)
    flops: int = 0
    bytes_accessed: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    stopped: HostSync = None
    seconds: float = 0.0
    f64_ops: list = dataclasses.field(default_factory=list)
    # (path, storage) of each tensor leaf of the step's arguments, in
    # leaf order: ``args[0]['w']`` and its meta copy's storage
    arg_storages: list = dataclasses.field(default_factory=list)
    # the callable traced, as lower_train_step hands it on (its donated
    # wrapper with donate_argnums); None from trace_step
    step: object = None

    @property
    def complete(self):
        return self.stopped is None

    @property
    def ops(self):
        return [e for e in self.events if isinstance(e, OpEvent)]

    @property
    def collectives(self):
        return [e for e in self.events if isinstance(e, CollectiveEvent)]

    @property
    def kernels(self):
        return [e for e in self.events if isinstance(e, KernelEvent)]

    def kernel_counts(self):
        """``{kernel id: events}`` (``{"B1": 32, ...}``)."""
        out = {}
        for k in self.kernels:
            out[k.kernel] = out.get(k.kernel, 0) + 1
        return out

    def signature(self):
        """The ordered collective sequence every rank of a gang must
        agree on: ``(kind, axis, dtype)`` triples, as the JAX package's
        ``jaxpr_walk.signature`` gives ``(prim, axes, dtype)``."""
        return tuple((c.kind, c.axis, c.dtype) for c in self.collectives)

    def memory_stats(self):
        """The static budget in the keys of the JAX package's
        ``memory_analysis`` dict: the inputs' bytes, the outputs' (those
        that are not inputs), and the peak of the live bytes above both;
        their sum is the live bytes' peak."""
        temp = max(0, self.peak_bytes - self.argument_bytes
                   - self.output_bytes)
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": temp,
                "alias_size_in_bytes": 0}

    def static_budget_bytes(self):
        stats = self.memory_stats()
        return (stats["argument_size_in_bytes"]
                + stats["output_size_in_bytes"] + stats["temp_size_in_bytes"])


# -- where an op comes from --------------------------------------------------

_SKIP_DIRS = tuple(os.path.dirname(m.__file__) + os.sep
                   for m in (torch, sparkdl_tpu_torch))
_STDLIB = os.path.dirname(os.__file__) + os.sep


def _location():
    """``file:line`` of the first frame outside torch, this package and
    the standard library ("" when there is none)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if not (name.startswith(_SKIP_DIRS) or name.startswith("<")
                or (name.startswith(_STDLIB)
                    and "site-packages" not in name)):
            return f"{name}:{f.f_lineno}"
        f = f.f_back
    return ""


def _storage(t):
    return t.untyped_storage()._cdata


def _spec(t):
    return (tuple(int(d) for d in t.shape), dtype_name(t.dtype))


def _nbytes(t):
    return t.numel() * t.element_size()


def _meta_like(t):
    return torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                               dtype=t.dtype, device="meta")


# -- the recording mode ------------------------------------------------------


class _Recorder(TorchDispatchMode):
    """Records every op dispatched while it is active (module docstring)
    into ``trace``."""

    def __init__(self, trace):
        super().__init__()
        self.trace = trace
        self.card = trace.device != "cpu"
        self.active = True
        self.index = 0
        self.live = 0
        self.inputs = {}      # meta storage -> InputInfo
        self.tracked = {}     # meta storage -> bytes, allocated in the call
        self.memo = {}        # id(real tensor) -> (real, meta copy)
        self.gathers = {}     # storage -> CollectiveEvent of its all-gather
        self.pending = []     # (sync collective, its result's storage)
        self.input_bytes_seen = set()

    # -- accounting

    def add_input(self, path, real, meta):
        """``meta`` stands for the input ``real``: its bytes count once
        for the storage ``real`` lies in."""
        key = _storage(meta)
        self.inputs[key] = InputInfo(path, *_spec(real), key)
        real_key = _storage(real)
        if real_key not in self.input_bytes_seen:
            self.input_bytes_seen.add(real_key)
            self.trace.argument_bytes += real.untyped_storage().nbytes()
            self.live += real.untyped_storage().nbytes()
            self.trace.peak_bytes = max(self.trace.peak_bytes, self.live)

    def _track(self, t):
        """Count ``t``'s storage as allocated, once; True when it is new."""
        if not (isinstance(t, torch.Tensor) and t.is_meta):
            return False
        st = t.untyped_storage()
        key = st._cdata
        if key in self.inputs or key in self.tracked:
            return False
        n = st.nbytes()
        self.tracked[key] = n
        self.live += n
        weakref.finalize(st, self._freed, key)
        return True

    def _freed(self, key):
        if self.active:
            self.live -= self.tracked.pop(key, 0)

    def _note_gather(self, t, event):
        """``t`` carries ``event``'s all-gather result on, as long as its
        storage lives (a freed storage's address is used again)."""
        st = t.untyped_storage()
        self.gathers[st._cdata] = event
        weakref.finalize(st, self.gathers.pop, st._cdata, None)
        event.forms.append((hlo_dtype(t.dtype),
                            tuple(int(d) for d in t.shape)))

    def _computed(self, ins):
        """A compute op reading ``ins`` ran: settle the sync collectives
        waiting for the next compute."""
        if self.pending:
            reads = {_storage(t) for t in ins}
            for event, key in self.pending:
                event.feeds_next = key in reads
            self.pending.clear()

    def _to_meta(self, t):
        """A meta tensor for ``t`` met during the call: itself, or a
        memoized meta copy of a real tensor (counted as an input once)."""
        if not isinstance(t, torch.Tensor) or t.is_meta:
            return t
        hit = self.memo.get(id(t))
        if hit is None:
            if t.requires_grad:
                raise ValueError(
                    f"a tensor {_spec(t)} that requires grad entered the "
                    "traced step from outside its modules and arguments: "
                    "pass the module that holds it (as an argument, or as "
                    "the step's .model) so that the trace swaps it")
            meta = _meta_like(t)
            if t.device.type != "cpu" or not self.card:
                self.add_input(f"<tensor met in the step {_spec(t)}>", t,
                               meta)
            hit = self.memo[id(t)] = (t, meta)
        return hit[1]

    def _next(self):
        i = self.index
        self.index += 1
        return i

    # -- the dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = pytree.tree_leaves((args, kwargs))
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        target = kwargs.get("device")
        target = None if target is None else torch.device(target)
        on_card = (any(t.is_meta or t.device.type != "cpu" for t in tensors)
                   or (target is not None and target.type != "cpu"))
        if not on_card:
            # host work (an optimizer's step counter, a CPU index)
            return func(*args, **kwargs)
        if func is aten._to_copy.default and target is not None \
                and target.type == "cpu" and self.card:
            self._stop(func, "copy to host")
        kind = _DATA_DEPENDENT.get(func)
        if kind is None and func is aten.index.Tensor and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if len(args) > 1 else ())):
            kind = "data-dependent shape"
        if kind is not None:
            self._stop(func, kind)
        args, kwargs = pytree.tree_map(self._to_meta, (args, kwargs))
        if target is not None:
            kwargs = dict(kwargs, device=torch.device("meta"))
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _stop(self, func, kind):
        self.trace.stopped = HostSync(self._next(), str(func), kind,
                                      _location())
        raise _TraceEnded()

    def _record(self, func, args, kwargs, out):
        trace = self.trace
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        allocs = tuple(_storage(t) for t in outs if self._track(t))
        trace.peak_bytes = max(trace.peak_bytes, self.live)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        schema = func._schema
        writes = view = False
        for i, arg in enumerate(schema.arguments):
            info = arg.alias_info
            if info is None or not info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in (val if isinstance(val, (list, tuple)) else (val,)):
                if isinstance(t, torch.Tensor):
                    writes = True
                    hit = self.inputs.get(_storage(t))
                    if hit is not None:
                        hit.written = True
        if not writes:
            view = any(r.alias_info is not None for r in schema.returns)
        flops = 0
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            try:
                flops = int(formula(*args, **kwargs, out_val=out))
            except (RuntimeError, TypeError, ValueError, IndexError):
                flops = 0
        nbytes = 0 if view else sum(_nbytes(t) for t in ins + outs)
        trace.flops += flops
        trace.bytes_accessed += nbytes
        event = OpEvent(self._next(), str(func),
                        tuple(_spec(t) for t in ins),
                        tuple(_spec(t) for t in outs), writes, view, flops,
                        _location(), compute=not view and (
                            flops > 0 or func not in _NOT_COMPUTE),
                        reads=tuple(_storage(t) for t in ins),
                        out_storages=tuple(_storage(t) for t in outs),
                        allocs=allocs, live=self.live)
        trace.events.append(event)
        if event.compute:
            self._computed(ins)
        if any(t.dtype in (torch.float64, torch.complex128)
               for t in outs) and not view:
            trace.f64_ops.append(event)
        if (view or func in _SHAPE_OPS) and len(ins) >= 1:
            gather = self.gathers.get(_storage(ins[0]))
            if gather is not None:
                for t in outs:
                    self._note_gather(t, gather)

    # -- kernels and collectives (called by the port's code)

    def kernel_event(self, name, kernel, inputs, outputs, flops, nbytes):
        self._computed(inputs)
        for t in outputs:
            self._track(t)
        self.trace.peak_bytes = max(self.trace.peak_bytes, self.live)
        self.trace.flops += int(flops)
        self.trace.bytes_accessed += int(nbytes)
        self.trace.events.append(KernelEvent(
            self._next(), kernel, name, tuple(_spec(t) for t in inputs),
            tuple(_spec(t) for t in outputs), int(flops), int(nbytes),
            _location(), reads=tuple(_storage(t) for t in inputs),
            live=self.live))

    def collective(self, kind, group, result, async_op, sends=None):
        """Record a collective producing ``result`` from ``sends`` (the
        tensors it reads; ``result`` itself when None)."""
        sends = (result,) if sends is None else sends
        event = CollectiveEvent(
            self._next(), kind, group.axis, tuple(group.ranks),
            tuple(int(d) for d in result.shape), hlo_dtype(result.dtype),
            _nbytes(result), bool(async_op), _location(),
            reads=tuple(_storage(t) for t in sends
                        if isinstance(t, torch.Tensor) and t.is_meta),
            out_storage=_storage(result))
        self.trace.events.append(event)
        if kind == "all-gather":
            self._note_gather(result, event)
        if not async_op:
            self.pending.append((event, _storage(result)))
        return _Work(self, event) if async_op else None

    def waited(self, event):
        if event.wait_index is None:
            event.wait_index = self._next()


class _Work:
    """The handle an async collective returns under a trace; its wait is
    recorded where it is waited for."""

    def __init__(self, recorder, event):
        self._recorder, self._event = recorder, event

    def wait(self, timeout=None):
        self._recorder.waited(self._event)
        return True

    def is_completed(self):
        return True


# -- torch.distributed under a trace -----------------------------------------

# torch.distributed's collectives the port's hvd and Mesh never issue: a
# step that calls one under a trace is refused by name
_REFUSED = ("all_gather", "reduce_scatter", "all_to_all", "gather",
            "scatter", "reduce", "send", "recv", "isend", "irecv",
            "all_gather_object", "broadcast_object_list", "gather_object",
            "scatter_object_list", "monitored_barrier")


class _P2POp:
    """``torch.distributed.P2POp`` under a trace: the op and its peer,
    on a trace's group."""

    def __init__(self, op, tensor, peer=None, group=None, tag=0,
                 group_peer=None):
        self.op, self.tensor, self.peer, self.group = op, tensor, peer, group
        self.tag = tag


def _distributed_stand_ins(recorder, world_group, rank):
    """``{name: stand-in}`` for the names of ``torch.distributed`` a
    trace replaces (module docstring)."""
    dist = torch.distributed

    def group_of(name, group):
        if isinstance(group, TracedGroup):
            return group
        raise TracedCollectiveError(
            f"torch.distributed.{name} called in a traced step on "
            f"{'the default group' if group is None else group!r}: a trace "
            "records only the collectives of the port's hvd and Mesh (on "
            "the trace's groups); call those, or trace this step with the "
            "collective outside it")

    def fill_real(out, value):
        if not out.is_meta and not value.is_meta:
            with torch.no_grad():
                out.copy_(value.reshape(out.shape) if value.numel()
                          == out.numel() else torch.zeros_like(out))

    def all_reduce(tensor, op=None, group=None, async_op=False):
        return recorder.collective("all-reduce", group_of("all_reduce", group),
                                   tensor, async_op)

    def all_gather_into_tensor(output_tensor, input_tensor, group=None,
                               async_op=False):
        group = group_of("all_gather_into_tensor", group)
        if not output_tensor.is_meta and not input_tensor.is_meta:
            fill_real(output_tensor, input_tensor.repeat(
                (group.size(),) + (1,) * (input_tensor.ndim - 1)))
        return recorder.collective("all-gather", group, output_tensor,
                                   async_op, sends=(input_tensor,))

    def reduce_scatter_tensor(output, input, op=None, group=None,
                              async_op=False):
        group = group_of("reduce_scatter_tensor", group)
        return recorder.collective("reduce-scatter", group, output, async_op,
                                   sends=(input,))

    def broadcast(tensor, src=None, group=None, async_op=False,
                  group_src=None):
        return recorder.collective(
            "collective-broadcast", group_of("broadcast", group), tensor,
            async_op)

    def all_to_all_single(output, input, output_split_sizes=None,
                          input_split_sizes=None, group=None,
                          async_op=False):
        group = group_of("all_to_all_single", group)
        fill_real(output, input)
        return recorder.collective("all-to-all", group, output, async_op,
                                   sends=(input,))

    def batch_isend_irecv(p2p_op_list):
        works = []
        for p in p2p_op_list:
            group = group_of("batch_isend_irecv", p.group)
            if getattr(p.op, "__name__", "") == "isend":
                works.append(recorder.collective(
                    "collective-permute", group, p.tensor, True))
        return [w for w in works if w is not None]

    def barrier(group=None, async_op=False, device_ids=None):
        group = world_group if group is None else group_of("barrier", group)
        return recorder.collective("barrier", group,
                                   torch.empty(0, device="meta"), async_op)

    def new_group(ranks=None, *args, **kwargs):
        return TracedGroup("world" if ranks is None else "group",
                           tuple(world_group.ranks if ranks is None
                                 else ranks))

    def refused(name):
        def call(*args, **kwargs):
            group_of(name, kwargs.get("group"))
            raise TracedCollectiveError(
                f"torch.distributed.{name} has no stand-in under a trace: "
                "the port's hvd and Mesh collectives do not issue it")
        return call

    class _Group:
        WORLD = world_group

    out = {name: refused(name) for name in _REFUSED}
    out.update(
        all_reduce=all_reduce, all_gather_into_tensor=all_gather_into_tensor,
        reduce_scatter_tensor=reduce_scatter_tensor, broadcast=broadcast,
        all_to_all_single=all_to_all_single,
        batch_isend_irecv=batch_isend_irecv, barrier=barrier,
        new_group=new_group, P2POp=_P2POp, group=_Group,
        is_initialized=lambda: True,
        get_rank=lambda group=None: (
            rank if group is None else group.ranks.index(rank)),
        get_world_size=lambda group=None: (
            len(world_group.ranks) if group is None else group.size()))
    # isend and irecv are refused when called, but P2POp names them
    out["isend"].__name__, out["irecv"].__name__ = "isend", "irecv"
    return {k: v for k, v in out.items() if hasattr(dist, k)}


def _mesh_groups(axis_names, sizes, rank):
    """``{axis: (ranks, TracedGroup)}`` of ``rank``'s slice along every
    axis of size > 1, laid out as ``parallel.mesh`` lays out a mesh."""
    layout = np.arange(int(np.prod(sizes))).reshape(sizes)
    groups = {}
    for i, axis in enumerate(axis_names):
        if sizes[i] == 1:
            continue
        slices = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
        for ranks in slices.tolist():
            if rank in ranks:
                groups[axis] = (ranks, TracedGroup(axis, tuple(ranks)))
    return groups


def _as_mesh(mesh):
    """A :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` for ``mesh``: the
    Mesh itself, or one built from an axis-size dict."""
    from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh

    if isinstance(mesh, Mesh):
        return mesh
    unknown = sorted(set(mesh) - set(AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                         f"{list(AXES)}")
    return Mesh(AXES, tuple(int(mesh.get(a, 1)) for a in AXES))


# -- what the step holds -----------------------------------------------------


def _state_of(fn, args):
    """The modules and optimizers the step works on: among its arguments,
    its ``model`` / ``optimizer`` attributes, and what its closure (and
    the closures of the functions there, a few levels deep) holds."""
    modules, optimizers, seen = {}, {}, set()

    def visit(obj, depth):
        if id(obj) in seen or depth > 4:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.nn.Module):
            modules[id(obj)] = obj
        elif isinstance(obj, torch.optim.Optimizer):
            optimizers[id(obj)] = obj
        elif isinstance(obj, (list, tuple)):
            for x in obj:
                visit(x, depth + 1)
        elif isinstance(obj, dict):
            for x in obj.values():
                visit(x, depth + 1)
        elif callable(obj):
            for attr in ("model", "optimizer", "func", "__self__",
                         "__wrapped__"):
                inner = getattr(obj, attr, None)
                if inner is not None:
                    visit(inner, depth + 1)
            for x in getattr(obj, "args", ()) or ():
                visit(x, depth + 1)
            for cell in getattr(obj, "__closure__", None) or ():
                try:
                    visit(cell.cell_contents, depth + 1)
                except ValueError:   # an empty cell
                    continue
            code = getattr(obj, "__code__", None)
            if code is not None:
                # the module globals it names, those of nested defs too
                g = getattr(obj, "__globals__", {})
                for name in sorted(_global_refs(code)):
                    visit(g.get(name), depth + 1)

    visit(fn, 0)
    for a in args:
        visit(a, 1)
    return list(modules.values()), list(optimizers.values())


def _global_refs(code):
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, type(code)):
            names |= _global_refs(const)
    return names


class _Swap:
    """The step's state swapped for meta copies for one call, and put
    back (:meth:`restore`)."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.memo = {}      # id(real) -> meta copy
        self.undo = []

    def meta(self, path, t, param=False):
        hit = self.memo.get(id(t))
        if hit is None:
            copy = _meta_like(t)
            if param:
                copy = torch.nn.Parameter(copy, requires_grad=t.requires_grad)
            elif t.requires_grad:
                copy.requires_grad_()
            self.recorder.add_input(path, t, copy)
            hit = self.memo[id(t)] = copy
        return hit

    def modules(self, modules):
        for root in modules:
            for prefix, mod in root.named_modules():
                for table, param in (("_parameters", True),
                                     ("_buffers", False)):
                    entries = getattr(mod, table)
                    for name, t in list(entries.items()):
                        if t is None:
                            continue
                        path = f"{prefix}.{name}" if prefix else name
                        entries[name] = self.meta(path, t, param)
                        self.undo.append((entries, name, t))

    def optimizers(self, optimizers, card):
        for opt in optimizers:
            groups = [(g, g["params"], g.get("foreach")) for g in
                      opt.param_groups]
            state = opt.state
            self.undo.append((opt, groups, state))
            new_state = type(state)() if hasattr(state, "default_factory") \
                else {}
            if hasattr(state, "default_factory"):
                new_state.default_factory = state.default_factory
            for i, (g, params, foreach) in enumerate(groups):
                g["params"] = [self.meta(f"optimizer.params[{i}]", p, True)
                               for p in params]
                # torch's default on the card is the foreach path
                if card and foreach is None and "foreach" in g:
                    g["foreach"] = True
            for p, st in state.items():
                new_st = {}
                for k, v in st.items():
                    if not isinstance(v, torch.Tensor):
                        new_st[k] = v
                    elif k == "step" and v.device.type == "cpu":
                        new_st[k] = v.clone()   # a host counter
                    else:
                        new_st[k] = self.meta(f"optimizer.state.{k}", v)
                new_state[self.memo.get(id(p), p)] = new_st
            opt.state = new_state

    def args(self, args):
        def conv(path, x):
            if isinstance(x, torch.Tensor):
                key = f"args{pytree.keystr(path)}"
                copy = self.meta(key, x)
                self.recorder.trace.arg_storages.append((key, _storage(copy)))
                return copy
            return x

        return pytree.tree_map_with_path(conv, args)

    def restore(self):
        for entry in reversed(self.undo):
            if len(entry) == 3 and isinstance(entry[0], dict):
                entries, name, t = entry
                entries[name] = t
            else:
                opt, groups, state = entry
                for g, params, foreach in groups:
                    g["params"] = params
                    if "foreach" in g:
                        g["foreach"] = foreach
                opt.state = state
        self.undo.clear()


def _flat_outputs(out):
    leaves = pytree.tree_leaves_with_path(out)
    return [(pytree.keystr(p) or "<output>", t) for p, t in leaves
            if isinstance(t, torch.Tensor)]


def trace_step(fn, *args, mesh=None, rank=None, device=None, name=None):
    """Trace ``fn(*args)`` once (module docstring) and return its
    :class:`Trace`. The call's own return value is dropped.

    :param mesh: a :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` (the
        one the step's layers hold: its rank, coordinates and groups are
        the traced rank's for the call) or an axis-size dict
        (``{"data": 2}``; ``make_mesh`` inside the step then answers
        for it). Without one, inside a gang of more than one rank, the
        gang's world is traced as one ``data`` axis.
    :param rank: the traced rank (default: this process's in a gang,
        else 0).
    :param device: the device the step's tensors stand for: ``"cuda"``
        (default) or ``"cpu"``.
    """
    from sparkdl_tpu_torch.hvd import _state

    device = torch.device("cuda" if device is None else device).type
    if device not in ("cuda", "cpu"):
        raise ValueError(f"a trace stands for the card or the CPU, not "
                         f"{device!r}")
    st = _state.state()
    if mesh is None and st.group is not None and st.size > 1 \
            and not isinstance(st.group, TracedGroup):
        mesh = {"data": st.size}
    m = None if mesh is None else _as_mesh(mesh)
    world = 1 if m is None else math.prod(m.shape.values())
    if rank is None:
        rank = st.rank if world > 1 and st.size == world else 0
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a traced world of {world}")
    trace = Trace(fn_name=name or getattr(fn, "__name__", "<fn>"),
                  device=device, rank=rank, world=world,
                  axes=None if m is None else dict(m.shape))
    with _LOCK:
        _trace_into(trace, fn, args, m, rank)
    return trace


def _trace_into(trace, fn, args, mesh, rank):
    from sparkdl_tpu_torch.hvd import _state

    recorder = _Recorder(trace)
    swap = _Swap(recorder)
    dist = torch.distributed
    saved_dist, saved_mesh, snap = {}, None, None
    t0 = time.perf_counter()
    try:
        modules, optimizers = _state_of(fn, args)
        swap.modules(modules)
        swap.optimizers(optimizers, recorder.card)
        margs = swap.args(args)
        if mesh is not None:
            world_group = TracedGroup("world", tuple(range(trace.world)))
            for k, v in _distributed_stand_ins(recorder, world_group,
                                               rank).items():
                saved_dist[k] = getattr(dist, k)
                setattr(dist, k, v)
            saved_mesh = (mesh.rank, mesh.coords, mesh.groups)
            sizes = tuple(mesh.shape.values())
            mesh.rank = rank
            mesh.coords = dict(zip(mesh.axis_names, _unravel(rank, sizes)))
            mesh.groups = _mesh_groups(mesh.axis_names, sizes, rank)
            # hvd answers for the traced rank of the traced world
            st = _state.state()
            snap = st.snapshot()
            st.initialized, st.rank, st.size = True, rank, trace.world
            st.local_rank, st.local_size = rank, trace.world
            st.group, st.backend = world_group, _state.PER_CARD_BACKEND
            st.device, st.master, st.local = None, None, False
        with recorder:
            try:
                out = fn(*margs)
            except _TraceEnded:
                out = None
        for path, t in _flat_outputs(out):
            if not t.is_meta:
                continue
            key = _storage(t)
            trace.outputs.append((path, *_spec(t), key))
            if key not in recorder.inputs:
                trace.output_bytes += t.untyped_storage().nbytes()
        trace.inputs = list(recorder.inputs.values())
        del out
    finally:
        recorder.active = False
        if snap is not None:
            _state.state().restore(snap)
        if saved_mesh is not None:
            mesh.rank, mesh.coords, mesh.groups = saved_mesh
        for k, v in saved_dist.items():
            setattr(dist, k, v)
        swap.restore()
        trace.seconds = time.perf_counter() - t0


def _unravel(rank, sizes):
    out = []
    for size in reversed(sizes):
        out.append(rank % size)
        rank //= size
    return list(reversed(out))
