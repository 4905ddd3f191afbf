"""Cross-process collectives over the gang's process group, one rank a
process.

Counterpart of ``sparkdl_tpu/hvd/_collectives.py``, whose engine runs
each collective as a compiled ``shard_map`` program over a one-device-a-
process mesh. Here each is one ``torch.distributed`` call on the default
group; the semantics are the JAX engine's:

- ``average`` / ``sum`` / ``min`` / ``max``; a float average is summed
  and divided in its own dtype, an integer (or bool) average is summed,
  divided in float64 and truncated back to the input dtype, and bool
  reduces as uint8 (``sum`` and ``average`` are then "any", ``min``
  "all");
- ``allgather`` takes first dimensions that differ by rank: the sizes
  are exchanged, each rank pads to the largest, gathers and trims;
- ``alltoall`` with equal or given splits, ``scatter_reduce`` along a
  first dimension divisible by the size, ``broadcast`` and ``barrier``;
- :func:`reduce_start` issues an allreduce at once, on the calling
  thread, and hands back an :class:`AsyncCollective`: the cross-rank
  order of collectives is the caller's program order.

Every function takes and returns torch tensors; the result keeps the
input's dtype and device. CUDA tensors are reduced on the card over
NCCL when every rank has its own card; on a gloo group (ranks sharing a
card, or a CPU gang) they are staged through host memory
(:mod:`sparkdl_tpu_torch.hvd._state` states the rule). Dtypes that a
backend lacks travel widened and come back: bool as uint8, int16 and
uint16 as int32, uint32 as int64. Outside a gang (no process group:
local mode, or a plain process) every collective returns a copy of its
input, as the JAX engine does at size 1.

With telemetry on, each public collective (the JAX engine's ``@_observed``)
marks its entry and exit for the hang detector
(``health.note_collective``), counts ``collective_ops_total{op}`` and
``collective_bytes_total{op}``, observes ``collective_seconds{op}`` and
records a ``cat="collective"`` span, under the JAX engine's op names
(``reduce``, ``allgather``, ``alltoall``, ``scatter_reduce``,
``broadcast``); an :class:`AsyncCollective` does so around its wait.
The span of a collective NCCL runs on the card is its enqueue, as a
dispatched collective's is in the JAX engine. With telemetry off, one
test of the switch.
"""

import datetime
import functools
import time

import torch
import torch.distributed as dist

from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.hvd import _state

# Reduction ops (horovod.common.Op semantics)
AVERAGE = "average"
SUM = "sum"
MIN = "min"
MAX = "max"

_REDUCE_OPS = {AVERAGE: dist.ReduceOp.SUM, SUM: dist.ReduceOp.SUM,
               MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX}
_WIDENED = {torch.bool: torch.uint8, torch.int16: torch.int32,
            torch.uint16: torch.int32, torch.uint32: torch.int64}


def _record(op_name, nbytes, wall0, dt):
    from sparkdl_tpu_torch.observe import health

    health.note_collective(op_name, done=True)
    observe.inc("collective_ops_total", op=op_name)
    observe.inc("collective_bytes_total", value=nbytes, op=op_name)
    observe.observe_value("collective_seconds", dt, op=op_name)
    observe.complete(op_name, wall0, dt, cat="collective", op=op_name,
                     bytes=nbytes)


def _nbytes(x):
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _observed(op_name):
    """The collective's telemetry (module docstring); with telemetry off,
    straight through."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(x, *args, **kwargs):
            if not observe.enabled():
                return fn(x, *args, **kwargs)
            from sparkdl_tpu_torch.observe import health

            health.note_collective(op_name)
            wall0 = time.time()
            t0 = time.perf_counter()
            out = fn(x, *args, **kwargs)
            _record(op_name, _nbytes(x), wall0, time.perf_counter() - t0)
            return out

        return wrapper

    return deco


def resolve_op(average, op):
    """Horovod's rule: an explicit ``op`` wins, else average unless
    ``average`` is False."""
    if op is not None:
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduction op {op!r}")
        return op
    if average is None or average is True:
        return AVERAGE
    return SUM


def _wire_device(x):
    """Where ``x`` travels: the card over NCCL, else host memory."""
    st = _state.state()
    if x.device.type == "cuda" and st.nccl:
        return x.device
    return torch.device("cpu")


def _on_wire(x):
    """A contiguous copy of ``x`` on the device and in the dtype its
    backend takes."""
    return x.detach().to(device=_wire_device(x),
                         dtype=_WIDENED.get(x.dtype, x.dtype),
                         copy=True).contiguous()


def _off_wire(w, like):
    """``w`` back in ``like``'s dtype and on its device."""
    if like.dtype == torch.bool:
        w = w != 0
    return w.to(device=like.device, dtype=like.dtype)


def _finish_reduce(w, op, size):
    """The average's division after a wire-level sum: in the wire dtype
    for floats, in float64 (truncated back by :func:`_off_wire`) for
    integers and bool."""
    if op != AVERAGE:
        return w
    if w.is_floating_point():
        return w.div_(size)
    return w.double() / size


class AsyncCollective:
    """Handle of a collective already issued on the calling thread
    (:func:`reduce_start`): the wire time runs while the caller does
    other work. Resolve with :meth:`result` (the reduced tensor) or
    :meth:`wait`. Every rank issues its collectives in the same program
    order, so handles may be resolved in any order."""

    def __init__(self, work, finish, op_name=None, nbytes=0):
        self._work = work
        self._finish = finish
        self._value = None
        self._resolved = False
        # the op name its wait is observed under (None: not observed)
        self._op_name = op_name
        self._nbytes = nbytes

    def done(self):
        return (self._resolved or self._work is None
                or self._work.is_completed())

    def result(self, timeout=None):
        """The collective's result (raising its error, if any);
        ``timeout`` in seconds."""
        if not self._resolved:
            observed = self._op_name is not None and observe.enabled()
            if observed:
                from sparkdl_tpu_torch.observe import health

                health.note_collective(self._op_name)
                wall0 = time.time()
                t0 = time.perf_counter()
            if self._work is not None:
                if timeout is None:
                    self._work.wait()
                else:
                    self._work.wait(datetime.timedelta(seconds=timeout))
            self._value = self._finish()
            self._resolved = True
            if observed:
                _record(self._op_name, self._nbytes, wall0,
                        time.perf_counter() - t0)
        return self._value

    def wait(self, timeout=None):
        """Block until done, discarding the value."""
        self.result(timeout)


def _reduce_start(x, op, convert=None, op_name=None):
    st = _state.state()
    convert = convert or (lambda out: out)
    if st.group is None:
        out = x.detach().clone()
        return AsyncCollective(None, lambda: convert(out), op_name,
                               _nbytes(x))
    w = _on_wire(x)
    work = dist.all_reduce(w, op=_REDUCE_OPS[op], async_op=True)
    return AsyncCollective(work, lambda: convert(
        _off_wire(_finish_reduce(w, op, st.size), x)), op_name, _nbytes(x))


def reduce_start(x, op, convert=None):
    """Issue the allreduce of ``x`` now, on the calling thread, from a
    copy (the caller may change ``x`` meanwhile); returns its
    :class:`AsyncCollective`, whose result is passed through
    ``convert`` when given."""
    return _reduce_start(x, op, convert, op_name="reduce")


@_observed("reduce")
def reduce(x, op):
    """Allreduce ``x`` across the gang; returns a new tensor."""
    return _reduce_start(x, op).result()


@_observed("reduce")
def reduce_(buf, op):
    """Allreduce ``buf`` in place. A contiguous float buffer on its wire
    device (a CUDA gradient buffer of a NCCL gang) is reduced where it
    lies, with no copy; any other takes :func:`reduce` and is copied
    back."""
    st = _state.state()
    if st.group is None:
        return buf
    if (buf.is_floating_point() and buf.is_contiguous()
            and _wire_device(buf) == buf.device):
        dist.all_reduce(buf, op=_REDUCE_OPS[op])
        if op == AVERAGE:
            buf.div_(st.size)
        return buf
    with torch.no_grad():
        return buf.copy_(_reduce_start(buf, op).result())


@_observed("allgather")
def allgather(x):
    """Concatenate every rank's ``x`` along dim 0; the first dimensions
    may differ by rank (size exchange, pad, gather, trim)."""
    st = _state.state()
    if st.group is None:
        return x.detach().clone()
    if x.ndim == 0:
        x = x[None]
    sizes = torch.empty(st.size, dtype=torch.int64)
    dist.all_gather_into_tensor(sizes, torch.tensor([x.shape[0]]))
    sizes = sizes.tolist()
    w = _on_wire(x)
    pad = max(sizes) - x.shape[0]
    if pad:
        w = torch.cat([w, w.new_zeros((pad,) + tuple(w.shape[1:]))])
    out = w.new_empty((st.size * max(sizes),) + tuple(w.shape[1:]))
    dist.all_gather_into_tensor(out, w)
    rows = out.view((st.size, max(sizes)) + tuple(w.shape[1:]))
    parts = [rows[r, :sizes[r]] for r in range(st.size)]
    return _off_wire(torch.cat(parts), x)


@_observed("alltoall")
def alltoall(x, splits):
    """All-to-all along dim 0: ``splits[j]`` rows of ``x`` go to rank j
    (in order), and the result holds the rows every rank sent here, in
    rank order. The split table is exchanged first, so ranks with other
    splits still issue the same collectives."""
    st = _state.state()
    if st.group is None:
        return x.detach().clone()
    table = allgather.__wrapped__(
        torch.tensor(splits, dtype=torch.int64)[None])
    received = table[:, st.rank].tolist()
    w = _on_wire(x)
    out = w.new_empty((sum(received),) + tuple(w.shape[1:]))
    dist.all_to_all_single(out, w, output_split_sizes=received,
                           input_split_sizes=list(splits))
    return _off_wire(out, x)


@_observed("scatter_reduce")
def scatter_reduce(x, op):
    """Reduce-scatter along dim 0 (divisible by the size): each rank
    receives its own reduced ``dim0 / size`` rows. ``sum`` and
    ``average`` take one reduce-scatter; ``min`` and ``max`` a full
    reduce and a slice, as in the JAX engine."""
    st = _state.state()
    n = st.size
    if x.shape[0] % n:
        raise ValueError(f"scatter_reduce requires dim0 ({x.shape[0]}) "
                         f"divisible by size ({n})")
    if st.group is None:
        return x.detach().clone()
    chunk = x.shape[0] // n
    if op not in (SUM, AVERAGE):
        return _reduce_start(x, op).result()[
            st.rank * chunk:(st.rank + 1) * chunk]
    w = _on_wire(x)
    out = w.new_empty((chunk,) + tuple(w.shape[1:]))
    dist.reduce_scatter_tensor(out, w, op=dist.ReduceOp.SUM)
    return _off_wire(_finish_reduce(out, op, n), x)


@_observed("broadcast")
def broadcast(x, root_rank):
    """Rank ``root_rank``'s ``x`` on every rank; returns a new tensor."""
    if _state.state().group is None:
        return x.detach().clone()
    w = _on_wire(x)
    dist.broadcast(w, src=int(root_rank))
    return _off_wire(w, x)


@_observed("broadcast")
def broadcast_(x, root_rank):
    """Broadcast into ``x`` in place: on the card over NCCL where it
    lies, else through :func:`broadcast` and a copy back."""
    if _state.state().group is None:
        return x
    with torch.no_grad():
        if (x.is_contiguous() and x.dtype not in _WIDENED
                and _wire_device(x) == x.device):
            dist.broadcast(x, src=int(root_rank))
            return x
        return x.copy_(broadcast.__wrapped__(x, root_rank))


def barrier():
    """Wait for every rank (a one-value allreduce, as the JAX engine
    does, so it takes the CPU backend of any group)."""
    reduce(torch.zeros(1), SUM)
