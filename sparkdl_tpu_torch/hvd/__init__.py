"""The Horovod API of the port, over ``torch.distributed``.

Counterpart of ``sparkdl_tpu/hvd/__init__.py`` (the ``hvd.*`` surface
that a HorovodRunner ``main`` calls) and of the JAX package's PyTorch
drop-in ``horovod/torch/__init__.py`` (:mod:`sparkdl_tpu_torch.hvd.optim`:
``DistributedOptimizer``, ``broadcast_parameters``, the in-place
collectives). ``init()`` joins the gang's process group; the
collectives run on it (:mod:`sparkdl_tpu_torch.hvd._collectives` states
their semantics, which are the JAX engine's).

Tensors in and out are torch tensors, numpy arrays or tf tensors
(anything else is taken through ``np.asarray``); a result has the
caller's type, dtype and device (:mod:`sparkdl_tpu_torch.utils.interop`).
"""

import hashlib
import pickle

import numpy as np
import torch
import torch.distributed as dist

from sparkdl_tpu_torch.hvd import _collectives as _engine
from sparkdl_tpu_torch.hvd import _state
from sparkdl_tpu_torch.hvd._collectives import (
    AVERAGE,
    MAX,
    MIN,
    SUM,
    AsyncCollective,
    resolve_op as _resolve_op,
)
from sparkdl_tpu_torch.utils.interop import from_numpy_like, to_numpy

# Horovod-style op constants
Average = AVERAGE
Sum = SUM
Min = MIN
Max = MAX


def init(comm=None):
    """Join the gang (:func:`sparkdl_tpu_torch.hvd._state.init`).
    ``comm`` is accepted for Horovod's signature and unused: there is no
    MPI communicator."""
    del comm
    _state.init()


def shutdown():
    _state.shutdown()


def is_initialized():
    return _state.state().initialized


def rank():
    _state.require_initialized()
    return _state.state().rank


def size():
    _state.require_initialized()
    return _state.state().size


def local_rank():
    _state.require_initialized()
    return _state.state().local_rank


def local_size():
    _state.require_initialized()
    return _state.state().local_size


def cross_rank():
    """Rank of this node among nodes (horovod.cross_rank)."""
    _state.require_initialized()
    st = _state.state()
    return st.rank // max(st.local_size, 1)


def cross_size():
    _state.require_initialized()
    st = _state.state()
    return max(st.size // max(st.local_size, 1), 1)


def _to_torch(x):
    """(torch tensor, back) where ``back(out)`` returns ``out`` in the
    caller's type: a tensor as it is, anything else through
    :func:`~sparkdl_tpu_torch.utils.interop.from_numpy_like` (a tf
    tensor gives a tf tensor, a Python scalar a Python scalar, the rest
    a numpy array)."""
    if isinstance(x, torch.Tensor):
        return x, lambda out: out
    return (torch.from_numpy(np.array(to_numpy(x), copy=True, order="C")),
            lambda out: from_numpy_like(out.numpy(), x))


def allreduce(tensor, average=None, name=None, op=None):
    """Allreduce across all ranks; the default op is the average
    (Horovod's gradient-averaging semantics)."""
    del name
    _state.require_initialized()
    x, back = _to_torch(tensor)
    return back(_engine.reduce(x, _resolve_op(average, op)))


def allreduce_async(tensor, average=None, name=None, op=None):
    """Allreduce issued now, on the calling thread, from a copy of
    ``tensor``; returns an :class:`AsyncCollective` whose ``result()``
    is what :func:`allreduce` returns. The wire time overlaps what the
    caller does next::

        handle = hvd.allreduce_async(grads)
        next_logits = forward(next_batch)
        grads = handle.result()
    """
    del name
    _state.require_initialized()
    x, back = _to_torch(tensor)
    return _engine.reduce_start(x, _resolve_op(average, op), back)


def grouped_allreduce(tensors, average=None, name=None, op=None):
    """Fused allreduce of a list: one collective per (dtype, device)
    (Horovod's tensor fusion) instead of one per tensor."""
    del name
    _state.require_initialized()
    kind = _resolve_op(average, op)
    converted = [_to_torch(t) for t in tensors]
    groups = {}
    for i, (x, _) in enumerate(converted):
        groups.setdefault((x.dtype, x.device), []).append(i)
    out = [None] * len(tensors)
    for idxs in groups.values():
        xs = [converted[i][0] for i in idxs]
        red = _engine.reduce(torch.cat([x.reshape(-1) for x in xs]), kind)
        offset = 0
        for i, x in zip(idxs, xs):
            n = x.numel()
            out[i] = converted[i][1](
                red[offset:offset + n].reshape(x.shape).clone())
            offset += n
    return out


def allgather(tensor, name=None):
    """Concatenate each rank's tensor along axis 0 (dim 0 may differ by
    rank, as in Horovod)."""
    del name
    _state.require_initialized()
    x, back = _to_torch(tensor)
    return back(_engine.allgather(x))


def broadcast(tensor, root_rank, name=None):
    del name
    _state.require_initialized()
    x, back = _to_torch(tensor)
    return back(_engine.broadcast(x, root_rank))


# Payload sizes of the object collectives travel as two int32 limbs
# (divmod 2**20): exact to 2**51 bytes with no wider integer or float on
# the wire (the JAX package's codec, kept so both packages agree on it).
# The guards below still bound a payload to < 2 GiB.
_SIZE_LIMB = 1 << 20


def _size_to_limbs(n):
    hi, lo = divmod(int(n), _SIZE_LIMB)
    return np.array([hi, lo], np.int32)


def _size_from_limbs(limbs):
    return int(limbs[0]) * _SIZE_LIMB + int(limbs[1])


def _pickled(obj):
    return torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)


def broadcast_object(obj, root_rank=0, name=None):
    """Pickle-based object broadcast (horovod.broadcast_object): the
    size first, as two int32 limbs, then the payload as uint8."""
    del name
    _state.require_initialized()
    if size() == 1:
        return obj
    if rank() == root_rank:
        payload = _pickled(obj)
        limbs = _size_to_limbs(payload.numel())
    else:
        payload = None
        limbs = np.zeros((2,), np.int32)
    # the guard comes after the size exchange, so every rank raises
    # together instead of one leaving the others inside the broadcast
    n = _size_from_limbs(_engine.broadcast(torch.from_numpy(limbs),
                                           root_rank))
    if n >= 2**31:
        raise ValueError(
            f"broadcast_object payload is {n} bytes; the payload broadcast "
            "is int32-bounded (< 2 GiB pickled). Broadcast a reference "
            "(path/handle) instead.")
    if payload is None:
        payload = torch.zeros(n, dtype=torch.uint8)
    payload = _engine.broadcast(payload, root_rank)
    return pickle.loads(payload.numpy().tobytes())


def allgather_object(obj, name=None):
    """Pickle-based object allgather (horovod.allgather_object): returns
    ``[rank 0's obj, rank 1's obj, ...]``; payload sizes may differ."""
    del name
    _state.require_initialized()
    if size() == 1:
        return [obj]
    payload = _pickled(obj)
    limbs = _engine.allgather(
        torch.from_numpy(_size_to_limbs(payload.numel()))[None])
    counts = [_size_from_limbs(row) for row in limbs.tolist()]
    if max(counts) >= 2**31:
        raise ValueError(
            f"allgather_object payload of {max(counts)} bytes on rank "
            f"{counts.index(max(counts))}: the payload gather is "
            "int32-bounded (< 2 GiB pickled). Gather a reference "
            "(path/handle) instead of the object.")
    flat = _engine.allgather(payload).numpy()
    out, off = [], 0
    for n in counts:
        out.append(pickle.loads(flat[off:off + n].tobytes()))
        off += n
    return out


def barrier():
    _state.require_initialized()
    _engine.barrier()


def _leaves(tree):
    """The arrays of a tree in a rank-independent order: dict keys
    sorted (as ``jax.tree.leaves`` orders them), lists and tuples in
    order, a module by its state dict, ``None`` empty."""
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [_to_torch(tree)[0]]


def check_synchronized(tree, name="parameters", atol=0.0):
    """Check that a tree of tensors is the same on every rank; raises
    RuntimeError on drift (the guard against silent rank divergence).

    ``atol=0`` compares raw bytes through one allgathered SHA-256 digest
    (exact at full precision, NaN equal to the same NaN bits);
    ``atol > 0`` takes one min and one max reduction over the leaves as
    one flat float32 buffer (tolerances below float32's resolution are
    not seen in that mode)."""
    _state.require_initialized()
    if size() == 1:
        return True
    leaves = [t.detach().cpu().contiguous() for t in _leaves(tree)]
    hint = ("Did you forget broadcast_parameters, or is there "
            "non-deterministic data-dependent control flow?")
    if atol == 0.0:
        h = hashlib.sha256()
        for t in leaves:
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        digest = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
        digests = _engine.allgather(digest[None])
        bad = [r for r in range(size()) if not torch.equal(digests[r],
                                                           digests[0])]
        if bad:
            raise RuntimeError(
                f"{name} diverged across ranks (bytewise digest mismatch "
                f"vs rank 0 on ranks {bad}). {hint}")
        return True
    flat = (torch.cat([t.float().reshape(-1) for t in leaves]) if leaves
            else torch.zeros(0))
    spread = _engine.reduce(flat, MAX) - _engine.reduce(flat, MIN)
    if not bool(torch.isfinite(spread).all()):
        raise RuntimeError(
            f"{name} contains non-finite divergence across ranks "
            "(NaN/Inf on some rank but not others, or Inf-Inf). " + hint)
    drift = float(spread.max()) if flat.numel() else 0.0
    if drift > atol:
        offset, worst = 0, (0, 0.0)
        for i, t in enumerate(leaves):
            n = t.numel()
            d = float(spread[offset:offset + n].max()) if n else 0.0
            if d > worst[1]:
                worst = (i, d)
            offset += n
        raise RuntimeError(
            f"{name} diverged across ranks: max spread {drift:g} "
            f"(> {atol:g}) at leaf #{worst[0]}. {hint}")
    return True


def alltoall(tensor, splits=None, name=None):
    """All-to-all along axis 0: ``splits[j]`` rows go to rank j (equal
    splits when None); returns the rows every rank sent here, in rank
    order."""
    del name
    _state.require_initialized()
    n = size()
    x, back = _to_torch(tensor)
    if splits is None:
        if x.shape[0] % n:
            raise ValueError(
                f"alltoall requires dim0 ({x.shape[0]}) divisible by size "
                f"({n}) when splits is None")
        splits = [x.shape[0] // n] * n
    splits = [int(s) for s in np.asarray(
        splits.cpu() if isinstance(splits, torch.Tensor) else splits
    ).tolist()]
    if len(splits) != n or sum(splits) != x.shape[0]:
        raise ValueError(
            f"alltoall splits {splits} must have one entry per rank ({n}) "
            f"and sum to the tensor's dim0 ({x.shape[0]})")
    return back(_engine.alltoall(x, splits))


def reducescatter(tensor, op=None, name=None):
    """Reduce-scatter along axis 0 (equal chunks): each rank receives
    its own reduced chunk. The default op is the average."""
    del name
    _state.require_initialized()
    x, back = _to_torch(tensor)
    return back(_engine.scatter_reduce(
        x, _resolve_op(None, op) if op else AVERAGE))


# -- capability probes (Horovod's API), answered from torch ---------------

def mpi_threads_supported():
    return False


def mpi_built():
    return False


def mpi_enabled():
    return False


def nccl_built():
    return dist.is_nccl_available()


def gloo_built():
    return dist.is_gloo_available()


def cuda_built():
    return torch.backends.cuda.is_built()


def rocm_built():
    return torch.version.hip is not None


class Compression:
    """Gradient compression (horovod.Compression): ``fp16`` halves the
    wire bytes of a float wider than 16 bits; ``none`` leaves it."""

    class none:  # noqa: N801 - Horovod spells these lowercase
        @staticmethod
        def compress(tensor):
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            del ctx
            return tensor

    class fp16:  # noqa: N801
        # a tensor keeps its type; anything else travels as numpy, as
        # in the JAX package (a tf tensor would be cast back up)
        @staticmethod
        def compress(tensor):
            x, back = _to_torch(tensor)
            if x.is_floating_point() and x.element_size() > 2:
                half = x.half()
                return (back(half) if isinstance(tensor, torch.Tensor)
                        else half.numpy()), x.dtype
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            if ctx is None:
                return tensor
            x, back = _to_torch(tensor)
            out = x.to(ctx)
            return back(out) if isinstance(tensor, torch.Tensor) else \
                out.numpy()


from sparkdl_tpu_torch.hvd.optim import (  # noqa: E402  (needs the above)
    DistributedOptimizer,
    allreduce_,
    broadcast_,
    broadcast_optimizer_state,
    broadcast_parameters,
)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "allreduce",
    "allreduce_async", "grouped_allreduce", "allgather",
    "allgather_object", "broadcast", "broadcast_object", "barrier",
    "check_synchronized", "alltoall", "reducescatter", "Average", "Sum",
    "Min", "Max", "Compression", "AsyncCollective", "mpi_threads_supported",
    "mpi_built", "mpi_enabled", "nccl_built", "gloo_built", "cuda_built",
    "rocm_built", "allreduce_", "broadcast_", "broadcast_parameters",
    "broadcast_optimizer_state", "DistributedOptimizer",
]
