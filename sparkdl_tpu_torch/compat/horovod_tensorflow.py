"""``horovod.tensorflow`` inside a gang of the port: TF tensors in, the
port's collectives over ``torch.distributed`` under.

Counterpart of ``horovod/tensorflow/__init__.py``, with its ``__all__``.
:mod:`~sparkdl_tpu_torch.compat.horovod_torch` binds this module as
``horovod.tensorflow`` at its first import in a gang. An eager tensor
crosses through numpy; a symbolic one (inside a ``tf.function``, where
``model.fit`` puts the train step) through one ``tf.py_function``, so
the collective runs when the graph does. :func:`grouped_allreduce` makes
one host crossing for its whole list: one ``py_function`` is one
ordering point, so every rank enters the collectives inside it in list
order (separate callbacks could run in another order on each rank and
deadlock the gang).
"""

import tensorflow as tf

from sparkdl_tpu_torch import hvd as _hvd
from sparkdl_tpu_torch.hvd import (  # noqa: F401  (re-exported names)
    Average,
    Compression,
    Max,
    Min,
    Sum,
    allgather,
    allgather_object,
    alltoall,
    barrier,
    broadcast_object,
    cross_rank,
    cross_size,
    cuda_built,
    gloo_built,
    init,
    is_initialized,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    rocm_built,
    shutdown,
    size,
)
from sparkdl_tpu_torch.hvd import _resolve_op, _state


def _eager(tensors):
    return tf.executing_eagerly() and all(
        isinstance(t, tf.__internal__.EagerTensor) for t in tensors)


def _numpy_collective(x_tf, fn):
    """Run ``fn`` (numpy in, numpy out) on a TF tensor, eagerly or from
    inside a tf.function through ``tf.py_function``."""
    if _eager([x_tf]):
        return tf.convert_to_tensor(fn(x_tf.numpy()))

    def _py(t):
        return tf.convert_to_tensor(fn(t.numpy()))

    out = tf.py_function(_py, [x_tf], x_tf.dtype)
    out.set_shape(x_tf.shape)
    return out


def _densify(tensor):
    if isinstance(tensor, tf.IndexedSlices):
        return tf.convert_to_tensor(tensor)
    return tensor


def allreduce(tensor, average=None, name=None, op=None, **kwargs):
    del name, kwargs
    _state.require_initialized()
    tensor = _densify(tf.convert_to_tensor(tensor))
    kind = _resolve_op(average, op)
    return _numpy_collective(tensor, lambda x: _hvd.allreduce(x, op=kind))


def grouped_allreduce(tensors, average=None, name=None, op=None):
    """Allreduce a list of TF tensors in one host crossing: one
    ``py_function`` (or one eager call) hands the list to
    :func:`sparkdl_tpu_torch.hvd.grouped_allreduce`, which fuses it into
    one collective per dtype."""
    del name
    _state.require_initialized()
    kind = _resolve_op(average, op)
    tensors = [_densify(tf.convert_to_tensor(t)) for t in tensors]
    if not tensors:
        return []

    def _np_grouped(*ts):
        outs = _hvd.grouped_allreduce([t.numpy() for t in ts], op=kind)
        return [tf.convert_to_tensor(o) for o in outs]

    if _eager(tensors):
        return _np_grouped(*tensors)
    outs = tf.py_function(_np_grouped, tensors, [t.dtype for t in tensors])
    for o, t in zip(outs, tensors):
        o.set_shape(t.shape)
    return list(outs)


def broadcast(tensor, root_rank, name=None):
    del name
    _state.require_initialized()
    return _numpy_collective(tf.convert_to_tensor(tensor),
                             lambda x: _hvd.broadcast(x, root_rank))


def broadcast_variables(variables, root_rank=0):
    """Assign every variable its root rank's value, in one
    ``broadcast_object`` of root's values (the other ranks read
    nothing)."""
    _state.require_initialized()
    variables = list(variables)
    if size() == 1 or not variables:
        return
    values = [v.numpy() for v in variables] if rank() == root_rank else None
    for var, val in zip(variables, broadcast_object(values, root_rank)):
        var.assign(val)


class DistributedGradientTape:
    """A ``tf.GradientTape`` whose ``gradient()`` returns the gradients
    allreduced over the gang, in the nested structure of ``sources``
    (all of them in one grouped crossing)."""

    def __init__(self, tape, compression=None, op=None, average=None):
        del compression
        self._tape = tape
        self._op = _resolve_op(average, op)

    def __getattr__(self, name):
        return getattr(self._tape, name)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        flat = tf.nest.flatten(grads)
        live = [(i, g) for i, g in enumerate(flat) if g is not None]
        if live:
            reduced = grouped_allreduce([g for _, g in live], op=self._op)
            for (i, _), r in zip(live, reduced):
                flat[i] = r
        return tf.nest.pack_sequence_as(grads, flat)


__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "allreduce",
    "grouped_allreduce", "allgather", "allgather_object", "broadcast",
    "broadcast_object",
    "broadcast_variables", "barrier", "alltoall", "Average", "Sum",
    "Min", "Max", "Compression", "DistributedGradientTape",
]
