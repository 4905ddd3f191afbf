"""``horovod.keras`` inside a gang of the port: Keras 3, aware of its
backend, torch first.

Counterpart of ``horovod/keras/__init__.py``, with its ``__all__``.
:mod:`~sparkdl_tpu_torch.compat.horovod_torch` binds it, and
``horovod.keras.callbacks`` to
:mod:`~sparkdl_tpu_torch.compat.horovod_keras_callbacks`. It imports no
tensorflow of its own: on the torch backend a main stays tf-free as far
as Keras itself allows.

How the gradients cross the gang, by ``keras.backend.backend()``:

- ``torch``: the trainer hands the optimizer's ``apply`` concrete
  tensors on the model's device; they go straight to
  :func:`sparkdl_tpu_torch.hvd.grouped_allreduce`, one flat buffer per
  (dtype, device), so on a gang of one card a rank NCCL keeps them on
  the card (the JAX shim's device-resident tier);
- ``tensorflow``: through
  :func:`sparkdl_tpu_torch.compat.horovod_tensorflow.grouped_allreduce`,
  one ``py_function`` a step (the JAX shim's numpy tier);
- ``jax``: refused (NotImplementedError). So are
  :func:`init_distribution` and an active ``keras.distribution``: that
  API is GSPMD on the jax backend, and the port has no counterpart.
"""

import numpy as np

from sparkdl_tpu_torch import hvd
from sparkdl_tpu_torch.hvd import (  # noqa: F401  (re-exported names)
    Average,
    Compression,
    Max,
    Min,
    Sum,
    _resolve_op,
    allgather,
    allgather_object,
    allreduce,
    barrier,
    broadcast,
    broadcast_object,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from sparkdl_tpu_torch.horovod.tensorflow import LogHooks
from sparkdl_tpu_torch.utils.interop import is_torch_tensor, to_numpy


def _keras():
    import keras

    return keras


def _refuse_jax(what):
    raise NotImplementedError(
        f"{what} on Keras's jax backend: the port's horovod.keras runs on "
        "the torch backend (KERAS_BACKEND=torch) or tensorflow's")


def _check_no_distribution():
    keras = _keras()
    dist = getattr(keras, "distribution", None)
    if dist is not None and dist.distribution() is not None:
        raise NotImplementedError(
            "a keras.distribution is active: that API is GSPMD on Keras's "
            "jax backend and has no counterpart in the port; unset it and "
            "let DistributedOptimizer allreduce the gradients")


def _allreduce_grads(grads, kind):
    live = [(i, g) for i, g in enumerate(grads) if g is not None]
    if not live or hvd.size() == 1:
        return grads
    _check_no_distribution()
    backend = _keras().backend.backend()
    vals = [g for _, g in live]
    if backend == "torch":
        reduced = hvd.grouped_allreduce(vals, op=kind)
    elif backend == "tensorflow":
        from sparkdl_tpu_torch.compat.horovod_tensorflow import (
            grouped_allreduce as tf_grouped,
        )

        reduced = tf_grouped(vals, op=kind)
    else:
        _refuse_jax("DistributedOptimizer")
    out = list(grads)
    for (i, _), r in zip(live, reduced):
        out[i] = r
    return out


def DistributedOptimizer(optimizer, name=None, compression=None,
                         op=None, average=None, **kwargs):
    """Wrap a Keras 3 optimizer so that the gradients are allreduced over
    the gang before they are applied (the average by default, so the
    effective batch is np x the per-worker batch).

    Hooks ``apply``, which the torch trainer calls directly and
    ``apply_gradients`` calls on the tensorflow backend. The wrapper is
    a dynamic subclass: a saved model records its name, so load with
    the base optimizer and wrap again."""
    del name, kwargs
    if _keras().backend.backend() == "jax":
        _refuse_jax("horovod.keras.DistributedOptimizer")
    _check_no_distribution()
    if compression is not None and compression is not Compression.none:
        import logging

        logging.getLogger("sparkdl.horovod").warning(
            "horovod.keras.DistributedOptimizer: gradient compression "
            "is not applied on the keras-3 path (gradients cross the "
            "gang at their native dtype); ignoring compression=%r.",
            compression)
    kind = _resolve_op(average, op)
    cls = optimizer.__class__

    class _DistributedOptimizer(cls):
        _hvd_op = kind

        def apply(self, grads, trainable_variables=None):
            grads = _allreduce_grads(list(grads), self._hvd_op)
            return super().apply(grads, trainable_variables)

    _DistributedOptimizer.__name__ = "Distributed" + cls.__name__
    optimizer.__class__ = _DistributedOptimizer
    return optimizer


def _host_value(v):
    """A variable's value on the host: a raw torch tensor (a card's
    included) is copied off its device; a Keras variable through its
    ``__array__``, which copies a card's value off it."""
    return to_numpy(v.value if is_torch_tensor(getattr(v, "value", None))
                    else v)


def _assign(v, val):
    """Assign ``val`` to ``v`` on the variable's own device."""
    cur = getattr(v, "value", None)
    if is_torch_tensor(cur):
        import torch

        val = torch.as_tensor(val, dtype=cur.dtype, device=cur.device)
    v.assign(val)


def broadcast_variables(variables, root_rank=0):
    """Give every variable its ``root_rank`` value: root's values, read
    on the host, travel in one ``broadcast_object``; each rank assigns
    them on its variables' devices."""
    variables = list(variables)
    if hvd.size() == 1 or not variables:
        return
    values = ([_host_value(v) for v in variables]
              if hvd.rank() == root_rank else None)
    values = hvd.broadcast_object(values, root_rank)
    for v, val in zip(variables, values):
        _assign(v, np.asarray(val))


def broadcast_model_variables(model, root_rank=0):
    """Synchronize every model variable (and a built optimizer's) to
    ``root_rank``'s values, in one ``broadcast_object``."""
    variables = list(model.variables)
    opt = getattr(model, "optimizer", None)
    if opt is not None and getattr(opt, "built", False):
        variables += list(opt.variables)
    broadcast_variables(variables, root_rank)


class LogCallback:
    """Keras-3 ``LogCallback``: the lines (and series) of
    :class:`sparkdl_tpu_torch.horovod.tensorflow.keras.LogCallback` on
    Keras 3's ``Callback``, without importing tensorflow."""

    def __new__(cls, per_batch_log=False):
        keras = _keras()

        class _Callback(LogHooks, keras.callbacks.Callback):
            def __init__(self, per_batch):
                super().__init__()
                self.per_batch_log = per_batch

        _Callback.__name__ = "LogCallback"
        return _Callback(per_batch_log)


def init_distribution():
    """Refused: Keras 3's SPMD data parallelism (``keras.distribution``)
    is GSPMD on the jax backend, with no counterpart in the port. A gang
    of the port is data-parallel through :func:`DistributedOptimizer`."""
    raise NotImplementedError(
        "horovod.keras.init_distribution: keras.distribution is GSPMD on "
        "Keras's jax backend and has no counterpart in the port; wrap the "
        "optimizer in hvd.DistributedOptimizer instead")


# last: the callbacks read names defined above
from sparkdl_tpu_torch.compat import (  # noqa: E402,F401
    horovod_keras_callbacks as callbacks,
)
from sparkdl_tpu_torch.compat.horovod_keras_callbacks import (  # noqa: E402,F401,E501
    BroadcastGlobalVariablesCallback,
)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "allreduce", "allgather", "broadcast",
    "allgather_object", "broadcast_object", "barrier", "DistributedOptimizer",
    "broadcast_variables", "broadcast_model_variables",
    "BroadcastGlobalVariablesCallback", "LogCallback",
    "init_distribution", "callbacks", "Average", "Sum", "Min", "Max",
    "Compression",
]
