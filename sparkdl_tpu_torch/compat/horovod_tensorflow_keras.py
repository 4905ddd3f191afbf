"""``horovod.tensorflow.keras`` inside a gang of the port:
``DistributedOptimizer`` and the callbacks for tf.keras (Keras 3 on
its tensorflow backend), the gradients allreduced by the port.

Counterpart of ``horovod/tensorflow/keras/__init__.py``, with its
``__all__``. It is the module the reference README's tf.keras main
imports (``import horovod.tensorflow.keras as hvd``);
:mod:`~sparkdl_tpu_torch.compat.horovod_torch` binds it, and
``horovod.tensorflow.keras.callbacks`` to
:mod:`~sparkdl_tpu_torch.compat.horovod_tensorflow_keras_callbacks`.
"""

from sparkdl_tpu_torch.compat import (  # noqa: F401
    horovod_tensorflow_keras_callbacks as callbacks,
)
from sparkdl_tpu_torch.compat.horovod_tensorflow import (  # noqa: F401
    Average,
    Compression,
    Max,
    Min,
    Sum,
    allgather,
    allreduce,
    barrier,
    broadcast,
    broadcast_object,
    broadcast_variables,
    grouped_allreduce,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from sparkdl_tpu_torch.hvd import _resolve_op


def DistributedOptimizer(optimizer, name=None, compression=None,
                         op=None, average=None, **kwargs):
    """Wrap a keras optimizer so that ``apply_gradients`` (which the
    tensorflow trainer's ``train_step`` calls) allreduces the gradients
    over the gang first, all of them in one grouped crossing. The
    default op is the average, so the effective batch is np x the
    per-worker batch."""
    del name, compression, kwargs
    kind = _resolve_op(average, op)
    cls = optimizer.__class__

    class _DistributedOptimizer(cls):
        _hvd_op = kind

        def apply_gradients(self, grads_and_vars, **kw):
            gv = list(grads_and_vars)
            live = [(i, g) for i, (g, _) in enumerate(gv) if g is not None]
            if live:
                reduced = grouped_allreduce([g for _, g in live],
                                            op=self._hvd_op)
                for (i, _), r in zip(live, reduced):
                    gv[i] = (r, gv[i][1])
            return super().apply_gradients(gv, **kw)

    _DistributedOptimizer.__name__ = "Distributed" + cls.__name__
    optimizer.__class__ = _DistributedOptimizer
    return optimizer


__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "allreduce", "allgather", "broadcast",
    "broadcast_object", "broadcast_variables", "barrier",
    "DistributedOptimizer", "callbacks", "Average", "Sum", "Min", "Max",
    "Compression",
]
