"""``horovod.tensorflow.keras.callbacks`` inside a gang of the port.

Counterpart of ``horovod/tensorflow/keras/callbacks.py``:
``BroadcastGlobalVariablesCallback`` (every rank starts from root's
parameters), ``MetricAverageCallback`` (epoch metrics averaged over the
gang, so rank 0's logs describe the whole job) and
``LearningRateWarmupCallback`` (the linear-scaling warmup).
"""

import numpy as np
from tensorflow import keras

from sparkdl_tpu_torch.compat import horovod_tensorflow as hvd


class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
    """Broadcast the model's and the optimizer's variables from
    ``root_rank`` at train start, so every rank begins from the same
    parameters."""

    def __init__(self, root_rank=0, device=""):
        del device
        super().__init__()
        self.root_rank = root_rank
        self._done = False

    def on_train_begin(self, logs=None):
        if self._done or hvd.size() == 1:
            return
        hvd.broadcast_variables(self.model.weights, root_rank=self.root_rank)
        opt = getattr(self.model, "optimizer", None)
        if opt is not None and getattr(opt, "variables", None):
            hvd.broadcast_variables(opt.variables, root_rank=self.root_rank)
        self._done = True


class MetricAverageCallback(keras.callbacks.Callback):
    """Average the epoch-end metrics over all ranks."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs or hvd.size() == 1:
            return
        for k in list(logs.keys()):
            v = logs[k]
            if isinstance(v, (int, float, np.floating)):
                logs[k] = float(
                    hvd.allreduce(np.asarray(float(v), np.float64)[None])[0])


class LearningRateWarmupCallback(keras.callbacks.Callback):
    """Linear learning-rate warmup over the first ``warmup_epochs``
    epochs, from ``initial_lr`` to ``initial_lr * hvd.size()``."""

    def __init__(self, initial_lr, warmup_epochs=5, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        super().__init__()
        del momentum_correction, steps_per_epoch
        self.initial_lr = initial_lr
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

    def _set_lr(self, lr):
        opt = self.model.optimizer
        try:
            opt.learning_rate.assign(lr)
        except AttributeError:
            opt.learning_rate = lr

    def on_epoch_begin(self, epoch, logs=None):
        if epoch >= self.warmup_epochs or hvd.size() == 1:
            return
        progress = (epoch + 1) / self.warmup_epochs
        lr = self.initial_lr * (1.0 + progress * (hvd.size() - 1.0))
        self._set_lr(lr)
        if self.verbose:
            print(f"LearningRateWarmupCallback: epoch {epoch} lr={lr:.6g}")


__all__ = [
    "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback",
    "LearningRateWarmupCallback",
]
