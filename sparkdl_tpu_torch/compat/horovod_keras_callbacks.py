"""``horovod.keras.callbacks`` inside a gang of the port: Keras 3, any
backend the port serves, no tensorflow of its own.

Counterpart of ``horovod/keras/callbacks.py``:
``BroadcastGlobalVariablesCallback`` (root's model variables at train
start, the lazily built optimizer's after the first batch),
``MetricAverageCallback`` and ``LearningRateWarmupCallback``.
"""

import numpy as np

from sparkdl_tpu_torch import hvd


def _keras():
    import keras

    return keras


class BroadcastGlobalVariablesCallback:
    """Broadcast rank ``root_rank``'s state to the gang: the model
    variables at train start (before the first update), and the
    optimizer's variables, which Keras builds at the first step, once
    after the first batch."""

    def __new__(cls, root_rank=0, device=""):
        del device
        keras = _keras()
        from sparkdl_tpu_torch.compat import horovod_keras

        class _Callback(keras.callbacks.Callback):
            def __init__(self, root):
                super().__init__()
                self.root_rank = root
                self._opt_done = False

            def on_train_begin(self, logs=None):
                horovod_keras.broadcast_model_variables(self.model,
                                                        self.root_rank)

            def on_batch_end(self, batch, logs=None):
                if self._opt_done or hvd.size() == 1:
                    return
                opt = getattr(self.model, "optimizer", None)
                if opt is not None and getattr(opt, "built", False):
                    horovod_keras.broadcast_variables(opt.variables,
                                                      self.root_rank)
                self._opt_done = True

        _Callback.__name__ = "BroadcastGlobalVariablesCallback"
        return _Callback(root_rank)


class MetricAverageCallback:
    """Average the epoch-end metrics over all ranks, so rank 0's
    history describes the whole job."""

    def __new__(cls):
        keras = _keras()

        class _Callback(keras.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                if not logs or hvd.size() == 1:
                    return
                for k in list(logs.keys()):
                    v = logs[k]
                    if isinstance(v, (int, float, np.floating)):
                        logs[k] = float(hvd.allreduce(
                            np.asarray(float(v), np.float64)[None])[0])

        _Callback.__name__ = "MetricAverageCallback"
        return _Callback()


class LearningRateWarmupCallback:
    """Linear learning-rate warmup over the first ``warmup_epochs``
    epochs, from ``initial_lr`` to ``initial_lr * hvd.size()``."""

    def __new__(cls, initial_lr, warmup_epochs=5, momentum_correction=True,
                steps_per_epoch=None, verbose=0):
        del momentum_correction, steps_per_epoch
        keras = _keras()

        class _Callback(keras.callbacks.Callback):
            def __init__(self):
                super().__init__()
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
                    print(f"LearningRateWarmupCallback: epoch {epoch} "
                          f"lr={lr:.6g}")

        _Callback.__name__ = "LearningRateWarmupCallback"
        return _Callback()


__all__ = [
    "BroadcastGlobalVariablesCallback",
    "MetricAverageCallback",
    "LearningRateWarmupCallback",
]
