"""Keras ``LogCallback``: streams training progress to the driver.

Counterpart of ``sparkdl_tpu/horovod/tensorflow/keras.py`` (the
reference's ``sparkdl/horovod/tensorflow/keras.py`` stub made real): a
tf.keras ``Callback`` with the hooks of
:class:`sparkdl_tpu_torch.horovod.tensorflow.LogHooks`. In a gang of
the port, ``from sparkdl.horovod.tensorflow.keras import LogCallback``
gives this class (:mod:`sparkdl_tpu_torch.compat.horovod_torch`).
"""

from tensorflow import keras

from sparkdl_tpu_torch.horovod.tensorflow import LogHooks

__all__ = ["LogCallback"]


class LogCallback(LogHooks, keras.callbacks.Callback):
    """
    A simple HorovodRunner log callback that streams event logs to
    notebook cell output.
    """

    def __init__(self, per_batch_log=False):
        """
        :param per_batch_log: whether to output logs per batch, default: False.
        """
        super().__init__()
        self.per_batch_log = per_batch_log
