"""The tf.keras integration of HorovodRunner jobs (``keras``: the
``LogCallback``), and that callback's hooks, which need no framework.

Counterpart of ``sparkdl_tpu/horovod/tensorflow/__init__.py`` (an empty
namespace there). :class:`LogHooks` holds the ``LogCallback``'s lines
and telemetry: :class:`~sparkdl_tpu_torch.horovod.tensorflow.keras.LogCallback`
puts them on tf.keras's ``Callback``, and
:func:`sparkdl_tpu_torch.compat.horovod_keras.LogCallback` on Keras 3's,
for any backend, so that a torch-backend main never imports tensorflow
through it.
"""

import time

from sparkdl_tpu_torch import observe
from sparkdl_tpu_torch.horovod import log_to_driver


def _fmt_logs(logs):
    if not logs:
        return ""
    return " - ".join(
        f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
        for k, v in logs.items())


def _numeric_logs(logs):
    out = {}
    for k, v in (logs or {}).items():
        try:
            out[str(k)] = float(v)
        except (TypeError, ValueError):
            continue  # a non-scalar entry stays in the line only
    return out


def _emit(scope, logs):
    """Each numeric log value as a ``keras_<metric>`` gauge labelled by
    the hook that produced it, beside the log line (a no-op with the
    telemetry off). A metric's name comes from user code and may collide
    with a series of another kind: that costs the one series, and never
    the training."""
    if not observe.enabled():
        return
    for k, v in _numeric_logs(logs).items():
        try:
            observe.set_gauge(f"keras_{k}", v, scope=scope)
            observe.inc("keras_metric_updates_total", scope=scope)
        except Exception:
            continue


class LogHooks:
    """The LogCallback's hooks, mixed into a keras ``Callback`` class:
    epoch lines (and batch lines with ``per_batch_log``) through
    :func:`~sparkdl_tpu_torch.horovod.log_to_driver`, the only log path
    that reaches the driver under the default
    ``driver_log_verbosity="log_callback_only"``; and, with the
    telemetry on, the ``keras_*`` series and the ``keras.epoch_begin`` /
    ``keras.epoch_end`` instants."""

    per_batch_log = False
    _epoch = None
    _epoch_start = None

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._epoch_start = time.time()
        log_to_driver(
            f"Epoch {epoch} begin at {time.strftime('%Y-%m-%d %H:%M:%S')}")
        observe.instant("keras.epoch_begin", cat="keras", epoch=epoch)

    def on_batch_end(self, batch, logs=None):
        if self.per_batch_log:
            log_to_driver(f"Epoch {self._epoch} batch {batch}: "
                          f"{_fmt_logs(logs)}")
        # the gauges overwrite in place, so they flow at every batch
        _emit("batch", logs)

    def on_epoch_end(self, epoch, logs=None):
        dt = time.time() - (self._epoch_start or time.time())
        log_to_driver(f"Epoch {epoch} end ({dt:.1f}s): {_fmt_logs(logs)}")
        _emit("epoch", logs)
        if observe.enabled():
            try:
                observe.observe_value("keras_epoch_seconds", dt)
                # user metrics ride nested under "metrics", so a metric
                # named "epoch" or "seconds" cannot collide
                observe.instant("keras.epoch_end", cat="keras",
                                epoch=epoch, seconds=round(dt, 3),
                                metrics=_numeric_logs(logs))
            except Exception:
                pass
