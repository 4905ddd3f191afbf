"""Unmodified TensorFlow and Keras mains on real gangs of the port: two
module-scoped gangs of two worker processes on gloo (the tests run
without a card), each bounded by the launcher's start and job timeouts
(set below) so that none can hang the run.

(a) A tf.keras main as the reference README writes it (``import
    horovod.tensorflow.keras as hvd``, ``from
    sparkdl.horovod.tensorflow.keras import LogCallback``), each rank
    from its own initial weights and its own data, with
    ``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback`` and
    the ``LogCallback``: the ranks end bit-synchronized, on the weights of
    an in-process replica that takes SGD steps on the two ranks'
    averaged gradients from rank 0's weights, and the epoch lines reach
    the driver.
(b) Keras 3 on its torch backend (``KERAS_BACKEND=torch`` set in the
    rank before keras is imported, as
    ``tests/horovod/test_keras3_jax.py`` does for jax): the JAX test's
    concrete-gradient case (rank r contributes r + 1, SGD(lr=1) gives
    -1.5 everywhere), and a ``model.fit`` held against a plain-torch
    replica of the averaged-gradient SGD.

cloudpickle sends this module's functions by value, so a worker imports
the port, tensorflow or keras, never this module or JAX.
"""

import contextlib
import io
import sys

import cloudpickle
import numpy as np
import pytest
import torch

from sparkdl_tpu_torch import HorovodRunner
from sparkdl_tpu_torch.horovod import launcher

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

pytestmark = pytest.mark.gang


class _Tee(io.StringIO):
    """Keeps what the driver prints and passes it on."""

    def __init__(self, out):
        super().__init__()
        self._out = out

    def write(self, s):
        self._out.write(s)
        return super().write(s)


@contextlib.contextmanager
def _bounded_gang(tmp_path_factory):
    """Each gang must start within 120 s and end within 300 s (each rank
    imports tensorflow, ~17 s alone on an idle 8-core box); a failed
    worker's peers are killed 2 s after it. The driver's stdout is kept."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launcher, "START_TIMEOUT_S", 120.0)
        mp.setattr(launcher, "JOB_TIMEOUT_S", 300.0)
        mp.setattr(launcher, "ABORT_GRACE_S", 2.0)
        mp.setattr(launcher, "WORKER_DEVICE", "cpu")
        mp.setattr(launcher, "SLOT_DIR",
                   str(tmp_path_factory.mktemp("slots")))
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            yield tee


ROWS, BATCH, EPOCHS = 64, 32, 2


def _tf_init(rank):
    rng = np.random.default_rng(10 + rank)
    return [rng.standard_normal((8, 4)).astype(np.float32) * 0.4,
            rng.standard_normal(4).astype(np.float32) * 0.1,
            rng.standard_normal((4, 1)).astype(np.float32) * 0.4,
            rng.standard_normal(1).astype(np.float32) * 0.1]


def _tf_data(rank):
    rng = np.random.RandomState(rank)
    return (rng.randn(ROWS, 8).astype("float32"),
            rng.randn(ROWS, 1).astype("float32"))


def _tf_keras_main():
    """tests/horovod/test_frameworks.py::_keras_main, each rank from its
    own weights, unshuffled so that the replica can follow it."""
    import numpy as np
    import tensorflow as tf

    import horovod.tensorflow.keras as hvd
    from sparkdl.horovod.tensorflow.keras import LogCallback

    hvd.init()
    model = tf.keras.Sequential([
        tf.keras.Input(shape=(8,)),
        tf.keras.layers.Dense(4, activation="relu"),
        tf.keras.layers.Dense(1),
    ])
    model.set_weights(_tf_init(hvd.rank()))
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.01))
    model.compile(optimizer=opt, loss="mse")
    x, y = _tf_data(hvd.rank())
    hist = model.fit(
        x, y, batch_size=BATCH, epochs=EPOCHS, verbose=0, shuffle=False,
        callbacks=[
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback(),
            LogCallback(),
        ],
    )
    flat = np.concatenate([w.ravel() for w in model.get_weights()])
    gathered = hvd.allgather(flat[None, :])
    return {
        "size": hvd.size(),
        "module": hvd.__name__,
        "losses": [float(v) for v in hist.history["loss"]],
        "weights": model.get_weights(),
        "sync_diff": float(np.abs(gathered[0] - gathered[1]).max()),
        # tensorflow and keras may import jax themselves; the JAX
        # package is never imported
        "jax_package": any(k.split(".")[0] == "sparkdl_tpu"
                           for k in sys.modules),
    }


@pytest.fixture(scope="module")
def tf_gang(tmp_path_factory):
    with _bounded_gang(tmp_path_factory) as out:
        result = HorovodRunner(np=-2).run(_tf_keras_main)
    return result, out.getvalue()


def _tf_replica():
    """Rank 0's initial weights, then SGD(0.01) steps on the mean of the
    two ranks' mse gradients, batch by batch, unshuffled."""
    import tensorflow as tf

    model = tf.keras.Sequential([
        tf.keras.Input(shape=(8,)),
        tf.keras.layers.Dense(4, activation="relu"),
        tf.keras.layers.Dense(1),
    ])
    model.set_weights(_tf_init(0))
    data = [_tf_data(r) for r in (0, 1)]
    for _ in range(EPOCHS):
        for lo in range(0, ROWS, BATCH):
            grads = []
            for x, y in data:
                with tf.GradientTape() as tape:
                    pred = model(x[lo:lo + BATCH])
                    loss = tf.reduce_mean(tf.square(pred - y[lo:lo + BATCH]))
                grads.append(tape.gradient(loss, model.trainable_weights))
            for w, g0, g1 in zip(model.trainable_weights, *grads):
                w.assign(w - 0.01 * ((g0 + g1) / 2))
    return model.get_weights()


def test_tf_keras_main_binds_the_port_and_stays_synchronized(tf_gang):
    result, _ = tf_gang
    assert result["size"] == 2
    assert result["module"] == \
        "sparkdl_tpu_torch.compat.horovod_tensorflow_keras"
    assert not result["jax_package"]
    assert all(np.isfinite(result["losses"]))
    assert result["sync_diff"] < 1e-5


def test_tf_keras_weights_are_the_averaged_gradient_replicas(tf_gang):
    result, _ = tf_gang
    for got, want in zip(result["weights"], _tf_replica()):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_tf_keras_log_callback_lines_reach_the_driver(tf_gang):
    _, out = tf_gang
    assert "Epoch 0 begin" in out and "Epoch 1 end" in out
    assert out.count("Epoch 1 end (") == 2  # one LogCallback a rank


FIT_ROWS, FIT_BATCH, FIT_LR = 64, 16, 0.05


def _fit_data(rank):
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal((FIT_ROWS, 4)).astype(np.float32),
            rng.standard_normal((FIT_ROWS, 1)).astype(np.float32))


def _keras3_torch_main():
    """The JAX concrete-gradient case and an unmodified model.fit, on
    Keras's torch backend."""
    import os

    os.environ["KERAS_BACKEND"] = "torch"
    import numpy as np
    import torch

    import horovod.keras as hvd
    import keras

    hvd.init()
    out = {"backend": keras.backend.backend(), "module": hvd.__name__}

    var = keras.Variable(np.zeros(3, np.float32))
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(learning_rate=1.0))
    opt.build([var])
    # rank r contributes r + 1: the mean 1.5, SGD(lr=1) gives -1.5
    opt.apply([torch.ones(3) * (hvd.rank() + 1)], [var])
    out["var"] = hvd.allgather_object(np.asarray(var).tolist())

    keras.utils.set_random_seed(7 + hvd.rank())  # other weights a rank
    model = keras.Sequential([keras.Input((4,)),
                              keras.layers.Dense(8, activation="relu"),
                              keras.layers.Dense(1)])
    model.compile(optimizer=hvd.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=FIT_LR)), loss="mse")
    out["init"] = [np.asarray(w) for w in model.get_weights()]
    out["device"] = str(model.weights[0].value.device)
    x, y = _fit_data(hvd.rank())
    hist = model.fit(x, y, batch_size=FIT_BATCH, epochs=2, verbose=0,
                     shuffle=False, callbacks=[
                         hvd.BroadcastGlobalVariablesCallback(0),
                         hvd.callbacks.MetricAverageCallback(),
                         hvd.LogCallback()])
    flat = np.concatenate([np.asarray(w).ravel() for w in model.weights])
    gathered = hvd.allgather(flat[None, :])
    out.update(losses=hist.history["loss"],
               weights=[np.asarray(w) for w in model.get_weights()],
               sync_diff=float(np.abs(gathered[0] - gathered[1]).max()),
               jax_package=any(k.split(".")[0] == "sparkdl_tpu"
                               for k in sys.modules))
    return out


@pytest.fixture(scope="module")
def keras3_gang(tmp_path_factory):
    with _bounded_gang(tmp_path_factory) as out:
        result = HorovodRunner(np=-2).run(_keras3_torch_main)
    return result, out.getvalue()


def _torch_replica(init):
    """A plain-torch replica of the gang's fit: rank 0's weights, SGD
    steps on the mean of the two ranks' mse gradients."""
    w1, b1, w2, b2 = (torch.tensor(a, requires_grad=True) for a in init)
    data = [_fit_data(r) for r in (0, 1)]
    for _ in range(2):
        for lo in range(0, FIT_ROWS, FIT_BATCH):
            grads = []
            for x, y in data:
                xb = torch.from_numpy(x[lo:lo + FIT_BATCH])
                yb = torch.from_numpy(y[lo:lo + FIT_BATCH])
                pred = torch.relu(xb @ w1 + b1) @ w2 + b2
                loss = ((pred - yb) ** 2).mean()
                grads.append(torch.autograd.grad(loss, [w1, b1, w2, b2]))
            with torch.no_grad():
                for p, g0, g1 in zip((w1, b1, w2, b2), *grads):
                    p -= FIT_LR * ((g0 + g1) / 2)
    return [p.detach().numpy() for p in (w1, b1, w2, b2)]


def test_keras3_torch_concrete_gradients_are_averaged(keras3_gang):
    result, _ = keras3_gang
    assert result["backend"] == "torch"
    assert result["module"] == "sparkdl_tpu_torch.compat.horovod_keras"
    assert result["var"] == [[-1.5, -1.5, -1.5]] * 2
    assert not result["jax_package"]


def test_keras3_torch_fit_stays_synchronized(keras3_gang):
    result, out = keras3_gang
    assert result["device"] == "cpu"
    assert all(np.isfinite(result["losses"]))
    assert result["sync_diff"] < 1e-5
    assert "Epoch 0 begin" in out and "Epoch 1 end" in out


def test_keras3_torch_fit_matches_the_plain_torch_replica(keras3_gang):
    result, _ = keras3_gang
    for got, want in zip(result["weights"], _torch_replica(result["init"])):
        np.testing.assert_allclose(got, want, atol=1e-5)
