"""The port's TensorFlow and Keras shims against the JAX package's, in
one process, in both packages' local mode: ``horovod.tensorflow``,
``horovod.tensorflow.keras`` (and ``.callbacks``), ``horovod.keras``
(and ``.callbacks``) on Keras's tensorflow backend (the backend is fixed
per process; the torch backend runs in the gang ranks of
``test_torch_frameworks_gang.py``), and the ``LogCallback`` of
``sparkdl.horovod.tensorflow.keras``.

The port's shims are reached as a main of a port gang reaches them:
through the names that ``compat.horovod_torch.bound()`` binds."""

import ast
import contextlib
import importlib
import pathlib
import sys

import numpy as np
import pytest
import tensorflow as tf
import torch

from sparkdl_tpu import HorovodRunner as JaxRunner
from sparkdl_tpu import observe as jax_observe
from sparkdl_tpu.hvd import _state as jax_state
from sparkdl_tpu_torch import HorovodRunner as PortRunner
from sparkdl_tpu_torch import observe as pt_observe
from sparkdl_tpu_torch.compat import horovod_torch
from sparkdl_tpu_torch.hvd import _state as pt_state

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]

# the shims by the name a main imports, and the files of both packages
SHIMS = {
    "horovod.tensorflow": ("horovod/tensorflow/__init__.py",
                           "sparkdl_tpu_torch/compat/horovod_tensorflow.py"),
    "horovod.tensorflow.keras": (
        "horovod/tensorflow/keras/__init__.py",
        "sparkdl_tpu_torch/compat/horovod_tensorflow_keras.py"),
    "horovod.tensorflow.keras.callbacks": (
        "horovod/tensorflow/keras/callbacks.py",
        "sparkdl_tpu_torch/compat/horovod_tensorflow_keras_callbacks.py"),
    "horovod.keras": ("horovod/keras/__init__.py",
                      "sparkdl_tpu_torch/compat/horovod_keras.py"),
    "horovod.keras.callbacks": (
        "horovod/keras/callbacks.py",
        "sparkdl_tpu_torch/compat/horovod_keras_callbacks.py"),
    "sparkdl.horovod.tensorflow.keras": (
        "sparkdl_tpu/horovod/tensorflow/keras.py",
        "sparkdl_tpu_torch/horovod/tensorflow/keras.py"),
}


def _all(path):
    for node in ast.parse((REPO / path).read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_every_shim_binds_the_jax_modules_names(name):
    jax_file, port_file = SHIMS[name]
    assert _all(port_file) == _all(jax_file)
    with horovod_torch.bound():
        mod = importlib.import_module(name)
        assert mod.__name__ == port_file[:-3].replace("/", ".")
        for attr in _all(port_file):
            assert hasattr(mod, attr), (name, attr)


@contextlib.contextmanager
def _local(pkg):
    """Local mode of one package, its shims importable by their
    ``horovod`` names."""
    if pkg == "jax":
        with jax_state.local_mode():
            yield
    else:
        with pt_state.local_mode(), horovod_torch.bound():
            yield


@pytest.fixture(params=["jax", "torch"])
def local(request):
    with _local(request.param):
        yield request.param


def _shim(name):
    return importlib.import_module(name)


def test_tf_local_identities(local):
    """tests/horovod/test_frameworks.py::test_tf_local_identities."""
    hvd = _shim("horovod.tensorflow")
    hvd.init()
    t = tf.constant([[1.0, 2.0], [3.0, 4.0]])
    out = hvd.allreduce(t)
    assert isinstance(out, tf.Tensor)
    np.testing.assert_allclose(out.numpy(), t.numpy())
    v = tf.Variable([1.0, 2.0])
    hvd.broadcast_variables([v], root_rank=0)
    with tf.GradientTape() as tape:
        tape = hvd.DistributedGradientTape(tape)
        loss = tf.reduce_sum(v * v)
    (g,) = tape.gradient(loss, [v])
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])


def test_keras_warmup_and_metric_callbacks_local(local):
    """tests/horovod/test_frameworks.py::
    test_keras_warmup_and_metric_callbacks_local."""
    hvd = _shim("horovod.tensorflow.keras")
    hvd.init()
    model = tf.keras.Sequential(
        [tf.keras.Input((4,)), tf.keras.layers.Dense(1)])
    model.compile(optimizer=tf.keras.optimizers.SGD(0.1), loss="mse")
    x = np.random.default_rng(0).standard_normal((16, 4)).astype("float32")
    y = x.sum(1, keepdims=True).astype("float32")
    hist = model.fit(x, y, epochs=2, verbose=0, callbacks=[
        hvd.callbacks.LearningRateWarmupCallback(initial_lr=0.1,
                                                 warmup_epochs=2),
        hvd.callbacks.MetricAverageCallback()])
    # size 1: the warmup and the averaging are no-ops
    assert len(hist.history["loss"]) == 2


def _tape_grads(pkg):
    """DistributedGradientTape over {"a": v, "b": [w, unused]}."""
    with _local(pkg):
        hvd = _shim("horovod.tensorflow")
        hvd.init()
        v = tf.Variable([1.0, -2.0])
        w = tf.Variable([[0.5], [3.0]])
        unused = tf.Variable([9.0])
        with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = tf.reduce_sum(v * v) + tf.reduce_sum(
                tf.matmul(v[None], w))
        return tape.gradient(loss, {"a": v, "b": [w, unused]})


def test_distributed_gradient_tape_keeps_the_structure():
    jx, pt = _tape_grads("jax"), _tape_grads("torch")
    assert set(pt) == {"a", "b"} and len(pt["b"]) == 2
    assert pt["b"][1] is None and jx["b"][1] is None
    for a, b in ((jx["a"], pt["a"]), (jx["b"][0], pt["b"][0])):
        assert isinstance(b, tf.Tensor) and b.dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    np.testing.assert_allclose(pt["a"].numpy(), [2.5, -1.0])


def _warmup_lrs(pkg, shim, monkeypatch):
    """The learning rate at each epoch's start under the shim's
    LearningRateWarmupCallback, at a patched gang size of 2."""
    with _local(pkg):
        cbs = _shim(shim + ".callbacks")
        # each callbacks module reads the size from its own hvd
        monkeypatch.setattr(cbs.hvd, "size", lambda: 2)
        seen = []

        class Record(tf.keras.callbacks.Callback):
            def on_epoch_begin(self, epoch, logs=None):
                seen.append(float(self.model.optimizer.learning_rate))

        model = tf.keras.Sequential(
            [tf.keras.Input((2,)), tf.keras.layers.Dense(1)])
        model.compile(optimizer=tf.keras.optimizers.SGD(0.1), loss="mse")
        x = np.ones((4, 2), np.float32)
        model.fit(x, x[:, :1], epochs=5, verbose=0, callbacks=[
            cbs.LearningRateWarmupCallback(initial_lr=0.1, warmup_epochs=3),
            Record()])
        monkeypatch.undo()
        return seen


@pytest.mark.parametrize("shim", ["horovod.tensorflow.keras",
                                  "horovod.keras"])
def test_learning_rate_warmup_matches_jax_at_size_two(shim, monkeypatch):
    jx = _warmup_lrs("jax", shim, monkeypatch)
    pt = _warmup_lrs("torch", shim, monkeypatch)
    np.testing.assert_allclose(pt, jx, atol=1e-7)
    # 0.1 * (1 + (e + 1) / 3) over the three warmup epochs, then kept
    np.testing.assert_allclose(pt, [0.1 * (1 + 1 / 3), 0.1 * (1 + 2 / 3),
                                    0.2, 0.2, 0.2], atol=1e-7)


class _Clock:
    """time.time advancing 2.5 s a call, and a fixed strftime."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 2.5
        return self.t

    def strftime(self, fmt):
        return "2026-01-02 03:04:05"


def _log_run(pkg, monkeypatch, tmp_path, per_batch_log):
    """Fit a small model with the package's LogCallback, telemetry on,
    the clock patched; returns its lines, series and instants."""
    lines = []
    if pkg == "jax":
        from sparkdl_tpu.horovod.tensorflow import keras as mod

        monkeypatch.setenv(jax_observe.TELEMETRY_DIR_ENV, str(tmp_path))
        observe, where = jax_observe, mod
    else:
        from sparkdl_tpu_torch.horovod import tensorflow as where
        from sparkdl_tpu_torch.horovod.tensorflow import keras as mod

        monkeypatch.setattr(pt_observe, "TELEMETRY_DIR", str(tmp_path))
        observe = pt_observe
    monkeypatch.setattr(where, "time", _Clock())
    monkeypatch.setattr(where, "log_to_driver", lines.append)
    observe._reset_for_tests()
    try:
        model = tf.keras.Sequential(
            [tf.keras.Input((3,)), tf.keras.layers.Dense(1)])
        model.set_weights([np.full((3, 1), 0.5, np.float32),
                           np.zeros(1, np.float32)])
        model.compile(optimizer=tf.keras.optimizers.SGD(0.05), loss="mse",
                      metrics=["mae"])
        x = np.linspace(-1, 1, 24, dtype=np.float32).reshape(8, 3)
        model.fit(x, x.sum(1, keepdims=True), batch_size=4, epochs=2,
                  shuffle=False, verbose=0,
                  callbacks=[mod.LogCallback(per_batch_log=per_batch_log)])
        snap = observe.metrics().snapshot()
        events = [(e["name"], e["args"]) for e in observe.timeline().drain()
                  if e["name"].startswith("keras.")]
    finally:
        observe._reset_for_tests()
    series = {k: [(s["name"], s["labels"], s.get("value", s.get("count")))
                  for s in snap[k] if s["name"].startswith("keras_")]
              for k in ("counters", "gauges", "histograms")}
    return lines, series, events


@pytest.mark.parametrize("per_batch_log", [False, True])
def test_log_callback_lines_and_series_match_jax(per_batch_log, monkeypatch,
                                                 tmp_path):
    jx = _log_run("jax", monkeypatch, tmp_path / "jax", per_batch_log)
    monkeypatch.undo()
    pt = _log_run("torch", monkeypatch, tmp_path / "pt", per_batch_log)
    assert pt[0] == jx[0]
    assert pt[0][0] == "Epoch 0 begin at 2026-01-02 03:04:05"
    assert pt[0][-1].startswith("Epoch 1 end (2.5s): loss: ")
    assert len(pt[0]) == (8 if per_batch_log else 4)
    assert pt[1] == jx[1]
    assert {n for n, _, _ in pt[1]["gauges"]} == {"keras_loss", "keras_mae"}
    assert pt[1]["histograms"] == [("keras_epoch_seconds", {}, 2)]
    assert pt[2] == jx[2]
    assert [n for n, _ in pt[2]] == ["keras.epoch_begin", "keras.epoch_end"] * 2


def test_log_callback_signature_is_the_jax_one():
    """tests/test_api_lock.py's lock on the JAX LogCallback, held by the
    port's two LogCallbacks."""
    from inspect import getfullargspec

    from sparkdl_tpu.horovod.tensorflow.keras import LogCallback as jax_cb
    from sparkdl_tpu_torch.compat.horovod_keras import LogCallback as k3_cb
    from sparkdl_tpu_torch.horovod.tensorflow.keras import LogCallback

    want = getfullargspec(jax_cb.__init__)
    assert getfullargspec(LogCallback.__init__) == want
    assert want.args == ["self", "per_batch_log"]
    spec = getfullargspec(k3_cb.__new__)
    assert spec.args[1:] == ["per_batch_log"] and spec.defaults == (False,)


def _keras_main(weights, epochs=2):
    """tests/horovod/test_frameworks.py::_keras_main's shape, its initial
    weights given, returning them after training too."""
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
    model.set_weights(weights)
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.SGD(0.01))
    model.compile(optimizer=opt, loss="mse")
    rng = np.random.RandomState(hvd.rank())
    x = rng.randn(64, 8).astype("float32")
    y = rng.randn(64, 1).astype("float32")
    hist = model.fit(x, y, batch_size=32, epochs=epochs, verbose=0,
                     shuffle=False, callbacks=[
                         hvd.callbacks.BroadcastGlobalVariablesCallback(0),
                         hvd.callbacks.MetricAverageCallback(),
                         LogCallback()])
    return {"size": hvd.size(), "module": hvd.__name__,
            "optimizer": type(opt).__name__,
            "losses": [float(v) for v in hist.history["loss"]],
            "weights": model.get_weights()}


def test_keras_main_through_horovod_runner_matches_jax(capfd):
    rng = np.random.default_rng(7)
    weights = [rng.standard_normal((8, 4)).astype(np.float32) * 0.3,
               np.zeros(4, np.float32),
               rng.standard_normal((4, 1)).astype(np.float32) * 0.3,
               np.zeros(1, np.float32)]
    jx = JaxRunner(np=-1).run(_keras_main, weights=weights)
    pt = PortRunner(np=-1).run(_keras_main, weights=weights)
    assert pt["module"] == "sparkdl_tpu_torch.compat.horovod_tensorflow_keras"
    assert jx["module"] == "horovod.tensorflow.keras"
    assert pt["size"] == 1 and pt["optimizer"] == "DistributedSGD"
    np.testing.assert_allclose(pt["losses"], jx["losses"], atol=1e-6)
    assert pt["losses"][1] < pt["losses"][0]
    for a, b in zip(jx["weights"], pt["weights"]):
        np.testing.assert_allclose(b, a, atol=1e-6)
    out = capfd.readouterr().out
    assert out.count("Epoch 0 begin") == 2 and out.count("Epoch 1 end") == 2
    # the port's run left the JAX package's sparkdl in place
    assert sys.modules["sparkdl"].HorovodRunner is JaxRunner


def test_keras3_shim_on_the_tensorflow_backend_matches_jax():
    """``horovod.keras``'s DistributedOptimizer, broadcast and callbacks
    on Keras's tensorflow backend (the JAX shim's numpy tier) in local
    mode; its refusals by name."""
    import keras

    assert keras.backend.backend() == "tensorflow"
    out = {}
    for pkg in ("jax", "torch"):
        with _local(pkg):
            hk = _shim("horovod.keras")
            hk.init()
            model = keras.Sequential([keras.Input((3,)),
                                      keras.layers.Dense(2)])
            model.set_weights([np.eye(3, 2, dtype=np.float32),
                               np.ones(2, np.float32)])
            model.compile(optimizer=hk.DistributedOptimizer(
                keras.optimizers.SGD(0.1)), loss="mse")
            x = np.linspace(0, 1, 12, dtype=np.float32).reshape(4, 3)
            hist = model.fit(x, x[:, :2], epochs=2, verbose=0, shuffle=False,
                             callbacks=[
                                 hk.BroadcastGlobalVariablesCallback(0),
                                 hk.callbacks.MetricAverageCallback()])
            hk.broadcast_model_variables(model, 0)
            out[pkg] = (hist.history["loss"], model.get_weights())
            if pkg == "torch":
                with pytest.raises(NotImplementedError,
                                   match="no counterpart in the port"):
                    hk.init_distribution()
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], atol=1e-6)
    for a, b in zip(out["jax"][1], out["torch"][1]):
        np.testing.assert_allclose(b, a, atol=1e-6)
