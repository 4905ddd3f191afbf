"""The port's distributed GBDT paths on the CPU, in gangs of two.

``launch_gang(per_rank_kwargs=)``: each rank gets its own kwargs in its
own payload, the list's length is checked before any spawn and again
once the world is resolved (an elastic relaunch to another size
included), such a gang opts out of the Spark barrier job, the payload
warning and the pre-flight look at each rank's payload. The distributed
fit against the JAX package's: two ranks as threads of this process,
meeting in a summing all-reduce, fit the same two shards through both
packages (the averaged edges, the reduced base score, each rank's
forest), and the JAX reducer's float32 sums give the base score C3
states. Then the estimators' gangs, each held against the JAX package's
threaded ranks on the same shards: the staged booster over
``hvd.allreduce`` builds the same trees on both ranks; ``_partition_gang_main`` (the Spark path's
executor-side worker) gathers the validation rows under its guard and
learns what one process learns; ``num_workers=2`` honours
``STRICT_SLOTS``; and through the minispark double
(``tests/minispark``: real executor processes, a real barrier) the
partition-resident fit and the ``mapInPandas`` transform.

Every gang runs with ``launcher.WORKER_DEVICE = "cpu"``, the launcher's
timeouts patched and a slot registry of the test's own; the fixtures
restore ``sys.modules`` (``pyspark*``, both Spark backends), as
``tests/test_torch_spark.py`` does."""

import hashlib
import logging
import os
import sys
import threading
import types

import cloudpickle
import numpy as np
import pandas as pd
import pytest
import torch

import sparkdl_tpu_torch.xgboost as px
from sparkdl_tpu.xgboost import booster as jb
from sparkdl_tpu_torch.analysis import PreflightLintError, preflight
from sparkdl_tpu_torch.horovod import RestartContext, launcher, supervisor
from sparkdl_tpu_torch.xgboost import booster as pb
from sparkdl_tpu_torch.xgboost import xgboost as px_mod
from tests.test_torch_booster import _data as _booster_data
from tests.test_torch_booster import assert_same_forest

torch.set_num_threads(2)
cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM = os.path.join(REPO, "tests", "minispark", "shim")
BACKENDS = ("sparkdl_tpu_torch.horovod.spark_backend",
            "sparkdl_tpu.horovod.spark_backend")
PARAMS = {"objective": "binary:logistic", "n_estimators": 6,
          "max_depth": 3, "num_class": 2, "max_bin": 32}


def _drop_spark_modules():
    for mod in list(sys.modules):
        if mod == "pyspark" or mod.startswith("pyspark.") or mod in BACKENDS:
            del sys.modules[mod]


@pytest.fixture(autouse=True)
def settings(monkeypatch, tmp_path):
    monkeypatch.setattr(launcher, "START_TIMEOUT_S", 60.0)
    monkeypatch.setattr(launcher, "JOB_TIMEOUT_S", 120.0)
    monkeypatch.setattr(launcher, "ABORT_GRACE_S", 2.0)
    monkeypatch.setattr(launcher, "WORKER_DEVICE", "cpu")
    monkeypatch.setattr(launcher, "SLOT_DIR", str(tmp_path / "slots"))
    monkeypatch.setattr(launcher, "NUM_SLOTS", None)
    monkeypatch.setattr(launcher, "HOSTS", None)
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy())
    monkeypatch.setattr(px, "DEVICE", "cpu")
    saved = {m: sys.modules[m] for m in list(sys.modules)
             if m == "pyspark" or m.startswith("pyspark.") or m in BACKENDS}
    yield
    _drop_spark_modules()
    sys.modules.update(saved)


def _data(n=240, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _frame(X, y, val=None):
    d = {"features": list(X), "label": y}
    if val is not None:
        d["isVal"] = val
    return pd.DataFrame(d)


def _accuracy(bst, X, y):
    return float(((bst.predict_proba(X, device="cpu")[:, 1] > 0.5)
                  == y.astype(bool)).mean())


def _digest(bst):
    h = hashlib.sha256()
    for t in bst.trees:
        for k in sorted(t):
            h.update(np.ascontiguousarray(t[k]).tobytes())
    return h.hexdigest()


class _ThreadGang:
    """``n`` ranks as threads of this process. Each rank's reducer is a
    summing all-reduce of numpy arrays that meets the others at a
    barrier and adds the ranks' arrays in rank order, so every rank gets
    the same bits. ``compute_dtype`` sums in that type and hands back
    the caller's: float32 is the JAX ``hvd.allreduce`` with x64 off,
    which computes a float64 sum in float32
    (``sparkdl_tpu/hvd/_collectives.py:401-405``)."""

    def __init__(self, n=2, compute_dtype=None):
        self.n, self.compute_dtype = n, compute_dtype
        self._slots = [None] * n
        self._barrier = threading.Barrier(n, timeout=120)

    def reducer(self, rank):
        def reduce(a):
            a = np.asarray(a)
            self._slots[rank] = (a if self.compute_dtype is None
                                 else a.astype(self.compute_dtype))
            self._barrier.wait()
            out = self._slots[0].copy()
            for other in self._slots[1:]:
                out = out + other
            self._barrier.wait()  # nobody overwrites a slot before all read
            return out.astype(a.dtype, copy=False)
        return reduce

    def run(self, fn):
        """``fn(rank, reducer)`` on every rank at once; the results by
        rank. A rank that raises breaks the barrier for the others."""
        out, errors = [None] * self.n, []

        def body(rank):
            try:
                out[rank] = fn(rank, self.reducer(rank))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _jax_ranks(params, shards, compute_dtype=None, **kw):
    """The JAX package's booster fit by threaded ranks, one a shard (a
    dict of ``train``'s ``X``, ``y`` and ``sample_weight``)."""
    return _ThreadGang(len(shards), compute_dtype).run(
        lambda r, reduce: jb.train(dict(params), hist_reduce=reduce,
                                   **shards[r], **kw))


def _port_ranks(params, shards, **kw):
    return _ThreadGang(len(shards)).run(
        lambda r, reduce: pb.train(dict(params), hist_reduce=reduce,
                                   device="cpu", **shards[r], **kw))


def _shards(X, y, bounds, w=None):
    return [{"X": X[a:b], "y": y[a:b],
             **({} if w is None else {"sample_weight": w[a:b]})}
            for a, b in zip(bounds, bounds[1:])]


# the two ranks' fits of tests/test_torch_booster.py's data (missing
# values included), split 130 / 170 so that the shards' quantiles differ
RANK_FITS = {
    "binary": ("binary:logistic", {"scale_pos_weight": 2.0}),
    "regression_weighted_monotone": (
        "reg:squarederror", {"monotone_constraints": (1, -1, 0, 0, 0)}),
    "multiclass_subsampled": ("multi:softprob",
                              {"num_class": 3, "subsample": 0.8,
                               "colsample_bytree": 0.6, "seed": 7}),
}


@pytest.mark.parametrize("name", sorted(RANK_FITS))
def test_two_rank_fit_is_the_jax_packages(name):
    """Both packages' ranks on the same shards through the same summing
    reducer: the edges are the shards' quantiles averaged, the
    regression base score is the weighted mean of all rows' labels, and
    each rank's forest is its JAX counterpart's (``assert_same_forest``:
    structure and numbers up to a near-tie); within a package both ranks
    build one forest."""
    objective, extra = RANK_FITS[name]
    X, ys = _booster_data()
    y = ys[objective]
    w = (np.random.default_rng(5).uniform(0.5, 2.0, len(y))
         .astype(np.float32) if objective == "reg:squarederror" else None)
    params = dict(objective=objective, n_estimators=5, max_depth=3,
                  max_bin=32, learning_rate=0.3, **extra)
    shards = _shards(X, y, [0, 130, len(y)], w)
    want = _jax_ranks(params, shards)
    got = _port_ranks(params, shards)
    edges = (jb.compute_bin_edges(X[:130], 32)
             + jb.compute_bin_edges(X[130:], 32)) / 2.0
    for bst in want + got:
        np.testing.assert_array_equal(bst.edges, edges)
    if objective == "reg:squarederror":
        sums = sum(np.array([np.sum(s["y"] * s["sample_weight"]),
                             np.sum(s["sample_weight"])], np.float64)
                   for s in shards)
        for bst in want + got:
            assert bst.base_score == np.float32(sums[0] / sums[1])
    for r in range(2):
        assert_same_forest(want[r], got[r], X, y,
                           jb._DEFAULT_METRIC[objective])
    assert _digest(got[0]) == _digest(got[1])
    assert _digest(want[0]) == _digest(want[1])


def test_jax_reducers_float32_sums_move_only_the_base_score():
    """C3's difference: the JAX ``hvd.allreduce`` sums a float64 array in
    float32, the port's keeps float64. The averaged edges are float32 in
    both (equal); the regression base score, a ratio of two reduced
    sums, is within two float32 ulps of the port's and equal to the
    float32 sums' ratio; the forests then agree in the train metric
    within 1e-3 relative."""
    X, ys = _booster_data(seed=3)
    y = ys["reg:squarederror"] + np.float32(0.37)
    # weights whose two sums round apart in float32, so that the
    # difference shows (about a third of the seeds' do)
    w = np.random.default_rng(2).uniform(0.5, 2.0, len(y)).astype(
        np.float32)
    params = dict(objective="reg:squarederror", n_estimators=5,
                  max_depth=3, max_bin=32, learning_rate=0.3)
    shards = _shards(X, y, [0, 130, len(y)], w)
    want = _jax_ranks(params, shards, compute_dtype=np.float32)
    got = _port_ranks(params, shards)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.edges, b.edges)
    parts = [np.array([np.sum(s["y"] * s["sample_weight"]),
                       np.sum(s["sample_weight"])], np.float64)
             for s in shards]
    wide = parts[0] + parts[1]
    narrow = (parts[0].astype(np.float32)
              + parts[1].astype(np.float32)).astype(np.float64)
    for a, b in zip(want, got):
        assert a.base_score == np.float32(narrow[0] / narrow[1])
        assert b.base_score == np.float32(wide[0] / wide[1])
        assert a.base_score != b.base_score
        assert abs(float(a.base_score) - float(b.base_score)) \
            <= 2 * float(np.spacing(np.float32(b.base_score)))
        rmse = [jb._eval_metric("rmse", np.asarray(a.predict_margin(X)), y,
                                1),
                pb._eval_metric("rmse", b.predict_margin(X, device="cpu"),
                                y, 1)]
        assert abs(rmse[0] - rmse[1]) <= 1e-3 * rmse[0]


def _rank_main(X, y, params, tag):
    """A rank of the estimators' gang (``_fit_booster``'s main), which
    also reports its rows, its own kwarg and its trees' digest."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.xgboost import booster as B

    hvd.init()
    bst = B.train(params, X, y,
                  hist_reduce=lambda a: hvd.allreduce(a, op=hvd.Sum))
    return {"rows": hvd.allgather_object(len(X)),
            "tags": hvd.allgather_object(tag),
            "digests": hvd.allgather_object(_digest(bst)),
            "booster": bst}


@pytest.mark.gang
def test_per_rank_kwargs_reach_their_rank_and_both_build_one_forest():
    X, y = _data()
    parts = [slice(0, 100), slice(100, None)]
    got = launcher.launch_gang(
        -2, _rank_main, {"X": None, "y": None, "params": PARAMS,
                         "tag": None}, "all",
        per_rank_kwargs=[{"X": X[s], "y": y[s], "tag": f"shard{i}"}
                         for i, s in enumerate(parts)])
    assert got["rows"] == [100, 140]
    assert got["tags"] == ["shard0", "shard1"]
    # every rank split on the same all-reduced sums: one forest
    assert got["digests"][0] == got["digests"][1] == _digest(got["booster"])
    single = pb.train(dict(PARAMS), X, y, device="cpu")
    assert abs(_accuracy(got["booster"], X, y) - _accuracy(single, X, y)) \
        <= 0.03
    # the gang's gloo sums give the JAX package's ranks' forest
    want = _jax_ranks(PARAMS, _shards(X, y, [0, 100, len(y)]))
    assert_same_forest(want[0], got["booster"], X, y, "logloss")


class _Spawned(Exception):
    """Tripwire: the launcher reached subprocess.Popen."""


@pytest.fixture
def popen_tripwire(monkeypatch):
    def boom(*a, **k):
        raise _Spawned(a[0] if a else "?")

    monkeypatch.setattr(launcher.subprocess, "Popen", boom)


def test_length_checks_come_before_any_spawn(popen_tripwire, monkeypatch):
    two = [{"x": 1}, {"x": 2}]
    monkeypatch.setattr(launcher, "NUM_SLOTS", 4)
    with pytest.raises(ValueError, match="2 entries for a gang of 3"):
        launcher.launch_gang(3, _rank_main, {}, "all", per_rank_kwargs=two)
    # a local gang's size is known once its world is resolved
    with pytest.raises(ValueError, match="2 entries for a gang of 3"):
        launcher.launch_gang(-3, _rank_main, {}, "all", per_rank_kwargs=two)
    # an elastic relaunch to another world size: the same refusal
    with pytest.raises(ValueError, match="2 entries for a gang of 3"):
        launcher._launch_gang_once(-2, [b"a", b"b"], "all",
                                   RestartContext(1, None), world=3)
    # the right length reaches the spawn
    with pytest.raises(_Spawned):
        launcher.launch_gang(2, _rank_main, {}, "all", per_rank_kwargs=two)


def test_per_rank_kwargs_opt_out_of_the_spark_gang(popen_tripwire,
                                                   monkeypatch):
    fake = types.ModuleType(BACKENDS[0])

    def never(*a, **k):
        raise AssertionError("a Spark barrier job was started")

    fake.maybe_launch_on_spark = never
    monkeypatch.setitem(sys.modules, BACKENDS[0], fake)
    monkeypatch.setattr(launcher, "NUM_SLOTS", 2)
    with pytest.raises(_Spawned):
        launcher._launch_gang_once(2, [b"a", b"b"], "all",
                                   RestartContext(0, None))
    # the one shared payload still asks Spark first
    with pytest.raises(AssertionError, match="Spark barrier job"):
        launcher._launch_gang_once(2, b"a", "all", RestartContext(0, None))


def test_payload_warning_and_preflight_look_at_each_rank(popen_tripwire,
                                                         monkeypatch,
                                                         caplog):
    monkeypatch.setattr(launcher, "LARGE_PAYLOAD_BYTES", 1 << 16)
    big = np.zeros(1 << 15, np.float32)  # 128 KiB for rank 1 alone
    with caplog.at_level(logging.WARNING, logger="HorovodRunner"):
        with pytest.raises(_Spawned):
            launcher.launch_gang(-2, _rank_main, {}, "all",
                                 per_rank_kwargs=[{"x": None}, {"x": big}])
    assert "for one rank" in caplog.text
    monkeypatch.setattr(preflight, "ENABLED", True)
    with pytest.raises(PreflightLintError, match=r"per_rank_kwargs\[1\]"):
        launcher.launch_gang(-2, _rank_main, {}, "all", per_rank_kwargs=[
            {"x": None}, {"x": torch.zeros(2, device="meta")}])


@pytest.mark.gang
def test_partition_gang_main_gathers_validation_rows_under_its_guard(capfd):
    X, y = _data(seed=1)
    val = np.zeros(len(y), bool)
    val[::5] = True
    halves = [_frame(X[:120], y[:120], val[:120]),
              _frame(X[120:], y[120:], val[120:])]
    params = dict(PARAMS, n_estimators=20, eval_metric="logloss")
    bst = launcher.launch_gang(
        -2, px_mod._partition_gang_main,
        dict(params=params, colspec={"features": "features",
                                     "label": "label", "val": "isVal"},
             esr=3, verbose=False, callbacks=None, xgb_model=None,
             use_external_storage=False, storage_precision=5,
             warn_bytes=1),
        "all", per_rank_kwargs=[{"partition_pdf": h} for h in halves])
    # early stopping over the gathered (identical) validation set
    assert bst.best_iteration is not None
    single = pb.train(dict(params), X[~val], y[~val],
                      eval_set=[(X[val], y[val])], early_stopping_rounds=3,
                      device="cpu")
    assert abs(_accuracy(bst, X, y) - _accuracy(single, X, y)) <= 0.03
    assert "validationIndicatorCol selects" in capfd.readouterr().out
    # the JAX package's ranks on the same partitions' training rows,
    # scored on the gathered validation rows (rank order)
    parts = [slice(0, 120), slice(120, None)]
    want = _jax_ranks(
        params, [{"X": X[p][~val[p]], "y": y[p][~val[p]]} for p in parts],
        eval_set=[(np.concatenate([X[p][val[p]] for p in parts]),
                   np.concatenate([y[p][val[p]] for p in parts]))],
        early_stopping_rounds=3)
    assert_same_forest(want[0], bst, X, y, "logloss")


def test_strict_slots_refuses_an_oversubscribed_gang(popen_tripwire,
                                                     monkeypatch):
    X, y = _data()
    monkeypatch.setattr(launcher, "NUM_SLOTS", 1)
    monkeypatch.setattr(px_mod, "STRICT_SLOTS", True)
    with pytest.raises(RuntimeError, match="STRICT_SLOTS"):
        px.XgboostClassifier(num_workers=2, n_estimators=2).fit(_frame(X, y))


@pytest.mark.gang
def test_num_workers_two_runs_one_worker_a_slot(monkeypatch, caplog):
    X, y = _data(n=300)
    monkeypatch.setattr(launcher, "NUM_SLOTS", 2)
    monkeypatch.setattr(px_mod, "STRICT_SLOTS", True)
    est = px.XgboostClassifier(n_estimators=10, max_depth=3, num_workers=2,
                               force_repartition=True)
    with caplog.at_level(logging.WARNING, logger="sparkdl.xgboost"):
        model = est.fit(_frame(X, y))
    # a pandas input: driver-collect, said loudly, then the gang
    assert "SINGLE-NODE" in caplog.text
    out = model.transform(_frame(X, y))
    assert float((out["prediction"] == y).mean()) > 0.9
    # _fit_booster's shards (force_repartition's reshuffle) through the
    # JAX package's ranks: the same forest
    idx = np.arange(len(X))
    np.random.RandomState(0).shuffle(idx)
    want = _jax_ranks(est._booster_params(2),
                      [{"X": X[s], "y": y[s]}
                       for s in np.array_split(idx, 2)])
    assert_same_forest(want[0], model.get_booster(), X, y, "logloss")


@pytest.fixture
def minispark(monkeypatch):
    """The double as ``pyspark`` with an active session of 2 slots; its
    executors import the port from this checkout."""
    _drop_spark_modules()
    monkeypatch.syspath_prepend(SHIM)
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       REPO if not path else REPO + os.pathsep + path)
    from pyspark.sql import SparkSession

    session = SparkSession._activate(n_slots=2)
    yield session
    SparkSession._deactivate()


@pytest.mark.gang
def test_partition_resident_fit_and_executor_transform(minispark):
    X, y = _data(n=300, seed=3)
    pdf = _frame(X, y)
    sdf = minispark.createDataFrame(pdf)
    model = px.XgboostClassifier(n_estimators=10, max_depth=3,
                                 num_workers=2).fit(sdf)
    assert isinstance(model, px.XgboostClassifierModel)
    out = model.transform(sdf)
    assert type(out).__module__ == "pyspark.sql"  # mapInPandas, not collect
    got = out.toPandas()
    assert list(got.columns) == ["features", "label", "rawPrediction",
                                 "probability", "prediction"]
    want = model.transform(pdf)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(np.stack(got["probability"].to_numpy()),
                               np.stack(want["probability"].to_numpy()))
    assert float((got["prediction"] == y).mean()) > 0.9
    # one executor-resident copy, keyed by the context and the device
    bc = model._transform_broadcast(minispark)
    assert model._transform_broadcast(minispark) is bc
    assert model._bc_sc_id == (minispark.sparkContext.applicationId, "cpu")
