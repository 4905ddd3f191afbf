"""The port's GBDT estimators against the JAX package's, on the CPU.

The scenarios of ``tests/xgboost/test_estimators.py`` and
``test_monotone.py`` run through ``sparkdl_tpu.xgboost`` and
``sparkdl_tpu_torch.xgboost`` (``xgboost.DEVICE = "cpu"``) on the same
pandas frames: the Param surface, the keyword-only constructors, the
blocked params and their hints, the output columns, margins and
probabilities, the models' files loaded by the other package, the
importances, warm start, external storage and the monotone constraints.
The boosters are held as ``tests/test_torch_booster.py`` holds them
(structure up to a checked near-tie, then the train metric)."""

import inspect
import logging

import numpy as np
import pandas as pd
import pytest
import torch

import sparkdl_tpu.xgboost as jx
import sparkdl_tpu_torch.xgboost as px
from sparkdl_tpu.xgboost import xgboost as jx_mod
from sparkdl_tpu_torch.xgboost import xgboost as px_mod
from tests.test_torch_booster import assert_same_forest

torch.set_num_threads(2)

CLASSES = ("XgboostClassifier", "XgboostRegressor",
           "XgboostClassifierModel", "XgboostRegressorModel")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(px, "DEVICE", "cpu")


def _reg_frame(n=300, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3).astype(np.float32)
    y = 2.0 * X[:, 0] - X[:, 1] + 0.05 * rng.randn(n)
    return pd.DataFrame({
        "features": list(X), "label": y.astype(np.float32),
        "isVal": (np.arange(n) % 5 == 0),
        "weight": np.linspace(0.5, 1.5, n).astype(np.float32)})


def _clf_frame(n=300, n_classes=2, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    if n_classes == 2:
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    return pd.DataFrame({"features": list(X), "label": y})


def _x(df):
    return np.stack(df["features"].to_numpy()).astype(np.float32)


def _both(name, df, **kw):
    """(JAX model, port model) of estimator ``name`` fit on ``df``."""
    return tuple(getattr(pkg, name)(**kw).fit(df) for pkg in (jx, px))


def _metric(model):
    obj = model.get_booster().params["objective"]
    return {"reg:squarederror": "rmse", "binary:logistic": "logloss",
            "multi:softprob": "mlogloss"}[obj]


def _hold(jm, pm, df, label="label"):
    """The boosters as the booster tests hold them; True when no tree
    met a near-tie, so the outputs compare closely."""
    return assert_same_forest(
        jm.get_booster(), pm.get_booster(), _x(df),
        df[label].to_numpy(np.float32), _metric(jm)) is None


def test_constructors_are_keyword_only_as_in_jax():
    for name in CLASSES[:2]:
        for pkg in (jx, px):
            cls = getattr(pkg, name)
            params = inspect.signature(cls.__init__).parameters
            assert [p.kind for p in params.values()][1:] == \
                [inspect.Parameter.VAR_KEYWORD], name
            with pytest.raises(TypeError):
                cls(3)


@pytest.mark.parametrize("name", CLASSES)
def test_param_surface_and_defaults_are_the_jax_packages(name):
    jobj, pobj = getattr(jx, name)(), getattr(px, name)()
    assert [p.name for p in pobj.params] == [p.name for p in jobj.params]
    for p in jobj.params:
        want = jobj.getOrDefault(p) if jobj.isDefined(p) else "undefined"
        got = pobj.getOrDefault(p.name) if pobj.isDefined(p.name) \
            else "undefined"
        if isinstance(want, float) and np.isnan(want):
            assert np.isnan(got), p.name
        else:
            assert got == want, p.name


@pytest.mark.parametrize("param", sorted(jx_mod._BLOCKED_PARAMS))
def test_blocked_params_raise_the_same_hint(param):
    errors = []
    for pkg in (jx, px):
        with pytest.raises(ValueError) as e:
            pkg.XgboostClassifier(**{param: 1})
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert px_mod._BLOCKED_PARAMS == jx_mod._BLOCKED_PARAMS


def test_ignored_and_unknown_params(caplog):
    assert px_mod._IGNORED_PARAMS == jx_mod._IGNORED_PARAMS
    with caplog.at_level(logging.WARNING, logger="sparkdl.xgboost"):
        px.XgboostClassifier(n_estimators=3, n_jobs=8, verbosity=0)
    assert caplog.text.count("no effect") == 2
    errors = []
    for pkg in (jx, px):
        with pytest.raises(ValueError) as e:
            pkg.XgboostRegressor(definitely_not_a_param=3)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("n_classes", [2, 3])
def test_classifier_columns_margins_and_probabilities(n_classes):
    df = _clf_frame(n_classes=n_classes)
    jm, pm = _both("XgboostClassifier", df, n_estimators=8, max_depth=3)
    assert isinstance(pm, px.XgboostClassifierModel)
    jo, po = jm.transform(df), pm.transform(df)
    assert list(po.columns) == list(jo.columns)
    assert (po["prediction"] == df["label"]).mean() > 0.9
    raw, proba = (np.stack(po[c].to_numpy()) for c in ("rawPrediction",
                                                         "probability"))
    assert raw.shape == proba.shape == (len(df), n_classes)
    assert raw.dtype == proba.dtype == np.float64
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    if _hold(jm, pm, df):
        for col in ("rawPrediction", "probability"):
            np.testing.assert_allclose(
                np.stack(po[col].to_numpy()), np.stack(jo[col].to_numpy()),
                atol=1e-5, err_msg=col)
        np.testing.assert_array_equal(po["prediction"], jo["prediction"])


def test_regressor_with_validation_weights_and_missing_zero():
    """The reference doctest flow (renamed params, early stopping)."""
    df = _reg_frame()
    kw = dict(max_depth=4, missing=0.0, validationIndicatorCol="isVal",
              weightCol="weight", early_stopping_rounds=3,
              eval_metric="rmse", n_estimators=30)
    jm, pm = _both("XgboostRegressor", df, **kw)
    assert pm.get_booster().best_iteration == \
        jm.get_booster().best_iteration
    train = df[~df["isVal"]]
    po, jo = pm.transform(df), jm.transform(df)
    if _hold(jm, pm, train):
        np.testing.assert_allclose(po["prediction"], jo["prediction"],
                                   atol=1e-5)
    rmse = float(np.sqrt(np.mean((po["prediction"] - df["label"]) ** 2)))
    assert rmse < 0.5


def test_models_cross_between_the_packages(tmp_path):
    df = _reg_frame()
    est = px.XgboostRegressor(n_estimators=6, max_depth=3,
                              learning_rate=0.2)
    est.save(str(tmp_path / "port_est"))
    for cls in (jx.XgboostRegressor, px.XgboostRegressor):
        back = cls.load(str(tmp_path / "port_est"))
        assert back.getOrDefault(back.n_estimators) == 6
        assert back.getOrDefault(back.learning_rate) == 0.2
    jm, pm = _both("XgboostRegressor", df, n_estimators=6, max_depth=3)
    jm.write().save(str(tmp_path / "jax_model"))
    pm.write().save(str(tmp_path / "port_model"))
    from_jax = px.XgboostRegressorModel.load(str(tmp_path / "jax_model"))
    from_port = jx.XgboostRegressorModel.load(str(tmp_path / "port_model"))
    np.testing.assert_array_equal(from_jax.transform(df)["prediction"],
                                  jm.transform(df)["prediction"])
    np.testing.assert_allclose(from_port.transform(df)["prediction"],
                               pm.transform(df)["prediction"], atol=1e-6)
    assert isinstance(from_jax.get_booster(),
                      px.xgboost._booster_mod.Booster)
    with pytest.raises(IOError, match="overwrite"):
        pm.write().save(str(tmp_path / "port_model"))
    pm.write().overwrite().save(str(tmp_path / "port_model"))


def test_importances_callbacks_and_warm_start():
    df = _reg_frame()
    jm, pm = _both("XgboostRegressor", df, n_estimators=10, max_depth=3)
    if _hold(jm, pm, df):
        for kind in ("gain", "weight", "total_gain"):
            np.testing.assert_allclose(
                pm.get_booster().feature_importances(kind),
                jm.get_booster().feature_importances(kind), atol=1e-5)
    imp = pm.feature_importances_
    assert imp.shape == (3,) and imp[0] + imp[1] > 0.9
    rounds = []
    px.XgboostRegressor(n_estimators=4, callbacks=[
        lambda rnd, margins: rounds.append((rnd, margins.shape))]).fit(df)
    assert rounds == [(r, (len(df), 1)) for r in range(4)]
    warm = px.XgboostRegressor(n_estimators=5,
                               xgb_model=pm.get_booster()).fit(df)
    assert len(warm.get_booster().trees) == 15
    assert warm.get_booster().n_base_trees == 10


def test_external_storage_scale_pos_weight_and_base_score():
    df = _reg_frame()
    out = px.XgboostRegressor(use_external_storage=True,
                              external_storage_precision=3,
                              n_estimators=5).fit(df).transform(df)
    assert np.isfinite(out["prediction"]).all()
    with pytest.raises(ValueError, match="external_storage"):
        px.XgboostRegressor(use_external_storage=True, weightCol="weight",
                            n_estimators=2).fit(df)
    out = px.XgboostRegressor(n_estimators=0, base_score=5.0).fit(
        df).transform(df)
    np.testing.assert_allclose(out["prediction"], 5.0, atol=1e-6)
    clf = _clf_frame(n=60)
    with pytest.raises(ValueError, match="base_score"):
        px.XgboostClassifier(n_estimators=2, base_score=1.0).fit(clf)
    clf["label"] = clf["label"] * 2  # {0, 2}
    with pytest.raises(ValueError, match="0..k-1"):
        px.XgboostClassifier(n_estimators=2).fit(clf)
    rng = np.random.RandomState(5)
    X = rng.randn(300, 3).astype(np.float32)
    y = (X[:, 0] > 1.0).astype(np.float32)
    skew = pd.DataFrame({"features": list(X), "label": y})
    jm, pm = _both("XgboostClassifier", skew, n_estimators=6, max_depth=3,
                   scale_pos_weight=10.0)
    _hold(jm, pm, skew)
    base = px.XgboostClassifier(n_estimators=6, max_depth=3).fit(skew)
    heavy = np.stack(pm.transform(skew)["rawPrediction"].to_numpy())
    light = np.stack(base.transform(skew)["rawPrediction"].to_numpy())
    assert heavy[y == 1, 1].mean() > light[y == 1, 1].mean() + 0.05


def test_distributed_base_margin_is_refused_before_any_gang():
    df = _reg_frame()
    df["margin"] = 0.0
    with pytest.raises(ValueError, match="distributed"):
        px.XgboostRegressor(num_workers=2, baseMarginCol="margin",
                            n_estimators=2).fit(df)


def _sweep(booster, feature, n_points=40, seed=1):
    rng = np.random.RandomState(seed)
    base = np.tile(rng.rand(1, 3).astype(np.float32), (n_points, 1))
    base[:, feature] = np.linspace(0.0, 1.0, n_points)
    return booster.predict_margin(base, device="cpu")[:, 0]


@pytest.mark.parametrize("spec", [(1, -1, 0), "(1,-1,0)", {0: 1, 1: -1}])
def test_monotone_constraints_through_the_estimator(spec):
    rng = np.random.RandomState(0)
    X = rng.rand(300, 3).astype(np.float32)
    y = (2.0 * X[:, 0] - 1.5 * X[:, 1] + 0.6 * rng.randn(300)).astype(
        np.float32)
    df = pd.DataFrame({"features": list(X), "label": y})
    jm, pm = _both("XgboostRegressor", df, n_estimators=15, max_depth=3,
                   monotone_constraints=spec)
    _hold(jm, pm, df)
    bst = pm.get_booster()
    for seed in range(3):
        assert (np.diff(_sweep(bst, 0, seed=seed)) >= -1e-5).all()
        assert (np.diff(_sweep(bst, 1, seed=seed)) <= 1e-5).all()


def test_estimators_default_to_the_card(monkeypatch):
    monkeypatch.setattr(px, "DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = _clf_frame(n=40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        px.XgboostClassifier(n_estimators=1).fit(df)
    monkeypatch.setattr(px, "DEVICE", "cpu")
    model = px.XgboostClassifier(n_estimators=1).fit(df)
    monkeypatch.setattr(px, "DEVICE", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.transform(df)
