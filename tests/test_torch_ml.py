"""The port's pyspark.ml stand-ins against the JAX package's, on the CPU.

``sparkdl_tpu_torch.ml`` is a copy of ``sparkdl_tpu.ml`` (the port
imports nothing of the JAX package): the Param system, the persistence
format, the evaluators (AUC with average ranks for ties, PR-AUC with
pyspark's interpolation), ``Pipeline``, ``CrossValidator``,
``TrainValidationSplit`` and ``OneVsRest`` give the same answers on the
same frames. The meta-algorithms run over each package's own
``XgboostClassifier`` / ``XgboostRegressor``
(``tests/xgboost/test_pipeline.py`` and ``test_ovr_eval.py``'s
scenarios); their chosen params and metrics are held to the JAX ones."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import sparkdl_tpu.ml as jml
import sparkdl_tpu.xgboost as jx
import sparkdl_tpu_torch.ml as pml
import sparkdl_tpu_torch.xgboost as px
from sparkdl_tpu.ml import classification as jcls
from sparkdl_tpu.ml import evaluation as jev
from sparkdl_tpu.ml import pipeline as jpipe
from sparkdl_tpu.ml import util as jutil
from sparkdl_tpu_torch.ml import classification as pcls
from sparkdl_tpu_torch.ml import dataframe as pdf_mod
from sparkdl_tpu_torch.ml import evaluation as pev
from sparkdl_tpu_torch.ml import pipeline as ppipe
from sparkdl_tpu_torch.ml import util as putil

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(px, "DEVICE", "cpu")


def _clf_frame(n=240, seed=0, n_classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    if n_classes == 2:
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    else:
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float32)
    return pd.DataFrame({"features": list(X), "label": y})


class _Est(pml.Estimator, pml.HasFeaturesCol, pml.HasLabelCol,
           pml.HasWeightCol):
    depth = pml.Param(pml.Params._dummy(), "depth", "a depth.",
                      typeConverter=pml.TypeConverters.toInt)

    def __init__(self):
        super().__init__()
        self._setDefault(depth=3)


class _JEst(jml.Estimator, jml.HasFeaturesCol, jml.HasLabelCol,
            jml.HasWeightCol):
    depth = jml.Param(jml.Params._dummy(), "depth", "a depth.",
                      typeConverter=jml.TypeConverters.toInt)

    def __init__(self):
        super().__init__()
        self._setDefault(depth=3)


def test_the_stand_ins_are_the_port_own():
    assert pml.HAVE_PYSPARK is False and jml.HAVE_PYSPARK is False
    assert pml.Params.__module__ == "sparkdl_tpu_torch.ml.param"
    assert pml.Estimator.__module__ == "sparkdl_tpu_torch.ml.base"
    for name in ("Estimator", "Model", "Transformer", "Param", "Params",
                 "TypeConverters", "HasFeaturesCol", "HasLabelCol",
                 "HasPredictionCol", "HasProbabilityCol",
                 "HasRawPredictionCol", "HasValidationIndicatorCol",
                 "HasWeightCol", "MLReadable", "MLWritable"):
        assert hasattr(pml, name) and hasattr(jml, name), name


def test_params_behave_as_the_jax_params():
    got, want = _Est(), _JEst()
    for obj in (got, want):
        assert obj.depth.parent == obj.uid
        assert obj.getOrDefault("depth") == 3 and not obj.isSet("depth")
        obj.set(obj.depth, "7")
        obj._set(featuresCol="x", weightCol="w")
        assert obj.isSet(obj.depth) and obj.getOrDefault(obj.depth) == 7
        with pytest.raises(ValueError, match="Cannot find param"):
            obj.getParam("nope")
        with pytest.raises(TypeError):
            obj.set(obj.depth, True)  # toInt refuses a bool
    assert [p.name for p in got.params] == [p.name for p in want.params]
    assert got.explainParams().replace(got.uid, "") == \
        want.explainParams().replace(want.uid, "")
    names = lambda pm: sorted((p.name, v) for p, v in pm.items())  # noqa
    assert names(got.extractParamMap()) == names(want.extractParamMap())
    dup = got.copy({got.depth: 9, "labelCol": "y", "not_mine": 1})
    assert dup.getOrDefault("depth") == 9 and dup.getLabelCol() == "y"
    assert got.getOrDefault("depth") == 7
    got.clear(got.depth)
    assert got.getOrDefault("depth") == 3
    for conv in ("toInt", "toFloat", "toString", "toList", "toListFloat",
                 "toListInt", "toListString", "identity"):
        val = [1, 2] if "List" in conv else 3
        assert getattr(pml.TypeConverters, conv)(val) == \
            getattr(jml.TypeConverters, conv)(val), conv


def test_persistence_format_is_the_jax_packages(tmp_path):
    got, want = _Est(), _JEst()
    for obj in (got, want):
        obj._set(depth=5, featuresCol="feats")
    a, b = putil.params_to_json(got), jutil.params_to_json(want)
    a.pop("uid"), b.pop("uid")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    # a cloudpickled value (a callback) crosses both ways
    fn_payload = {"set": {"depth": {"json": 4}},
                  "default": {"labelCol": putil.params_to_json(
                      _with_callable())["set"]["labelCol"]}}
    back = jutil.params_from_json(_JEst(), fn_payload)
    assert back.getOrDefault("depth") == 4
    assert callable(back.getOrDefault("labelCol"))
    # writer and reader
    path = str(tmp_path / "m")

    class Saved(_Est, putil.MLReadable, putil.MLWritable):
        def _save_impl(self, p):
            with open(p + "/x.json", "w") as fh:
                json.dump(putil.params_to_json(self), fh)

        @classmethod
        def _load_impl(cls, p):
            with open(p + "/x.json") as fh:
                return putil.params_from_json(cls(), json.load(fh))

    s = Saved()
    s._set(depth=11)
    s.save(path)
    with pytest.raises(IOError, match="overwrite"):
        s.save(path)
    s.write().overwrite().save(path)
    assert Saved.load(path).getOrDefault("depth") == 11


def _with_callable():
    e = _Est()
    e._paramMap[e.labelCol] = lambda x: x + 1
    return e


def test_dataframe_adapters():
    df = _clf_frame(n=10)
    X = pdf_mod.extract_matrix(df, "features")
    assert X.shape == (10, 4) and X.dtype == np.float32
    np.testing.assert_array_equal(
        pdf_mod.extract_matrix(df, "label"), df[["label"]].to_numpy())
    with pytest.raises(ValueError, match="not found"):
        pdf_mod.extract_matrix(df, "nope")
    assert not pdf_mod.is_spark_df(df)
    assert pdf_mod.to_pandas(df) == (df, None)
    assert pdf_mod.to_output(df, None) is df


# -- the evaluators ------------------------------------------------------------


def _scored(seed=0, n=120):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.4).astype(np.float32)
    score = np.round(y + rng.randn(n), 1)  # rounded: many ties
    return pd.DataFrame({
        "label": y, "prediction": (score > 0.5).astype(np.float32),
        "rawPrediction": [[-s, s] for s in score],
        "target": 2 * score + 0.1 * rng.randn(n)})


@pytest.mark.parametrize("cls,kw", [
    ("BinaryClassificationEvaluator", {}),
    ("BinaryClassificationEvaluator", {"metricName": "areaUnderPR"}),
    ("MulticlassClassificationEvaluator", {}),
    ("MulticlassClassificationEvaluator", {"metricName": "accuracy"}),
    ("RegressionEvaluator", {"predictionCol": "target"}),
    ("RegressionEvaluator", {"predictionCol": "target", "metricName": "r2"}),
    ("RegressionEvaluator", {"predictionCol": "target",
                             "metricName": "mae"}),
])
def test_evaluators_match(cls, kw):
    df = _scored()
    got, want = getattr(pev, cls)(**kw), getattr(jev, cls)(**kw)
    assert got.evaluate(df) == want.evaluate(df)
    assert got(df) == want(df)  # the tuning-callable orientation
    assert got.isLargerBetter() == want.isLargerBetter()
    single = df[df["label"] == 1.0]
    assert got.evaluate(single) == want.evaluate(single)


def test_auc_ties_and_pr_interpolation():
    ties = pd.DataFrame({"label": [0.0, 1.0, 0.0, 1.0],
                         "rawPrediction": [[0.0, 1.0]] * 4})
    assert pev.BinaryClassificationEvaluator().evaluate(ties) == 0.5
    pr = pev.BinaryClassificationEvaluator(metricName="areaUnderPR")
    assert abs(pr.evaluate(ties) - 0.5) < 1e-9
    df = pd.DataFrame({"label": [1.0, 0.0, 1.0, 0.0], "rawPrediction": [
        [0.0, 0.9], [0.0, 0.8], [0.0, 0.7], [0.0, 0.1]]})
    assert abs(pr.evaluate(df) - (0.5 + 0.5 * (0.5 + 2 / 3) / 2)) < 1e-9
    for bad in (pev.BinaryClassificationEvaluator(metricName="logLoss"),
                pev.RegressionEvaluator(metricName="mape"),
                pev.MulticlassClassificationEvaluator(metricName="x")):
        with pytest.raises(ValueError, match="metricName"):
            bad.evaluate(_scored())
    np.testing.assert_array_equal(
        pev._average_ranks(np.array([3.0, 1.0, 3.0, 2.0])),
        jev._average_ranks(np.array([3.0, 1.0, 3.0, 2.0])))


# -- the meta-algorithms over each package's estimators -------------------------


def test_pipeline_fit_transform():
    df = _clf_frame()
    outs = []
    for xgb, mod in ((jx, jpipe), (px, ppipe)):
        model = mod.Pipeline(stages=[xgb.XgboostClassifier(
            n_estimators=6, max_depth=3)]).fit(df)
        assert len(model.getStages()) == 1
        outs.append(model.transform(df))
    assert list(outs[1].columns) == list(outs[0].columns)
    assert (outs[1]["prediction"] == df["label"]).mean() > 0.9
    assert (outs[1]["prediction"] == outs[0]["prediction"]).mean() >= 0.99
    with pytest.raises(TypeError, match="Estimator or Transformer"):
        ppipe.Pipeline(stages=[object()]).fit(df)


def test_param_grid_builder_matches():
    grids = []
    for xgb, mod in ((jx, jpipe), (px, ppipe)):
        clf = xgb.XgboostClassifier()
        grid = (mod.ParamGridBuilder()
                .addGrid(clf.n_estimators, [1, 5])
                .addGrid(clf.max_depth, [2, 3])
                .baseOn({clf.learning_rate: 0.5}).build())
        grids.append([sorted((p.name, v) for p, v in g.items())
                      for g in grid])
    assert grids[0] == grids[1] and len(grids[1]) == 4
    assert ppipe.ParamGridBuilder().build() == [{}]


@pytest.mark.parametrize("over_pipeline", [False, True])
def test_cross_validator_picks_the_jax_choice(over_pipeline):
    df = _clf_frame(n=300)
    results = []
    for xgb, mod in ((jx, jpipe), (px, ppipe)):
        clf = xgb.XgboostClassifier(max_depth=3, n_estimators=8)
        est = mod.Pipeline(stages=[clf]) if over_pipeline else clf
        param = clf.max_depth if over_pipeline else clf.n_estimators
        grid = mod.ParamGridBuilder().addGrid(param, [1, 6] if not
                                              over_pipeline else [1, 3])
        cv = mod.CrossValidator(estimator=est, estimatorParamMaps=grid.build(),
                                evaluator=mod.accuracy_evaluator, numFolds=3)
        model = cv.fit(df)
        results.append((model.bestIndex, model.avgMetrics))
        assert (model.transform(df)["prediction"] == df["label"]).mean() > 0.9
    (jb, jm), (pb, pm) = results
    assert pb == jb
    np.testing.assert_allclose(pm, jm, atol=0.02)
    with pytest.raises(ValueError, match="fold"):
        ppipe.CrossValidator(estimator=px.XgboostClassifier(n_estimators=1),
                             evaluator=ppipe.accuracy_evaluator,
                             numFolds=10).fit(df[:5])


def test_train_validation_split_matches():
    rng = np.random.RandomState(1)
    X = rng.randn(240, 3).astype(np.float32)
    y = 2 * X[:, 0] + 0.05 * rng.randn(240).astype(np.float32)
    df = pd.DataFrame({"features": list(X), "label": y})
    results = []
    for xgb, mod in ((jx, jpipe), (px, ppipe)):
        reg = xgb.XgboostRegressor(max_depth=3)
        grid = mod.ParamGridBuilder().addGrid(reg.n_estimators,
                                              [2, 12]).build()
        model = mod.TrainValidationSplit(
            estimator=reg, estimatorParamMaps=grid,
            evaluator=mod.neg_rmse_evaluator, trainRatio=0.8).fit(df)
        assert model.validationMetrics == model.avgMetrics
        results.append((model.bestIndex, model.validationMetrics))
    assert results[1][0] == results[0][0] == 1
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-3)
    with pytest.raises(ValueError, match="at least 2 rows"):
        ppipe.TrainValidationSplit(estimator=px.XgboostRegressor()).fit(
            df[:1])


@pytest.mark.parametrize("label_col", ["label", "target"])
def test_one_vs_rest_matches(label_col):
    df = _clf_frame(n_classes=3).rename(columns={"label": label_col})
    outs = []
    for xgb, mod in ((jx, jcls), (px, pcls)):
        ovr = mod.OneVsRest(
            classifier=xgb.XgboostClassifier(n_estimators=6, max_depth=3),
            labelCol=label_col)
        model = ovr.fit(df)
        assert len(model.models) == 3
        np.testing.assert_array_equal(model.labels, [0.0, 1.0, 2.0])
        outs.append(model.transform(df))
    acc = (outs[1]["prediction"] == df[label_col]).mean()
    assert acc > 0.9
    assert (outs[1]["prediction"] == outs[0]["prediction"]).mean() >= 0.99
    f1 = pev.MulticlassClassificationEvaluator(
        labelCol=label_col).evaluate(outs[1])
    assert f1 > 0.9
