"""Pipeline and model-selection meta-algorithms.

The reference promises its estimators work "in PySpark Pipeline and
PySpark ML meta algorithms like CrossValidator/TrainValidationSplit"
(reference ``xgboost.py:167-169``). With pyspark installed the real
classes are used (our estimators subclass the real pyspark bases); this
module provides standalone equivalents for hosts without Spark, operating on
pandas DataFrames with the same fit/transform contract.

Counterpart of ``sparkdl_tpu/ml/pipeline.py``, copied so that the port
imports nothing of the JAX package.
"""

import numpy as np

from sparkdl_tpu_torch.ml.base import Estimator, Model, Transformer
from sparkdl_tpu_torch.ml.param import Params


class Pipeline(Estimator):
    """Sequential stages; fit() fits estimators in order, transforming
    the running dataset through each fitted model."""

    def __init__(self, stages=None):
        super().__init__()
        self._stages = list(stages or [])

    def getStages(self):
        return list(self._stages)

    def setStages(self, stages):
        self._stages = list(stages)
        return self

    def copy(self, extra=None):
        # Propagate an extra param map into the STAGES (pyspark
        # Pipeline.copy semantics) — this is what makes grid search
        # over pipeline-stage params work.
        that = super().copy(None)
        that._stages = [
            s.copy(extra) if extra is not None and isinstance(s, Params)
            else s
            for s in self._stages
        ]
        return that

    def _fit(self, dataset):
        fitted = []
        current = dataset
        for stage in self._stages:
            if isinstance(stage, Estimator):
                model = stage.fit(current)
                fitted.append(model)
                current = model.transform(current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                current = stage.transform(current)
            else:
                raise TypeError(
                    f"Pipeline stage must be Estimator or Transformer, "
                    f"got {type(stage).__name__}"
                )
        return PipelineModel(fitted)


class PipelineModel(Model):
    def __init__(self, stages):
        super().__init__()
        self._stages = list(stages)

    def getStages(self):
        return list(self._stages)

    def _transform(self, dataset):
        current = dataset
        for stage in self._stages:
            current = stage.transform(current)
        return current


class ParamGridBuilder:
    """Cartesian parameter grids (pyspark.ml.tuning parity)."""

    def __init__(self):
        self._grid = {}

    def addGrid(self, param, values):
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args):
        for param, value in (
            args[0].items() if args and isinstance(args[0], dict)
            else args
        ):
            self._grid[param] = [value]
        return self

    def build(self):
        import itertools

        keys = list(self._grid)
        combos = []
        for values in itertools.product(*(self._grid[k] for k in keys)):
            combos.append(dict(zip(keys, values)))
        return combos or [{}]


def _eval_columns(estimator):
    """Label/prediction column names for evaluation: taken from the
    estimator when it exposes the params (plain estimators), defaults
    otherwise (e.g. a Pipeline, which has no column params itself)."""
    label, pred = "label", "prediction"
    if isinstance(estimator, Params):
        if estimator.hasParam("labelCol"):
            label = estimator.getOrDefault(estimator.getParam("labelCol"))
        if estimator.hasParam("predictionCol"):
            pred = estimator.getOrDefault(
                estimator.getParam("predictionCol")
            )
    return label, pred


def _fit_and_score(estimator, evaluator, param_map, train, valid):
    """One (param_map, split) evaluation. Param application goes
    through Estimator.fit(dataset, params) → copy(extra), which
    propagates into Pipeline stages."""
    if valid.empty:
        raise ValueError(
            "validation split is empty; use fewer folds or more data"
        )
    model = estimator.fit(train, params=param_map)
    out = model.transform(valid)
    label, pred = _eval_columns(estimator)
    return evaluator(out, label, pred)


class CrossValidator(Estimator):
    """K-fold cross validation over a param grid.

    :param evaluator: ``f(transformed_df, labelCol, predictionCol) ->
        float`` — higher is better (pass e.g.
        :func:`accuracy_evaluator` or :func:`neg_rmse_evaluator`).
    """

    def __init__(self, estimator=None, estimatorParamMaps=None,
                 evaluator=None, numFolds=3, seed=0):
        super().__init__()
        self._estimator = estimator
        self._grid = estimatorParamMaps or [{}]
        self._evaluator = evaluator
        self._num_folds = numFolds
        self._seed = seed

    def _fit(self, dataset):
        n = len(dataset)
        if n < self._num_folds:
            raise ValueError(
                f"{self._num_folds}-fold CV needs at least that many "
                f"rows; got {n}"
            )
        rng = np.random.RandomState(self._seed)
        # permutation-based assignment: folds are balanced, never empty
        fold_of = rng.permutation(n) % self._num_folds
        avg_metrics = []
        for param_map in self._grid:
            scores = [
                _fit_and_score(
                    self._estimator, self._evaluator, param_map,
                    dataset[fold_of != fold].reset_index(drop=True),
                    dataset[fold_of == fold].reset_index(drop=True),
                )
                for fold in range(self._num_folds)
            ]
            avg_metrics.append(float(np.mean(scores)))
        best_idx = int(np.argmax(avg_metrics))
        best_model = self._estimator.fit(
            dataset, params=self._grid[best_idx]
        )
        return CrossValidatorModel(best_model, avg_metrics, best_idx)


class CrossValidatorModel(Model):
    def __init__(self, bestModel, avgMetrics, bestIndex):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics
        self.bestIndex = bestIndex

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)


class TrainValidationSplitModel(CrossValidatorModel):
    @property
    def validationMetrics(self):
        """pyspark.ml.tuning parity alias."""
        return self.avgMetrics


class TrainValidationSplit(Estimator):
    """Single random train/validation split over a param grid."""

    def __init__(self, estimator=None, estimatorParamMaps=None,
                 evaluator=None, trainRatio=0.75, seed=0):
        super().__init__()
        self._estimator = estimator
        self._grid = estimatorParamMaps or [{}]
        self._evaluator = evaluator
        self._ratio = trainRatio
        self._seed = seed

    def _fit(self, dataset):
        n = len(dataset)
        if n < 2:
            raise ValueError("TrainValidationSplit needs at least 2 rows")
        rng = np.random.RandomState(self._seed)
        perm = rng.permutation(n)
        n_val = min(max(1, int(round(n * (1 - self._ratio)))), n - 1)
        is_val = np.zeros(n, bool)
        is_val[perm[:n_val]] = True
        train = dataset[~is_val].reset_index(drop=True)
        valid = dataset[is_val].reset_index(drop=True)
        metrics = [
            _fit_and_score(
                self._estimator, self._evaluator, pm, train, valid
            )
            for pm in self._grid
        ]
        best_idx = int(np.argmax(metrics))
        return TrainValidationSplitModel(
            self._estimator.fit(dataset, params=self._grid[best_idx]),
            metrics, best_idx,
        )


# -- evaluator shorthands (delegate to sparkdl_tpu_torch.ml.evaluation) ---


def accuracy_evaluator(df, label_col, prediction_col):
    from sparkdl_tpu_torch.ml.evaluation import (
        MulticlassClassificationEvaluator,
    )

    return MulticlassClassificationEvaluator(
        labelCol=label_col, predictionCol=prediction_col,
        metricName="accuracy",
    ).evaluate(df)


def neg_rmse_evaluator(df, label_col, prediction_col):
    from sparkdl_tpu_torch.ml.evaluation import RegressionEvaluator

    return -RegressionEvaluator(
        labelCol=label_col, predictionCol=prediction_col,
    ).evaluate(df)
