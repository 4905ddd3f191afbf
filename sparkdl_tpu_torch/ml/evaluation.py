"""Evaluators with pyspark.ml.evaluation-style surface, usable both as
objects (``ev.evaluate(df)``) and as the callables the tuning
meta-algorithms accept.

Counterpart of ``sparkdl_tpu/ml/evaluation.py``, copied so that the port
imports nothing of the JAX package.
"""

import numpy as np

from sparkdl_tpu_torch.ml.param import Params


class _Evaluator(Params):
    def __init__(self, labelCol="label", predictionCol="prediction",
                 metricName=None):
        super().__init__()
        self.labelCol = labelCol
        self.predictionCol = predictionCol
        if metricName is not None:
            self.metricName = metricName

    def evaluate(self, dataset):
        return self._metric(
            dataset[self.labelCol].to_numpy(),
            dataset[self.predictionCol].to_numpy(),
        )

    # tuning-callable form: f(df, label_col, prediction_col) -> float,
    # higher is better
    def __call__(self, dataset, label_col=None, prediction_col=None):
        y = dataset[label_col or self.labelCol].to_numpy()
        p = dataset[prediction_col or self.predictionCol].to_numpy()
        v = self._metric(y, p)
        return v if self.isLargerBetter() else -v

    def isLargerBetter(self):
        return True


class MulticlassClassificationEvaluator(_Evaluator):
    # pyspark's default metric is "f1" (support-weighted)
    metricName = "f1"

    def _metric(self, y, p):
        if self.metricName == "accuracy":
            return float((y == p).mean())
        if self.metricName == "f1":
            # support-weighted F1 over label classes (pyspark semantics)
            classes, supports = np.unique(y, return_counts=True)
            f1s = []
            for c in classes:
                tp = float(((p == c) & (y == c)).sum())
                fp = float(((p == c) & (y != c)).sum())
                fn = float(((p != c) & (y == c)).sum())
                denom = 2 * tp + fp + fn
                f1s.append(2 * tp / denom if denom else 0.0)
            return float(np.average(f1s, weights=supports))
        raise ValueError(f"unknown metricName {self.metricName!r}")


def _average_ranks(scores):
    """Ranks 1..n with ties receiving their average rank."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks within tie groups
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    return ranks


class BinaryClassificationEvaluator(_Evaluator):
    """areaUnderROC (default) or areaUnderPR over the rawPrediction
    margin, as in pyspark."""

    metricName = "areaUnderROC"

    def __init__(self, labelCol="label", rawPredictionCol="rawPrediction",
                 metricName=None):
        super().__init__(labelCol=labelCol, predictionCol=rawPredictionCol,
                         metricName=metricName)

    def __call__(self, dataset, label_col=None, prediction_col=None):
        # This evaluator is margin-based: IGNORE the tuning harness's
        # prediction-column override (it would hand us hard 0/1 labels
        # and degenerate the ranking metric).
        y = dataset[label_col or self.labelCol].to_numpy()
        raw = dataset[self.predictionCol].to_numpy()
        return self._metric(y, raw)

    def _metric(self, y, raw):
        if self.metricName not in ("areaUnderROC", "areaUnderPR"):
            raise ValueError(f"unknown metricName {self.metricName!r}")
        # raw column holds margin vectors [neg, pos]; use pos margin
        scores = np.asarray(
            [r[1] if np.ndim(r) else r for r in raw], np.float64
        )
        pos_mask = y == 1
        n_pos, n_neg = int(pos_mask.sum()), int((~pos_mask).sum())
        if n_pos == 0 or n_neg == 0:
            return 0.5
        if self.metricName == "areaUnderROC":
            ranks = _average_ranks(scores)  # tie-averaged Mann-Whitney
            r_pos = ranks[pos_mask].sum()
            return float(
                (r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
            )
        # areaUnderPR per pyspark's BinaryClassificationMetrics: the PR
        # curve has one point per DISTINCT threshold (ties grouped),
        # prepended with (recall=0, precision of the first point), and
        # the area is the trapezoidal (linear) integral — average
        # precision would diverge from pyspark on small/tied data.
        order = np.argsort(-scores, kind="mergesort")
        y_sorted = y[order]
        s_sorted = scores[order]
        tp = np.cumsum(y_sorted == 1)
        n = len(y)
        # last index of each tied-score group = the curve's points
        boundary = np.nonzero(
            np.append(s_sorted[1:] != s_sorted[:-1], True)
        )[0]
        tp_b = tp[boundary]
        recall = tp_b / n_pos
        precision = tp_b / (boundary + 1.0)
        recall = np.concatenate([[0.0], recall])
        precision = np.concatenate([[precision[0]], precision])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # np<2.0
        return float(trapezoid(precision, recall))


class RegressionEvaluator(_Evaluator):
    metricName = "rmse"

    def _metric(self, y, p):
        err = p.astype(np.float64) - y.astype(np.float64)
        if self.metricName == "rmse":
            return float(np.sqrt(np.mean(err ** 2)))
        if self.metricName == "mae":
            return float(np.abs(err).mean())
        if self.metricName == "r2":
            ss_res = float((err ** 2).sum())
            ss_tot = float(((y - y.mean()) ** 2).sum())
            return 1.0 - ss_res / ss_tot if ss_tot else 0.0
        raise ValueError(f"unknown metricName {self.metricName!r}")

    def isLargerBetter(self):
        return self.metricName == "r2"
