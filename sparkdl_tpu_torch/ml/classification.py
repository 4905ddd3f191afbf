"""OneVsRest meta-classifier (the third meta-algorithm the reference
names, ``xgboost.py:167-169``): fits one binary classifier per class
and predicts by the largest positive-class margin.

Counterpart of ``sparkdl_tpu/ml/classification.py``, copied so that the port
imports nothing of the JAX package.
"""

import numpy as np

from sparkdl_tpu_torch.ml.base import Estimator, Model


class OneVsRest(Estimator):
    def __init__(self, classifier=None, labelCol="label",
                 predictionCol="prediction"):
        super().__init__()
        self._classifier = classifier
        self._label_col = labelCol
        self._prediction_col = predictionCol

    def _fit(self, dataset):
        labels = np.sort(dataset[self._label_col].unique())
        models = []
        for cls in labels:
            binarized = dataset.copy()
            binarized[self._label_col] = (
                dataset[self._label_col] == cls
            ).astype(np.float32)
            sub = self._classifier.copy()
            # propagate column config into the sub-classifier (pyspark
            # OneVsRest semantics) — without this a non-default
            # labelCol would silently train on the wrong column
            if sub.hasParam("labelCol"):
                sub._set(labelCol=self._label_col)
            if sub.hasParam("predictionCol"):
                sub._set(predictionCol=self._prediction_col)
            models.append(sub.fit(binarized))
        return OneVsRestModel(
            models, labels, self._label_col, self._prediction_col
        )


class OneVsRestModel(Model):
    def __init__(self, models, labels, label_col, prediction_col):
        super().__init__()
        self.models = models
        self.labels = labels
        self._label_col = label_col
        self._prediction_col = prediction_col

    def _transform(self, dataset):
        out = dataset.copy()
        margins = []
        for model in self.models:
            scored = model.transform(dataset)
            raw_col = model.getOrDefault(model.getParam("rawPredictionCol"))
            # positive-class margin from each binary model
            margins.append(
                np.stack(scored[raw_col].to_numpy())[:, 1]
            )
        margins = np.stack(margins, axis=1)        # (n, n_classes)
        out[self._prediction_col] = self.labels[
            margins.argmax(axis=1)
        ].astype(np.float64)
        return out
