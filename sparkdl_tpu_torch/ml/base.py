"""Estimator/Model/Transformer bases mirroring ``pyspark.ml``
(reference ``xgboost.py:31``), operating on pandas DataFrames when
pyspark is absent.

Counterpart of ``sparkdl_tpu/ml/base.py``, copied so that the port
imports nothing of the JAX package.
"""

from sparkdl_tpu_torch.ml.param import Params


class Transformer(Params):
    def transform(self, dataset, params=None):
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    def _transform(self, dataset):
        raise NotImplementedError


class Estimator(Params):
    def fit(self, dataset, params=None):
        if isinstance(params, (list, tuple)):
            return [self.fit(dataset, p) for p in params]
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def _fit(self, dataset):
        raise NotImplementedError


class Model(Transformer):
    pass
