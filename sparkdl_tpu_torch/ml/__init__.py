"""Minimal PySpark-ML-compatible layer.

The reference builds its estimators on ``pyspark.ml`` base classes
(reference ``xgboost.py:31-35``). pyspark is an *optional* dependency
here (matching the reference's zero-``install_requires`` packaging,
reference ``setup.py:41``), so this package re-exports the real
pyspark.ml classes when pyspark is importable and otherwise provides
API-compatible stand-ins that operate on pandas DataFrames — giving the
same Estimator/Model/Param/persistence surface on a host without Spark.

Counterpart of ``sparkdl_tpu/ml/__init__.py``, copied so that the port
imports nothing of the JAX package.
"""

try:  # pragma: no cover - exercised only on pyspark-equipped clusters
    from pyspark.ml import Estimator, Model, Transformer  # noqa: F401
    from pyspark.ml.param import (  # noqa: F401
        Param,
        Params,
        TypeConverters,
    )
    from pyspark.ml.param.shared import (  # noqa: F401
        HasFeaturesCol,
        HasLabelCol,
        HasPredictionCol,
        HasProbabilityCol,
        HasRawPredictionCol,
        HasValidationIndicatorCol,
        HasWeightCol,
    )
    from pyspark.ml.util import MLReadable, MLWritable  # noqa: F401

    HAVE_PYSPARK = True
except ImportError:
    from sparkdl_tpu_torch.ml.base import (  # noqa: F401
        Estimator,
        Model,
        Transformer,
    )
    from sparkdl_tpu_torch.ml.param import (  # noqa: F401
        Param,
        Params,
        TypeConverters,
    )
    from sparkdl_tpu_torch.ml.shared import (  # noqa: F401
        HasFeaturesCol,
        HasLabelCol,
        HasPredictionCol,
        HasProbabilityCol,
        HasRawPredictionCol,
        HasValidationIndicatorCol,
        HasWeightCol,
    )
    from sparkdl_tpu_torch.ml.util import MLReadable, MLWritable  # noqa: F401

    HAVE_PYSPARK = False
