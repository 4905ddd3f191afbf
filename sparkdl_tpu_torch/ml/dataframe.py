"""DataFrame adapters: the estimators accept pandas DataFrames natively
and PySpark DataFrames when pyspark is present (reference input type,
``xgboost.py:225-234``).

Counterpart of ``sparkdl_tpu/ml/dataframe.py``, copied so that the port
imports nothing of the JAX package.
"""

import numpy as np


def is_spark_df(dataset):
    mod = type(dataset).__module__
    return mod.startswith("pyspark.")


def to_pandas(dataset):
    if is_spark_df(dataset):
        import pandas as pd  # noqa: F401

        pdf = dataset.toPandas()
        return pdf, dataset
    return dataset, None


def extract_matrix(pdf, col):
    """Column of vectors/lists (Spark Vector cells included) or a
    scalar column → (n, f) float32 matrix. Sparse vector semantics
    follow the reference contract: inactive slots mean 0, not missing
    (reference ``xgboost.py:44-47``)."""
    if col not in pdf.columns:
        raise ValueError(
            f"Column {col!r} not found in dataset columns {list(pdf.columns)}"
        )
    series = pdf[col]
    first = series.iloc[0]
    if np.isscalar(first):
        return series.to_numpy(np.float32).reshape(-1, 1)
    if hasattr(first, "toArray"):  # pyspark.ml.linalg.Vector
        return np.stack([v.toArray() for v in series]).astype(np.float32)
    return np.stack([np.asarray(v, np.float32) for v in series])


def to_output(pdf, spark_template):
    """Return the transformed frame in the caller's dialect."""
    if spark_template is not None:
        return spark_template.sparkSession.createDataFrame(pdf)
    return pdf
