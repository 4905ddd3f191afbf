"""Shared column-param mixins mirroring ``pyspark.ml.param.shared``
(the traits the reference's estimators mix in, reference
``xgboost.py:32-33``).

Counterpart of ``sparkdl_tpu/ml/shared.py``, copied so that the port
imports nothing of the JAX package.
"""

from sparkdl_tpu_torch.ml.param import Param, Params, TypeConverters


class HasFeaturesCol(Params):
    featuresCol = Param(
        Params._dummy(), "featuresCol", "features column name.",
        typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(featuresCol="features")

    def getFeaturesCol(self):
        return self.getOrDefault(self.featuresCol)


class HasLabelCol(Params):
    labelCol = Param(
        Params._dummy(), "labelCol", "label column name.",
        typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(labelCol="label")

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)


class HasWeightCol(Params):
    weightCol = Param(
        Params._dummy(), "weightCol",
        "weight column name. If this is not set or empty, we treat all "
        "instance weights as 1.0.",
        typeConverter=TypeConverters.toString)

    def getWeightCol(self):
        return self.getOrDefault(self.weightCol)


class HasPredictionCol(Params):
    predictionCol = Param(
        Params._dummy(), "predictionCol", "prediction column name.",
        typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(predictionCol="prediction")

    def getPredictionCol(self):
        return self.getOrDefault(self.predictionCol)


class HasProbabilityCol(Params):
    probabilityCol = Param(
        Params._dummy(), "probabilityCol",
        "Column name for predicted class conditional probabilities.",
        typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(probabilityCol="probability")

    def getProbabilityCol(self):
        return self.getOrDefault(self.probabilityCol)


class HasRawPredictionCol(Params):
    rawPredictionCol = Param(
        Params._dummy(), "rawPredictionCol",
        "raw prediction (a.k.a. confidence) column name.",
        typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(rawPredictionCol="rawPrediction")

    def getRawPredictionCol(self):
        return self.getOrDefault(self.rawPredictionCol)


class HasValidationIndicatorCol(Params):
    validationIndicatorCol = Param(
        Params._dummy(), "validationIndicatorCol",
        "name of the column that indicates whether each row is for "
        "training or for validation. False indicates training; true "
        "indicates validation.",
        typeConverter=TypeConverters.toString)

    def getValidationIndicatorCol(self):
        return self.getOrDefault(self.validationIndicatorCol)
