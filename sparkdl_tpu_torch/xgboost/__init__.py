"""Gradient-boosted-tree estimators (reference
``sparkdl/xgboost/__init__.py:19-23`` public surface).

Counterpart of ``sparkdl_tpu/xgboost/__init__.py``. :data:`DEVICE` is
the estimators' device, a module setting read at call time on the
driver (the Param surface is the JAX package's, which has no device
Param): None trains and predicts on the card (a gang rank on its bound
device) and raises without one; ``"cpu"`` runs on the CPU.
"""

# the estimators' device (None: the card, or a gang rank's bound device)
DEVICE = None

from sparkdl_tpu_torch.xgboost.xgboost import (  # noqa: E402
    XgboostClassifier,
    XgboostClassifierModel,
    XgboostRegressor,
    XgboostRegressorModel,
)

__all__ = [
    "DEVICE",
    "XgboostClassifier",
    "XgboostClassifierModel",
    "XgboostRegressor",
    "XgboostRegressorModel",
]
