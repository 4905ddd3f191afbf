"""Gradient-boosted-tree estimators with the reference's public surface.

Real implementations of the reference's all-stub estimator module
(reference ``sparkdl/xgboost/xgboost.py`` — every constructor and method
there raises NotImplementedError; the docstrings define the contract).
The param surface reproduces reference ``xgboost.py:38-106`` including
the renamed-param contract (SURVEY.md §5.6): ``use_gpu`` not ``gpu_id``
(``:258``), ``baseMarginCol`` not ``base_margin`` (``:261-262``),
``weightCol`` not ``sample_weight`` (``:282-285``),
``validationIndicatorCol`` not ``eval_set`` (``:277-281``), and
``missing`` with sparse-vector semantics (``:41-47``).

Counterpart of ``sparkdl_tpu/xgboost/xgboost.py``: the same Params,
defaults, blocked params and their hints, ignored-param warnings, and
keyword-only constructors. The training engine is the histogram GBDT of
:mod:`sparkdl_tpu_torch.xgboost.booster` on the card; with
``num_workers > 1`` training runs as a HorovodRunner gang whose
per-level histogram all-reduce rides the gang's ``hvd.allreduce`` (the
Rabit replacement): rows sharded on the driver into
``launch_gang(per_rank_kwargs=)`` for a pandas input, each Spark
partition's rows on its own barrier task for a Spark DataFrame.

The JAX package's environment knobs are module settings here, read at
call time: :data:`STRICT_SLOTS` (``SPARKDL_TPU_XGB_STRICT_SLOTS``) and
:data:`VAL_GATHER_WARN_BYTES` (``SPARKDL_TPU_VAL_GATHER_WARN_BYTES``,
read on the driver and shipped to the ranks). The Param surface is the
JAX package's, so there is no device Param: the device is the package's
setting ``sparkdl_tpu_torch.xgboost.DEVICE`` (None: the card, or a gang
rank's bound device; ``"cpu"``), read on the driver and carried to the
ranks and, in the transform's closure, to the Spark executors.
"""

import functools
import json
import logging
import os

import numpy as np

from sparkdl_tpu_torch.ml import (
    Estimator,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasValidationIndicatorCol,
    HasWeightCol,
    MLReadable,
    MLWritable,
    Model,
    Param,
    Params,
    TypeConverters,
)
from sparkdl_tpu_torch.ml.dataframe import (
    extract_matrix,
    to_output,
    to_pandas,
)
from sparkdl_tpu_torch.ml.util import params_from_json, params_to_json
from sparkdl_tpu_torch.xgboost import booster as _booster_mod

logger = logging.getLogger("sparkdl.xgboost")

# SPARKDL_TPU_XGB_STRICT_SLOTS: num_workers beyond the task slots fails
# instead of falling back to an oversubscribed local gang
STRICT_SLOTS = False
# SPARKDL_TPU_VAL_GATHER_WARN_BYTES: the partition-resident fit warns when
# gathering the validation rows to every worker passes this many bytes
VAL_GATHER_WARN_BYTES = 256 << 20


def _device_setting():
    """``sparkdl_tpu_torch.xgboost.DEVICE``, read at call time."""
    import sparkdl_tpu_torch.xgboost as pkg

    return pkg.DEVICE

# Booster hyper-parameters auto-supported in the constructors — the
# analogue of "automatically supports most of the parameters in
# `xgboost.XGBClassifier`" (reference xgboost.py:253-256). Each becomes
# a discoverable Param (reference xgboost.py:304-305).
_BOOSTER_PARAM_DEFS = {
    "n_estimators": (100, TypeConverters.toInt, "number of boosting rounds."),
    "max_depth": (6, TypeConverters.toInt, "maximum tree depth."),
    "learning_rate": (0.3, TypeConverters.toFloat,
                      "boosting learning rate (eta)."),
    "objective": (None, TypeConverters.toString,
                  "learning objective: reg:squarederror, binary:logistic "
                  "or multi:softprob."),
    "reg_lambda": (1.0, TypeConverters.toFloat, "L2 regularization term."),
    "reg_alpha": (0.0, TypeConverters.toFloat, "L1 regularization term."),
    "gamma": (0.0, TypeConverters.toFloat,
              "minimum loss reduction required to make a split."),
    "min_child_weight": (1.0, TypeConverters.toFloat,
                         "minimum sum of instance hessian in a child."),
    "subsample": (1.0, TypeConverters.toFloat,
                  "row subsample ratio per boosting round."),
    "colsample_bytree": (1.0, TypeConverters.toFloat,
                         "feature subsample ratio per tree."),
    "max_bin": (256, TypeConverters.toInt,
                "number of histogram bins for the hist tree method."),
    "tree_method": ("hist", TypeConverters.toString,
                    "tree construction algorithm; this implementation "
                    "always uses the histogram method."),
    "random_state": (0, TypeConverters.toInt, "random seed."),
    "monotone_constraints": (None, TypeConverters.identity,
                             "per-feature monotonicity: tuple/str/dict "
                             "of {-1, 0, 1} (xgboost semantics); the "
                             "trained forest is monotone in each "
                             "constrained feature."),
    "num_class": (None, TypeConverters.toInt,
                  "number of classes for multi:softprob."),
    "eval_metric": (None, TypeConverters.toString,
                    "metric for the validation set: rmse, logloss, "
                    "mlogloss or error."),
    "early_stopping_rounds": (None, TypeConverters.toInt,
                              "stop when the validation metric has not "
                              "improved for this many rounds."),
    "verbose_eval": (False, TypeConverters.toBoolean,
                     "print the validation metric each round."),
    "xgb_model": (None, TypeConverters.identity,
                  "a Booster to continue training from (the value "
                  "returned by model.get_booster())."),
    "scale_pos_weight": (1.0, TypeConverters.toFloat,
                         "weight multiplier for positive-class rows "
                         "(binary objectives)."),
    "base_score": (None, TypeConverters.toFloat,
                   "initial prediction: a probability for logistic "
                   "objectives, a raw value otherwise."),
}

# xgboost.XGBClassifier params that have no effect on this runtime
# (threading/GPU/booster-variant knobs): accepted with a warning, so
# mains written against xgboost's sklearn API run unmodified — the
# "automatically supports most of the parameters" posture (reference
# xgboost.py:253-256) without silently absorbing typos.
_IGNORED_PARAMS = {
    "n_jobs", "nthread", "verbosity", "silent", "booster",
    "enable_categorical", "max_cat_to_onehot", "predictor",
    "sampling_method", "interaction_constraints",
    "importance_type", "device", "grow_policy", "max_leaves",
    "colsample_bylevel", "colsample_bynode", "max_delta_step",
}

# Params the reference explicitly rejects, with the replacement the user
# should use instead (reference xgboost.py:176-182, :258-267).
_BLOCKED_PARAMS = {
    "gpu_id": "use_gpu",
    "base_margin": "baseMarginCol",
    "base_margin_eval_set": "baseMarginCol",
    "sample_weight": "weightCol",
    "sample_weight_eval_set": "weightCol",
    "eval_set": "validationIndicatorCol",
    "output_margin": "rawPredictionCol (margins are always emitted there)",
    "validate_features": None,
}


class _XgboostParams(HasFeaturesCol, HasLabelCol, HasWeightCol,
                     HasPredictionCol, HasValidationIndicatorCol):
    """Shared Param surface (reference ``xgboost.py:38-106``)."""

    missing = Param(
        Params._dummy(), "missing",
        "the value to treat as missing in the features, default np.nan. "
        "Using 0.0 as the missing value performs better. Note that in a "
        "Spark DataFrame the inactive slots of a sparse vector mean 0, "
        "not missing, unless missing=0 is set. "
        "(Contract: reference xgboost.py:41-47.)")

    callbacks = Param(
        Params._dummy(), "callbacks",
        "arbitrary training callback functions, invoked each boosting "
        "round. Saved with cloudpickle, which is not fully "
        "self-contained: loading may fail under different dependency "
        "versions. (Contract: reference xgboost.py:49-56.)")

    num_workers = Param(
        Params._dummy(), "num_workers",
        "number of boosting workers; each worker corresponds to one "
        "task slot / CUDA card, and histogram reduction runs over the "
        "same collectives as deep-learning training. (Contract: "
        "reference xgboost.py:58-64.)",
        typeConverter=TypeConverters.toInt)

    use_gpu = Param(
        Params._dummy(), "use_gpu",
        "accepted for API compatibility (reference xgboost.py:65-71); "
        "this runtime trains on the card (the module setting "
        "sparkdl_tpu_torch.xgboost.DEVICE), so the flag is a no-op.")

    force_repartition = Param(
        Params._dummy(), "force_repartition",
        "force the input rows to be reshuffled across workers before "
        "training rather than trusting the existing partitioning. "
        "(Contract: reference xgboost.py:72-80.)")

    use_external_storage = Param(
        Params._dummy(), "use_external_storage",
        "spill the training matrix to disk (memory-mapped) for "
        "exceptionally large datasets; values are rounded to "
        "external_storage_precision digits, trading precision for "
        "memory. baseMarginCol and weightCol are unsupported in this "
        "mode. (Contract: reference xgboost.py:81-97.)")

    external_storage_precision = Param(
        Params._dummy(), "external_storage_precision",
        "significant digits kept when spilling features to disk. "
        "(Contract: reference xgboost.py:91-97.)",
        typeConverter=TypeConverters.toInt)

    baseMarginCol = Param(
        Params._dummy(), "baseMarginCol",
        "column holding per-row base margins for training and "
        "validation; use this instead of base_margin / "
        "base_margin_eval_set fit-method params. Not available for "
        "distributed training. (Contract: reference xgboost.py:99-106.)")

    def __init__(self):
        super().__init__()
        self._setDefault(
            missing=float("nan"), num_workers=1, use_gpu=False,
            force_repartition=False, use_external_storage=False,
            external_storage_precision=5,
        )
        for name, (default, conv, doc) in _BOOSTER_PARAM_DEFS.items():
            p = Param(self, name, doc + " (passed through to the "
                      "histogram booster)", conv)
            setattr(self, name, p)
            self._defaultParamMap[p] = default

    # -- shared estimator plumbing -----------------------------------------

    def _apply_kwargs(self, kwargs):
        for k, v in kwargs.items():
            if k in _BLOCKED_PARAMS:
                repl = _BLOCKED_PARAMS[k]
                hint = f"; use {repl} instead" if repl else ""
                raise ValueError(
                    f"Param {k!r} is not supported (reference contract"
                    f"{hint})."
                )
            if k in _IGNORED_PARAMS:
                logger.warning(
                    "Param %r has no effect on this booster and is "
                    "ignored.", k,
                )
                continue
            if not self.hasParam(k):
                raise ValueError(
                    f"Unknown param {k!r}. Discoverable params are the "
                    "entries with Param(parent=...) on this class."
                )
            if v is not None:
                self._set(**{k: v})

    def _booster_params(self, n_classes):
        p = {}
        for name in _BOOSTER_PARAM_DEFS:
            if name in ("verbose_eval", "early_stopping_rounds", "xgb_model"):
                continue
            v = self.getOrDefault(self.getParam(name))
            if v is not None:
                p[name] = v
        p["missing"] = self.getOrDefault(self.missing)
        if self._is_classifier():
            if n_classes > 2:
                p["objective"] = p.get("objective") or "multi:softprob"
                p["num_class"] = n_classes
            else:
                p["objective"] = p.get("objective") or "binary:logistic"
                p["num_class"] = 2
        else:
            p["objective"] = p.get("objective") or "reg:squarederror"
            p.pop("num_class", None)
        p.pop("tree_method", None)  # hist is the only method
        return p

    def _is_classifier(self):
        raise NotImplementedError


def _fit_booster(params, X, y, w, base_margin, X_val, y_val,
                 early_stopping_rounds, verbose_eval, callbacks,
                 xgb_model, num_workers, force_repartition):
    """Single-process or gang-distributed booster training, on the
    device the driver's ``xgboost.DEVICE`` names."""
    device = _device_setting()
    eval_set = [(X_val, y_val)] if X_val is not None and len(X_val) else None
    if num_workers <= 1:
        return _booster_mod.train(
            params, X, y, sample_weight=w, base_margin=base_margin,
            eval_set=eval_set, early_stopping_rounds=early_stopping_rounds,
            verbose_eval=verbose_eval, callbacks=callbacks,
            xgb_model=xgb_model, device=device,
        )

    if base_margin is not None:
        # Contract: baseMarginCol "is not available for distributed
        # training" (reference xgboost.py:102-105).
        raise ValueError(
            "baseMarginCol is not available for distributed training "
            "(num_workers > 1)."
        )

    def gang_main(params, X, y, w, eval_set, esr, verbose, callbacks,
                  xgb_model, device):
        from sparkdl_tpu_torch import hvd
        from sparkdl_tpu_torch.xgboost import booster as B

        hvd.init()
        rank = hvd.rank()

        def hist_reduce(a):
            return hvd.allreduce(a, op=hvd.Sum)

        bst = B.train(
            params, X, y, sample_weight=w,
            eval_set=eval_set, early_stopping_rounds=esr,
            verbose_eval=verbose and rank == 0,
            hist_reduce=hist_reduce, callbacks=callbacks,
            xgb_model=xgb_model, device=device,
        )
        return bst if rank == 0 else None

    # Shard rows on the driver so each worker's payload carries ONLY its
    # shard (the eval set stays replicated: every worker must compute
    # the identical metric for deterministic early stopping).
    idx = np.arange(len(X))
    if force_repartition:
        # force_repartition: deterministic reshuffle so every worker
        # gets an unbiased shard (reference xgboost.py:72-80).
        np.random.RandomState(0).shuffle(idx)
    shards = np.array_split(idx, num_workers)
    per_rank = [
        {"X": X[s], "y": y[s], "w": None if w is None else w[s]}
        for s in shards
    ]

    from sparkdl_tpu_torch.horovod.launcher import (
        available_slots,
        launch_gang,
    )

    # One boosting worker per task slot (reference xgboost.py:58-64):
    # one a slot when the slots exist, a local subprocess gang otherwise.
    # The fallback oversubscribes the host, so it is never silent, and
    # STRICT_SLOTS turns it into the fail-fast of HorovodRunner(np>0).
    # (The port counts its slots without a subprocess: the JAX package's
    # SlotProbeError has no counterpart.)
    slots = available_slots()
    if slots >= num_workers:
        np_arg = num_workers
    elif STRICT_SLOTS:
        raise RuntimeError(
            f"num_workers={num_workers} exceeds the {slots} available "
            "task slots and xgboost.xgboost.STRICT_SLOTS forbids "
            "the oversubscribed local fallback (reference "
            "xgboost.py:58-64)."
        )
    else:
        logger.warning(
            "num_workers=%d exceeds the %d available task slots; "
            "training falls back to %d OVERSUBSCRIBED local "
            "subprocess workers (slower, same result). Set "
            "xgboost.xgboost.STRICT_SLOTS = True to fail fast instead.",
            num_workers, slots, num_workers,
        )
        np_arg = -num_workers
    return launch_gang(
        np=np_arg, main=gang_main,
        kwargs=dict(
            params=params, X=None, y=None, w=None, eval_set=eval_set,
            esr=early_stopping_rounds, verbose=verbose_eval,
            callbacks=callbacks, xgb_model=xgb_model, device=device,
        ),
        driver_log_verbosity="log_callback_only",
        per_rank_kwargs=per_rank,
    )


def _partition_gang_main(partition_pdf, params, colspec, esr, verbose,
                         callbacks, xgb_model, use_external_storage,
                         storage_precision, device=None, warn_bytes=None):
    """Executor-side estimator worker: trains on the rows of THIS
    barrier task's partition only (reference ``xgboost.py:58-64`` —
    each worker trains on its partition-resident data; nothing is
    collected to the driver). ``device`` and ``warn_bytes`` (None:
    :data:`VAL_GATHER_WARN_BYTES` of this process) are the driver's."""
    import numpy as np

    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.ml.dataframe import extract_matrix
    from sparkdl_tpu_torch.xgboost import booster as B

    hvd.init()  # idempotent: the barrier bootstrap already rendezvoused
    rank = hvd.rank()
    n_rows = 0 if partition_pdf is None else len(partition_pdf)
    # Fast-fail on skew, SYMMETRICALLY: every rank reports its row
    # count through one tiny allgather BEFORE any data-dependent
    # collective, so an empty partition aborts the whole gang at once.
    # (The naive alternative — the empty rank raising unilaterally —
    # leaves its peers blocked in the histogram allreduce until the
    # control plane tears the gang down: a slow, timeout-shaped
    # failure instead of an immediate typed one.)
    counts = hvd.allgather(np.array([[n_rows]], np.int64))[:, 0]
    if (counts == 0).any():
        empty = [int(r) for r in np.nonzero(counts == 0)[0]]
        raise ValueError(
            f"empty input partition(s) at rank(s) {empty} (fewer rows "
            f"than num_workers, or skewed partitioning) — lower "
            f"num_workers or set force_repartition=True"
        )
    X = extract_matrix(partition_pdf, colspec["features"])
    y = partition_pdf[colspec["label"]].to_numpy(np.float32)
    w = (partition_pdf[colspec["weight"]].to_numpy(np.float32)
         if colspec.get("weight") else None)
    eval_set = None
    if colspec.get("val"):
        mask = partition_pdf[colspec["val"]].to_numpy(bool)
        X_val, y_val = X[mask], y[mask]
        X, y = X[~mask], y[~mask]
        if w is not None:
            w = w[~mask]
        # Early stopping is deterministic only if every worker scores
        # the IDENTICAL validation set — gather the per-partition val
        # rows across the gang (training rows stay partition-resident).
        # Guard rail: the gather replicates the val set num_workers×,
        # on the very path built for exceptionally large datasets
        # (reference xgboost.py:81-97) — warn before it gets expensive.
        if warn_bytes is None:
            warn_bytes = VAL_GATHER_WARN_BYTES
        # float64, as in the JAX package (whose collective would wrap a
        # >2 GiB int total to 32 bits; torch keeps either)
        total_val = int(hvd.allreduce(
            np.array([float(X_val.nbytes + y_val.nbytes)], np.float64),
            op=hvd.Sum)[0])
        if total_val * hvd.size() > warn_bytes:
            logger.warning(
                "validationIndicatorCol selects ~%.1f MB of rows; "
                "gathering them to all %d workers replicates ~%.1f MB "
                "for deterministic early stopping. Shrink the "
                "validation fraction, or raise "
                "xgboost.xgboost.VAL_GATHER_WARN_BYTES to silence this.",
                total_val / 2**20, hvd.size(),
                total_val * hvd.size() / 2**20,
            )
        X_val = hvd.allgather(X_val)
        y_val = hvd.allgather(y_val)
        eval_set = [(X_val, y_val)] if len(X_val) else None
    if use_external_storage:
        # Spill executor-side: each worker memory-maps only its own
        # shard (reference xgboost.py:81-97 — this is the path the
        # driver-collect design could never reach at scale).
        import tempfile

        spill = os.path.join(
            tempfile.mkdtemp(prefix="sparkdl-xgb-spill-"), "X.npy"
        )
        np.save(spill, np.round(X, storage_precision).astype(np.float32))
        X = np.load(spill, mmap_mode="r")

    bst = B.train(
        params, np.asarray(X), y, sample_weight=w, eval_set=eval_set,
        early_stopping_rounds=esr, verbose_eval=verbose and rank == 0,
        hist_reduce=lambda a: hvd.allreduce(a, op=hvd.Sum),
        callbacks=callbacks, xgb_model=xgb_model, device=device,
    )
    return bst if rank == 0 else None


class _XgboostEstimator(Estimator, _XgboostParams, MLReadable, MLWritable):
    """Shared fit/persistence (real versions of reference
    ``xgboost.py:109-122``)."""

    def __init__(self, **kwargs):
        super().__init__()
        self._apply_kwargs(kwargs)

    def _resolve_columns(self, pdf):
        X = extract_matrix(pdf, self.getFeaturesCol())
        y = pdf[self.getLabelCol()].to_numpy(np.float32)
        w = None
        if self.isDefined(self.weightCol) and self.getOrDefault(self.weightCol):
            w = pdf[self.getOrDefault(self.weightCol)].to_numpy(np.float32)
        bm = None
        if self.isDefined(self.baseMarginCol) and self.getOrDefault(self.baseMarginCol):
            bm = pdf[self.getOrDefault(self.baseMarginCol)].to_numpy(np.float32)
        val_mask = None
        if (self.isDefined(self.validationIndicatorCol)
                and self.getOrDefault(self.validationIndicatorCol)):
            val_mask = pdf[
                self.getOrDefault(self.validationIndicatorCol)
            ].to_numpy(bool)
        return X, y, w, bm, val_mask

    def _fit_partitioned_on_spark(self, dataset, num_workers):
        """Distributed fit over partition-resident executor data;
        returns None (caller falls back to the driver-collect path)
        when no Spark backend is live."""
        try:
            from sparkdl_tpu_torch.horovod.spark_backend import (
                maybe_launch_estimator_on_spark,
            )
        except ImportError:
            return None

        if (self.isDefined(self.baseMarginCol)
                and self.getOrDefault(self.baseMarginCol)):
            raise ValueError(
                "baseMarginCol is not available for distributed training "
                "(num_workers > 1)."
            )
        weight = (self.getOrDefault(self.weightCol)
                  if self.isDefined(self.weightCol) else None)
        if self.getOrDefault(self.use_external_storage) and weight:
            raise ValueError(
                "weightCol/baseMarginCol do not work with "
                "use_external_storage=True (reference xgboost.py:87)."
            )

        n_classes = 0
        if self._is_classifier():
            # Label cardinality via a distributed distinct — k values
            # reach the driver, never the dataset.
            label_col = self.getLabelCol()
            vals = np.asarray(
                [r[0] for r in dataset.select(label_col).distinct().collect()
                 if r[0] is not None],
                np.float32,
            )
            labels = np.unique(vals[~np.isnan(vals)])
            n_classes = int(labels.size)
            expected = np.arange(n_classes, dtype=labels.dtype)
            if n_classes < 2 or not np.array_equal(labels, expected):
                raise ValueError(
                    "XgboostClassifier requires integer labels "
                    f"0..k-1 with k>=2; got label values {labels.tolist()}"
                )

        colspec = {
            "features": self.getFeaturesCol(),
            "label": self.getLabelCol(),
            "weight": weight,
            "val": (self.getOrDefault(self.validationIndicatorCol)
                    if self.isDefined(self.validationIndicatorCol) else None),
        }
        result = maybe_launch_estimator_on_spark(
            dataset, num_workers, _partition_gang_main,
            kwargs=dict(
                params=self._booster_params(n_classes),
                colspec=colspec,
                esr=self.getOrDefault(self.early_stopping_rounds),
                verbose=self.getOrDefault(self.verbose_eval),
                callbacks=(self.getOrDefault(self.callbacks)
                           if self.isDefined(self.callbacks) else None),
                xgb_model=self.getOrDefault(self.xgb_model),
                use_external_storage=self.getOrDefault(
                    self.use_external_storage),
                storage_precision=self.getOrDefault(
                    self.external_storage_precision),
                device=_device_setting(),
                warn_bytes=VAL_GATHER_WARN_BYTES,
            ),
            driver_log_verbosity="log_callback_only",
            force_repartition=bool(
                self.getOrDefault(self.force_repartition)),
        )
        if result is None:
            return None
        model = self._model_class()(result.value)
        self._copyValues(model)
        return model

    def _fit(self, dataset):
        from sparkdl_tpu_torch.ml.dataframe import is_spark_df

        num_workers = int(self.getOrDefault(self.num_workers))
        if num_workers > 1:
            model = None
            if is_spark_df(dataset):
                model = self._fit_partitioned_on_spark(dataset, num_workers)
                if model is not None:
                    return model
                reason = ("no live SparkSession / barrier backend for "
                          "this DataFrame")
            else:
                reason = "the input is not a Spark DataFrame"
            # Never change semantics silently (fail-fast philosophy,
            # reference runner_base.py:56-58): the user asked for a
            # num_workers-way partition-resident fit and is about to
            # get single-node driver-collect training instead.
            logger.warning(
                "num_workers=%d requested but distributed training is "
                "unavailable (%s); falling back to SINGLE-NODE "
                "driver-collect training. The whole dataset will be "
                "materialized on this machine.",
                num_workers, reason,
            )
        pdf, _ = to_pandas(dataset)
        X, y, w, bm, val_mask = self._resolve_columns(pdf)
        if val_mask is not None:
            X_val, y_val = X[val_mask], y[val_mask]
            X, y = X[~val_mask], y[~val_mask]
            w = None if w is None else w[~val_mask]
            bm = None if bm is None else bm[~val_mask]
        else:
            X_val = y_val = None

        if self.getOrDefault(self.use_external_storage):
            # External storage: spill the (rounded) matrix to disk and
            # train from a memory map — precision for memory, per the
            # contract (reference xgboost.py:81-97).
            if w is not None or bm is not None:
                raise ValueError(
                    "weightCol/baseMarginCol do not work with "
                    "use_external_storage=True (reference xgboost.py:87)."
                )
            import tempfile

            prec = self.getOrDefault(self.external_storage_precision)
            spill = os.path.join(
                tempfile.mkdtemp(prefix="sparkdl-xgb-spill-"), "X.npy"
            )
            np.save(spill, np.round(X, prec).astype(np.float32))
            X = np.load(spill, mmap_mode="r")

        n_classes = 0
        if self._is_classifier():
            labels = np.unique(y[~np.isnan(y)])
            n_classes = int(labels.size)
            expected = np.arange(n_classes, dtype=labels.dtype)
            if n_classes < 2 or not np.array_equal(labels, expected):
                raise ValueError(
                    "XgboostClassifier requires integer labels "
                    f"0..k-1 with k>=2; got label values {labels.tolist()}"
                )
        params = self._booster_params(n_classes)
        callbacks = (
            self.getOrDefault(self.callbacks)
            if self.isDefined(self.callbacks) else None
        )
        bst = _fit_booster(
            params, np.asarray(X), y, w, bm, X_val, y_val,
            self.getOrDefault(self.early_stopping_rounds),
            self.getOrDefault(self.verbose_eval),
            callbacks,
            self.getOrDefault(self.xgb_model),
            int(self.getOrDefault(self.num_workers)),
            bool(self.getOrDefault(self.force_repartition)),
        )
        model = self._model_class()(bst)
        self._copyValues(model)
        return model

    def _model_class(self):
        raise NotImplementedError

    # -- persistence (reference xgboost.py:117-122) -------------------------

    def _save_impl(self, path):
        with open(os.path.join(path, "estimator.json"), "w") as fh:
            json.dump(
                {"class": type(self).__name__,
                 "params": params_to_json(self)}, fh)

    @classmethod
    def _load_impl(cls, path):
        with open(os.path.join(path, "estimator.json")) as fh:
            payload = json.load(fh)
        inst = cls()
        params_from_json(inst, payload["params"])
        return inst


class _XgboostModel(Model, _XgboostParams, MLReadable, MLWritable):
    """Shared transform/persistence (real versions of reference
    ``xgboost.py:125-144``)."""

    def __init__(self, xgb_sklearn_model=None):
        super().__init__()
        self._xgb_model = xgb_sklearn_model

    def get_booster(self):
        """Return the trained :class:`sparkdl_tpu_torch.xgboost.booster.
        Booster` (this runtime's stand-in for ``xgboost.core.Booster``,
        reference
        ``xgboost.py:130-134``)."""
        return self._xgb_model

    @property
    def feature_importances_(self):
        """Gain-based per-feature importances (xgboost sklearn parity)."""
        return self._xgb_model.feature_importances("gain")

    def _transform_pandas(self, pdf, device=None):
        """pandas -> pandas with prediction columns appended — the one
        inference body, run driver-side for pandas inputs and
        executor-side per partition for Spark inputs, on ``device`` (the
        driver's ``xgboost.DEVICE``)."""
        pdf = pdf.copy()
        X = extract_matrix(pdf, self.getFeaturesCol())
        margins = self._xgb_model.predict_margin(X, device=device)
        self._add_prediction_cols(pdf, margins)
        return pdf

    def _transform(self, dataset):
        from sparkdl_tpu_torch.ml.dataframe import is_spark_df

        if is_spark_df(dataset):
            # Distributed inference: partitions stay executor-resident
            # (the reference's large-data contract, xgboost.py:81-97).
            try:
                from sparkdl_tpu_torch.horovod.spark_backend import (
                    maybe_transform_on_spark,
                )
            except ImportError:
                pass
            else:
                out = maybe_transform_on_spark(
                    dataset, self._transform_broadcast,
                    self._prediction_schema())
                if out is not None:
                    return out
        pdf, spark_template = to_pandas(dataset)
        return to_output(self._transform_pandas(pdf, _device_setting()),
                         spark_template)

    def _add_prediction_cols(self, pdf, margins):
        raise NotImplementedError

    def _prediction_schema(self):
        """[(column, spark type)] appended by ``_add_prediction_cols``
        — the distributed transform builds its output schema from this
        instead of running a schema-inference job."""
        raise NotImplementedError

    def __getstate__(self):
        """Pickling (closure shipping, broadcast, persistence helpers)
        must never drag the context-bound Broadcast cache along: a
        pickled Broadcast re-registers into ITS context, which may be
        stopped — and the broadcast of this very model would recurse
        into the previous one."""
        state = dict(self.__dict__)
        state.pop("_bc", None)
        state.pop("_bc_sc_id", None)
        return state

    def _transform_broadcast(self, spark):
        """Broadcast of the inference closure (carrying this model's
        booster and the driver's ``xgboost.DEVICE``, so that an executor
        never decides its device from its own environment), cached per
        SparkContext and device: repeated transforms reuse ONE
        executor-resident model copy instead of leaking one per call. A
        context change (session restart) re-broadcasts and releases the
        stale copy. Keyed by applicationId — an id() could be reused by a
        new context allocated at a dead one's address."""
        import cloudpickle

        sc = spark.sparkContext
        device = _device_setting()
        key = (getattr(sc, "applicationId", None) or id(sc), device)
        if self.__dict__.get("_bc_sc_id") != key:
            stale = self.__dict__.pop("_bc", None)
            self.__dict__.pop("_bc_sc_id", None)
            if stale is not None:
                try:
                    stale.unpersist()
                except Exception:  # context already gone
                    pass
            # cloudpickle BYTES, not the closure itself: Spark's
            # broadcast serializer is plain pickle, which rejects the
            # lambdas inside the Param machinery this model carries
            self._bc = sc.broadcast(cloudpickle.dumps(
                functools.partial(self._transform_pandas, device=device)))
            self._bc_sc_id = key
        return self._bc

    def _save_impl(self, path):
        with open(os.path.join(path, "model.json"), "w") as fh:
            json.dump(
                {"class": type(self).__name__,
                 "params": params_to_json(self)}, fh)
        self._xgb_model.save(os.path.join(path, "booster"))

    @classmethod
    def _load_impl(cls, path):
        with open(os.path.join(path, "model.json")) as fh:
            payload = json.load(fh)
        inst = cls(_booster_mod.Booster.load(os.path.join(path, "booster")))
        params_from_json(inst, payload["params"])
        return inst


class XgboostRegressorModel(_XgboostModel):
    """
    The model returned by :func:`sparkdl.xgboost.XgboostRegressor.fit`
    (reference ``xgboost.py:147-153``).
    """

    def _is_classifier(self):
        return False

    def _add_prediction_cols(self, pdf, margins):
        pdf[self.getPredictionCol()] = margins[:, 0].astype(np.float64)

    def _prediction_schema(self):
        return [(self.getPredictionCol(), "double")]


class XgboostClassifierModel(_XgboostModel, HasProbabilityCol,
                             HasRawPredictionCol):
    """
    The model returned by :func:`sparkdl.xgboost.XgboostClassifier.fit`
    (reference ``xgboost.py:156-162``). ``rawPredictionCol`` always
    carries the predicted margins (the reference's ``output_margin``
    replacement, reference ``xgboost.py:274-276``).
    """

    def _is_classifier(self):
        return True

    def _add_prediction_cols(self, pdf, margins):
        if margins.shape[1] == 1:  # binary: margins for the pos class
            raw = np.concatenate([-margins, margins], axis=1)
            p1 = 1.0 / (1.0 + np.exp(-margins[:, 0]))
            proba = np.stack([1.0 - p1, p1], axis=1)
        else:
            raw = margins
            mm = margins - margins.max(axis=1, keepdims=True)
            e = np.exp(mm)
            proba = e / e.sum(axis=1, keepdims=True)
        pdf[self.getRawPredictionCol()] = list(raw.astype(np.float64))
        pdf[self.getProbabilityCol()] = list(proba.astype(np.float64))
        pdf[self.getPredictionCol()] = proba.argmax(axis=1).astype(np.float64)

    def _prediction_schema(self):
        return [(self.getRawPredictionCol(), "array<double>"),
                (self.getProbabilityCol(), "array<double>"),
                (self.getPredictionCol(), "double")]


class XgboostRegressor(_XgboostEstimator):
    """
    XgboostRegressor is an ML estimator with the surface of the
    reference's class of the same name (reference ``xgboost.py:165-
    244``): gradient-boosted regression usable in ML Pipelines and
    meta-algorithms, accepting booster hyper-parameters as constructor
    kwargs. Special params follow the renamed-param contract —
    ``weightCol`` (not sample_weight), ``validationIndicatorCol`` (not
    eval_set), ``baseMarginCol`` (not base_margin), ``use_gpu`` (not
    gpu_id; a no-op here: the card is ``xgboost.DEVICE``'s), ``missing``
    with sparse-vector semantics.

    Training runs on the histogram booster on the card; with
    ``num_workers > 1`` it is distributed as a HorovodRunner gang with a
    per-level histogram all-reduce.
    """

    def _is_classifier(self):
        return False

    def _model_class(self):
        return XgboostRegressorModel


class XgboostClassifier(_XgboostEstimator, HasProbabilityCol,
                        HasRawPredictionCol):
    """
    XgboostClassifier is an ML estimator with the surface of the
    reference's class of the same name (reference ``xgboost.py:247-
    331``): gradient-boosted classification (binary or multiclass; the
    objective is inferred from the label cardinality unless set).
    ``rawPredictionCol`` always carries margins (the ``output_margin``
    replacement), ``probabilityCol`` the class probabilities. The
    renamed-param contract and distributed behavior match
    :class:`XgboostRegressor`.
    """

    def _is_classifier(self):
        return True

    def _model_class(self):
        return XgboostClassifierModel
