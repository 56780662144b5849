"""PyTorch/CUDA port of ``metrics_tpu``: streaming evaluation metrics on an NVIDIA GPU.

Module metrics and :class:`MetricCollection` keep their state on ``device``
(``"cuda"`` by default, ``"cpu"`` on request); functionals run on the device of
their inputs.  With a ``torch.distributed`` process group initialised,
``compute()`` syncs the states across processes (:mod:`metrics_tpu_torch.parallel`).
This package imports neither JAX nor ``metrics_tpu``.
"""

from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    ConfusionMatrix,
    Dice,
    F1Score,
    FBetaScore,
    HammingDistance,
    Precision,
    PrecisionRecallCurve,
    ROC,
    Recall,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.functional import (
    accuracy,
    auc,
    auroc,
    average_precision,
    confusion_matrix,
    dice,
    dice_score,
    f1_score,
    fbeta_score,
    hamming_distance,
    precision,
    precision_recall_curve,
    recall,
    roc,
    specificity,
    stat_scores,
)
from metrics_tpu_torch.interop import load_jax_state
from metrics_tpu_torch.metric import Metric

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CatMetric",
    "ConfusionMatrix",
    "Dice",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "Precision",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "Specificity",
    "StatScores",
    "SumMetric",
    "accuracy",
    "auc",
    "auroc",
    "average_precision",
    "confusion_matrix",
    "dice",
    "dice_score",
    "f1_score",
    "fbeta_score",
    "hamming_distance",
    "load_jax_state",
    "precision",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
