"""PyTorch/CUDA port of ``metrics_tpu``: streaming evaluation metrics on an NVIDIA GPU.

Module metrics and :class:`MetricCollection` keep their state on ``device``
(``"cuda"`` by default, ``"cpu"`` on request); functionals run on the device of
their inputs.  With a ``torch.distributed`` process group initialised,
``compute()`` syncs the states across processes (:mod:`metrics_tpu_torch.parallel`).
This package imports neither JAX nor ``metrics_tpu``.
"""

from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification import (
    Accuracy,
    ConfusionMatrix,
    F1Score,
    FBetaScore,
    Precision,
    Recall,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.functional import (
    accuracy,
    confusion_matrix,
    f1_score,
    fbeta_score,
    precision,
    recall,
    stat_scores,
)
from metrics_tpu_torch.interop import load_jax_state
from metrics_tpu_torch.metric import Metric

__all__ = [
    "Accuracy",
    "CatMetric",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "MaxMetric",
    "MeanMetric",
    "Metric",
    "MetricCollection",
    "MinMetric",
    "Precision",
    "Recall",
    "StatScores",
    "SumMetric",
    "accuracy",
    "confusion_matrix",
    "f1_score",
    "fbeta_score",
    "load_jax_state",
    "precision",
    "recall",
    "stat_scores",
]
