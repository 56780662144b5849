from metrics_tpu_torch.functional.classification import (
    accuracy,
    confusion_matrix,
    f1_score,
    fbeta_score,
    precision,
    recall,
    stat_scores,
)

__all__ = [
    "accuracy",
    "confusion_matrix",
    "f1_score",
    "fbeta_score",
    "precision",
    "recall",
    "stat_scores",
]
