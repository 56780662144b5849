from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.auc import auc
from metrics_tpu_torch.functional.classification.auroc import auroc
from metrics_tpu_torch.functional.classification.average_precision import average_precision
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix
from metrics_tpu_torch.functional.classification.dice import dice, dice_score
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.functional.classification.hamming import hamming_distance
from metrics_tpu_torch.functional.classification.precision_recall import precision, recall
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.functional.classification.specificity import specificity
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = [
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
    "precision",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
