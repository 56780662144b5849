from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.auc import auc
from metrics_tpu_torch.functional.classification.auroc import auroc
from metrics_tpu_torch.functional.classification.average_precision import average_precision
from metrics_tpu_torch.functional.classification.calibration_error import calibration_error
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix
from metrics_tpu_torch.functional.classification.dice import dice, dice_score
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.functional.classification.hamming import hamming_distance
from metrics_tpu_torch.functional.classification.hinge import hinge_loss
from metrics_tpu_torch.functional.classification.jaccard import jaccard_index
from metrics_tpu_torch.functional.classification.kl_divergence import kl_divergence
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef
from metrics_tpu_torch.functional.classification.precision_recall import precision, precision_recall, recall
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve
from metrics_tpu_torch.functional.classification.ranking import (
    coverage_error,
    label_ranking_average_precision,
    label_ranking_loss,
)
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.functional.classification.specificity import specificity
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = [
    "accuracy",
    "auc",
    "auroc",
    "average_precision",
    "calibration_error",
    "cohen_kappa",
    "confusion_matrix",
    "coverage_error",
    "dice",
    "dice_score",
    "f1_score",
    "fbeta_score",
    "hamming_distance",
    "hinge_loss",
    "jaccard_index",
    "kl_divergence",
    "label_ranking_average_precision",
    "label_ranking_loss",
    "matthews_corrcoef",
    "precision",
    "precision_recall",
    "precision_recall_curve",
    "recall",
    "roc",
    "specificity",
    "stat_scores",
]
