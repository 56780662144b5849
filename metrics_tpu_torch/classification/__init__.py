from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.auc import AUC
from metrics_tpu_torch.classification.auroc import AUROC
from metrics_tpu_torch.classification.avg_precision import AveragePrecision
from metrics_tpu_torch.classification.binned_precision_recall import (
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.calibration_error import CalibrationError
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.classification.dice import Dice
from metrics_tpu_torch.classification.f_beta import F1Score, FBetaScore
from metrics_tpu_torch.classification.hamming import HammingDistance
from metrics_tpu_torch.classification.hinge import HingeLoss
from metrics_tpu_torch.classification.jaccard import JaccardIndex
from metrics_tpu_torch.classification.kl_divergence import KLDivergence
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrCoef
from metrics_tpu_torch.classification.precision_recall import Precision, Recall
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve
from metrics_tpu_torch.classification.ranking import (
    CoverageError,
    LabelRankingAveragePrecision,
    LabelRankingLoss,
)
from metrics_tpu_torch.classification.roc import ROC
from metrics_tpu_torch.classification.specificity import Specificity
from metrics_tpu_torch.classification.stat_scores import StatScores

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CalibrationError",
    "CohenKappa",
    "ConfusionMatrix",
    "CoverageError",
    "Dice",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "KLDivergence",
    "LabelRankingAveragePrecision",
    "LabelRankingLoss",
    "MatthewsCorrCoef",
    "Precision",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "Specificity",
    "StatScores",
]
