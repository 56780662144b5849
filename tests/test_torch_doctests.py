"""Run the docstring examples of every ``metrics_tpu_torch`` module (all on the CPU)."""

import doctest
import importlib
import pkgutil

import pytest

import metrics_tpu_torch

MODULES = sorted(m.name for m in pkgutil.walk_packages(metrics_tpu_torch.__path__, "metrics_tpu_torch."))


@pytest.mark.parametrize("name", MODULES)
def test_docstring_examples(name):
    result = doctest.testmod(importlib.import_module(name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.failed == 0


CURVE_SLICE = [
    "AUC", "AUROC", "AveragePrecision", "BinnedAveragePrecision", "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision", "Dice", "HammingDistance", "PrecisionRecallCurve", "ROC", "Specificity",
    "auc", "auroc", "average_precision", "dice", "dice_score", "hamming_distance", "precision_recall_curve",
    "roc", "specificity",
]


@pytest.mark.parametrize("name", CURVE_SLICE)
def test_each_public_name_of_the_curve_slice_has_an_example(name):
    assert ">>>" in (getattr(metrics_tpu_torch, name).__doc__ or "")


REST_OF_CLASSIFICATION = [
    "CalibrationError", "CohenKappa", "CoverageError", "HingeLoss", "JaccardIndex", "KLDivergence",
    "LabelRankingAveragePrecision", "LabelRankingLoss", "MatthewsCorrCoef",
    "calibration_error", "cohen_kappa", "coverage_error", "hinge_loss", "jaccard_index", "kl_divergence",
    "label_ranking_average_precision", "label_ranking_loss", "matthews_corrcoef", "precision_recall",
]


@pytest.mark.parametrize("name", REST_OF_CLASSIFICATION)
def test_each_public_name_of_the_rest_of_classification_has_an_example(name):
    assert ">>>" in (getattr(metrics_tpu_torch, name).__doc__ or "")
