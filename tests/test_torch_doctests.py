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


REGRESSION_AND_PAIRWISE = [
    "CosineSimilarity", "ExplainedVariance", "MeanAbsoluteError", "MeanAbsolutePercentageError", "MeanSquaredError",
    "MeanSquaredLogError", "PearsonCorrCoef", "R2Score", "SpearmanCorrCoef", "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore", "WeightedMeanAbsolutePercentageError",
    "cosine_similarity", "explained_variance", "mean_absolute_error", "mean_absolute_percentage_error",
    "mean_squared_error", "mean_squared_log_error", "pearson_corrcoef", "r2_score", "spearman_corrcoef",
    "symmetric_mean_absolute_percentage_error", "tweedie_deviance_score", "weighted_mean_absolute_percentage_error",
    "pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_linear_similarity", "pairwise_manhattan_distance",
]


@pytest.mark.parametrize("name", REGRESSION_AND_PAIRWISE)
def test_each_public_name_of_regression_and_pairwise_has_an_example(name):
    assert ">>>" in (getattr(metrics_tpu_torch, name).__doc__ or "")


WRAPPERS_AND_RETRIEVAL = [
    "BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper", "RetrievalMRR",
    "retrieval_average_precision", "retrieval_fall_out", "retrieval_hit_rate", "retrieval_normalized_dcg",
    "retrieval_precision", "retrieval_precision_recall_curve", "retrieval_r_precision", "retrieval_recall",
    "retrieval_reciprocal_rank",
]


@pytest.mark.parametrize("name", WRAPPERS_AND_RETRIEVAL)
def test_each_wrapper_and_retrieval_functional_has_an_example(name):
    assert ">>>" in (getattr(metrics_tpu_torch, name).__doc__ or "")


DETECTION_AND_IMAGE = [
    "MeanAveragePrecision", "PeakSignalNoiseRatio", "StructuralSimilarityIndexMeasure",
    "MultiScaleStructuralSimilarityIndexMeasure", "UniversalImageQualityIndex", "ErrorRelativeGlobalDimensionlessSynthesis",
    "SpectralAngleMapper", "SpectralDistortionIndex", "peak_signal_noise_ratio", "structural_similarity_index_measure",
    "multiscale_structural_similarity_index_measure", "universal_image_quality_index",
    "error_relative_global_dimensionless_synthesis", "spectral_angle_mapper", "spectral_distortion_index", "image_gradients",
]


@pytest.mark.parametrize("name", DETECTION_AND_IMAGE)
def test_each_public_name_of_detection_and_image_has_an_example(name):
    assert ">>>" in (getattr(metrics_tpu_torch, name).__doc__ or "")
