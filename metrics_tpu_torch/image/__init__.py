"""Image metrics (counterpart of ``metrics_tpu/image/``): the pure-tensor ones and the
extractor-backed FID, KID, IS and LPIPS (:mod:`metrics_tpu_torch.image.backbones`)."""

from metrics_tpu_torch.image.d_lambda import SpectralDistortionIndex
from metrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from metrics_tpu_torch.image.fid import FrechetInceptionDistance
from metrics_tpu_torch.image.inception import InceptionScore
from metrics_tpu_torch.image.kid import KernelInceptionDistance
from metrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.sam import SpectralAngleMapper
from metrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "UniversalImageQualityIndex",
]
