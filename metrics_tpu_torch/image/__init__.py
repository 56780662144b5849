"""Image metrics (counterpart of ``metrics_tpu/image/``): the pure-tensor ones.

FID, KID, IS and LPIPS, which need the backbones, are not ported yet.
"""

from metrics_tpu_torch.image.d_lambda import SpectralDistortionIndex
from metrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.sam import SpectralAngleMapper
from metrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.image.uqi import UniversalImageQualityIndex

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "UniversalImageQualityIndex",
]
