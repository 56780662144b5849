"""Stateless image functionals (counterpart of ``metrics_tpu/functional/image/``)."""

from metrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index
from metrics_tpu_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis
from metrics_tpu_torch.functional.image.gradients import image_gradients
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.sam import spectral_angle_mapper
from metrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "universal_image_quality_index",
]
