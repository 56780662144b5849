"""Audio functionals (counterpart of ``metrics_tpu/functional/audio/``)."""

from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio
from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

__all__ = [
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
]
