"""Feature-extractor backbones of the neural image metrics (counterpart of
``metrics_tpu/image/backbones/``): Inception-v3 as a ``torch.nn.Module`` with the
torch-fidelity taps.  No pretrained weights ship with the package: pass the
JAX package's variables (converted by :mod:`.convert`), install a converted
``.npz`` (:mod:`.weights`), or take the seeded random init for shape and
parity work.
"""

from metrics_tpu_torch.image.backbones.convert import inception_state_dict_from_flax, lpips_state_dict_from_flax
from metrics_tpu_torch.image.backbones.inception import (
    FoldedInceptionV3,
    InceptionFeatureExtractor,
    InceptionV3,
    tf1_resize_bilinear,
)

__all__ = [
    "FoldedInceptionV3",
    "InceptionFeatureExtractor",
    "InceptionV3",
    "inception_state_dict_from_flax",
    "lpips_state_dict_from_flax",
    "tf1_resize_bilinear",
]
