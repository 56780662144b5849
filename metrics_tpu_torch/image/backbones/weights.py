"""Converted-checkpoint discovery for the image feature extractors
(counterpart of ``metrics_tpu/image/backbones/weights.py``).

Both packages look for the same files in the same order, so one converted
``.npz`` (a flat ``{"a/b/kernel": array}`` of the JAX package's variables,
``tools/convert_weights.py::flatten_params``) serves both:

1. ``$METRICS_TPU_WEIGHTS_DIR`` if set,
2. ``~/.cache/metrics_tpu/weights``,
3. ``_weights/`` at the root of the package (here ``metrics_tpu_torch/_weights``).

File names: ``inception_fid.npz``, ``lpips_vgg.npz``, ``lpips_alex.npz``,
``lpips_squeeze.npz``.  The trees are converted to this package's
``state_dict`` by :mod:`metrics_tpu_torch.image.backbones.convert`.  When no
file is found the extractors take a seeded random init, and the metrics warn
that their scores are not comparable to published numbers.
"""

import functools
import os
from typing import Any, Dict, Optional, Tuple

INCEPTION_FILE = "inception_fid.npz"
LPIPS_FILES = {"vgg": "lpips_vgg.npz", "alex": "lpips_alex.npz", "squeeze": "lpips_squeeze.npz"}


def _cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "metrics_tpu", "weights")


def default_weights_dir() -> str:
    """Where the fetch tool installs converted checkpoints: ``$METRICS_TPU_WEIGHTS_DIR``
    if set, else ``~/.cache/metrics_tpu/weights`` (the JAX package's directory too)."""
    return os.environ.get("METRICS_TPU_WEIGHTS_DIR") or _cache_dir()


def weight_search_paths(filename: str) -> list:
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dirs = dict.fromkeys([default_weights_dir(), _cache_dir(), os.path.join(pkg_root, "_weights")])
    return [os.path.join(d, filename) for d in dirs]


def find_weight_file(filename: str) -> Optional[str]:
    for path in weight_search_paths(filename):
        if os.path.isfile(path):
            return path
    return None


@functools.lru_cache(maxsize=8)
def _load_npz_cached(path: str, mtime: float) -> Dict:
    from metrics_tpu_torch.image.backbones.inception import load_params_npz

    return load_params_npz(path)


def load_inception_variables() -> Optional[Dict]:
    """The converted Inception variables ``{"params", "batch_stats"}`` if installed
    (read once per path and modification time)."""
    path = find_weight_file(INCEPTION_FILE)
    if path is None:
        return None
    return _load_npz_cached(path, os.path.getmtime(path))


def make_inception_extractor(feature: str, params: Optional[Dict] = None, device: Any = "cuda") -> Tuple[Any, bool]:
    """The Inception extractor of ``feature``, preferring given or installed weights.

    ``params`` is the JAX package's tree: a full variables tree or bare params.
    Returns ``(extractor, pretrained)``; callers warn when ``pretrained`` is
    False (random init: scores not comparable to published numbers)."""
    from metrics_tpu_torch.image.backbones.inception import InceptionFeatureExtractor

    if params is not None:
        if "params" in params and isinstance(params.get("params"), dict):
            return InceptionFeatureExtractor(feature, variables=params, device=device), True
        return InceptionFeatureExtractor(feature, params=params, device=device), True
    variables = load_inception_variables()
    if variables is not None:
        return InceptionFeatureExtractor(feature, variables=variables, device=device), True
    return InceptionFeatureExtractor(feature, device=device), False


def load_lpips_params(net_type: str) -> Optional[Dict]:
    """The converted LPIPS backbone and head params of ``net_type`` if installed."""
    filename = LPIPS_FILES.get(net_type)
    if filename is None:
        return None
    path = find_weight_file(filename)
    if path is None:
        return None
    return _load_npz_cached(path, os.path.getmtime(path))
