"""Optional-dependency flags (counterpart of ``metrics_tpu/utils/imports.py``).

Every optional integration is gated behind a module-level boolean so the
domain packages import cleanly where the package is missing.
"""

import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def _package_available(package_name: str) -> bool:
    """Whether ``package_name`` is installed, found without importing it: an
    import here would cost every process that imports the port (a fleet
    worker's start-up, so a failover) the package's own import, seconds
    for ``transformers``."""
    try:
        return importlib.util.find_spec(package_name) is not None
    except (ImportError, ValueError):
        return False


_SCIPY_AVAILABLE = _package_available("scipy")
_SKLEARN_AVAILABLE = _package_available("sklearn")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")
_NLTK_AVAILABLE = _package_available("nltk")
_TORCH_AVAILABLE = _package_available("torch")
_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
_PYCOCOTOOLS_AVAILABLE = _package_available("pycocotools")
_SACREBLEU_AVAILABLE = _package_available("sacrebleu")
_REGEX_AVAILABLE = _package_available("regex")
_PIL_AVAILABLE = _package_available("PIL")
