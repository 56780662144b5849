"""FBetaScore / F1Score module metrics (counterpart of ``metrics_tpu/classification/f_beta.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.classification.precision_recall import _PrecisionRecallBase
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_compute


class FBetaScore(_PrecisionRecallBase):
    """Weighted harmonic mean of precision and recall."""

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _fbeta_compute(
            tp, fp, tn, fn, self.beta, self.ignore_index, self.average, self.mdmc_reduce
        )


class F1Score(FBetaScore):
    """F-beta with beta=1.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import F1Score
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> metric = F1Score(num_classes=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 6)
        0.333333
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(beta=1.0, **kwargs)
