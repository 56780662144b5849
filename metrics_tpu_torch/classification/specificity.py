"""Specificity module metric (counterpart of ``metrics_tpu/classification/specificity.py``)."""

import torch

from metrics_tpu_torch.classification.precision_recall import _PrecisionRecallBase
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute


class Specificity(_PrecisionRecallBase):
    """Specificity = tn / (tn + fp).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Specificity
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> metric = Specificity(average='macro', num_classes=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 6)
        0.611111
    """

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
