"""ROC module metric (counterpart of ``metrics_tpu/classification/roc.py``)."""

from typing import List, Tuple, Union

import torch

from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve
from metrics_tpu_torch.functional.classification.roc import _roc_compute


class ROC(PrecisionRecallCurve):
    """fpr, tpr and thresholds at every distinct score of the stream.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ROC
        >>> metric = ROC(pos_label=1, device='cpu')
        >>> metric.update(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0, 1, 1, 1]))
        >>> fpr, tpr, thresholds = metric.compute()
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
    """

    def compute(self) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
        return _roc_compute(self.buffer_values("preds"), self.buffer_values("target"), self.num_classes, self.pos_label)
