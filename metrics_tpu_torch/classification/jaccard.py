"""JaccardIndex module metric (counterpart of ``metrics_tpu/classification/jaccard.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat


class JaccardIndex(ConfusionMatrix):
    """Intersection over union from the streamed confusion matrix.

    Its ``confmat`` state is a ``ConfusionMatrix``'s, so in one collection they
    fall into one compute group.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import JaccardIndex
        >>> target = torch.tensor([[0, 1, 0], [1, 1, 0]])
        >>> preds = torch.tensor([[0, 1, 0], [0, 1, 1]])
        >>> metric = JaccardIndex(num_classes=2, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 6)
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, multilabel=multilabel, **kwargs)
        self.average = average
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> torch.Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.average, self.ignore_index, self.absent_score)
