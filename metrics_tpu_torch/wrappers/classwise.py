"""ClasswiseWrapper (counterpart of ``metrics_tpu/wrappers/classwise.py``)."""

from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.metric import Metric


class ClasswiseWrapper(Metric):
    """Split a per-class metric output into a ``{name_label: value}`` dict.

    ``device=`` (``"cuda"`` by default) must be the wrapped metric's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, ClasswiseWrapper
        >>> cw = ClasswiseWrapper(Accuracy(num_classes=3, average=None, device="cpu"), device="cpu")
        >>> cw.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 2, 2, 1]))
        >>> {k: round(float(v), 2) for k, v in sorted(cw.compute().items())}
        {'accuracy_0': 1.0, 'accuracy_1': 1.0, 'accuracy_2': 0.5}
    """

    traced_update = False

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of metrics_tpu_torch.Metric but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        super().__init__(**kwargs)
        if metric.device != self.device:
            raise ValueError(f"the wrapped metric keeps its state on {metric.device}, the wrapper on {self.device}")
        self.metric = metric
        self.labels = labels
        self.sync_on_compute = False  # the wrapped metric syncs its own states

    def _convert(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric._update_wrapper(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        return self._convert(self.metric._compute_wrapper())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        return self._convert(self.metric.forward(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()
        super().reset()
