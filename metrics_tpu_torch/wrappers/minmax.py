"""MinMaxMetric (counterpart of ``metrics_tpu/wrappers/minmax.py``)."""

from typing import Any, Dict, Union

import torch

from metrics_tpu_torch.metric import Metric


class MinMaxMetric(Metric):
    """Track the min and max of a wrapped metric's value across an experiment.

    ``compute`` returns the base metric's value as ``raw`` and refreshes
    ``min``/``max`` with it.  ``forward`` returns the base metric's value on
    the batch alone as ``raw`` (its own ``forward``), while the base keeps
    accumulating, and folds that value into ``min``/``max``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MinMaxMetric
        >>> mm = MinMaxMetric(Accuracy(num_classes=2, device="cpu"), device="cpu")
        >>> mm.update(torch.tensor([1, 1, 0, 0]), torch.tensor([1, 0, 0, 0]))
        >>> out = mm.compute()
        >>> float(out["raw"]), float(out["min"]), float(out["max"])
        (0.75, 0.75, 0.75)
    """

    full_state_update = True
    traced_update = False

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        if base_metric.device != self.device:
            raise ValueError(f"the base metric keeps its state on {base_metric.device}, the wrapper on {self.device}")
        self._base_metric = base_metric
        self.sync_on_compute = False  # the base metric syncs its own states
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric._update_wrapper(*args, **kwargs)

    def _fold(self, val: Any) -> Dict[str, torch.Tensor]:
        if not self._is_suitable_val(val):
            raise RuntimeError(
                f"Returned value from base metric should be a scalar (int, float or tensor of size 1, but got {val}"
            )
        val = torch.as_tensor(val, device=self.device)
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def compute(self) -> Dict[str, torch.Tensor]:
        return self._fold(self._base_metric._compute_wrapper())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        val = self._base_metric.forward(*args, **kwargs)
        self._update_count += 1  # a forward is an update for the staleness warning
        self._computed = None
        return self._fold(val)

    def reset(self) -> None:
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)
        self._base_metric.reset()
        super().reset()

    @staticmethod
    def _is_suitable_val(val: Union[int, float, torch.Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, torch.Tensor):
            return val.numel() == 1
        return False
