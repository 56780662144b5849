"""MetricTracker (counterpart of ``metrics_tpu/wrappers/tracker.py``)."""

from copy import deepcopy
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn


class MetricTracker:
    """Track a metric (or collection) over steps or epochs.

    ``increment()`` starts a step with a fresh copy of the metric, except
    that a ``WindowedMetric`` (alone or in a collection) carries its ring of
    buckets into the new step, so each step sees the last ``window_size``
    buckets;
    ``update``/``compute``/``forward`` address the newest step;
    ``compute_all``/``best_metric`` span every step.  ``best_metric`` gives
    ``None`` (with a warning) for a value that is not one scalar per step,
    such as a confusion matrix in a collection.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricTracker
        >>> tr = MetricTracker(Accuracy(num_classes=2, device="cpu"), maximize=True)
        >>> for step_preds in ([1, 0, 0, 0], [1, 1, 0, 0]):
        ...     tr.increment()
        ...     tr.update(torch.tensor(step_preds), torch.tensor([1, 1, 0, 0]))
        >>> float(tr.best_metric())
        1.0
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a metrics_tpu_torch `Metric` or `MetricCollection` "
                f"but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._steps: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        return len(self._steps)

    def __len__(self) -> int:
        return len(self._steps)

    def __getitem__(self, idx: int) -> Union[Metric, MetricCollection]:
        return self._steps[idx]

    def increment(self) -> None:
        self._increment_called = True
        new = deepcopy(self._base_metric)
        if self._steps:
            self._carry_window_state(self._steps[-1], new)
        self._steps.append(new)

    @staticmethod
    def _carry_window_state(prev: Union[Metric, MetricCollection], new: Union[Metric, MetricCollection]) -> None:
        """Carry ``WindowedMetric`` members' rings into the next step.

        A fresh copy starts with an empty window, which would drop the sliding
        history the window exists to keep.  The states are cloned, never
        aliased.  Other members keep the per-step semantics (fresh state every
        step).
        """
        from metrics_tpu_torch.streaming.window import WindowedMetric

        if isinstance(prev, MetricCollection):
            pairs = [(prev[k], new[k]) for k in prev.keys(keep_base=True)]
        else:
            pairs = [(prev, new)]
        for pm, nm in pairs:
            if not isinstance(pm, WindowedMetric):
                continue
            for name in pm._defaults:
                setattr(nm, name, getattr(pm, name).clone())
            nm._update_count = pm._update_count
            nm._computed = None

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Any:
        """Each step's value stacked along a new leading step axis."""
        self._check_for_increment("compute_all")
        res = [m.compute() for m in self._steps]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        if self._steps:
            self._steps[-1].reset()

    def reset_all(self) -> None:
        for m in self._steps:
            m.reset()

    @staticmethod
    def _best(values: torch.Tensor, maximize: bool, what: str) -> Tuple[Any, Any]:
        """The best step's value and index, or ``(None, None)`` with a warning
        where the values are not one scalar per step."""
        arr = values.detach().cpu().numpy()
        if arr.ndim != 1:
            rank_zero_warn(
                f"The best metric{what} is not defined: its value per step has shape {arr.shape[1:]}, "
                "not a scalar. Returning `None` instead.",
                UserWarning,
            )
            return None, None
        best = int(np.argmax(arr) if maximize else np.argmin(arr))
        return float(arr[best]), best

    def best_metric(
        self, return_step: bool = False
    ) -> Union[float, Tuple[float, int], Dict[str, float], Tuple[Dict[str, float], Dict[str, int]], None]:
        """Best value (and optionally its step) under the ``maximize`` policy."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value, idx = {}, {}
            for i, (k, v) in enumerate(res.items()):
                value[k], idx[k] = self._best(v, maximize[i], f" for {k}")
            return (value, idx) if return_step else value
        best, step = self._best(res, self.maximize, "")
        return (best, step) if return_step else best

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")
