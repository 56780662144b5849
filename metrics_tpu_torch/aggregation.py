"""Stream aggregators (counterpart of ``metrics_tpu/aggregation.py``).

``Max/Min/Sum/Cat/MeanMetric`` log scalars or tensors with a NaN policy
(``nan_strategy``): ``"error"`` raises on a NaN, ``"warn"`` warns and drops
it, ``"ignore"`` drops it silently, and a float replaces it.  They are the
library's own metrics for the ``max``, ``min``, ``sum`` and ``cat``
reductions.  Inputs are cast to float32, as the JAX package's are.
"""

from typing import Any, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class BaseAggregator(Metric):
    """Common scaffolding for the aggregation metrics."""

    is_differentiable = None
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        fn: str,
        default_value: Union[torch.Tensor, list],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed = ("error", "warn", "ignore")
        if not (isinstance(nan_strategy, float) or nan_strategy in allowed):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.state_name = state_name
        if nan_strategy in ("error", "warn"):
            self.traced_update = False  # the NaN check reads the batch on the host
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)

    def _as_float(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _cast_and_nan_check_input(self, x: Any, weight: Any = None) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        x = self._as_float(x)
        if weight is not None:
            weight = torch.broadcast_to(self._as_float(weight), x.shape)
        if self.nan_strategy in ("error", "warn"):
            # a NaN check reads the values on the host, which a per-row update under
            # torch.func.vmap cannot: there the NaN flows on, as under a JAX trace
            if not self._rows_mapped:
                nans = torch.isnan(x)
                if bool(nans.any()):
                    if self.nan_strategy == "error":
                        raise RuntimeError("Encountered `nan` values in tensor")
                    rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
                    keep = ~nans
                    if weight is not None:
                        weight = weight[keep]
                    x = x[keep]
        elif self.nan_strategy == "ignore":
            keep = ~torch.isnan(x)
            if weight is not None:
                weight = torch.where(keep, weight, torch.zeros_like(weight))
            x = torch.where(keep, x, torch.full_like(x, self._nan_neutral()))
        else:  # float imputation
            x = torch.where(torch.isnan(x), torch.full_like(x, self.nan_strategy), x)
        if weight is None:
            return x
        return x, weight

    def _nan_neutral(self) -> float:
        return 0.0

    def update(self, value: Any) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def compute(self) -> torch.Tensor:
        return getattr(self, self.state_name)


class MaxMetric(BaseAggregator):
    """Running max.

    Example:
        >>> from metrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device='cpu')
        >>> metric.update(1.0)
        >>> metric.update([2.0, 3.0])
        >>> float(metric.compute())
        3.0
    """

    full_state_update = True
    higher_is_better = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(float("-inf")), nan_strategy, state_name="max_value", **kwargs)

    def _nan_neutral(self) -> float:
        return float("-inf")

    def update(self, value: Any) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.max_value = torch.maximum(self.max_value, value.max())


class MinMetric(BaseAggregator):
    """Running min."""

    full_state_update = True
    higher_is_better = False

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, state_name="min_value", **kwargs)

    def _nan_neutral(self) -> float:
        return float("inf")

    def update(self, value: Any) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.min_value = torch.minimum(self.min_value, value.min())


class SumMetric(BaseAggregator):
    """Running sum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device='cpu')
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        6.0
    """

    stackable = True  # one zero-default sum state

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="sum_value", **kwargs)

    def update(self, value: Any) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.sum_value = self.sum_value + value.sum()


class CatMetric(BaseAggregator):
    """Concatenate everything (a ``cat`` list state of float32 rows)."""

    stackable = False  # the concatenation list grows with the stream

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Any) -> None:
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(torch.atleast_1d(value))

    def compute(self) -> Union[torch.Tensor, list]:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> metric = MeanMetric(device='cpu')
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        2.0
    """

    stackable = True  # zero-default sum states (value, weight)

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="mean_value", **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Any, weight: Any = 1.0) -> None:
        value, weight = self._cast_and_nan_check_input(value, weight)
        if value.numel() == 0:
            return
        self.mean_value = self.mean_value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> torch.Tensor:
        return self.mean_value / self.weight
