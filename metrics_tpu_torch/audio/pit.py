"""PermutationInvariantTraining (counterpart of ``metrics_tpu/audio/pit.py``)."""

from typing import Any, Callable

import torch

from metrics_tpu_torch.audio._base import _SignalMean
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training

# the keyword arguments that configure the metric; every other one goes to ``metric_func``
_METRIC_KWARGS = (
    "device", "compute_on_cpu", "dist_sync_on_step", "sync_on_compute", "dist_sync_fn", "process_group",
    "sync_backend", "sync_timeout", "sync_max_retries", "sync_backoff", "on_sync_error", "validate_sync",
    "delta_sync", "async_sync", "compute_with_cache",
)


class PermutationInvariantTraining(_SignalMean):
    """Mean of the best-permutation metric over the stream (``sum_pit_metric``
    float32, ``total`` int32).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PermutationInvariantTraining
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> gen = torch.Generator().manual_seed(0)
        >>> metric = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, "max", device="cpu")
        >>> metric.update(torch.randn(3, 2, 50, generator=gen), torch.randn(3, 2, 50, generator=gen))
        >>> tuple(metric.compute().shape)
        ()
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_pit_metric"

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _METRIC_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
