"""Streaming evaluation: fixed-shape mergeable sketches, windowed metrics and
O(1)-state online quantiles (counterpart of ``metrics_tpu.streaming``).

The KLL sketch's chunk fold runs as a hand-written CUDA kernel on a CUDA
state (:mod:`metrics_tpu_torch.ops.kll`), and every sketch equals the JAX
package's leaf for leaf, its PRNG key included.
"""

from metrics_tpu_torch.streaming.quantile import SketchMetric, StreamingHistogram, StreamingQuantile
from metrics_tpu_torch.streaming.sketches import (
    DEFAULT_CAPACITY,
    DEFAULT_MAX_ITEMS,
    bootstrap_resample_indices,
    kll_cdf,
    kll_init,
    kll_merge,
    kll_quantile,
    kll_rank_error_bound,
    kll_total_weight,
    kll_update,
    reservoir_init,
    reservoir_merge,
    reservoir_update,
    reservoir_values,
)
from metrics_tpu_torch.streaming.window import TimeDecayedMetric, WindowedMetric

__all__ = [
    "DEFAULT_CAPACITY",
    "DEFAULT_MAX_ITEMS",
    "SketchMetric",
    "StreamingHistogram",
    "StreamingQuantile",
    "TimeDecayedMetric",
    "WindowedMetric",
    "bootstrap_resample_indices",
    "kll_cdf",
    "kll_init",
    "kll_merge",
    "kll_quantile",
    "kll_rank_error_bound",
    "kll_total_weight",
    "kll_update",
    "reservoir_init",
    "reservoir_merge",
    "reservoir_update",
    "reservoir_values",
]
