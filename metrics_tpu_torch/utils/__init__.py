"""Utilities for metric authors (counterpart of ``metrics_tpu/utils``): the
``dim_zero_*`` reductions a custom metric's ``add_state(..., dist_reduce_fx=...)``
takes, label converters, rank-zero printing, and the ``full_state_update`` check.
"""

from metrics_tpu_torch.utils.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn
from metrics_tpu_torch.utils.checks import check_forward_full_state_property

__all__ = [
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
    "to_categorical",
    "to_onehot",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
    "check_forward_full_state_property",
]
