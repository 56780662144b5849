"""Pairwise euclidean distance (counterpart of ``metrics_tpu/functional/pairwise/euclidean.py``).

The Gram form ``||x||² + ||y||² - 2 x·y`` keeps the work in one float32
``torch.matmul`` (which follows ``torch.backends.cuda.matmul.allow_tf32``).
It cancels for near rows: a squared distance carries an absolute error of a
few ``||x||² * 2**-24``, not a relative one.
"""

from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.compute import _sqrt


def _pairwise_euclidean_distance_compute(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(1, keepdim=True)
    y_norm = x_norm if y is x else (y * y).sum(1, keepdim=True)
    sq = x_norm + y_norm.T - 2 * (x @ y.T)
    return _zero_diagonal(_sqrt(sq.clamp_min(0.0)), zero_diag)


def pairwise_euclidean_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """``[N, M]`` euclidean distances between the rows of ``x`` and ``y`` (default ``y = x``), on the device of the inputs.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_euclidean_distance(x, y).round(decimals=4)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231],
                [8.9443, 7.6158]])
    """
    return _reduce_distance_matrix(_pairwise_euclidean_distance_compute(x, y, zero_diagonal), reduction)
