"""Pairwise linear (dot-product) similarity (counterpart of ``metrics_tpu/functional/pairwise/linear.py``).

The product is ``torch.matmul`` in float32: it follows the caller's
``torch.backends.cuda.matmul.allow_tf32`` (off by default).
"""

from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal


def _pairwise_linear_similarity_compute(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(x @ y.T, zero_diag)


def pairwise_linear_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """``[N, M]`` dot products between the rows of ``x`` and ``y`` (default ``y = x``), on the device of the inputs.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  7.],
                [ 3., 11.],
                [ 5., 18.]])
    """
    return _reduce_distance_matrix(_pairwise_linear_similarity_compute(x, y, zero_diagonal), reduction)
