"""Pairwise cosine similarity (counterpart of ``metrics_tpu/functional/pairwise/cosine.py``).

Rows are scaled by their norms (clamped at ``1e-30``), then one float32
``torch.matmul``, which follows ``torch.backends.cuda.matmul.allow_tf32``.
"""

from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.compute import _norm


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / _norm(x, 1, keepdim=True).clamp_min(1e-30)


def _pairwise_cosine_similarity_compute(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    norm_x = _unit_rows(x)
    norm_y = norm_x if y is x else _unit_rows(y)
    return _zero_diagonal(norm_x @ norm_y.T, zero_diag)


def pairwise_cosine_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """``[N, M]`` cosine similarities between the rows of ``x`` and ``y`` (default ``y = x``), on the device of the inputs.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_cosine_similarity(x, y).round(decimals=4)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    return _reduce_distance_matrix(_pairwise_cosine_similarity_compute(x, y, zero_diagonal), reduction)
