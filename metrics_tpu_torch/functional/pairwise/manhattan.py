"""Pairwise manhattan distance (counterpart of ``metrics_tpu/functional/pairwise/manhattan.py``).

The JAX package forms the whole ``(N, M, d)`` difference and lets XLA fuse
the sum; eager PyTorch would hold it (102 GB at 50,000 x 1,000 x 512
float32).  Here the rows of ``x`` go in chunks whose ``(rows, M, d)``
difference stays under ``_CHUNK_ELEMENTS``: each distance is still one sum
over its ``d`` terms, so the chunks change the memory, not the result.
"""

from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal

_CHUNK_ELEMENTS = 1 << 24  # elements of one (rows, M, d) difference: 64 MiB of float32


def _pairwise_manhattan_distance_compute(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    zero_diagonal: Optional[bool] = None,
    chunk_elements: int = _CHUNK_ELEMENTS,
) -> torch.Tensor:
    x, y, zero_diag = _check_input(x, y, zero_diagonal)
    n, m = x.shape[0], y.shape[0]
    rows = max(1, chunk_elements // max(1, m * x.shape[1]))
    distance = torch.empty((n, m), dtype=torch.float32, device=x.device)
    for start in range(0, n, rows):
        diff = x[start : start + rows, None, :] - y[None, :, :]
        torch.sum(diff.abs_(), dim=-1, out=distance[start : start + rows])
    return _zero_diagonal(distance, zero_diag)


def pairwise_manhattan_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """``[N, M]`` L1 distances between the rows of ``x`` and ``y`` (default ``y = x``), on the device of the inputs.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[ 4.,  2.],
                [ 7.,  5.],
                [12., 10.]])
    """
    return _reduce_distance_matrix(_pairwise_manhattan_distance_compute(x, y, zero_diagonal), reduction)
