"""Precision-recall curve functional
(counterpart of ``metrics_tpu/functional/classification/precision_recall_curve.py``).

The JAX package sweeps each class's curve in host numpy float64, one class
at a time.  Here every class is a row of one ``(K, N)`` sweep on the
device of the inputs: one stable sort of all rows, cumulative counts in
float64, and the rows' distinct thresholds compacted to the front of each
row.  The ratios are float64 and the curves float32, as in the JAX package.

The order is numpy's ``argsort(kind="stable")[::-1]``: ascending and stable,
then reversed, with ``-0.0`` equal to ``+0.0`` and every NaN above ``+inf``
and equal to the others.  The sort runs on integer keys, so the CPU and the
GPU give the same permutation.
"""

from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.data import _total_order_keys, _x32
from metrics_tpu_torch.utils.prints import rank_zero_warn

_INT32_MAX = 2**31 - 1


def _sort_keys(x: torch.Tensor) -> torch.Tensor:
    """Integers that order ``x`` along its last axis as ``np.argsort`` orders it."""
    if not x.is_floating_point():
        return x.to(torch.int32) if x.dtype == torch.bool else x
    x = x.to(torch.float32)  # exact for float16 and bfloat16
    keys = _total_order_keys(torch.where(x == 0, 0.0, x))  # -0.0 ties +0.0
    return torch.where(torch.isnan(x), _INT32_MAX, keys)  # every NaN ties, above +inf


def _descending_order(preds: torch.Tensor) -> torch.Tensor:
    """``np.argsort(preds, kind="stable")[::-1]`` along the last axis."""
    return torch.sort(_sort_keys(preds), dim=-1, stable=True).indices.flip(-1)


def _curve_rows(
    preds: torch.Tensor,
    positives: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cumulative fps/tps at each distinct threshold of every row, in descending score order.

    ``preds`` and ``positives`` (bool) are ``(K, N)``, ``weights`` an
    optional ``(N,)`` per sample.  Returns float64 ``fps``, ``tps`` and the
    thresholds (``preds``' dtype), each ``(K, N)`` with row ``k``'s
    ``lengths[k]`` distinct thresholds first and junk after, and ``lengths``.
    """
    k, n = preds.shape
    if n == 0:
        raise IndexError("a curve needs at least one sample")
    desc = _descending_order(preds)
    preds = preds.gather(1, desc)
    positives = positives.gather(1, desc)
    if weights is None:
        tps = positives.cumsum(1, dtype=torch.int64).to(torch.float64)
        fps = torch.arange(1, n + 1, device=preds.device, dtype=torch.float64) - tps
    else:
        w = weights.to(torch.float64)[desc]
        tps = torch.where(positives, w, 0.0).cumsum(1)
        fps = torch.where(positives, 0.0, w).cumsum(1)
    # the last row of each group of equal scores; np.diff's semantics: inf - inf
    # and NaN - NaN are NaN, so each infinity and each NaN is a group of its own
    last = torch.ones((k, n), dtype=torch.bool, device=preds.device)
    last[:, :-1] = (preds[:, 1:] - preds[:, :-1]) != 0
    lengths = last.sum(1)
    # compact: row k's j-th kept position goes to column j; the others to a junk column
    dest = torch.where(last, last.cumsum(1) - 1, n)

    def compact(x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((k, n + 1), dtype=x.dtype, device=x.device).scatter_(1, dest, x)[:, :n]

    return compact(fps), compact(tps), compact(preds), lengths


def _column(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[k, index[k]]`` for every row ``k``, as a ``(K, 1)`` column."""
    return x.gather(1, index[:, None])


def _pr_rows(
    preds: torch.Tensor,
    positives: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every row's precision-recall curve, as the JAX package's single-class compute gives it.

    Returns float32 ``precision`` and ``recall`` ``(K, N + 1)``, the
    thresholds ``(K, N)`` and ``points (K,)``: row ``k`` holds
    ``points[k]`` curve points (its thresholds one fewer), in increasing
    threshold order, the ``(1, 0)`` end point last.
    """
    fps, tps, thresholds, lengths = _curve_rows(preds, positives, weights)
    k, n = fps.shape
    tps_last = _column(tps, lengths - 1)
    precision = tps / (tps + fps)
    recall = torch.where(tps_last > 0, tps / tps_last, torch.nan)
    # stop where full recall is first reached; reverse so recall decreases
    cols = torch.arange(n, device=fps.device)
    reached = (tps == tps_last) & (cols < lengths[:, None])
    kept = reached.to(torch.int8).argmax(1) + 1
    src = (kept[:, None] - 1 - cols).clamp(min=0)
    inside = cols < kept[:, None]
    ones = torch.ones((k, 1), dtype=torch.float64, device=fps.device)
    precision = torch.cat([torch.where(inside, precision.gather(1, src), 1.0), ones], 1)
    recall = torch.cat([torch.where(inside, recall.gather(1, src), 0.0), 0 * ones], 1)
    return precision.to(torch.float32), recall.to(torch.float32), thresholds.gather(1, src), kept + 1


def _roc_rows(
    preds: torch.Tensor,
    positives: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every row's ROC curve, as the JAX package's single-class compute gives it.

    Returns float32 ``fpr`` and ``tpr``, the thresholds (each ``(K, N + 1)``,
    the ``(0, 0)`` point first at threshold ``max + 1``) and ``points (K,)``.
    """
    fps, tps, thresholds, lengths = _curve_rows(preds, positives, weights)
    zeros = torch.zeros((fps.shape[0], 1), dtype=torch.float64, device=fps.device)
    fps, tps = torch.cat([zeros, fps], 1), torch.cat([zeros, tps], 1)
    thresholds = torch.cat([thresholds[:, :1] + 1, thresholds], 1)
    points = lengths + 1
    fps_last, tps_last = _column(fps, points - 1), _column(tps, points - 1)
    fpr = torch.where(fps_last > 0, fps / fps_last, torch.nan)
    tpr = torch.where(tps_last > 0, tps / tps_last, torch.nan)
    return fpr.to(torch.float32), tpr.to(torch.float32), thresholds, points


def _split_rows(x: torch.Tensor, points: torch.Tensor) -> List[torch.Tensor]:
    """Each row's first ``points[k]`` entries (one read of the lengths from the device)."""
    counts = points.tolist()
    valid = torch.arange(x.shape[1], device=x.device) < points[:, None]
    return list(x[valid].split(counts))


def _class_rows(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int],
    single: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(K, N)`` scores and positives: one row for a single class (against
    ``pos_label``), else one per class, as the JAX package's per-class loop
    slices them (multi-label columns against 1, multi-class labels against
    the class)."""
    if single:
        if preds.ndim > target.ndim:
            preds = preds[:, 0]
        return preds.reshape(1, -1), target.reshape(1, -1) == pos_label
    scores = preds[:, :num_classes].t()
    if target.ndim > 1:
        return scores, target[:, :num_classes].t() == 1
    classes = torch.arange(num_classes, device=target.device)[:, None]
    return scores, target[None, :] == classes


def _sample_weights(sample_weights: Optional[Sequence], device: torch.device) -> Optional[torch.Tensor]:
    if sample_weights is None:
        return None
    return torch.as_tensor(sample_weights, dtype=torch.float64).to(device)


def _binary_clf_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cumulative fps/tps (float64) at each distinct threshold, in descending score order."""
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    fps, tps, thresholds, lengths = _curve_rows(
        preds.reshape(1, -1), target.reshape(1, -1) == pos_label, _sample_weights(sample_weights, preds.device)
    )
    n = int(lengths[0])
    return fps[0, :n], tps[0, :n], thresholds[0, :n]


def _precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    """Format inputs: binary flattens; multi-label and multi-class put the class last."""
    preds, target = _x32(torch.as_tensor(preds)), _x32(torch.as_tensor(target))
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} but detected"
                    f" {preds.shape[1]} number of classes from predictions"
                )
            preds = torch.movedim(preds, 0, 1).reshape(num_classes, -1).t()
            target = torch.movedim(target, 0, 1).reshape(num_classes, -1).t()
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                "Argument `pos_label` should be `None` when running multiclass"
                f" precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} but detected"
                f" {preds.shape[1]} number of classes from predictions"
            )
        preds = torch.movedim(preds, 0, 1).reshape(num_classes, -1).t()
        target = target.reshape(-1)
    else:
        raise ValueError(
            "preds and target must have same number of dimensions, or one additional dimension for preds"
        )
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
    if num_classes == 1 and pos_label is None:
        pos_label = 1
    scores, positives = _class_rows(preds, target, num_classes, pos_label, num_classes == 1)
    precision, recall, thresholds, points = _pr_rows(scores, positives, _sample_weights(sample_weights, preds.device))
    if num_classes == 1:
        n = int(points[0])
        return precision[0, :n], recall[0, :n], thresholds[0, : n - 1]
    return (
        _split_rows(precision, points),
        _split_rows(recall, points),
        _split_rows(thresholds, points - 1),
    )


def precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
):
    """precision, recall, thresholds at every distinct score, on the device of the inputs.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> thresholds
        tensor([1., 2., 3.])
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
