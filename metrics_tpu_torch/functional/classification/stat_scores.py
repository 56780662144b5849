"""TP/FP/TN/FN engine, the shared core of the classification domain
(counterpart of ``metrics_tpu/functional/classification/stat_scores.py``).

Absent or ignored classes are marked with a ``-1`` denominator sentinel and
masked inside :func:`_reduce_stat_scores`, as in the JAX package.
"""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.stat_scores import fused_stat_scores
from metrics_tpu_torch.utils.checks import _as_tensor, _input_format_classification
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _del_column(data: torch.Tensor, idx: int) -> torch.Tensor:
    """Delete a class column."""
    return torch.cat([data[:, :idx], data[:, idx + 1 :]], dim=1)


def _stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str] = "micro",
) -> Counts:
    """tp/fp/tn/fn from canonical binary ``(N, C)`` / ``(N, C, X)`` tensors.

    Output shapes per reduce:
    (N,C): micro → scalar, macro → (C,), samples → (N,)
    (N,C,X): micro → (N,), macro → (N,C), samples → (N,X)

    ``macro`` on 2-D CUDA operands goes through the hand-written kernel,
    for any number of classes; everything else takes the torch reductions.
    """
    if reduce == "macro" and preds.ndim == 2 and preds.is_cuda:
        return fused_stat_scores(preds.contiguous(), target.contiguous())

    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = (0,) if preds.ndim == 2 else (2,)
    else:  # samples
        dim = (1,)

    true_pred = target == preds
    false_pred = target != preds
    pos_pred = preds == 1
    neg_pred = preds == 0

    tp = torch.sum(true_pred & pos_pred, dim=dim, dtype=torch.int32)
    fp = torch.sum(false_pred & pos_pred, dim=dim, dtype=torch.int32)
    tn = torch.sum(true_pred & neg_pred, dim=dim, dtype=torch.int32)
    fn = torch.sum(false_pred & neg_pred, dim=dim, dtype=torch.int32)
    return tp, fp, tn, fn


def _drop_negative_ignored_indices(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: int, mode: DataType
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the rows whose target is a negative ``ignore_index``."""
    if mode == DataType.MULTIDIM_MULTICLASS and preds.is_floating_point():
        num_classes = preds.shape[1]
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
        target = target.reshape(-1)
    if mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        keep = target != ignore_index
        preds = preds[keep]
        target = target[keep]
    return preds, target


def _stat_scores_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
    validate_args: bool = True,
) -> Counts:
    """Canonicalize inputs and count stat scores."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _negative_index_dropped = False
    if ignore_index is not None and ignore_index < 0 and mode is not None:
        preds, target = _drop_negative_ignored_indices(preds, target, ignore_index, mode)
        _negative_index_dropped = True

    preds, target, _ = _input_format_classification(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
        validate_args=validate_args,
        case=mode if not _negative_index_dropped else None,
    )

    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(
            f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes"
        )
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = torch.movedim(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.movedim(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro" and not _negative_index_dropped:
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro" and not _negative_index_dropped:
        ignored = torch.arange(tp.shape[-1], device=tp.device) == ignore_index
        tp, fp, tn, fn = (torch.where(ignored, -1, x) for x in (tp, fp, tn, fn))

    return tp, fp, tn, fn


def _stat_scores_compute(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor
) -> torch.Tensor:
    """Stack [tp, fp, tn, fn, support] along a trailing dim."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, -1, outputs)


def _reduce_stat_scores(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    weights: Optional[torch.Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> torch.Tensor:
    """micro/macro/weighted/none/samples reduction with the -1 "ignored" sentinel:
    zero denominators score ``zero_division``; negative denominators drop the
    class from averaging (nan under ``average=None``).
    """
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)
    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    # all-classes-ignored with average='weighted' → 0/0; impute zero_division
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0) > 0

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, float("nan"), scores)
    return torch.sum(scores)


def stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Public functional: stacked [tp, fp, tn, fn, support] counts.

    Example:
        >>> import torch
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores(preds, target, reduce='micro')
        tensor([2, 2, 6, 2, 4], dtype=torch.int32)
    """
    if reduce not in ("micro", "macro", "samples"):
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in (None, "samplewise", "global"):
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        num_classes=num_classes,
        top_k=top_k,
        threshold=threshold,
        multiclass=multiclass,
        ignore_index=ignore_index,
        validate_args=validate_args,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
