"""Hinge loss functional (counterpart of ``metrics_tpu/functional/classification/hinge.py``)."""

from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _input_squeeze
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


_MODE_ERROR = (
    "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
    "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
)


def _check_shape_and_type_consistency_hinge(preds: torch.Tensor, target: torch.Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        return DataType.BINARY
    if preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        return DataType.MULTICLASS
    raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")


def _hinge_measures(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> torch.Tensor:
    """The hinge loss of each sample: ``(N,)``, or ``(N, C)`` one-vs-all."""
    preds, target = _input_squeeze(_as_tensor(preds), _as_tensor(target))
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        # a label outside [0, C) gives an all-False row, as jax.nn.one_hot gives
        target_oh = to_onehot(target, max(2, preds.shape[1])).bool()

    if mode == DataType.MULTICLASS and (
        multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER
    ):
        # margin = score of the true class minus the best competing score
        true_score = torch.where(target_oh, preds, 0.0).sum(1)
        other_best = torch.where(target_oh, -torch.inf, preds).amax(1)
        margin = true_score - other_best
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        t = target.bool() if mode == DataType.BINARY else target_oh
        margin = torch.where(t, preds, -preds)
    else:
        raise ValueError(f"{_MODE_ERROR} got {multiclass_mode}.")

    measures = torch.clamp(1 - margin, min=0)
    return measures**2 if squared else measures


def _hinge_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed loss (a scalar, or ``(C,)`` one-vs-all) and the int32 sample count."""
    measures = _hinge_measures(preds, target, squared, multiclass_mode)
    total = torch.tensor(measures.shape[0], dtype=torch.int32, device=measures.device)
    return measures.sum(0), total


def _hinge_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> torch.Tensor:
    """Mean hinge loss (Crammer-Singer or one-vs-all for multi-class), on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> round(float(hinge_loss(preds, target)), 6)
        0.3
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
