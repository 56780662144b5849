"""Canonical input formatting for classification metrics, and the retrieval
input checks (counterpart of ``metrics_tpu/utils/checks.py``).

:func:`_check_classification_inputs` does the value-dependent checks (label
ranges) and :func:`_input_format_classification` turns any accepted
``(preds, target)`` pair into canonical binary int32 tensors, on the device
the inputs lie on.  :func:`_check_retrieval_inputs` flattens a retrieval
batch to int32 query ids, float32 scores and int32 or float32 targets.
:func:`check_forward_full_state_property` tells a custom metric's author
whether its ``forward`` may take the fast path (``full_state_update=False``).
"""

import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.data import allclose, apply_to_collection, select_topk, to_onehot
from metrics_tpu_torch.utils.enums import DataType


def _as_tensor(x) -> torch.Tensor:
    """Tensors stay on their own device; numpy arrays and lists land on the CPU.

    float64 rounds to float32, as ``jnp.asarray`` rounds it with
    ``jax_enable_x64`` off, so rankings and thresholds decide on the same values.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise if the shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _max_value(*xs: torch.Tensor) -> float:
    """The largest value over the given tensors, as a host float (one device read)."""
    return float(torch.stack([x.max().to(torch.float64) for x in xs]).max())


def _input_squeeze(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop a trailing singleton dim when both inputs carry it ((N,1) -> (N,))."""
    if preds.ndim == target.ndim == 2 and preds.shape[1] == 1 and target.shape[1] == 1:
        return preds.squeeze(-1), target.squeeze(-1)
    return preds, target


def _classify_case(
    preds: torch.Tensor,
    target: torch.Tensor,
    multiclass: Optional[bool],
) -> DataType:
    """Determine the input case from dtype, rank and, for integer inputs, values."""
    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                f"preds and target have same ndim but different shapes: {tuple(preds.shape)} vs "
                f"{tuple(target.shape)}"
            )
        if preds.ndim == 1:
            if multiclass is True:
                return DataType.MULTICLASS
            if multiclass is None and not preds.is_floating_point() and _max_value(preds, target) > 1:
                return DataType.MULTICLASS
            return DataType.BINARY
        if preds.is_floating_point():
            return DataType.MULTILABEL
        # both int, ndim >= 2: binary-valued data is multi-label, anything else
        # multi-dim multi-class
        if multiclass is False:
            return DataType.MULTILABEL
        if multiclass is None and _max_value(preds, target) <= 1:
            return DataType.MULTILABEL
        return DataType.MULTIDIM_MULTICLASS
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("preds with an extra class dimension must be floats (probabilities/logits)")
        if preds.ndim == 2:
            return DataType.MULTICLASS
        return DataType.MULTIDIM_MULTICLASS
    raise ValueError(
        f"preds and target ndim mismatch: preds.ndim={preds.ndim}, target.ndim={target.ndim}; "
        "either equal ndim or preds.ndim == target.ndim + 1 is required."
    )


def _check_classification_inputs(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    num_classes: Optional[int],
    multiclass: Optional[bool],
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
) -> None:
    """Value-dependent validation: each check reads the device once."""
    if target.is_floating_point():
        raise ValueError("target must be an integer tensor")
    if float(target.min()) < 0:
        if ignore_index is None or float(torch.where(target == ignore_index, 0, target).min()) < 0:
            raise ValueError("target values must be non-negative")
    # float preds outside [0, 1] are accepted as logits and thresholded /
    # argmaxed directly
    if not 0.0 < threshold < 1.0:
        raise ValueError(f"threshold must be in (0, 1), got {threshold}")
    case = _classify_case(preds, target, multiclass)
    implied_classes = None
    if preds.ndim == target.ndim + 1:
        implied_classes = preds.shape[1]
    elif case == DataType.MULTILABEL:
        implied_classes = preds.shape[1]
    if num_classes is not None and implied_classes is not None and case != DataType.MULTILABEL:
        if num_classes != implied_classes:
            raise ValueError(
                f"num_classes={num_classes} does not match the implied class dimension {implied_classes}"
            )
    tmax = _max_value(target)
    if implied_classes is not None and case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        if tmax >= implied_classes and (ignore_index is None or tmax != ignore_index):
            raise ValueError(f"target contains label {int(tmax)} >= num_classes {implied_classes}")
    if num_classes is not None and tmax >= num_classes and case != DataType.BINARY:
        if ignore_index is None or tmax != ignore_index:
            raise ValueError(f"target contains label {int(tmax)} >= num_classes {num_classes}")
    if top_k is not None:
        if case not in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or not preds.is_floating_point():
            raise ValueError("top_k is only supported for (multi-dim) multi-class probability inputs")
        if implied_classes is not None and top_k >= implied_classes:
            raise ValueError(f"top_k={top_k} must be < number of classes ({implied_classes})")


def _infer_num_classes(
    preds: torch.Tensor,
    target: torch.Tensor,
    case: DataType,
    num_classes: Optional[int],
) -> int:
    if case == DataType.BINARY:
        return 1
    if preds.ndim == target.ndim + 1:
        return preds.shape[1] if num_classes is None else num_classes
    if case == DataType.MULTILABEL:
        return preds.shape[1]
    if num_classes is not None:
        return num_classes
    return int(_max_value(preds, target)) + 1


def _input_format_classification(
    preds,
    target,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    case: Optional[DataType] = None,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """Normalize any accepted (preds, target) pair to canonical binary int32 tensors.

    Returns ``(preds, target, case)`` where both tensors are ``(N, C)`` int32
    (or ``(N, C, X)`` for multi-dim multi-class).  A ``case`` locked earlier
    by the module metric skips the value-dependent case detection.
    """
    preds, target, case = _checked_inputs(
        preds, target, threshold, top_k, num_classes, multiclass, ignore_index, validate_args, case
    )
    return _canonical_format(preds, target, case, threshold, top_k, num_classes, multiclass)


@_obs.spanned_function("validation.check")
def _checked_inputs(
    preds,
    target,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    case: Optional[DataType] = None,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """The first half of :func:`_input_format_classification`: tensors on one
    device, squeezed, validated when ``validate_args``, and their input case."""
    preds = _as_tensor(preds)
    target = _as_tensor(target)
    if preds.device != target.device:
        raise ValueError(f"preds lie on {preds.device} but target on {target.device}")
    preds, target = _input_squeeze(preds, target)
    if validate_args:
        _check_classification_inputs(
            preds, target, threshold=threshold, num_classes=num_classes,
            multiclass=multiclass, top_k=top_k, ignore_index=ignore_index,
        )
    if case is None:
        case = _classify_case(preds, target, multiclass)
    return preds, target, case


@_obs.spanned_function("validation.format")
def _canonical_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    case: DataType,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """The second half of :func:`_input_format_classification`: checked inputs to canonical form."""
    top_k = top_k or 1

    if case == DataType.BINARY:
        if preds.is_floating_point():
            preds_b = (preds >= threshold).to(torch.int32)
        else:
            preds_b = preds.to(torch.int32)
        target_b = target.to(torch.int32)
        if multiclass is True:
            # promote binary -> explicit 2-class one-hot
            return to_onehot(preds_b, 2), to_onehot(target_b, 2), DataType.MULTICLASS
        return preds_b[:, None], target_b[:, None], case

    if case == DataType.MULTILABEL:
        if preds.is_floating_point():
            preds_b = (preds >= threshold).to(torch.int32)
        else:
            preds_b = preds.to(torch.int32)
        # flatten any extra dims into the label axis
        preds_b = preds_b.reshape(preds_b.shape[0], -1)
        target_b = target.to(torch.int32).reshape(target.shape[0], -1)
        return preds_b, target_b, case

    # multi-class / multi-dim multi-class
    n_classes = _infer_num_classes(preds, target, case, num_classes)

    if preds.ndim == target.ndim + 1:  # probabilities with class dim at 1
        # flatten trailing dims: (N, C, d1, d2, ...) -> (N, C, X)
        if preds.ndim > 2:
            preds_p = preds.reshape(preds.shape[0], preds.shape[1], -1)
            target_l = target.reshape(target.shape[0], -1)
        else:
            preds_p = preds
            target_l = target
        preds_c = select_topk(preds_p, top_k, dim=1)
        target_c = to_onehot(target_l, n_classes)
    else:  # dense labels for both
        if preds.ndim > 1:
            preds_l = preds.reshape(preds.shape[0], -1)
            target_l = target.reshape(target.shape[0], -1)
        else:
            preds_l, target_l = preds, target
        preds_c = to_onehot(preds_l, n_classes)
        target_c = to_onehot(target_l, n_classes)

    if multiclass is False:
        # user asserts these are really binary/multilabel: collapse class dim
        if n_classes == 2:
            preds_c = preds_c[:, 1]
            target_c = target_c[:, 1]
            if preds_c.ndim == 1:
                preds_c, target_c = preds_c[:, None], target_c[:, None]
            return preds_c, target_c, DataType.BINARY if case == DataType.MULTICLASS else DataType.MULTILABEL

    if case == DataType.MULTICLASS and target_c.ndim == 3 and target_c.shape[-1] == 1:
        preds_c, target_c = preds_c.squeeze(-1), target_c.squeeze(-1)
    return preds_c, target_c, case


def _results_close(a: Any, b: Any) -> bool:
    """Whether two nested results (tensors, numbers, lists, tuples, dicts) agree leaf by leaf (:func:`allclose`)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys() and all(
            _results_close(a[k], b[k]) for k in a
        )
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_results_close(x, y) for x, y in zip(a, b)))
    a = torch.as_tensor(a)
    return allclose(a, torch.as_tensor(b, device=a.device))


def _wait_for(result: Any) -> None:
    """Wait for the card when any tensor of ``result`` lies on it (the JAX package's ``block_until_ready``)."""
    on_card: list = []
    apply_to_collection(result, torch.Tensor, lambda t: on_card.append(t.is_cuda))
    if any(on_card):
        torch.cuda.synchronize()


def check_forward_full_state_property(
    metric_class,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare=(10, 100, 1000),
    reps: int = 5,
) -> None:
    """Compare ``forward`` with ``full_state_update`` True and False on ``metric_class``.

    Raises ``ValueError`` when the first ``forward`` of the two differs (the
    metric needs ``full_state_update=True``); else prints the mean and spread
    of ``reps`` runs of each number of steps in ``num_update_to_compare``,
    each ended by a ``compute()``, and recommends ``False``.  The metrics are
    built with ``init_args``, so on the card unless they pass ``device="cpu"``.
    """
    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):
        full_state_update = True

    class PartState(metric_class):
        full_state_update = False

    m_full, m_part = FullState(**init_args), PartState(**init_args)
    if not _results_close(m_full(**input_args), m_part(**input_args)):
        raise ValueError(
            "The two step results of full_state_update True/False differ; "
            f"full_state_update=True is required for {metric_class.__name__}."
        )
    for n_updates in num_update_to_compare:
        for cls, label in ((FullState, "True"), (PartState, "False")):
            times = []
            for _ in range(reps):
                m = cls(**init_args)
                start = time.perf_counter()
                for _ in range(n_updates):
                    m(**input_args)
                _wait_for(m.compute())
                times.append(time.perf_counter() - start)
            print(f"full_state_update={label}: {np.mean(times):.4g}s +- {np.std(times):.2g} for {n_updates} steps")
    print(f"Recommended setting `full_state_update=False` for {metric_class.__name__} (results match).")


# --------------------------------------------------------------------- retrieval
def _retrieval_dtypes(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat float32 scores and flat float32 (floating targets) or int32 (bool and integer targets) targets."""
    target = target.to(torch.float32) if target.is_floating_point() else target.to(torch.int32)
    return preds.to(torch.float32).reshape(-1), target.reshape(-1)


def _check_retrieval_target_and_prediction_types(
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dtype and value checks for retrieval inputs; the range check is one device->host read."""
    if target.is_complex():
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    if not allow_non_binary_target and bool(((target > 1) | (target < 0)).any()):
        raise ValueError("`target` must contain `binary` values")
    return _retrieval_dtypes(preds, target)


def _check_retrieval_functional_inputs(
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and dtype checks for one query's ``(preds, target)``."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if not validate_args:
        return _retrieval_dtypes(preds, target)
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0 or preds.ndim == 0:
        raise ValueError("`preds` and `target` must be non-empty and non-scalar tensors")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target=allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shape and dtype checks for ``(indexes, preds, target)``, flattened; the
    rows whose target equals ``ignore_index`` are dropped.  Query ids become int32."""
    indexes, preds, target = _as_tensor(indexes), _as_tensor(preds), _as_tensor(target)
    if validate_args:
        if indexes.shape != preds.shape or preds.shape != target.shape:
            raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
        if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
            raise ValueError("`indexes` must be a tensor of long integers")
    if ignore_index is not None:
        valid = (target != ignore_index).reshape(-1)
        indexes = indexes.reshape(-1)[valid]
        preds = preds.reshape(-1)[valid]
        target = target.reshape(-1)[valid]
    if validate_args:
        if indexes.numel() == 0 or indexes.ndim == 0:
            raise ValueError("`indexes`, `preds` and `target` must be non-empty and non-scalar tensors")
        preds, target = _check_retrieval_target_and_prediction_types(
            preds, target, allow_non_binary_target=allow_non_binary_target
        )
    else:
        preds, target = _retrieval_dtypes(preds, target)
    return indexes.to(torch.int32).reshape(-1), preds, target
