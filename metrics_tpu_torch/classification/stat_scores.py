"""StatScores module metric, base of the stat-scores family
(counterpart of ``metrics_tpu/classification/stat_scores.py``)."""

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.accuracy import _mode
from metrics_tpu_torch.functional.classification.stat_scores import (
    _stat_scores_compute,
    _stat_scores_stream_update,
    _stat_scores_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _as_tensor, _max_value
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import DataType


class StatScores(Metric):
    """Streaming tp/fp/tn/fn counts.

    States are fixed-shape int32 tensors with ``sum`` reduction when possible
    (micro → scalar, macro → ``(C,)``); per-sample reductions
    (``reduce='samples'`` / ``mdmc_reduce='samplewise'``) keep ``cat`` list
    states.

    ``validate_args=False`` contract: the per-batch value inspection (a
    device->host read) is skipped for batches whose static signature (dtype
    kind / rank / trailing shape) matches the locked input case.  An
    input-case switch that changes only *values* is therefore not caught on
    the switching batch; detection re-runs every ``_REDETECT_EVERY`` skipped
    batches, so a sustained switch still raises.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StatScores
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> metric = StatScores(reduce='micro', device='cpu')
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([2, 2, 6, 2, 4], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    stackable = True  # tensor sum states only; per-stream stacking is exact
    # with validate_args=False, re-run value-level case detection after this
    # many fingerprint-matched (skipped) batches
    _REDETECT_EVERY = 64
    # the locked input case must survive a checkpoint restore: a restored
    # metric may go straight to compute() without seeing another batch
    _ckpt_attrs = ("mode",)

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        multiclass: Optional[bool] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.multiclass = multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k
        self.validate_args = validate_args

        if reduce not in ("micro", "macro", "samples"):
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in (None, "samplewise", "global"):
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        default_factory: Callable[[], Any]
        if mdmc_reduce != "samplewise" and reduce != "samples":
            zeros_shape: Tuple[int, ...] = () if reduce == "micro" else (num_classes,)  # type: ignore[assignment]
            default_factory = lambda: torch.zeros(zeros_shape, dtype=torch.int32)  # noqa: E731
            reduce_fn = "sum"
        else:
            default_factory = list
            reduce_fn = "cat"

        self.mode: Optional[DataType] = None
        self._locked_fingerprint: Optional[tuple] = None
        self._fingerprint_skips = 0
        for s in ("tp", "fp", "tn", "fn"):
            self.add_state(s, default=default_factory(), dist_reduce_fx=reduce_fn)

    @staticmethod
    def _input_fingerprint(preds: torch.Tensor, target: torch.Tensor) -> tuple:
        """Static (value-free) input signature: enough to notice a mode switch
        like float probs vs int labels without any device->host read."""
        return (
            preds.is_floating_point(),
            preds.ndim,
            tuple(preds.shape[1:]),
            target.is_floating_point(),
            target.ndim,
            tuple(target.shape[1:]),
        )

    def _pre_update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Lock the input case on the first batch; check later batches against it."""
        preds, target = _as_tensor(preds), _as_tensor(target)
        # with validation disabled, skip re-detection (each value inspection
        # is a device->host read) for batches whose static signature matches
        # the locked one; a dtype/rank change still re-runs detection and raises
        needs_classes = self.mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS)
        if (
            self.mode is not None
            and not self.validate_args
            and (self.num_classes is not None or not needs_classes)
            and self._locked_fingerprint == self._input_fingerprint(preds, target)
        ):
            skips = self._fingerprint_skips + 1
            if skips < self._REDETECT_EVERY:
                self._fingerprint_skips = skips
                return
            self._fingerprint_skips = 0  # periodic re-detection catches value-only switches
        mode = _mode(
            preds, target, self.threshold, self.top_k, self.num_classes,
            self.multiclass, self.ignore_index, validate_args=self.validate_args,
        )
        if self.mode is None:
            self.mode = mode
        elif self.mode != mode:
            # a batch whose VALUES are a subset of the locked case (all labels
            # <= 1 in a multiclass stream, all-{0,1} ints in a multidim
            # stream) classifies as the narrower case; that confirms the lock
            # rather than conflicting with it
            value_subset_ok = {
                (DataType.BINARY, DataType.MULTICLASS),
                (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS),
            }
            if (mode, self.mode) not in value_subset_ok:
                raise ValueError(f"You can not use {mode} inputs with {self.mode} inputs.")
        self._locked_fingerprint = self._input_fingerprint(preds, target)
        # infer the class count from the first batch, so later batches
        # one-hot to the same width
        if self.num_classes is None and self.mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            if preds.is_floating_point():
                self.num_classes = preds.shape[1]
            else:
                self.num_classes = int(_max_value(preds, target)) + 1

    def _accumulate(self, tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> None:
        """Fold one batch's counts into the states (rebinding, never in place)."""
        if isinstance(self.tp, list):
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
            mode=self.mode,
            validate_args=self.validate_args,
        )
        self._accumulate(tp, fp, tn, fn)

    def _stream_counts(self, ids: torch.Tensor, num_streams: int, preds: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The tp/fp/tn/fn sums per stream (:func:`_stat_scores_stream_update`)."""
        tp, fp, tn, fn = _stat_scores_stream_update(
            preds,
            target,
            ids,
            num_streams,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            multiclass=self.multiclass,
            ignore_index=self.ignore_index,
            mode=self.mode,
            validate_args=self.validate_args,
        )
        return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}

    def _stream_update(self, ids: torch.Tensor, num_streams: int, *args: Any, **kwargs: Any) -> Optional[Dict[str, torch.Tensor]]:
        """Per-stream sums of the states each row's own :meth:`update` would add
        (:class:`~metrics_tpu_torch.multistream.MultiStreamMetric`'s segment route):
        one launch of the per-stream stat-scores kernel on a CUDA tensor.
        ``None`` where this class's update is not the one it mirrors."""
        if type(self).update is not StatScores.update:
            return None
        return self._stream_counts(ids, num_streams, *args, **kwargs)

    def _get_final_stats(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenate list states (if any) into final count tensors."""
        return (
            dim_zero_cat(self.tp),
            dim_zero_cat(self.fp),
            dim_zero_cat(self.tn),
            dim_zero_cat(self.fn),
        )

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)
