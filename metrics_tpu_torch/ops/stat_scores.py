"""Fused tp/fp/tn/fn counts: the hand-written CUDA kernels, their plain versions and their loader.

Counterpart of ``metrics_tpu/ops/stat_scores_pallas.py::fused_stat_scores``,
with two entry points in ``csrc/stat_scores.cu``, one launch each:

* :func:`fused_stat_scores` counts canonical binary ``(N, C)`` operands, the
  TPU kernel's own function;
* :func:`fused_stat_scores_logits` counts float logits ``(N, C)`` against
  integer labels ``(N,)``, taking each row's argmax inside the kernel: the
  result of ``fused_stat_scores(select_topk(logits, 1), to_onehot(labels, C))``
  without the one-hot operands;
* :func:`fused_stream_stat_scores` and :func:`fused_stream_stat_scores_logits`
  count the same inputs per stream: each row carries a stream id and adds
  its counts into its stream's row of ``(S, C)`` outputs (``(S,)`` summed
  over the classes with ``micro``), as the JAX package's multistream segment
  update adds each row's own stat-scores update into its stream.

CUDA tensors launch the kernel and CPU tensors take the plain version.  The
kernels are compiled with ``nvcc`` from the package's own source at first use,
into ``build/kernels/`` at the root of the checkout, keyed by a hash of the
source and flags, and loaded with ``ctypes`` (:mod:`metrics_tpu_torch.ops._build`).  A failed build or launch raises.
"""

import ctypes
import functools
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.utils.data import select_topk, to_onehot

_SOURCE = _build.CSRC / "stat_scores.cu"
_COUNT_FUNCTIONS = {torch.int32: "stat_scores_i32", torch.bool: "stat_scores_u8"}
_LOGITS_FUNCTIONS = {
    torch.float32: "stat_scores_logits_f32",
    torch.bfloat16: "stat_scores_logits_b16",
    torch.float16: "stat_scores_logits_b16",
}
LOGIT_DTYPES = tuple(_LOGITS_FUNCTIONS)
LABEL_DTYPES = (torch.int64, torch.int32)
_STREAM_LOGITS_FUNCTIONS = {dtype: "stream_" + name for dtype, name in _LOGITS_FUNCTIONS.items()}
_STREAM_COUNT_FUNCTIONS = {dtype: "stream_" + name for dtype, name in _COUNT_FUNCTIONS.items()}
ID_DTYPES = (torch.int64, torch.int32)

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    pointer, i64 = ctypes.c_void_p, ctypes.c_int64
    for name in set(_COUNT_FUNCTIONS.values()):
        fn = getattr(lib, name)  # (preds, target, n, c, out, stream)
        fn.argtypes = [pointer, pointer, i64, i64, pointer, pointer]
        fn.restype = ctypes.c_int
    for name in set(_LOGITS_FUNCTIONS.values()):
        fn = getattr(lib, name)  # (logits, labels, labels_are_64, n, c, pred scratch, out, stream)
        fn.argtypes = [pointer, pointer, ctypes.c_int, i64, i64, pointer, pointer, pointer]
        fn.restype = ctypes.c_int
    for name in set(_STREAM_LOGITS_FUNCTIONS.values()):
        fn = getattr(lib, name)  # (logits, labels, labels_are_64, ids, ids_are_64, n, c, s, micro, out, stream)
        fn.argtypes = [pointer, pointer, ctypes.c_int, pointer, ctypes.c_int, i64, i64, i64, ctypes.c_int, pointer, pointer]
        fn.restype = ctypes.c_int
    for name in set(_STREAM_COUNT_FUNCTIONS.values()):
        fn = getattr(lib, name)  # (preds, target, ids, ids_are_64, n, c, s, micro, out, stream)
        fn.argtypes = [pointer, pointer, pointer, ctypes.c_int, i64, i64, i64, ctypes.c_int, pointer, pointer]
        fn.restype = ctypes.c_int
    return lib


def _check_tensors(name: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name} takes tensors on one device, got {[str(t.device) for t in tensors]}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_operands(preds: torch.Tensor, target: torch.Tensor) -> None:
    if not isinstance(preds, torch.Tensor) or not isinstance(target, torch.Tensor):
        raise TypeError("fused_stat_scores takes two tensors")
    if preds.dtype != target.dtype or preds.dtype not in _COUNT_FUNCTIONS:
        raise TypeError(
            f"fused_stat_scores takes two int32 or two bool tensors, got {preds.dtype} and {target.dtype}"
        )
    if preds.ndim != 2 or preds.shape != target.shape:
        raise ValueError(
            f"fused_stat_scores takes two (N, C) tensors of one shape, got {tuple(preds.shape)} "
            f"and {tuple(target.shape)}"
        )
    _check_tensors("fused_stat_scores", preds, target)


def _check_logits_operands(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if not isinstance(logits, torch.Tensor) or not isinstance(labels, torch.Tensor):
        raise TypeError("fused_stat_scores_logits takes two tensors")
    if logits.dtype not in LOGIT_DTYPES or labels.dtype not in LABEL_DTYPES:
        raise TypeError(
            "fused_stat_scores_logits takes float32, bfloat16 or float16 logits and int64 or int32 "
            f"labels, got {logits.dtype} and {labels.dtype}"
        )
    if logits.ndim != 2 or labels.shape != logits.shape[:1] or logits.shape[1] == 0:
        raise ValueError(
            "fused_stat_scores_logits takes (N, C) logits with C >= 1 and (N,) labels, got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}"
        )
    _check_tensors("fused_stat_scores_logits", logits, labels)


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def fused_stat_scores_plain(preds: torch.Tensor, target: torch.Tensor) -> Counts:
    """The canonical kernel's function in plain PyTorch: four masked sums over axis 0, int32."""
    pos = preds == 1
    same = target == preds
    return (
        (same & pos).sum(0, dtype=torch.int32),
        (~same & pos).sum(0, dtype=torch.int32),
        (same & ~pos).sum(0, dtype=torch.int32),
        (~same & ~pos).sum(0, dtype=torch.int32),
    )


def fused_stat_scores(preds: torch.Tensor, target: torch.Tensor) -> Counts:
    """Per-class ``(tp, fp, tn, fn)``, each ``(C,)`` int32, over axis 0 of binary ``(N, C)`` tensors.

    CPU tensors take :func:`fused_stat_scores_plain`; CUDA tensors launch the
    kernel on the current stream, one device operation per call.
    ``fused_stat_scores.launches`` counts the kernel's launches.
    """
    _check_operands(preds, target)
    if preds.device.type == "cpu":
        return fused_stat_scores_plain(preds, target)
    n, c = preds.shape
    out = torch.empty((4, c), dtype=torch.int32, device=preds.device)
    if c == 0:
        return out.unbind(0)
    fn = getattr(_library(), _COUNT_FUNCTIONS[preds.dtype])
    with torch.cuda.device(preds.device):
        err = fn(preds.data_ptr(), target.data_ptr(), n, c, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error("stat_scores", err)
    fused_stat_scores.launches += 1
    return out.unbind(0)


fused_stat_scores.launches = 0


def fused_stat_scores_logits_plain(logits: torch.Tensor, labels: torch.Tensor) -> Counts:
    """The logits kernel's function in plain PyTorch, as the JAX package computes it:
    the top-1 mask of the logits and the one-hot of the labels, then the four counts."""
    return fused_stat_scores_plain(select_topk(logits, 1), to_onehot(labels, logits.shape[1]))


def fused_stat_scores_logits(logits: torch.Tensor, labels: torch.Tensor) -> Counts:
    """Per-class ``(tp, fp, tn, fn)``, each ``(C,)`` int32, of each row's argmax against its label.

    ``logits`` is ``(N, C)`` float32, bfloat16 or float16; ``labels`` is
    ``(N,)`` int64 or int32, and a label outside ``[0, C)`` counts for no
    class.  The argmax ranks values as ``lax.top_k`` does (see
    :func:`metrics_tpu_torch.utils.data.select_topk`).  CPU tensors take
    :func:`fused_stat_scores_logits_plain`; CUDA tensors launch the kernel on
    the current stream, one device operation per call.
    ``fused_stat_scores_logits.launches`` counts the kernel's launches.
    """
    _check_logits_operands(logits, labels)
    if logits.device.type == "cpu":
        return fused_stat_scores_logits_plain(logits, labels)
    n, c = logits.shape
    buffer = torch.empty(4 * c + n, dtype=torch.int32, device=logits.device)
    out, pred = buffer[: 4 * c].view(4, c), buffer[4 * c :]  # pred: each row's argmax, scratch
    fn = getattr(_library(), _LOGITS_FUNCTIONS[logits.dtype])
    with torch.cuda.device(logits.device):
        err = fn(
            logits.data_ptr(), labels.data_ptr(), labels.dtype == torch.int64, n, c,
            pred.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on_error("stat_scores_logits", err)
    fused_stat_scores_logits.launches += 1
    return out.unbind(0)


fused_stat_scores_logits.launches = 0


def _check_stream_ids(name: str, ids: torch.Tensor, n: int, num_streams: int) -> None:
    if not isinstance(ids, torch.Tensor) or ids.dtype not in ID_DTYPES:
        raise TypeError(f"{name} takes int64 or int32 stream ids, got {getattr(ids, 'dtype', type(ids))}")
    if ids.shape != (n,):
        raise ValueError(f"{name} takes one stream id per row: ({n},), got {tuple(ids.shape)}")
    if int(num_streams) < 1:
        raise ValueError(f"{name} needs num_streams >= 1, got {num_streams}")


def _stream_plain(tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor, ids: torch.Tensor,
                  num_streams: int, micro: bool) -> Counts:
    """Per-row counts ``(N, C)`` added into their streams' rows with ``index_add_``; rows
    whose id lies outside ``[0, S)`` land in a spare row that is cut off."""
    if micro:
        tp, fp, tn, fn = (x.sum(1, dtype=torch.int32) for x in (tp, fp, tn, fn))
    ids = ids.to(torch.int64)
    slot = torch.where((ids >= 0) & (ids < num_streams), ids, torch.full_like(ids, num_streams))
    out = []
    for x in (tp, fp, tn, fn):
        acc = torch.zeros((num_streams + 1,) + tuple(x.shape[1:]), dtype=torch.int32, device=x.device)
        out.append(acc.index_add_(0, slot, x.to(torch.int32))[:num_streams])
    return tuple(out)


def fused_stream_stat_scores_plain(preds: torch.Tensor, target: torch.Tensor, ids: torch.Tensor, num_streams: int,
                                   micro: bool = False) -> Counts:
    """The per-stream canonical kernel's function in plain PyTorch: each row's own counts, then ``index_add_``."""
    pos = preds == 1
    same = target == preds
    return _stream_plain(same & pos, ~same & pos, same & ~pos, ~same & ~pos, ids, num_streams, micro)


def _launch_stream(name: str, fn_name: str, a: torch.Tensor, b: torch.Tensor, ids: torch.Tensor, num_streams: int,
                   micro: bool, logits: bool) -> Counts:
    n, c = a.shape
    s = int(num_streams)
    width = 1 if micro else c
    # the four outputs, which the kernel writes entry by entry, then the logits route's scratch: each row's
    # stream, argmax and label
    buffer = torch.empty(4 * s * width + (3 * n if logits else 0), dtype=torch.int32, device=a.device)
    fn = getattr(_library(), fn_name)
    ids_64 = ids.dtype == torch.int64
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if logits:
            err = fn(a.data_ptr(), b.data_ptr(), b.dtype == torch.int64, ids.data_ptr(), ids_64, n, c, s, int(micro),
                     buffer.data_ptr(), stream)
        else:
            err = fn(a.data_ptr(), b.data_ptr(), ids.data_ptr(), ids_64, n, c, s, int(micro), buffer.data_ptr(), stream)
    _raise_on_error(name, err)
    counts = buffer[: 4 * s * width].view(4, s, width)
    return tuple(x.reshape(s) if micro else x for x in counts.unbind(0))


def fused_stream_stat_scores(preds: torch.Tensor, target: torch.Tensor, ids: torch.Tensor, num_streams: int,
                             micro: bool = False) -> Counts:
    """Per-stream ``(tp, fp, tn, fn)`` of binary ``(N, C)`` operands: each ``(S, C)`` int32,
    or ``(S,)`` summed over the classes with ``micro``.

    Row ``i`` adds its counts into stream ``ids[i]``; a row whose id lies
    outside ``[0, num_streams)`` is dropped.  CPU tensors take
    :func:`fused_stream_stat_scores_plain`; CUDA tensors launch the kernel on
    the current stream, one device operation per call.
    ``fused_stream_stat_scores.launches`` counts the kernel's launches.
    """
    _check_operands(preds, target)
    _check_stream_ids("fused_stream_stat_scores", ids, preds.shape[0], num_streams)
    _check_tensors("fused_stream_stat_scores", preds, target, ids)
    if preds.device.type == "cpu":
        return fused_stream_stat_scores_plain(preds, target, ids, num_streams, micro)
    if preds.shape[1] == 0:
        raise ValueError("fused_stream_stat_scores takes (N, C) operands with C >= 1")
    out = _launch_stream("stream_stat_scores", _STREAM_COUNT_FUNCTIONS[preds.dtype], preds, target, ids,
                         num_streams, micro, logits=False)
    fused_stream_stat_scores.launches += 1
    return out


fused_stream_stat_scores.launches = 0


def fused_stream_stat_scores_logits_plain(logits: torch.Tensor, labels: torch.Tensor, ids: torch.Tensor,
                                          num_streams: int, micro: bool = False) -> Counts:
    """The per-stream logits kernel's function in plain PyTorch: each row's top-1 mask and
    label one-hot, its own counts, then ``index_add_`` into its stream."""
    return fused_stream_stat_scores_plain(select_topk(logits, 1), to_onehot(labels, logits.shape[1]), ids,
                                          num_streams, micro)


def fused_stream_stat_scores_logits(logits: torch.Tensor, labels: torch.Tensor, ids: torch.Tensor,
                                    num_streams: int, micro: bool = False) -> Counts:
    """Per-stream ``(tp, fp, tn, fn)`` of each row's argmax against its label: each ``(S, C)``
    int32, or ``(S,)`` summed over the classes with ``micro``.

    The inputs are :func:`fused_stat_scores_logits`'s, and ``ids`` ``(N,)``
    int64 or int32 assigns each row to a stream; a row whose id lies outside
    ``[0, num_streams)`` is dropped.  CPU tensors take
    :func:`fused_stream_stat_scores_logits_plain`; CUDA tensors launch the
    kernel on the current stream, one device operation per call.
    ``fused_stream_stat_scores_logits.launches`` counts the kernel's launches.
    """
    _check_logits_operands(logits, labels)
    _check_stream_ids("fused_stream_stat_scores_logits", ids, logits.shape[0], num_streams)
    _check_tensors("fused_stream_stat_scores_logits", logits, labels, ids)
    if logits.device.type == "cpu":
        return fused_stream_stat_scores_logits_plain(logits, labels, ids, num_streams, micro)
    out = _launch_stream("stream_stat_scores_logits", _STREAM_LOGITS_FUNCTIONS[logits.dtype], logits, labels, ids,
                         num_streams, micro, logits=True)
    fused_stream_stat_scores_logits.launches += 1
    return out


fused_stream_stat_scores_logits.launches = 0
