"""The greedy COCO matcher in rank space: the hand-written CUDA kernel, its plain version and its loader.

Counterpart of ``metrics_tpu/detection/device.py::_match_kernel`` (a
``lax.fori_loop`` over the detections under three ``jax.vmap``\\ s, not a
Pallas kernel).  For each area range ``a``, block ``b`` (one class on one
image) and IoU threshold ``t``, the detections are walked in score order; each
takes, among the gts still free whose IoU rank reaches the threshold's rank,
the one with the highest rank, every counted gt before every ignored one, ties
to the highest gt index.

:func:`coco_match` launches ``csrc/coco_match.cu`` on CUDA tensors (one
device operation) and runs :func:`coco_match_plain` on CPU tensors.  Both
compare integers only, so they agree bitwise on every input; ``python3
chip_smoke.py`` (phase 14 (d)) and ``tests/test_torch_cuda.py`` hold the
kernel against the plain version on the card.  The library is built with
``nvcc`` at first use (:mod:`metrics_tpu_torch.ops._build`); a failed build or
launch raises.
"""

import ctypes
import functools

import torch

from metrics_tpu_torch.ops import _build

_SOURCE = _build.CSRC / "coco_match.cu"

#: the rank bump of a counted gt over an ignored one; every rank lies below it
PREF = 1 << 30


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    pointer, i64 = ctypes.c_void_p, ctypes.c_int64
    # (ranks, gig, thr, codes, A, B, T, D, G, stream)
    lib.coco_match.argtypes = [pointer] * 4 + [i64] * 5 + [pointer]
    lib.coco_match.restype = ctypes.c_int
    lib.coco_match_max_gts.argtypes = []
    lib.coco_match_max_gts.restype = ctypes.c_int
    return lib


def _check(ranks, gt_ignore, thr_ranks) -> None:
    tensors = (ranks, gt_ignore, thr_ranks)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("coco_match takes three tensors")
    if ranks.ndim != 3 or ranks.dtype != torch.int32:
        raise ValueError(f"coco_match takes ranks (B, D, G) int32, got {tuple(ranks.shape)} {ranks.dtype}")
    b, _, g = ranks.shape
    if gt_ignore.ndim != 3 or tuple(gt_ignore.shape[1:]) != (b, g) or gt_ignore.dtype != torch.bool:
        raise ValueError(f"coco_match takes gt_ignore (A, {b}, {g}) bool, got {tuple(gt_ignore.shape)} {gt_ignore.dtype}")
    if thr_ranks.ndim != 1 or thr_ranks.dtype != torch.int32:
        raise ValueError(f"coco_match takes thr_ranks (T,) int32, got {tuple(thr_ranks.shape)} {thr_ranks.dtype}")
    device = ranks.device
    if any(t.device != device for t in tensors):
        raise ValueError(f"coco_match takes tensors on one device, got {[str(t.device) for t in tensors]}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"coco_match runs on CPU or CUDA tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("coco_match takes contiguous tensors")


def coco_match_plain(ranks: torch.Tensor, gt_ignore: torch.Tensor, thr_ranks: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``_match_kernel``'s loop over the detections, every
    (area, block, threshold) at once, about ten device operations per detection.

    The argmax with ties to the highest index is two maxima: of the keys, then of the indices that
    hold the largest key.
    """
    _check(ranks, gt_ignore, thr_ranks)
    b, d_count, g = ranks.shape
    a, t = gt_ignore.shape[0], thr_ranks.shape[0]
    codes = torch.zeros((a, b, t, d_count), dtype=torch.uint8, device=ranks.device)
    if codes.numel() == 0 or g == 0:
        return codes
    pref = torch.where(gt_ignore, 0, PREF).to(torch.int32)[:, :, None, :]  # (A, B, 1, G)
    g_idx = torch.arange(g, dtype=torch.int32, device=ranks.device)
    thr = thr_ranks.view(1, 1, t, 1)
    avail = torch.ones((a, b, t, g), dtype=torch.bool, device=ranks.device)
    for d in range(d_count):
        r = ranks[:, d, :].view(1, b, 1, g)
        key = torch.where(avail & (r >= thr), r + pref, -1)  # (A, B, T, G)
        best = key.amax(dim=-1)
        g_star = torch.where(key == best[..., None], g_idx, -1).amax(dim=-1)
        matched = best >= 0
        ignored = torch.gather(gt_ignore[:, :, None, :].expand(a, b, t, g), -1, g_star.clamp(min=0)[..., None].long())[..., 0]
        codes[..., d] = torch.where(matched, torch.where(ignored, 2, 1), 0).to(torch.uint8)
        avail &= ~(matched[..., None] & (g_idx == g_star[..., None]))
    return codes


def coco_match(ranks: torch.Tensor, gt_ignore: torch.Tensor, thr_ranks: torch.Tensor) -> torch.Tensor:
    """Match codes ``(A, B, T, D)`` uint8 (0 unmatched, 1 matched to a counted gt, 2 matched to an
    ignored gt) of ``ranks (B, D, G)`` int32 (``-1`` pads), ``gt_ignore (A, B, G)`` bool and
    ``thr_ranks (T,)`` int32.

    Every rank lies below ``2**30``.  CPU tensors take :func:`coco_match_plain`; CUDA tensors launch
    the kernel on the current stream, one device operation (none when the codes are empty), for at
    most ``coco_match_max_gts()`` gts a block (58,112: the free-gt bitmasks of 32 lanes in one
    block's shared memory).  ``coco_match.launches`` counts the calls that launch it.
    """
    if isinstance(ranks, torch.Tensor) and ranks.device.type == "cpu":
        return coco_match_plain(ranks, gt_ignore, thr_ranks)
    _check(ranks, gt_ignore, thr_ranks)
    b, d_count, g = ranks.shape
    a, t = gt_ignore.shape[0], thr_ranks.shape[0]
    codes = torch.empty((a, b, t, d_count), dtype=torch.uint8, device=ranks.device)
    if codes.numel() == 0:
        return codes
    lib = _library()
    if g > lib.coco_match_max_gts():
        raise ValueError(f"coco_match on CUDA takes at most {lib.coco_match_max_gts()} gts a block, got {g}")
    with torch.cuda.device(ranks.device):
        err = lib.coco_match(
            ranks.data_ptr(), gt_ignore.data_ptr(), thr_ranks.data_ptr(), codes.data_ptr(),
            a, b, t, d_count, g, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"coco_match kernel launch failed with CUDA error {err}")
    coco_match.launches += 1
    return codes


coco_match.launches = 0
