"""Fused tp/fp/tn/fn counts: the hand-written CUDA kernel, its plain version and its loader.

Counterpart of ``metrics_tpu/ops/stat_scores_pallas.py::fused_stat_scores``.
:func:`fused_stat_scores` launches ``csrc/stat_scores.cu`` for CUDA tensors
and takes :func:`fused_stat_scores_plain` only for CPU tensors.  The kernel
is compiled with ``nvcc`` from the package's own source at first use, into
``build/kernels/`` at the root of the checkout, keyed by a hash of the source
and flags, and loaded with ``ctypes``.  A failed build or launch raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

_SOURCE = Path(__file__).resolve().parent / "csrc" / "stat_scores.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_THREADS = 256  # classes per block, as kThreads in the source
_MIN_ROWS_PER_BLOCK = 16
_BLOCKS_PER_SM = 4
_MAX_GRID_Y = 65535

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the stat-scores CUDA kernel cannot be built")
    return found


def build() -> Tuple[Path, str]:
    """Compile the kernel if this source has not been built yet.

    Returns the shared library's path and the compiler's messages (the
    ``-Xptxas -v`` register and shared-memory report; empty when the library
    was already built).
    """
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libstat_scores_{digest}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")  # concurrent builds never share a file
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {_SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name in ("stat_scores_i32", "stat_scores_u8"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64] + [
            ctypes.c_void_p
        ] * 5
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _row_blocks(n: int, c: int, device: torch.device) -> int:
    """Row splits (grid.y): enough blocks for a few per SM, at least 16 rows each."""
    col_blocks = -(-c // _THREADS)
    wanted = -(-_BLOCKS_PER_SM * _sm_count(device.index) // col_blocks)
    return max(1, min(-(-n // _MIN_ROWS_PER_BLOCK), wanted, _MAX_GRID_Y))


def _check_operands(preds: torch.Tensor, target: torch.Tensor) -> None:
    if not isinstance(preds, torch.Tensor) or not isinstance(target, torch.Tensor):
        raise TypeError("fused_stat_scores takes two tensors")
    if preds.dtype != target.dtype or preds.dtype not in (torch.int32, torch.bool):
        raise TypeError(
            f"fused_stat_scores takes two int32 or two bool tensors, got {preds.dtype} and {target.dtype}"
        )
    if preds.ndim != 2 or preds.shape != target.shape:
        raise ValueError(
            f"fused_stat_scores takes two (N, C) tensors of one shape, got {tuple(preds.shape)} "
            f"and {tuple(target.shape)}"
        )
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError("fused_stat_scores takes contiguous tensors")
    if preds.device != target.device:
        raise ValueError(f"preds lie on {preds.device} but target on {target.device}")


def fused_stat_scores_plain(preds: torch.Tensor, target: torch.Tensor) -> Counts:
    """The kernel's function in plain PyTorch: four masked sums over axis 0, int32."""
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
    kernel on the current stream.  ``fused_stat_scores.launches`` counts the
    kernel's launches.
    """
    _check_operands(preds, target)
    if preds.device.type == "cpu":
        return fused_stat_scores_plain(preds, target)
    if preds.device.type != "cuda":
        raise ValueError(f"fused_stat_scores runs on CPU or CUDA tensors, got {preds.device}")
    n, c = preds.shape
    out = torch.zeros((4, c), dtype=torch.int32, device=preds.device)
    if c == 0:
        return out[0], out[1], out[2], out[3]
    lib = _library()
    fn = lib.stat_scores_i32 if preds.dtype == torch.int32 else lib.stat_scores_u8
    with torch.cuda.device(preds.device):
        err = fn(
            preds.data_ptr(), target.data_ptr(), n, c, _row_blocks(n, c, preds.device),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stat_scores kernel launch failed with CUDA error {err}")
    fused_stat_scores.launches += 1
    return out[0], out[1], out[2], out[3]


fused_stat_scores.launches = 0
