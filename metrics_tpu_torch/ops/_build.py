"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface, at first use, into ``build/kernels/`` at the root of the
checkout, named by the source's stem and a hash of its text and the flags:
an edited source builds anew, an unchanged one loads what is there.
:func:`build` starts one ``nvcc`` per missing library, all at once.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return found


def library_path(source: Path) -> Path:
    """Where ``source``'s shared library lives once built."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build(*sources: Path) -> List[Tuple[Path, str]]:
    """Compile each source whose library is missing, one ``nvcc`` each, all started together.

    Returns each source's library path and the compiler's messages (the
    ``-Xptxas -v`` register and shared-memory report; empty for a library
    that was already built).  A failed compile raises, naming its source.
    """
    pending = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")  # concurrent builds never share a file
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        pending[source] = (proc, tmp, out)
    logs = {}
    for source, (proc, tmp, out) in pending.items():
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source.name} (exit {proc.returncode}):\n{stderr}")
        os.replace(tmp, out)
        logs[source] = stderr
    return [(library_path(source), logs.get(source, "")) for source in sources]


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """``source``'s shared library, built first if it is missing; the caller sets each function's argtypes."""
    return ctypes.CDLL(str(build(source)[0][0]))
