"""Device-side costs behind the port's stat-scores kernels, on one NVIDIA GPU.

Run from the root of a checkout, optionally naming further checkouts of the
port to compare (for example an unpacked ``git archive`` of the parent commit):

    python3 tools/port_device_probe.py [ROOT ...]

It prints, with the card's name and power limit:

1. the own device time (``torch.profiler``) of kernels that do nothing but
   synchronise, built from the source below with ``nvcc``: an empty grid of
   128 blocks, the same grid launched cooperatively with one ``grid.sync()``,
   and 16 clusters of 8 blocks with one ``cluster.sync()``, the barriers the
   stat-scores kernels pay for;
2. for the package under this checkout and under each ROOT, the device
   operations that one ``forward`` of configuration 1 and one ``update`` of
   configuration 2 issue at a batch of (1024, 1000) float32 logits, with their
   summed own device time and the device-to-host copies among them, and the
   median wall time of such an update, host work included, measured in turns
   over the checkouts.
"""

import ctypes
import importlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
N, C = 1024, 1000
BARRIERS = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void empty_kernel() {}
__global__ void grid_sync_kernel() { cg::this_grid().sync(); }
__global__ void cluster_sync_kernel() { cg::this_cluster().sync(); }
extern "C" int empty(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
extern "C" int grid_sync(int blocks, void* stream) {
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_sync_kernel), dim3(blocks),
                                                      dim3(256), nullptr, 0, static_cast<cudaStream_t>(stream)));
}
extern "C" int cluster_sync(int clusters, int size, void* stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1, clusters * size, 1);
  config.blockDim = dim3(256, 1, 1);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = size;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, cluster_sync_kernel));
}
"""


def _device_ops(fn, calls: int = 1) -> list:
    """(name, own device us) of each device operation that ``calls`` calls of ``fn`` issue."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def barriers() -> None:
    sys.path.insert(0, str(ROOT))
    from metrics_tpu_torch.ops._build import _nvcc

    build = ROOT / "build" / "probe"
    build.mkdir(parents=True, exist_ok=True)
    (build / "barriers.cu").write_text(BARRIERS)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(build / "barriers.so"), str(build / "barriers.cu")], check=True)
    lib = ctypes.CDLL(str(build / "barriers.so"))
    lib.empty.argtypes = lib.grid_sync.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.cluster_sync.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty.restype = lib.grid_sync.restype = lib.cluster_sync.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    cases = {
        "empty kernel, 128 blocks": lambda: lib.empty(128, stream()),
        "cooperative, 128 blocks, one grid.sync()": lambda: lib.grid_sync(128, stream()),
        "16 clusters of 8 blocks, one cluster.sync()": lambda: lib.cluster_sync(16, 8, stream()),
    }
    for name, fn in cases.items():
        if fn() != 0:
            raise RuntimeError(f"{name}: launch failed")
        us = [t for _, t in _device_ops(fn, calls=30)]
        print(f"{name}: {statistics.median(us)!r} us own device time (median of {len(us)})")


def _load(root: Path):
    for name in [m for m in sys.modules if m.split(".")[0] == "metrics_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module("metrics_tpu_torch")
    finally:
        sys.path.remove(str(root))


def _configs(mt, logits: torch.Tensor, labels: torch.Tensor) -> dict:
    acc = mt.Accuracy(num_classes=C, device="cuda")
    col = mt.MetricCollection({
        "acc": mt.Accuracy(num_classes=C, average="macro", device="cuda"),
        "f1": mt.F1Score(num_classes=C, average="macro", device="cuda"),
        "prec": mt.Precision(num_classes=C, average="macro", device="cuda"),
        "cm": mt.ConfusionMatrix(num_classes=C, device="cuda"),
    }, device="cuda")
    runs = {"config 1 forward": lambda: acc(logits, labels), "config 2 update": lambda: col.update(logits, labels)}
    for fn in runs.values():
        for _ in range(3):  # past the first update, which every member of a collection makes
            fn()
    return runs


def updates(roots: list, walls_per_turn: int = 50) -> None:
    """Device operations of one update per root, then wall times in turns over the roots
    (A, B, B, A for two), so that drift on the shared host falls on each alike."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((N, C), generator=gen, device="cuda")
    labels = torch.randint(0, C, (N,), generator=gen, device="cuda")
    walls = {}
    for turn, root in enumerate(roots + roots[::-1]):
        runs = _configs(_load(root), logits, labels)
        for name, fn in runs.items():
            if turn < len(roots):
                seen = _device_ops(fn)
                copies = sum("DtoH" in op for op, _ in seen)
                print(f"{root}: {name}: {len(seen)} device operations ({copies} device-to-host copies), "
                      f"{sum(t for _, t in seen)!r} us of their own device time")
            times = []
            for _ in range(walls_per_turn):
                torch.cuda.synchronize()
                start = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            walls.setdefault((root, name), []).append(statistics.median(times))
    for (root, name), medians in walls.items():
        print(f"{root}: {name}: wall time per update, host work included, median of {walls_per_turn} "
              f"in each turn: {medians!r} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("port_device_probe: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    barriers()
    updates([ROOT] + [Path(arg).resolve() for arg in sys.argv[1:]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
