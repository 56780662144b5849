// Per-class tp/fp/tn/fn over axis 0 of canonical binary (N, C) operands.
//
// Replaces the Pallas TPU kernel
// metrics_tpu/ops/stat_scores_pallas.py::fused_stat_scores (its `_kernel`).
// Same predicates as `_kernel`: pos = (p == 1), true = (t == p), and
//   tp = true & pos, fp = ~true & pos, tn = true & ~pos, fn = ~true & ~pos.
// All four counts are taken directly (tn is not derived as N - tp - fp - fn),
// so the result matches the plain version for any integer values.
//
// What bounds it on an H100: bytes.  It reads 2 * N * C * sizeof(T) bytes
// (8 MB for (1024, 1000) int32, about 2.4 us at 3.35 TB/s) and does a few
// integer operations per element.  The design:
//   * one thread per class column; a block covers 256 adjacent classes, so a
//     warp's loads of one row are 32 consecutive elements (coalesced);
//   * grid.y splits the rows, so (1024, 1000) runs as 256 blocks on 132 SMs;
//   * each thread counts its rows in registers, then does one integer
//     atomicAdd per output into (C,) int32 buffers the caller zeroed.
//     Integer atomics commute, so the result is bitwise that of the plain
//     version whatever order the blocks run in;
//   * ragged rows and columns are masked by bounds: no padding, no tn
//     correction, and no cap on C (the TPU kernel capped C at 1024 for VMEM).
// On the TPU the grid ran in order and carried the sums in VMEM across 512-row
// tiles; here blocks run in parallel and only the atomics join them.
//
// Plain C entry points (bound with ctypes).  Each launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void stat_scores_kernel(const T* __restrict__ preds, const T* __restrict__ target,
                                   int64_t n, int64_t c, int64_t rows_per_block,
                                   int* __restrict__ tp, int* __restrict__ fp,
                                   int* __restrict__ tn, int* __restrict__ fn) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= c) return;
  const int64_t row_begin = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t row_end = row_begin + rows_per_block < n ? row_begin + rows_per_block : n;
  int c_tp = 0, c_fp = 0, c_tn = 0, c_fn = 0;
  const T* p = preds + row_begin * c + col;
  const T* t = target + row_begin * c + col;
#pragma unroll 4
  for (int64_t row = row_begin; row < row_end; ++row) {
    const T pv = *p;
    const T tv = *t;
    const int pos = pv == T(1);
    const int same = tv == pv;
    c_tp += same & pos;
    c_fp += (same ^ 1) & pos;
    c_tn += same & (pos ^ 1);
    c_fn += (same ^ 1) & (pos ^ 1);
    p += c;
    t += c;
  }
  atomicAdd(tp + col, c_tp);
  atomicAdd(fp + col, c_fp);
  atomicAdd(tn + col, c_tn);
  atomicAdd(fn + col, c_fn);
}

template <typename T>
int launch(const void* preds, const void* target, int64_t n, int64_t c, int64_t row_blocks,
           void* tp, void* fp, void* tn, void* fn, void* stream) {
  if (n < 0 || c <= 0 || row_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  const dim3 grid(static_cast<unsigned>((c + kThreads - 1) / kThreads),
                  static_cast<unsigned>(row_blocks));
  stat_scores_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(preds), static_cast<const T*>(target), n, c, rows_per_block,
      static_cast<int*>(tp), static_cast<int*>(fp), static_cast<int*>(tn), static_cast<int*>(fn));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stat_scores_i32(const void* preds, const void* target, int64_t n, int64_t c,
                    int64_t row_blocks, void* tp, void* fp, void* tn, void* fn, void* stream) {
  return launch<int32_t>(preds, target, n, c, row_blocks, tp, fp, tn, fn, stream);
}

// torch.bool is one byte holding 0 or 1
int stat_scores_u8(const void* preds, const void* target, int64_t n, int64_t c,
                   int64_t row_blocks, void* tp, void* fp, void* tn, void* fn, void* stream) {
  return launch<uint8_t>(preds, target, n, c, row_blocks, tp, fp, tn, fn, stream);
}

}  // extern "C"
