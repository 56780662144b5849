// Per-class tp/fp/tn/fn counts on Hopper: two entry points, one launch each.
//
// Replaces the Pallas TPU kernel
// metrics_tpu/ops/stat_scores_pallas.py::fused_stat_scores (its `_kernel`).
//
// A. stat_scores_{i32,u8}: the TPU kernel's own function, over canonical
//    binary (N, C) operands.  Same predicates as `_kernel`: pos = (p == 1),
//    same = (t == p); tp = same & pos, fp = ~same & pos, tn = same & ~pos,
//    fn = ~same & ~pos.  tp, fp and tn are counted directly and fn is the rest
//    of the rows, so the result matches the plain version for any values.
// B. stat_scores_logits_{f32,b16}: float logits (N, C) and integer labels
//    (N,) straight to the four counts, as A would count
//    (select_topk(logits, 1), to_onehot(labels, C)).  One warp takes a row's
//    argmax; then tp[c] = #(argmax == label == c), pc[c] = #(argmax == c) and
//    lc[c] = #(label == c, 0 <= label < C) give fp = pc - tp, fn = lc - tp and
//    tn = N - pc - lc + tp, exact because each one-hot row holds one 1 at most.
//    The argmax orders values as lax.top_k does, by IEEE-754 totalOrder on
//    the bits (a NaN with the sign bit clear above +inf, one with it set below
//    -inf, -0.0 below +0.0), and of tied values takes the lowest index.
//
// C. stream_stat_scores_{logits_f32,logits_b16,i32,u8}: the per-stream counts
//    of B's or A's inputs.  Each row carries a stream id; a row whose id lies
//    outside [0, S) is dropped.  The result is what adding each row's own
//    counts into its stream's row of (S, C) outputs gives (the JAX package's
//    segment_sum of a per-row stat-scores update), or with `micro` the
//    per-stream sums over the classes, (S,).  One cooperative launch: zero
//    the outputs, grid.sync(); one warp per row adds the row's tp, fp and fn
//    with atomics (a logits row has at most one tp or fp and one fn; a
//    canonical row adds only its nonzero counts, a micro row one warp sum
//    each), and the stream's row count; grid.sync(); tn is the rest,
//    rows(s) - tp - fp - fn per class (times C with `micro`), because the
//    four predicates split every element.  Integer adds do not depend on
//    their order, so the result is bitwise the plain version's.
//
// What bounds them on an H100: bytes.  A reads 2 * N * C * sizeof(T) bytes
// (8.19 MB for (1024, 1000) int32, 2.45 us at 3.35 TB/s); B reads the logits
// and labels once (4.10 MB for (1024, 1000) float32 with int64 labels,
// 1.23 us).  Both do a few integer operations per element.
//
// What the design does about the three costs of the first version (a
// zeroing launch before an atomicAdd kernel, 4-byte loads, and an int32
// one-hot chain of 8 device operations in front of it):
//   * No zeroing launch: every output element is written once, with a plain
//     store, by one thread; the wrapper allocates with torch.empty.
//     A reduces over rows inside a thread-block cluster: the column tiles are
//     independent, so a cluster of up to 8 blocks along the rows (the
//     portable limit) holds every row of its tile.  Each block owns a share
//     of the tile's classes in its shared memory; the warps sum their lanes
//     with shuffles, the block sums its warps in shared memory and adds one
//     value per count and class into the owner's shared memory through
//     distributed shared memory, and after one cluster barrier each owner
//     stores its classes.  The barrier that makes the owners' zeros visible
//     is split (arrive at the start, wait before the first add), so the
//     loads overlap it; nothing is read remotely, so no barrier is needed
//     before the blocks exit.  No grid-wide barrier and no scratch.
//     B's histograms span all rows, so it is a cooperative launch: phase 1
//     writes each row's argmax to torch.empty scratch while each block zeroes
//     its histograms, grid.sync(), and in phase 2 each block owns a range of
//     classes, histograms every row's (argmax, label) into shared memory and
//     stores its classes' counts.  Integer sums do not depend on their order,
//     so both are bitwise equal to the plain version.
//   * 16-byte loads: each thread loads the widest word (16, 8, 4, 2 or 1
//     bytes) that the row stride and both base pointers are aligned to;
//     neighbouring threads read neighbouring words.  At (1024, 1000) int32 or
//     float32 the rows are 16-byte aligned; an unaligned C takes the scalar
//     path.  In A four threads side by side cover 64 bytes of a row and each
//     thread has all its rows' loads in flight before it counts: narrow tiles
//     give 126 blocks at (1024, 1000) with a cluster of 2, and measured
//     faster than 256-byte tiles in clusters of 8.  A has no class cap
//     (C = 4097 is checked); B's class ranges fit a block's shared memory
//     while C <= 2048 * (blocks resident on the card).
//   * The one-hot chain: B reads the logits and labels themselves, so the
//     main path issues one launch per update instead of eight.
// Known weak spots (PERF.md): a call's fixed cost (launch, barriers) is
// about as large as its memory time at the main path's shapes; tall, narrow
// inputs (N = 50000, C = 10) leave A with few blocks (a cluster holds 8 at
// most) and B with only C blocks scanning all rows in phase 2.
//
// Plain C entry points (bound with ctypes).  Each makes one launch on the
// given stream, allocates nothing and returns cudaGetLastError() (or the
// launch's own error).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = 8;      // A: rows each thread loads at once; the cluster grows until it holds them
constexpr int kMaxClusterBlocks = 8; // A: the portable cluster size
constexpr int kClassChunk = 2048;    // B: classes one block's shared memory histograms
constexpr int kUnroll = 4;           // B: words each lane has in flight

// An unsigned word of VB bytes: one load instruction.
template <int VB> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<1> { using type = unsigned char; };

// VB bytes of elements T, loaded as one word and read element by element.
template <typename T, int VB>
union Pack {
  typename Word<VB>::type word;
  T e[VB / sizeof(T)];
};

template <typename T, int VB>
__device__ __forceinline__ Pack<T, VB> load(const T* p) {
  Pack<T, VB> out;
  out.word = __ldg(reinterpret_cast<const typename Word<VB>::type*>(p));
  return out;
}

// The largest power of two, at most 16, that divides both addresses and the row's bytes.
int vector_bytes(const void* a, const void* b, int64_t row_bytes) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                      static_cast<uintptr_t>(row_bytes) | 16u;
  return static_cast<int>(m & (~m + 1));
}

cudaError_t launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------- A: canonical operands

// The cluster barrier in two halves: arrive releases this thread's earlier writes to the
// cluster, wait returns once every thread of the cluster has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }

template <typename T, int VB>
struct CountShape {
  static constexpr int kElems = VB / sizeof(T);         // elements per load
  static constexpr int kSeg = VB >= 8 ? 4 : 32;          // threads side by side along one row
  static constexpr int kLanes = kThreads / kSeg;         // rows a block reads at once
  static constexpr int kCols = kSeg * kElems;            // classes per block
};

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
stat_scores_kernel(const T* __restrict__ preds, const T* __restrict__ target, int64_t n, int64_t c,
                   int* __restrict__ out) {
  using S = CountShape<T, VB>;
  // [tp | fp | tn | fn] of the tile's classes; a block owns the classes k with k % ranks == rank
  // and sums every block's counts of them here
  __shared__ int sums[4 * S::kCols];
  __shared__ int by_warp[kWarps][4 * S::kCols];  // each warp's counts of the tile's classes

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned ranks = cluster.num_blocks();
  for (int i = threadIdx.x; i < 4 * S::kCols; i += kThreads) sums[i] = 0;
  cluster_arrive();  // the zeros are released to the cluster; the loads below overlap the barrier

  const int seg = threadIdx.x % S::kSeg;
  const int lane = threadIdx.x / S::kSeg;
  // with more than one element per load, C is a multiple of kElems: a word is all in range or all out
  const int64_t col = static_cast<int64_t>(blockIdx.x) * S::kCols + seg * S::kElems;
  int tp[S::kElems], fp[S::kElems], tn[S::kElems], fn[S::kElems];
#pragma unroll
  for (int v = 0; v < S::kElems; ++v) tp[v] = fp[v] = tn[v] = 0;
  int rows = 0;
  if (col < c) {
    const int64_t step = static_cast<int64_t>(ranks) * S::kLanes;
    for (int64_t first = static_cast<int64_t>(rank) * S::kLanes + lane; first < n; first += step * kRowsPerLane) {
      Pack<T, VB> p[kRowsPerLane], t[kRowsPerLane];  // all loads in flight before any is used
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        const int64_t row = first + u * step;
        if (row < n) {
          p[u] = load<T, VB>(preds + row * c + col);
          t[u] = load<T, VB>(target + row * c + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        if (first + u * step < n) {
#pragma unroll
          for (int v = 0; v < S::kElems; ++v) {
            const int pos = p[u].e[v] == T(1);
            const int same = t[u].e[v] == p[u].e[v];
            tp[v] += same & pos;
            fp[v] += (same ^ 1) & pos;
            tn[v] += same & (pos ^ 1);
          }
          ++rows;
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < S::kElems; ++v) fn[v] = rows - tp[v] - fp[v] - tn[v];
  // the lanes of a warp kSeg apart hold the same classes: sum them
#pragma unroll
  for (int offset = S::kSeg; offset < 32; offset <<= 1) {
#pragma unroll
    for (int v = 0; v < S::kElems; ++v) {
      tp[v] += __shfl_xor_sync(0xffffffffu, tp[v], offset);
      fp[v] += __shfl_xor_sync(0xffffffffu, fp[v], offset);
      tn[v] += __shfl_xor_sync(0xffffffffu, tn[v], offset);
      fn[v] += __shfl_xor_sync(0xffffffffu, fn[v], offset);
    }
  }
  // then the warps, through shared memory: one value per count and class for the block
  if (threadIdx.x % 32 < S::kSeg) {
    int* mine = by_warp[threadIdx.x / 32];
#pragma unroll
    for (int v = 0; v < S::kElems; ++v) {
      const int k = seg * S::kElems + v;
      mine[k] = tp[v];
      mine[S::kCols + k] = fp[v];
      mine[2 * S::kCols + k] = tn[v];
      mine[3 * S::kCols + k] = fn[v];
    }
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started and zeroed its sums
  for (int i = threadIdx.x; i < 4 * S::kCols; i += kThreads) {
    const int k = i % S::kCols;
    if (static_cast<int64_t>(blockIdx.x) * S::kCols + k < c) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += by_warp[w][i];
      atomicAdd(cluster.map_shared_rank(sums, k % ranks) + i, sum);
    }
  }
  cluster.sync();  // every add has landed; from here each block reads only its own shared memory
  for (int i = threadIdx.x; i < 4 * S::kCols; i += kThreads) {
    const int k = i % S::kCols;
    const int64_t cls = static_cast<int64_t>(blockIdx.x) * S::kCols + k;
    if (k % ranks == rank && cls < c) out[(i / S::kCols) * c + cls] = sums[i];
  }
}

template <typename T, int VB>
cudaError_t launch_counts(const void* preds, const void* target, int64_t n, int64_t c, void* out,
                          cudaStream_t stream) {
  using S = CountShape<T, VB>;
  unsigned ranks = 1;  // blocks along the rows: one cluster holds all rows of a column tile
  while (ranks < kMaxClusterBlocks && static_cast<int64_t>(ranks) * S::kLanes * kRowsPerLane < n) ranks *= 2;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>((c + S::kCols - 1) / S::kCols), ranks, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = ranks;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, stat_scores_kernel<T, VB>, static_cast<const T*>(preds),
                            static_cast<const T*>(target), n, c, static_cast<int*>(out));
}

// The widest load at most VB bytes wide that `vb` allows.
template <typename T, int VB>
cudaError_t dispatch_counts(int vb, const void* preds, const void* target, int64_t n, int64_t c, void* out,
                            cudaStream_t stream) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return cudaErrorMisalignedAddress;
  } else {
    if (vb >= VB) return launch_counts<T, VB>(preds, target, n, c, out, stream);
    return dispatch_counts<T, VB / 2>(vb, preds, target, n, c, out, stream);
  }
}

template <typename T>
int counts(const void* preds, const void* target, int64_t n, int64_t c, void* out, void* stream) {
  if (n < 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vb = vector_bytes(preds, target, c * static_cast<int64_t>(sizeof(T)));
  return static_cast<int>(
      launched(dispatch_counts<T, 16>(vb, preds, target, n, c, out, static_cast<cudaStream_t>(stream))));
}

// ---------------------------------------------------------------- B: logits and labels

// Signed integers that order the floats' bits as IEEE-754 totalOrder.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int order_key(unsigned short x) {  // bfloat16 and float16 alike
  const int b = static_cast<short>(x);
  return b ^ ((b >> 15) & 0x7fff);
}

// (key, index) as one integer whose maximum is the largest key at the lowest index.
__device__ __forceinline__ long long candidate(int key, int64_t index) {
  return static_cast<long long>(key) * 4294967296LL + (0xffffffffLL - index);
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
logits_kernel(const T* __restrict__ logits, const void* __restrict__ labels, int labels_are_64, int64_t n,
              int64_t c, int* pred, int* __restrict__ out) {
  constexpr int kElems = VB / sizeof(T);
  __shared__ int hist[3 * kClassChunk];  // [tp | pc | lc] for this block's classes

  // this block's range of classes for phase 2, its histograms zeroed while phase 1 runs
  const int64_t span = (c + gridDim.x - 1) / gridDim.x;  // at most kClassChunk (the launcher sees to it)
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * span;
  const int64_t c1 = c0 + span < c ? c0 + span : c;
  for (int64_t j = threadIdx.x; c0 < c1 && j < 3 * span; j += kThreads) hist[j] = 0;

  // phase 1: one warp per row; each lane keeps the best candidate of its words
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t words = c / kElems;  // with more than one element per word, C is a multiple of kElems
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const T* base = logits + row * c;
    long long best = LLONG_MIN;
    for (int64_t first = lane; first < words; first += 32 * kUnroll) {
      Pack<T, VB> w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (first + u * 32 < words) w[u] = load<T, VB>(base + (first + u * 32) * kElems);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = first + u * 32;
        if (i < words) {
#pragma unroll
          for (int e = 0; e < kElems; ++e) {
            const long long cand = candidate(order_key(w[u].e[e]), i * kElems + e);
            best = cand > best ? cand : best;
          }
        }
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, best, offset);
      best = other > best ? other : best;
    }
    if (lane == 0) pred[row] = static_cast<int>(0xffffffffLL - (best & 0xffffffffLL));
  }

  cg::this_grid().sync();  // every row's argmax is in `pred`, and this block's histograms are zeroed

  // phase 2: this block's range of classes, histogrammed over all rows
  if (c0 >= c1) return;
  for (int64_t r = threadIdx.x; r < n; r += kThreads) {
    const int64_t p = __ldcg(pred + r);  // written by other blocks in this launch: read through L2
    const int64_t l = labels_are_64 ? static_cast<int64_t>(__ldg(static_cast<const long long*>(labels) + r))
                                    : static_cast<int64_t>(__ldg(static_cast<const int*>(labels) + r));
    if (p >= c0 && p < c1) {
      atomicAdd(hist + span + (p - c0), 1);
      if (p == l) atomicAdd(hist + (p - c0), 1);
    }
    if (l >= c0 && l < c1) atomicAdd(hist + 2 * span + (l - c0), 1);
  }
  __syncthreads();
  for (int64_t j = threadIdx.x; j < c1 - c0; j += kThreads) {
    const int tp = hist[j], pc = hist[span + j], lc = hist[2 * span + j];
    const int64_t cls = c0 + j;
    out[cls] = tp;
    out[c + cls] = pc - tp;
    out[2 * c + cls] = static_cast<int>(n) - pc - lc + tp;
    out[3 * c + cls] = lc - tp;
  }
}

int sm_count() {
  static int counts[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (counts[device] == 0) cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device);
  return counts[device];
}

template <typename T, int VB>
cudaError_t launch_logits(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c,
                          void* pred, void* out, cudaStream_t stream) {
  auto kernel = logits_kernel<T, VB>;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const int64_t sms = sm_count();
  const int64_t resident = sms * per_sm;  // a cooperative grid must be resident all at once
  const int64_t least = (c + kClassChunk - 1) / kClassChunk;
  if (resident == 0 || least > resident) return cudaErrorInvalidValue;
  int64_t blocks = (n + kWarps - 1) / kWarps;  // a warp per row
  blocks = blocks < 2 * sms ? blocks : 2 * sms;  // every block reads all rows in phase 2
  blocks = blocks > least ? blocks : least;
  blocks = blocks < resident ? blocks : resident;
  blocks = blocks > 0 ? blocks : 1;

  const T* logits_t = static_cast<const T*>(logits);
  int* pred_i = static_cast<int*>(pred);
  int* out_i = static_cast<int*>(out);
  void* args[] = {&logits_t, &labels, &labels_are_64, &n, &c, &pred_i, &out_i};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                     dim3(kThreads), args, 0, stream);
}

template <typename T, int VB>
cudaError_t dispatch_logits(int vb, const void* logits, const void* labels, int labels_are_64, int64_t n,
                            int64_t c, void* pred, void* out, cudaStream_t stream) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return cudaErrorMisalignedAddress;
  } else {
    if (vb >= VB) return launch_logits<T, VB>(logits, labels, labels_are_64, n, c, pred, out, stream);
    return dispatch_logits<T, VB / 2>(vb, logits, labels, labels_are_64, n, c, pred, out, stream);
  }
}

template <typename T>
int logits_counts(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c, void* pred,
                  void* out, void* stream) {
  if (n < 0 || c <= 0 || c >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vb = vector_bytes(logits, logits, c * static_cast<int64_t>(sizeof(T)));
  return static_cast<int>(launched(dispatch_logits<T, 16>(vb, logits, labels, labels_are_64, n, c, pred, out,
                                                          static_cast<cudaStream_t>(stream))));
}


// ---------------------------------------------------------------- C: per-stream counts

__device__ __forceinline__ int64_t load_index(const void* p, int is_64, int64_t i) {
  return is_64 ? static_cast<int64_t>(__ldg(static_cast<const long long*>(p) + i))
               : static_cast<int64_t>(__ldg(static_cast<const int*>(p) + i));
}

// out: [tp | fp | tn | fn], each (S, W) with W = micro ? 1 : C, then rows (S).
// kLogits: `a` is (N, C) logits and `b` (N,) labels (int64 when b_is_64); else `a` and `b` are
// canonical (N, C) operands of one type T.
template <typename T, int VB, bool kLogits>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const T* __restrict__ a, const void* __restrict__ b, int b_is_64, const void* __restrict__ ids,
              int ids_are_64, int64_t n, int64_t c, int64_t s, int micro, int* out) {
  constexpr int kElems = VB / sizeof(T);
  const int64_t w = micro ? 1 : c;
  int* tp = out;
  int* fp = out + s * w;
  int* tn = out + 2 * s * w;
  int* fn = out + 3 * s * w;
  int* rows = out + 4 * s * w;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t i = tid; i < 4 * s * w + s; i += threads) out[i] = 0;

  cg::grid_group grid = cg::this_grid();
  grid.sync();  // every output is zero

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t words = c / kElems;  // with more than one element per word, C is a multiple of kElems
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t id = load_index(ids, ids_are_64, row);
    if (id < 0 || id >= s) continue;  // the whole warp skips a dropped row
    if (lane == 0) atomicAdd(rows + id, 1);
    if constexpr (kLogits) {
      const T* base = a + row * c;
      long long best = LLONG_MIN;
      for (int64_t first = lane; first < words; first += 32 * kUnroll) {
        Pack<T, VB> v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (first + u * 32 < words) v[u] = load<T, VB>(base + (first + u * 32) * kElems);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t i = first + u * 32;
          if (i < words) {
#pragma unroll
            for (int e = 0; e < kElems; ++e) {
              const long long cand = candidate(order_key(v[u].e[e]), i * kElems + e);
              best = cand > best ? cand : best;
            }
          }
        }
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        const long long other = __shfl_xor_sync(0xffffffffu, best, offset);
        best = other > best ? other : best;
      }
      if (lane == 0) {
        const int64_t p = 0xffffffffLL - (best & 0xffffffffLL);
        const int64_t l = load_index(b, b_is_64, row);
        const int64_t base_out = id * w;
        if (p == l) {
          atomicAdd(tp + base_out + (micro ? 0 : p), 1);
        } else {
          atomicAdd(fp + base_out + (micro ? 0 : p), 1);
          if (l >= 0 && l < c) atomicAdd(fn + base_out + (micro ? 0 : l), 1);
        }
      }
    } else {
      const T* prow = a + row * c;
      const T* trow = static_cast<const T*>(b) + row * c;
      int tps = 0, fps = 0, fns = 0;
      for (int64_t i = lane; i < words; i += 32) {
        const Pack<T, VB> pv = load<T, VB>(prow + i * kElems);
        const Pack<T, VB> tv = load<T, VB>(trow + i * kElems);
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const int pos = pv.e[e] == T(1);
          const int same = tv.e[e] == pv.e[e];
          const int is_tp = same & pos, is_fp = (same ^ 1) & pos, is_fn = (same ^ 1) & (pos ^ 1);
          if (micro) {
            tps += is_tp;
            fps += is_fp;
            fns += is_fn;
          } else {
            const int64_t at = id * c + i * kElems + e;
            if (is_tp) atomicAdd(tp + at, 1);
            if (is_fp) atomicAdd(fp + at, 1);
            if (is_fn) atomicAdd(fn + at, 1);
          }
        }
      }
      if (micro) {
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) {
          tps += __shfl_xor_sync(0xffffffffu, tps, offset);
          fps += __shfl_xor_sync(0xffffffffu, fps, offset);
          fns += __shfl_xor_sync(0xffffffffu, fns, offset);
        }
        if (lane == 0) {
          if (tps) atomicAdd(tp + id, tps);
          if (fps) atomicAdd(fp + id, fps);
          if (fns) atomicAdd(fn + id, fns);
        }
      }
    }
  }

  grid.sync();  // every row has landed
  for (int64_t i = tid; i < s * w; i += threads) {
    const int64_t total = static_cast<int64_t>(__ldcg(rows + i / w)) * (micro ? c : 1);
    tn[i] = static_cast<int>(total - __ldcg(tp + i) - __ldcg(fp + i) - __ldcg(fn + i));
  }
}

template <typename T, int VB, bool kLogits>
cudaError_t launch_stream(const void* a, const void* b, int b_is_64, const void* ids, int ids_are_64, int64_t n,
                          int64_t c, int64_t s, int micro, void* out, cudaStream_t stream) {
  auto kernel = stream_kernel<T, VB, kLogits>;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const int64_t resident = static_cast<int64_t>(sm_count()) * per_sm;
  if (resident == 0) return cudaErrorInvalidValue;
  // a warp per row, and threads enough to zero the outputs a few entries each; at most two
  // blocks per SM, since every block waits at both grid barriers
  const int64_t outputs = 4 * s * (micro ? 1 : c) + s;
  int64_t blocks = (n + kWarps - 1) / kWarps;
  const int64_t zeroing = (outputs + 4 * kThreads - 1) / (4 * kThreads);
  blocks = blocks > zeroing ? blocks : zeroing;
  const int64_t cap = 2 * static_cast<int64_t>(sm_count()) < resident ? 2 * static_cast<int64_t>(sm_count()) : resident;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 0 ? blocks : 1;
  const T* a_t = static_cast<const T*>(a);
  int* out_i = static_cast<int*>(out);
  void* args[] = {&a_t, &b, &b_is_64, &ids, &ids_are_64, &n, &c, &s, &micro, &out_i};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                     dim3(kThreads), args, 0, stream);
}

template <typename T, int VB, bool kLogits>
cudaError_t dispatch_stream(int vb, const void* a, const void* b, int b_is_64, const void* ids, int ids_are_64,
                            int64_t n, int64_t c, int64_t s, int micro, void* out, cudaStream_t stream) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return cudaErrorMisalignedAddress;
  } else {
    if (vb >= VB) return launch_stream<T, VB, kLogits>(a, b, b_is_64, ids, ids_are_64, n, c, s, micro, out, stream);
    return dispatch_stream<T, VB / 2, kLogits>(vb, a, b, b_is_64, ids, ids_are_64, n, c, s, micro, out, stream);
  }
}

template <typename T, bool kLogits>
int stream_counts(const void* a, const void* b, int b_is_64, const void* ids, int ids_are_64, int64_t n, int64_t c,
                  int64_t s, int micro, void* out, void* stream) {
  if (n < 0 || c <= 0 || c >= INT_MAX || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = c * static_cast<int64_t>(sizeof(T));
  const int vb = kLogits ? vector_bytes(a, a, row_bytes) : vector_bytes(a, b, row_bytes);
  return static_cast<int>(launched(dispatch_stream<T, 16, kLogits>(vb, a, b, b_is_64, ids, ids_are_64, n, c, s, micro,
                                                                   out, static_cast<cudaStream_t>(stream))));
}

}  // namespace

extern "C" {

// out: (4, C) int32, rows tp, fp, tn, fn
int stat_scores_i32(const void* preds, const void* target, int64_t n, int64_t c, void* out, void* stream) {
  return counts<int32_t>(preds, target, n, c, out, stream);
}

// torch.bool is one byte holding 0 or 1
int stat_scores_u8(const void* preds, const void* target, int64_t n, int64_t c, void* out, void* stream) {
  return counts<uint8_t>(preds, target, n, c, out, stream);
}

// labels: (N,) int64 when labels_are_64, else int32; pred: (N,) int32 scratch; out: (4, C) int32
int stat_scores_logits_f32(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c,
                           void* pred, void* out, void* stream) {
  return logits_counts<float>(logits, labels, labels_are_64, n, c, pred, out, stream);
}

// bfloat16 or float16 logits: both order their bits the same way
int stat_scores_logits_b16(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c,
                           void* pred, void* out, void* stream) {
  return logits_counts<unsigned short>(logits, labels, labels_are_64, n, c, pred, out, stream);
}

// C: ids (N,) int64 when ids_are_64, else int32; out: 4 * S * W + S int32, W = micro ? 1 : C
int stream_stat_scores_logits_f32(const void* logits, const void* labels, int labels_are_64, const void* ids,
                                  int ids_are_64, int64_t n, int64_t c, int64_t s, int micro, void* out,
                                  void* stream) {
  return stream_counts<float, true>(logits, labels, labels_are_64, ids, ids_are_64, n, c, s, micro, out, stream);
}

int stream_stat_scores_logits_b16(const void* logits, const void* labels, int labels_are_64, const void* ids,
                                  int ids_are_64, int64_t n, int64_t c, int64_t s, int micro, void* out,
                                  void* stream) {
  return stream_counts<unsigned short, true>(logits, labels, labels_are_64, ids, ids_are_64, n, c, s, micro, out,
                                             stream);
}

int stream_stat_scores_i32(const void* preds, const void* target, const void* ids, int ids_are_64, int64_t n,
                           int64_t c, int64_t s, int micro, void* out, void* stream) {
  return stream_counts<int32_t, false>(preds, target, 0, ids, ids_are_64, n, c, s, micro, out, stream);
}

int stream_stat_scores_u8(const void* preds, const void* target, const void* ids, int ids_are_64, int64_t n,
                          int64_t c, int64_t s, int micro, void* out, void* stream) {
  return stream_counts<uint8_t, false>(preds, target, 0, ids, ids_are_64, n, c, s, micro, out, stream);
}

}  // extern "C"
