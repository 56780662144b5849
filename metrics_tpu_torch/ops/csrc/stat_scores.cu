// Per-class tp/fp/tn/fn counts on Hopper: four entry points, one launch each.
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
//    outside [0, S) is dropped, and a label outside [0, C) adds no fn.  The
//    result is what adding each row's own counts into its stream's row of
//    (S, C) outputs gives, or with `micro` the per-stream sums over the
//    classes, (S,): the JAX package's Pallas kernel under jax.vmap, one row at
//    a time, with segment_sum into the streams
//    (metrics_tpu/multistream/core.py, the segment strategy).
// D. stat_scores_planes_{f32,b16}: multi-dimensional float logits (N, C, X)
//    and integer labels (N, X), each pixel's argmax over the C planes (B's
//    order), counted in one of two forms: the (C, C) confusion counts in
//    [target, pred] order, as the JAX package's confusion update counts
//    (argmax(select_topk(logits)), argmax(to_onehot(labels))), so a label
//    outside [0, C) counts in row 0; or B's four (C,) counts of the same
//    pixels, from tp, pc and lc, a label outside [0, C) adding no fn.  It
//    replaces no TPU kernel: the JAX package counts these inputs through the
//    one-hots and the Pallas kernel (or a one-hot matmul), which on this card
//    turned a 176 MB read into about 1.3 GB of one-hot traffic (PERF.md).
//
// What bounds them on an H100: bytes.  A reads 2 * N * C * sizeof(T) bytes
// (8.19 MB for (1024, 1000) int32, 2.45 us at 3.35 TB/s); B reads the logits
// and labels once (4.10 MB for (1024, 1000) float32 with int64 labels,
// 1.23 us).  C reads the same inputs and the ids once and writes 4 * S * W
// int32 once (for (1024, 1000) into S = 64 streams, 1.02 MB more out: 2.75
// us for int32 operands, 1.53 us for logits).  All do a few integer
// operations per element.
//
// Entry point C, redesigned as A and B were: every output element is written
// once, with a plain store, by the one thread that owns it; no pass zeroes the
// outputs and nothing adds to device memory with atomics.  The wrapper
// allocates with torch.empty: the outputs, then (logits route) 3 * N int32 of
// scratch.  A call is one device operation.  Its first version (one cooperative launch: zero every output,
// grid barrier, a warp a row adding with device atomics, grid barrier, tn)
// spent its time on the barriers and, on the canonical route, on one device
// atomic per nonzero element with one 16-byte load in flight a lane.
//   * Logits route: B's two phases per stream, one cooperative launch with
//     one grid barrier.  Phase 1, a warp per row, takes the argmax (kUnroll
//     words a lane in flight) and writes the row's (stream, argmax, label) to
//     scratch; a dropped row writes only its mark.  Phase 2: each block owns
//     ranges of the flat s * W + class outputs (at most kClassChunk at a time,
//     looping past grid * kClassChunk) and histograms tp, pc (rows that
//     predict the class), lc (rows labelled with it) and each stream's rows in
//     shared memory from every row's triple, then stores tp, fp = pc - tp,
//     fn = lc - tp and tn = rows(s) - pc - lc + tp.  With micro a range holds
//     streams: every row predicts one class, so pc = rows(s), and the sums
//     over the classes are fp = rows(s) - tp, fn = lc - tp and tn = C *
//     rows(s) - pc - lc + tp.  Phase 2 reads all N triples (12 bytes a row)
//     in every block from L2, 4 rows a thread in flight: 12 KB a block at
//     N = 1024.  Measured against the first version (tools/
//     stream_stat_scores_ab.py, PERF.md): faster up to N = 2,048 rows at
//     (N, 1000) into S = 64, slower from 4,096, since every block's scan
//     grows with N (fewer scanning blocks measured no faster; 16-byte loads
//     of the triples gained 12 % at N = 65,536 but lost at N = 1,024).  Above
//     that the kernel runs the same two phases; the multistream update passes
//     one batch a call (1,024 rows on the main path).
//   * Canonical route: A's column tiles per stream, no grid barrier and no
//     cooperative launch.  A block owns a tile of kCols classes
//     (StreamShape: two threads side by side along a row, 16 bytes each) and
//     a thread-block cluster along the rows (at most 8 blocks, a power of
//     two; one block up to 1,024 rows) holds every row of the tile.  Each
//     block counts tp, fp and fn for each (stream, class of its tile), and
//     each stream's rows, with atomics in shared memory; each thread has all
//     of its 8 rows' 16-byte loads (and ids) in flight before it counts.  A
//     tile's rows of counts sit kCols + 4 words apart and its classes
//     transposed (TileCounts), so the rows a warp counts at once rarely share
//     a bank.  The cluster barrier that makes the zeros visible is split
//     (arrive once they are stored, wait once counting ends); then each block
//     adds its counts of the streams it does not own into the owner's shared
//     memory through distributed shared memory (stream q belongs to rank q %
//     ranks), and after one cluster barrier each owner stores all four
//     counts, tn as rows(s) - tp - fp - fn.  A block's counts take (3 * (kCols
//     + 4) + 1) * 4 bytes a stream: 9.5 KB at S = 64 with int32's 8-class
//     tiles.
//   * Large S: past the streams that kStreamSmemBytes (96 KB) holds (S > 664
//     for int32, S > 225 for bool, both at 16-byte loads), the streams split into
//     groups (id % groups), a column of blocks each, on four-thread tiles
//     (16 int32 classes; measured faster than two there); each pass of a
//     block first lists, in shared memory, which of kGroupIds * 256 rows are
//     its group's (their ids in flight together), then loads only those rows'
//     words.  The outputs stay owned; only the ids are read again, once a
//     group.
//   * Micro on the canonical route: the reduction across the tiles is a
//     warp's.  A block's tile is the whole row, a warp a row with kUnroll
//     16-byte words of both operands a lane in flight, summed by shuffles
//     into one shared-memory add per count; groups of streams (about two
//     blocks an SM) spread the rows over the card, and the cluster splits
//     each group's rows and reduces as above, tn = C * rows(s) - tp - fp -
//     fn.
//   Integer sums do not depend on their order, so every route is bitwise the
//   plain version's.
//
// What A's and B's design does about the three costs of their first version (a
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

constexpr int kStreamSmemBytes = 96 * 1024;  // C, canonical route: the dynamic shared memory a block's counts take at most
constexpr int kScanUnroll = 4;               // C, logits route: scratch rows each thread has in flight in phase 2
constexpr int kGroupIds = 4;                 // C, canonical route with groups: ids each thread lists at a time

__device__ __forceinline__ int64_t load_index(const void* p, int is_64, int64_t i) {
  return is_64 ? static_cast<int64_t>(__ldg(static_cast<const long long*>(p) + i))
               : static_cast<int64_t>(__ldg(static_cast<const int*>(p) + i));
}

// The logits route.  out: [tp | fp | tn | fn], each (S, W) with W = micro ? 1 : C, then 3 * N int32 of
// scratch: each row's stream (-1 when dropped), argmax and label (-1 outside [0, C)).
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
stream_logits_kernel(const T* __restrict__ logits, const void* __restrict__ labels, int labels_are_64,
                     const void* __restrict__ ids, int ids_are_64, int64_t n, int64_t c, int64_t s, int micro,
                     int* __restrict__ out) {
  constexpr int kElems = VB / sizeof(T);
  __shared__ int hist[4 * kClassChunk];  // [tp | pc | lc | rows] of one range of the flat s * W + class outputs
  const int64_t w = micro ? 1 : c;
  const int64_t outputs = s * w;
  const int64_t share = (outputs + gridDim.x - 1) / gridDim.x;
  const int64_t span = share < kClassChunk ? share : kClassChunk;
  int* tp = hist;
  int* pc = hist + span;
  int* lc = hist + 2 * span;
  int* rows = hist + 3 * span;  // the streams a range touches: at most span of them
  int* row_id = out + 4 * outputs;
  int* row_pred = row_id + n;
  int* row_label = row_id + 2 * n;
  for (int64_t j = threadIdx.x; j < 4 * span; j += kThreads) hist[j] = 0;  // the first range's, during phase 1

  // phase 1: one warp per row, its argmax as B takes it; a dropped row is only marked
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t words = c / kElems;  // with more than one element per word, C is a multiple of kElems
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < n;
       row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t id = load_index(ids, ids_are_64, row);
    if (id < 0 || id >= s) {  // the whole warp skips a dropped row
      if (lane == 0) row_id[row] = -1;
      continue;
    }
    const T* base = logits + row * c;
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
      const int64_t l = load_index(labels, labels_are_64, row);
      row_id[row] = static_cast<int>(id);
      row_pred[row] = static_cast<int>(0xffffffffLL - (best & 0xffffffffLL));
      row_label[row] = l >= 0 && l < c ? static_cast<int>(l) : -1;
    }
  }

  cg::this_grid().sync();  // every row's triple is in scratch, and this block's first histograms are zeroed

  // phase 2: each block owns ranges of the flat outputs and histograms every row's triple into them
  for (int64_t o0 = static_cast<int64_t>(blockIdx.x) * span; o0 < outputs; o0 += static_cast<int64_t>(gridDim.x) * span) {
    if (o0 != static_cast<int64_t>(blockIdx.x) * span) {  // a later range starts from zero too
      __syncthreads();
      for (int64_t j = threadIdx.x; j < 4 * span; j += kThreads) hist[j] = 0;
      __syncthreads();
    }
    const int64_t len = outputs - o0 < span ? outputs - o0 : span;
    const int64_t s0 = o0 / w, s1 = (o0 + len - 1) / w;  // the range's first and last stream
    for (int64_t first = threadIdx.x; first < n; first += kThreads * kScanUnroll) {
      int id[kScanUnroll], p[kScanUnroll], l[kScanUnroll];
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int64_t r = first + u * kThreads;
        id[u] = -1;
        if (r < n) {  // written by other blocks in this launch: read through L2
          id[u] = __ldcg(row_id + r);
          p[u] = __ldcg(row_pred + r);
          l[u] = __ldcg(row_label + r);
        }
      }
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        if (id[u] < 0) continue;
        const int64_t at = static_cast<int64_t>(id[u]) * w - o0;  // the row's stream's first output, in the range
        const int64_t at_p = at + (micro ? 0 : p[u]);
        if (at_p >= 0 && at_p < len) {
          atomicAdd(pc + at_p, 1);
          if (p[u] == l[u]) atomicAdd(tp + at_p, 1);
        }
        if (l[u] >= 0) {
          const int64_t at_l = at + (micro ? 0 : l[u]);
          if (at_l >= 0 && at_l < len) atomicAdd(lc + at_l, 1);
        }
        if (id[u] >= s0 && id[u] <= s1) atomicAdd(rows + (id[u] - s0), 1);
      }
    }
    __syncthreads();
    // B's identities within a stream; with micro pc = rows(s) and tn = C * rows(s) - pc - lc + tp
    for (int64_t j = threadIdx.x; j < len; j += kThreads) {
      const int64_t o = o0 + j;
      const int t = tp[j], predicted = pc[j], labelled = lc[j];
      const int64_t total = static_cast<int64_t>(rows[o / w - s0]) * (micro ? c : 1);
      out[o] = t;
      out[outputs + o] = predicted - t;
      out[2 * outputs + o] = static_cast<int>(total - predicted - labelled + t);
      out[3 * outputs + o] = labelled - t;
    }
  }
}

template <typename T, int VB>
cudaError_t launch_stream_logits(const void* logits, const void* labels, int labels_are_64, const void* ids,
                                 int ids_are_64, int64_t n, int64_t c, int64_t s, int micro, void* out,
                                 cudaStream_t stream) {
  auto kernel = stream_logits_kernel<T, VB>;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  const int64_t sms = sm_count();
  const int64_t resident = sms * per_sm;  // a cooperative grid must be resident all at once
  if (resident == 0) return cudaErrorInvalidValue;
  // a warp per row in phase 1, and enough blocks that each holds at most kClassChunk outputs at a time in
  // phase 2; at most two blocks per SM
  const int64_t outputs = s * (micro ? 1 : c);
  int64_t blocks = (n + kWarps - 1) / kWarps;
  const int64_t least = (outputs + kClassChunk - 1) / kClassChunk;
  blocks = blocks > least ? blocks : least;
  const int64_t cap = 2 * sms < resident ? 2 * sms : resident;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks > 0 ? blocks : 1;
  const T* logits_t = static_cast<const T*>(logits);
  int* out_i = static_cast<int*>(out);
  void* args[] = {&logits_t, &labels, &labels_are_64, &ids, &ids_are_64, &n, &c, &s, &micro, &out_i};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                     dim3(kThreads), args, 0, stream);
}

// The canonical route.  A block holds the counts of its group of streams (stream id % groups == group,
// local index id / groups) in dynamic shared memory: [tp | fp | fn], each (sl, kStride), then rows (sl).
// The cluster's blocks split the rows; local stream q belongs to rank q % ranks (ranks a power of two).

// The rows of [base, base + kIds * kThreads) whose stream lies in this block's group, listed in shared
// memory (kIds ids a thread, all in flight); each adds one to its stream's row count.  Every thread of the
// block calls it.
template <int kIds>
__device__ __forceinline__ int list_rows(const void* ids, int ids_are_64, int64_t n, int64_t s, int groups, int group,
                                         int64_t base, int* list_row, int* list_stream, int* list_len, int* rows) {
  if (threadIdx.x == 0) *list_len = 0;
  __syncthreads();
  int64_t id[kIds];
#pragma unroll
  for (int j = 0; j < kIds; ++j) {
    const int64_t row = base + j * kThreads + threadIdx.x;
    id[j] = row < n ? load_index(ids, ids_are_64, row) : -1;
  }
#pragma unroll
  for (int j = 0; j < kIds; ++j) {
    if (id[j] >= 0 && id[j] < s && id[j] % groups == group) {
      const int q = static_cast<int>(id[j] / groups);
      const int at = atomicAdd(list_len, 1);
      list_row[at] = static_cast<int>(base + j * kThreads + threadIdx.x);
      list_stream[at] = q;
      atomicAdd(rows + q, 1);
    }
  }
  __syncthreads();
  return *list_len;
}

// A block's counts of one (kind, stream) row of a tile: the tile's classes, the lanes side by side along a
// row on neighbouring banks (class seg * kElems + v at v * kSeg + seg), rows kStride apart (an odd multiple
// of 4 words, kCols being a multiple of 8, so 8 consecutive rows start on 8 different banks and the rows a
// warp counts at once rarely share one); micro keeps one count (kCols = 1).
template <int Cols, int Seg, int Elems>
struct TileCounts {
  static constexpr int kCols = Cols;
  static constexpr int kStride = Cols == 1 ? 1 : Cols + 4;
  static constexpr int kPer = 3 * kStride + 1;  // one stream's shared memory: tp, fp, fn rows and its row count
  static constexpr int kBytes = 4 * kPer;
  static __device__ __forceinline__ int at(int k) { return (k % Elems) * Seg + k / Elems; }
};

// Every block adds its counts of the streams it does not own into the owner's shared memory, behind the
// cluster barrier the caller waited at (every block has zeroed its counts); after one more cluster barrier
// each owner stores its streams' four counts of the tile's classes, tn the rest of the rows: rows(s) - tp - fp
// - fn per class, or C * rows(s) - tp - fp - fn with micro (kCols = 1).
template <typename L>
__device__ __forceinline__ void push_and_store(cg::cluster_group& cluster, int* cnt, int sl, int64_t s, int groups,
                                               int group, int64_t c, int64_t tile0, int micro, int* out) {
  constexpr int kCols = L::kCols;
  constexpr int kStride = L::kStride;
  const unsigned rank = cluster.block_rank();
  const unsigned mask = cluster.num_blocks() - 1;
  for (int j = threadIdx.x; mask != 0 && j < sl * L::kPer; j += kThreads) {
    const int q = j / L::kPer, e = j % L::kPer;
    const unsigned owner = static_cast<unsigned>(q) & mask;
    if (owner == rank) continue;
    const int i = e < 3 * kStride ? ((e / kStride) * sl + q) * kStride + e % kStride : 3 * sl * kStride + q;
    const int v = cnt[i];
    if (v != 0) atomicAdd(cluster.map_shared_rank(cnt, owner) + i, v);
  }
  cluster.sync();  // every add has landed; from here each block reads only its own shared memory
  const int64_t w = micro ? 1 : c;
  const int64_t plane = s * w;
  const int owned = (sl - static_cast<int>(rank) + static_cast<int>(mask)) / static_cast<int>(mask + 1);
  for (int j = threadIdx.x; j < owned * kCols; j += kThreads) {
    const int q = static_cast<int>(rank) + (j / kCols) * static_cast<int>(mask + 1);
    const int k = j % kCols;
    const int64_t stream = group + static_cast<int64_t>(q) * groups;
    const int64_t cls = tile0 + k;
    if (stream >= s || cls >= c) continue;
    const int kk = L::at(k);
    const int t = cnt[q * kStride + kk], f = cnt[(sl + q) * kStride + kk], m = cnt[(2 * sl + q) * kStride + kk];
    const int64_t total = static_cast<int64_t>(cnt[3 * sl * kStride + q]) * (micro ? c : 1);
    const int64_t at = stream * w + (micro ? 0 : cls);
    out[at] = t;
    out[plane + at] = f;
    out[2 * plane + at] = static_cast<int>(total - t - f - m);
    out[3 * plane + at] = m;
  }
}

// The canonical route's tile: Seg threads side by side along a row (at 8- or 16-byte loads; 32 at narrower
// ones).  Two measured faster than four at S = 64, four faster once the streams split into groups.
template <typename T, int VB, int Seg>
struct StreamShape {
  static constexpr int kElems = VB / sizeof(T);     // elements per load
  static constexpr int kSeg = VB >= 8 ? Seg : 32;   // threads side by side along one row
  static constexpr int kLanes = kThreads / kSeg;    // rows a block reads at once
  static constexpr int kCols = kSeg * kElems;       // classes per tile
};
template <typename T, int VB, bool kGrouped>
using TileShape = StreamShape<T, VB, kGrouped ? 4 : 2>;

// (S, C) outputs: A's column tiles (blockIdx.y), a cluster along the rows (blockIdx.x % ranks) and, past
// the streams one block's shared memory holds, groups of streams (blockIdx.x / ranks).  Ungrouped, each
// thread loads its rows' ids and words together; grouped, each pass first lists which of kGroupIds *
// kThreads rows are the block's.

template <typename T, int VB, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
stream_tile_kernel(const T* __restrict__ preds, const T* __restrict__ target, const void* __restrict__ ids,
                   int ids_are_64, int64_t n, int64_t c, int64_t s, int groups, int sl, int* __restrict__ out) {
  using Sh = TileShape<T, VB, kGrouped>;
  using L = TileCounts<Sh::kCols, Sh::kSeg, Sh::kElems>;
  constexpr int kListed = kGrouped ? kGroupIds * kThreads : 1;
  extern __shared__ int cnt[];
  __shared__ int list_row[kListed], list_stream[kListed], list_len;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned ranks = cluster.num_blocks();
  const int group = static_cast<int>(blockIdx.x / ranks);
  const int64_t tile0 = static_cast<int64_t>(blockIdx.y) * Sh::kCols;
  int* rows = cnt + 3 * sl * L::kStride;
  for (int i = threadIdx.x; i < sl * L::kPer; i += kThreads) cnt[i] = 0;
  __syncthreads();
  cluster_arrive();  // the zeros are released to the cluster; the counting below overlaps the barrier

  const int seg = threadIdx.x % Sh::kSeg;
  const int lane = threadIdx.x / Sh::kSeg;
  // with more than one element per load, C is a multiple of kElems: a word is all in range or all out
  const int64_t col = tile0 + seg * Sh::kElems;
  const bool live = col < c;
  auto count = [&](int q, const Pack<T, VB>& p, const Pack<T, VB>& t) {
#pragma unroll
    for (int v = 0; v < Sh::kElems; ++v) {
      const bool pos = p.e[v] == T(1);
      const bool same = t.e[v] == p.e[v];
      if (!same || pos) {  // tp, fp or fn; tn is the rest
        const int kind = same ? 0 : (pos ? 1 : 2);
        atomicAdd(cnt + (kind * sl + q) * L::kStride + v * Sh::kSeg + seg, 1);
      }
    }
  };
  Pack<T, VB> p[kRowsPerLane], t[kRowsPerLane];  // all loads in flight before any is used
  int q[kRowsPerLane];
  if constexpr (!kGrouped) {
    const int64_t step = static_cast<int64_t>(ranks) * Sh::kLanes;
    for (int64_t first = static_cast<int64_t>(rank) * Sh::kLanes + lane; first < n; first += step * kRowsPerLane) {
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        const int64_t row = first + u * step;
        q[u] = -1;
        if (row < n) {
          const int64_t id = load_index(ids, ids_are_64, row);
          q[u] = id >= 0 && id < s ? static_cast<int>(id) : -1;
          if (live) {
            p[u] = load<T, VB>(preds + row * c + col);
            t[u] = load<T, VB>(target + row * c + col);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        if (q[u] < 0) continue;
        if (live) count(q[u], p[u], t[u]);
        if (seg == 0) atomicAdd(rows + q[u], 1);
      }
    }
  } else {
    for (int64_t base = static_cast<int64_t>(rank) * kListed; base < n; base += static_cast<int64_t>(ranks) * kListed) {
      const int len = list_rows<kGroupIds>(ids, ids_are_64, n, s, groups, group, base, list_row, list_stream, &list_len, rows);
      for (int e0 = lane; e0 < len; e0 += Sh::kLanes * kRowsPerLane) {
#pragma unroll
        for (int u = 0; u < kRowsPerLane; ++u) {
          const int e = e0 + u * Sh::kLanes;
          q[u] = -1;
          if (e < len) {
            q[u] = list_stream[e];
            const int64_t row = list_row[e];
            if (live) {
              p[u] = load<T, VB>(preds + row * c + col);
              t[u] = load<T, VB>(target + row * c + col);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRowsPerLane; ++u) {
          if (q[u] >= 0 && live) count(q[u], p[u], t[u]);
        }
      }
      __syncthreads();  // the next pass rewrites the list
    }
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started and zeroed its counts
  push_and_store<L>(cluster, cnt, sl, s, groups, group, c, tile0, 0, out);
}

// (S,) outputs with micro: a block's tile is the whole row, so the sum over the classes stays inside one
// warp (a row each, kUnroll words of both operands in flight a lane); groups of streams spread the rows
// over the card and the cluster splits each group's rows.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
stream_micro_kernel(const T* __restrict__ preds, const T* __restrict__ target, const void* __restrict__ ids,
                    int ids_are_64, int64_t n, int64_t c, int64_t s, int groups, int sl, int* __restrict__ out) {
  constexpr int kElems = VB / sizeof(T);
  extern __shared__ int cnt[];
  __shared__ int list_row[kThreads], list_stream[kThreads], list_len;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned ranks = cluster.num_blocks();
  const int group = static_cast<int>(blockIdx.x / ranks);
  int* rows = cnt + 3 * sl;
  for (int i = threadIdx.x; i < 4 * sl; i += kThreads) cnt[i] = 0;
  __syncthreads();
  cluster_arrive();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t words = c / kElems;  // with more than one element per word, C is a multiple of kElems
  for (int64_t base = static_cast<int64_t>(rank) * kThreads; base < n; base += static_cast<int64_t>(ranks) * kThreads) {
    const int len = list_rows<1>(ids, ids_are_64, n, s, groups, group, base, list_row, list_stream, &list_len, rows);
    for (int e = warp; e < len; e += kWarps) {
      const int64_t row = list_row[e];
      const T* prow = preds + row * c;
      const T* trow = target + row * c;
      int tps = 0, fps = 0, fns = 0;
      for (int64_t first = lane; first < words; first += 32 * kUnroll) {
        Pack<T, VB> p[kUnroll], t[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (first + u * 32 < words) {
            p[u] = load<T, VB>(prow + (first + u * 32) * kElems);
            t[u] = load<T, VB>(trow + (first + u * 32) * kElems);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (first + u * 32 < words) {
#pragma unroll
            for (int v = 0; v < kElems; ++v) {
              const int pos = p[u].e[v] == T(1);
              const int same = t[u].e[v] == p[u].e[v];
              tps += same & pos;
              fps += (same ^ 1) & pos;
              fns += (same ^ 1) & (pos ^ 1);
            }
          }
        }
      }
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        tps += __shfl_xor_sync(0xffffffffu, tps, offset);
        fps += __shfl_xor_sync(0xffffffffu, fps, offset);
        fns += __shfl_xor_sync(0xffffffffu, fns, offset);
      }
      if (lane == 0) {
        const int q = list_stream[e];
        if (tps) atomicAdd(cnt + q, tps);
        if (fps) atomicAdd(cnt + sl + q, fps);
        if (fns) atomicAdd(cnt + 2 * sl + q, fns);
      }
    }
    __syncthreads();  // the next pass rewrites the list
  }
  __syncthreads();
  cluster_wait();
  push_and_store<TileCounts<1, 1, 1>>(cluster, cnt, sl, s, groups, group, c, 0, 1, out);
}

template <typename T, int VB>
cudaError_t launch_stream_counts(const void* preds, const void* target, const void* ids, int ids_are_64, int64_t n,
                                 int64_t c, int64_t s, int micro, void* out, cudaStream_t stream) {
  using Flat = TileShape<T, VB, false>;
  using Grouped = TileShape<T, VB, true>;
  const int64_t sms = sm_count();
  if (sms == 0 || n >= INT_MAX) return cudaErrorInvalidValue;
  using Kernel = void (*)(const T*, const T*, const void*, int, int64_t, int64_t, int64_t, int, int, int*);
  Kernel kernel = stream_micro_kernel<T, VB>;
  int64_t per_stream = TileCounts<1, 1, 1>::kBytes;  // shared bytes of one stream's counts
  int64_t rows_at_once = kThreads;                   // rows a rank lists or loads in one pass
  int64_t tiles = 1, groups = 1;
  if (!micro) {
    // all S streams in one block where they fit its shared memory, else groups of streams on wider tiles
    per_stream = TileCounts<Flat::kCols, Flat::kSeg, Flat::kElems>::kBytes;
    tiles = (c + Flat::kCols - 1) / Flat::kCols;
    rows_at_once = static_cast<int64_t>(Flat::kLanes) * kRowsPerLane;
    kernel = stream_tile_kernel<T, VB, false>;
    if (s * per_stream > kStreamSmemBytes) {
      per_stream = TileCounts<Grouped::kCols, Grouped::kSeg, Grouped::kElems>::kBytes;
      tiles = (c + Grouped::kCols - 1) / Grouped::kCols;
      groups = (s + kStreamSmemBytes / per_stream - 1) / (kStreamSmemBytes / per_stream);
      rows_at_once = kGroupIds * kThreads;
      kernel = stream_tile_kernel<T, VB, true>;
    }
  }
  unsigned ranks = 1;  // a power of two, at most the portable cluster size: the cluster holds every row
  while (ranks < kMaxClusterBlocks && static_cast<int64_t>(ranks) * rows_at_once < n) ranks *= 2;
  if (micro) {
    groups = 2 * sms / ranks;  // about two blocks per SM
    groups = groups < s ? groups : s;
    const int64_t fewest = (s + kStreamSmemBytes / per_stream - 1) / (kStreamSmemBytes / per_stream);
    groups = groups > fewest ? groups : fewest;
  }
  const int64_t sl = (s + groups - 1) / groups;
  if (tiles > 65535 || groups * ranks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStreamSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(groups * ranks), static_cast<unsigned>(tiles), 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(sl * per_stream);
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(preds), static_cast<const T*>(target), ids,
                            ids_are_64, n, c, s, static_cast<int>(groups), static_cast<int>(sl),
                            static_cast<int*>(out));
}

template <typename T, int VB, bool kLogits>
cudaError_t dispatch_stream(int vb, const void* a, const void* b, int b_is_64, const void* ids, int ids_are_64,
                            int64_t n, int64_t c, int64_t s, int micro, void* out, cudaStream_t stream) {
  if constexpr (VB < static_cast<int>(sizeof(T))) {
    return cudaErrorMisalignedAddress;
  } else {
    if (vb >= VB) {
      if constexpr (kLogits) return launch_stream_logits<T, VB>(a, b, b_is_64, ids, ids_are_64, n, c, s, micro, out, stream);
      else return launch_stream_counts<T, VB>(a, b, ids, ids_are_64, n, c, s, micro, out, stream);
    }
    return dispatch_stream<T, VB / 2, kLogits>(vb, a, b, b_is_64, ids, ids_are_64, n, c, s, micro, out, stream);
  }
}

template <typename T, bool kLogits>
int stream_counts(const void* a, const void* b, int b_is_64, const void* ids, int ids_are_64, int64_t n, int64_t c,
                  int64_t s, int micro, void* out, void* stream) {
  if (n < 0 || n >= INT_MAX || c <= 0 || c >= INT_MAX || s <= 0 || s >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = c * static_cast<int64_t>(sizeof(T));
  const int vb = kLogits ? vector_bytes(a, a, row_bytes) : vector_bytes(a, b, row_bytes);
  return static_cast<int>(launched(dispatch_stream<T, 16, kLogits>(vb, a, b, b_is_64, ids, ids_are_64, n, c, s, micro,
                                                                   out, static_cast<cudaStream_t>(stream))));
}

// ---------------------------------------------------------------- D: multi-dimensional logits and labels
//
// What bounds it: bytes.  It reads the logits and labels once, N * X * (C * sizeof(T) + sizeof(label)):
// 176 MB for (1, 19, 1024 * 2048) float32 with int64 labels, 0.0526 ms at 3.35 TB/s.  Per pixel it does C
// order keys and compares, and one shared-memory increment per group of equal pixels in a warp.
// The design, one cooperative launch:
//   * Adjacent threads take adjacent words (16 bytes: 4 float32 or 8 16-bit pixels) of one channel plane, so
//     each plane is read with coalesced 16-byte loads; each thread walks the C planes at stride X with
//     kPlaneUnroll loads in flight and keeps its pixels' best keys and indices in registers.  Nothing is
//     written per pixel: no one-hot, no argmax tensor, no scratch.
//   * Each block counts into shared memory: C * C bins (confusion form) or [tp | pc | lc] (3C, counts form).
//     Pixels of a warp with the same (label, argmax) pair are added together, one increment by one lane
//     (__match_any_sync): 85-95 % of a segmentation's pixels fall on the diagonal, in runs of one label.
//   * Every block stores its bins to its own row of scratch, one grid barrier, and each block then owns a
//     range of the outputs and sums that range over the blocks' rows (many threads to an output, reading
//     through L2), storing each output element once.  The scratch is 2 * SMs rows at most, written whole.
// The bins must fit a block's shared memory (kMaxBinBytes: C <= 226 for the confusion form); the Engine
// keeps larger inputs on the one-hot route.

constexpr int kPlaneThreads = 512;        // D: threads a block, two blocks an SM
constexpr int kPlaneUnroll = 4;           // D: channel planes each thread has in flight
// D: the most shared memory a block's bins may take.  ops/stat_scores.py's MAX_PLANE_BINS is this / 4, and
// the Engine routes by it: change both together (a CPU test holds them equal).
constexpr int kMaxBinBytes = 200 * 1024;

// The classes of kVec consecutive labels: a label in [0, C) as it is, any other as `outside`.  With `vec`
// the labels are read in 16-byte words (the wrapper's base pointer aligned to 16 bytes).
template <typename L, int kVec>
__device__ __forceinline__ void load_classes(const L* src, bool vec, int64_t c, int outside, int (&cls)[kVec]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(L));  // labels a word
  L l[kVec];
  if (kVec % kPer == 0 && vec) {
#pragma unroll
    for (int i = 0; i < kVec / kPer; ++i) {
      const Pack<L, 16> w = load<L, 16>(src + i * kPer);
#pragma unroll
      for (int e = 0; e < kPer; ++e) l[i * kPer + e] = w.e[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) l[e] = __ldg(src + e);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) cls[e] = l[e] >= 0 && l[e] < c ? static_cast<int>(l[e]) : outside;
}

// out: (C, C) with kConfusion, else (4, C) rows tp, fp, tn, fn; partial: gridDim.x rows of the bins.
template <typename T, int VB, bool kConfusion>
__global__ void __launch_bounds__(kPlaneThreads, 2)
plane_counts_kernel(const T* __restrict__ logits, const void* __restrict__ labels, int labels_are_64,
                    int labels_vec, int64_t n, int64_t c, int64_t x, int* __restrict__ out, int* partial) {
  constexpr int kVec = VB / sizeof(T);  // pixels a thread takes at once, side by side in each plane
  extern __shared__ int bins[];         // C * C confusion counts, or [tp | pc | lc] of each class
  __shared__ int sums[kPlaneThreads];   // the fold's
  const int64_t nbins = kConfusion ? c * c : 3 * c;
  for (int64_t j = threadIdx.x; j < nbins; j += kPlaneThreads) bins[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int64_t per_image = x / kVec;  // with more than one pixel a word, X is a multiple of kVec
  const int64_t groups = n * per_image;
  const int outside = kConfusion ? 0 : static_cast<int>(c);  // the class a label outside [0, C) counts as
  // the warp's lanes take neighbouring groups, and the whole warp loops while any of them is live
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * kPlaneThreads + (threadIdx.x - lane); first < groups;
       first += static_cast<int64_t>(gridDim.x) * kPlaneThreads) {
    const int64_t g = first + lane;
    const bool live = g < groups;
    int key[kVec], arg[kVec], cls[kVec];
    if (live) {
      const int64_t image = g / per_image;
      if (labels_are_64) {
        load_classes<long long, kVec>(static_cast<const long long*>(labels) + g * kVec, labels_vec, c, outside, cls);
      } else {
        load_classes<int, kVec>(static_cast<const int*>(labels) + g * kVec, labels_vec, c, outside, cls);
      }
      const T* base = logits + image * c * x + (g - image * per_image) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        key[e] = INT_MIN;  // at most the least key, so plane 0 always sets the index
        arg[e] = 0;
      }
      for (int64_t k0 = 0; k0 < c; k0 += kPlaneUnroll) {
        Pack<T, VB> w[kPlaneUnroll];
#pragma unroll
        for (int u = 0; u < kPlaneUnroll; ++u) {
          if (k0 + u < c) w[u] = load<T, VB>(base + (k0 + u) * x);
        }
#pragma unroll
        for (int u = 0; u < kPlaneUnroll; ++u) {
          if (k0 + u < c) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              const int k = order_key(w[u].e[e]);
              if (k > key[e]) {  // strictly greater: of tied planes the lowest index stays
                key[e] = k;
                arg[e] = static_cast<int>(k0) + u;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int code = live ? cls[e] * static_cast<int>(c) + arg[e] : -1;  // the (label, argmax) pair
      const unsigned same = __match_any_sync(0xffffffffu, code);
      if (live && lane == __ffs(same) - 1) {
        const int k = __popc(same);
        if constexpr (kConfusion) {
          atomicAdd(bins + code, k);
        } else {
          atomicAdd(bins + c + arg[e], k);
          if (cls[e] == arg[e]) atomicAdd(bins + arg[e], k);
          if (cls[e] < c) atomicAdd(bins + 2 * c + cls[e], k);
        }
      }
    }
  }
  __syncthreads();
  int* mine = partial + static_cast<int64_t>(blockIdx.x) * nbins;
  for (int64_t j = threadIdx.x; j < nbins; j += kPlaneThreads) mine[j] = bins[j];

  cg::this_grid().sync();  // every block's bins are in scratch

  // each block owns a range of the outputs (classes in the counts form, each three bins), a round of at most
  // kPlaneThreads bins at a time, each bin summed over the blocks' rows by `ways` threads
  constexpr int kPer = kConfusion ? 1 : 3;
  const int64_t units = kConfusion ? c * c : c;
  const int64_t share = (units + gridDim.x - 1) / gridDim.x;
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * share;
  const int64_t u1 = u0 + share < units ? u0 + share : units;
  for (int64_t k0 = u0; k0 < u1; k0 += kPlaneThreads / kPer) {
    const int width = static_cast<int>(u1 - k0 < kPlaneThreads / kPer ? u1 - k0 : kPlaneThreads / kPer);
    const int entries = kPer * width;
    const int ways = kPlaneThreads / entries;
    sums[threadIdx.x] = 0;
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < ways * entries) {
      const int i = threadIdx.x % entries;
      const int64_t bin = kConfusion ? k0 + i : (i / width) * c + k0 + i % width;
      int sum = 0;
      for (int64_t b = threadIdx.x / entries; b < gridDim.x; b += ways) {
        sum += __ldcg(partial + b * nbins + bin);  // written by other blocks in this launch: read through L2
      }
      atomicAdd(sums + i, sum);
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < width) {
      const int64_t u = k0 + threadIdx.x;
      if constexpr (kConfusion) {
        out[u] = sums[threadIdx.x];
      } else {  // B's identities
        const int tp = sums[threadIdx.x], pc = sums[width + threadIdx.x], lc = sums[2 * width + threadIdx.x];
        out[u] = tp;
        out[c + u] = pc - tp;
        out[2 * c + u] = static_cast<int>(n * x) - pc - lc + tp;
        out[3 * c + u] = lc - tp;
      }
    }
    __syncthreads();
  }
}

template <typename T, int VB, bool kConfusion>
cudaError_t launch_planes(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c, int64_t x,
                          int64_t slots, void* partial, void* out, cudaStream_t stream) {
  auto kernel = plane_counts_kernel<T, VB, kConfusion>;
  const size_t smem = static_cast<size_t>(kConfusion ? c * c : 3 * c) * sizeof(int);
  if (smem > static_cast<size_t>(kMaxBinBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBinBytes);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPlaneThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(sm_count()) * per_sm;  // a cooperative grid is resident at once
  if (resident == 0) return cudaErrorInvalidValue;
  constexpr int kVec = VB / sizeof(T);
  int64_t blocks = (n * (x / kVec) + kPlaneThreads - 1) / kPlaneThreads;  // at most a group a thread
  blocks = blocks < resident ? blocks : resident;
  blocks = blocks < slots ? blocks : slots;  // the rows of scratch the wrapper allocated
  blocks = blocks > 0 ? blocks : 1;

  const T* logits_t = static_cast<const T*>(logits);
  int labels_vec = reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  int* out_i = static_cast<int*>(out);
  int* partial_i = static_cast<int*>(partial);
  void* args[] = {&logits_t, &labels, &labels_are_64, &labels_vec, &n, &c, &x, &out_i, &partial_i};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(static_cast<unsigned>(blocks)),
                                     dim3(kPlaneThreads), args, smem, stream);
}

template <typename T, bool kConfusion>
cudaError_t dispatch_planes(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c,
                            int64_t x, int64_t slots, void* partial, void* out, cudaStream_t stream) {
  // 16-byte words where the base and the plane stride allow them, else one pixel a thread
  if (vector_bytes(logits, logits, x * static_cast<int64_t>(sizeof(T))) >= 16) {
    return launch_planes<T, 16, kConfusion>(logits, labels, labels_are_64, n, c, x, slots, partial, out, stream);
  }
  return launch_planes<T, sizeof(T), kConfusion>(logits, labels, labels_are_64, n, c, x, slots, partial, out, stream);
}

template <typename T>
int plane_counts(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c, int64_t x,
                 int confusion, int64_t slots, void* partial, void* out, void* stream) {
  if (n < 0 || x < 0 || c <= 0 || c >= INT_MAX / (c + 1) || slots <= 0 || n * x >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launched(
      confusion ? dispatch_planes<T, true>(logits, labels, labels_are_64, n, c, x, slots, partial, out, s)
                : dispatch_planes<T, false>(logits, labels, labels_are_64, n, c, x, slots, partial, out, s)));
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

// C: ids (N,) int64 when ids_are_64, else int32; out: 4 * S * W int32, W = micro ? 1 : C, and for the logits
// route 3 * N int32 of scratch after them
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

// D: logits (N, C, X); labels (N, X) int64 when labels_are_64, else int32; partial: `slots` rows of int32
// scratch, each C * C (confusion) or 3 * C long; out: (C, C) int32 when confusion, else (4, C)
int stat_scores_planes_f32(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c, int64_t x,
                           int confusion, int64_t slots, void* partial, void* out, void* stream) {
  return plane_counts<float>(logits, labels, labels_are_64, n, c, x, confusion, slots, partial, out, stream);
}

int stat_scores_planes_b16(const void* logits, const void* labels, int labels_are_64, int64_t n, int64_t c, int64_t x,
                           int confusion, int64_t slots, void* partial, void* out, void* stream) {
  return plane_counts<unsigned short>(logits, labels, labels_are_64, n, c, x, confusion, slots, partial, out, stream);
}

}  // extern "C"
