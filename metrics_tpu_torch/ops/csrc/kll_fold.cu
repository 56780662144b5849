// The KLL sketch's chunk fold on Hopper: one launch folds n chunks into each
// of S sketches, in place.
//
// Replaces metrics_tpu/streaming/sketches.py::_fold_chunks, a lax.scan (not a
// Pallas kernel): per chunk, a split of the sketch's PRNG key, then (if the
// chunk holds any value) a top-down pass of one lax.cond per level that
// compacts each full level, then a slice write of the chunk.  Under jit that
// is one program; as eager torch ops each cond would cost a device-to-host
// read or a dozen branch-free launches, hundreds of thousands of them per
// batch.  Here one thread block walks one sketch's chunks in order.
//
// Per chunk t, for the block's sketch (L levels of K slots, half = K / 2):
//   1. key, sub = split(key); k2 = split(sub)[1]; the coin of level h is
//      (y0 ^ y1) & 1 of threefry(k2, (0, h)): jax.random.randint(sub, (L,),
//      0, 2) under the partitionable threefry.  The key advances for every
//      chunk, an all-padding one too (the split comes before the cond).
//   2. If valid[t] > 0, for h = L-1 down to level[t], where cnt[h] > K - half:
//      sort row h (stable, -0.0 equal to +0.0, as XLA's sort compares), keep
//      picks[i] = sorted[coin + 2i] for i < n_surv = max((cnt + 1 - coin) / 2,
//      0) (+inf past it), write them at cnt[h+1] of row h+1 and reset row h
//      to +inf (the top level keeps them in place), and count the compaction.
//   3. Write the chunk's first valid[t] values (+inf past them) at
//      cnt[level[t]] of that row and add valid[t].
// Slice writes start at min(cnt, K - half), as lax.dynamic_update_slice
// clamps them.  The kernel compares and moves floats and never does
// arithmetic on them, so it is bitwise equal to the plain version
// (ops/kll.py::kll_fold_plain) and to the JAX package.
//
// The sort.  A row is almost always one or two sorted runs: an insert
// appends a sorted chunk (or a sorted run of survivors), and a level is
// compacted as soon as it holds more than half a row.  The block counts the
// descents between neighbouring order keys (one barrier per blockDim pairs);
// with at most one, it merges the runs: each entry finds its place by a
// binary search in the other run, ties going to the lower slot, and no
// further barrier is needed.  Otherwise (rows that a merge of states
// filled, or three short runs) a bitonic network sorts (order key << 32 |
// slot) pairs, padded to a power of two P2 >= K; the slot breaks ties, which
// makes the unstable network give the stable order.  Either way the row's
// values sit beside in shared memory, so a pick reads its bits (a -0.0 stays
// -0.0).
//
// What bounds it on an H100: the serial walk.  Chunks fold in order, and
// each depends on the state the last one left, so the work of one sketch
// cannot spread over the card; S sketches run as S blocks.  The bytes are
// few: each chunk is read once (n * half * 4 bytes), and the rows stay in
// device memory, where a 147 KB sketch (K = 2048, L = 18) sits in L2.  A
// chunk costs the key's threefry chain (two dependent hashes, which every
// thread computes alike), two block barriers, and, when a level is full, a
// merge of two runs (about K / blockDim + 3 barriers; a full sort would take
// log2(P2) (log2(P2) + 1) / 2); a stream of full chunks compacts level 0
// every second chunk.
// One block per sketch is the algorithm's definition made concrete; a later
// design may merge the two sorted runs of a level-0 row instead of sorting
// it, or take the key chain ahead of the fold.
//
// Shared memory: P2 * 8 + K * 4 + 4 * L bytes (K = 2048: 24 KB).  The wrapper
// refuses a capacity above 16384 (P2 = 16384: 196 KB of the 227 KB a block
// may use).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

// threefry-2x32, 20 rounds, as jax.random computes it
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[step & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + uint32_t(step + 1);
  }
  y0 = x0;
  y1 = x1;
}

// unsigned key ordering floats as XLA's sort does: -0.0 equal to +0.0, every NaN equal and last
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = v != v ? 0x7FC00000u : (v == 0.0f ? 0u : __float_as_uint(v));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ascending bitonic sort of n (a power of two) keys, one compare-exchange per thread and stage
__device__ void bitonic_sort(unsigned long long* a, int n) {
  const int pairs = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
        const int i = 2 * j * (q / j) + (q % j);
        const int p = i + j;
        const unsigned long long x = a[i], y = a[p];
        if ((x > y) == ((i & k) == 0)) {
          a[i] = y;
          a[p] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void kll_fold_kernel(float* __restrict__ buf, int* __restrict__ cnt, uint32_t* __restrict__ key,
                                int* __restrict__ nc, const float* __restrict__ chunks,
                                const int* __restrict__ valids, const int* __restrict__ levels,
                                int n, int L, int K, int P2) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* sorted = smem;                    // P2 (order key, slot) pairs
  float* rowv = reinterpret_cast<float*>(sorted + P2);  // K values of the row being compacted
  int* scnt = reinterpret_cast<int*>(rowv + K);         // L level counts
  // the merge path's two arrays share the sort's space: K order keys, then K slots in sorted order
  uint32_t* okey = reinterpret_cast<uint32_t*>(sorted);
  uint32_t* order = okey + K;
  __shared__ int split;

  const float kInf = __int_as_float(0x7F800000);
  const int s = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int half = K / 2;
  float* rows = buf + (size_t)s * L * K;
  const float* chunk0 = chunks + (size_t)s * n * half;
  const int* valid_of = valids + (size_t)s * n;

  // Every thread walks the same control flow with the same values: each keeps
  // the key chain and the compaction count in registers, and every write of a
  // level count writes, from every thread, the value all of them read before
  // the barrier ahead of it.  No branch of one thread stands before a barrier.
  for (int h = tid; h < L; h += T) scnt[h] = cnt[(size_t)s * L + h];
  uint32_t key0 = key[2 * s], key1 = key[2 * s + 1];
  int compactions = nc[s];
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    const int valid = valid_of[t];
    uint32_t sub0, sub1, a, b;
    threefry(key0, key1, 0u, 1u, sub0, sub1);  // sub
    threefry(key0, key1, 0u, 0u, a, b);        // the new key: independent of sub, so the two hashes overlap
    key0 = a;
    key1 = b;
    if (valid <= 0) continue;  // an all-padding chunk only advances the key
    uint32_t k20, k21;
    threefry(sub0, sub1, 0u, 1u, k20, k21);  // k2 of split(sub)

    const int level = levels[t];
    for (int h = L - 1; h >= level; --h) {
      const int c = scnt[h];
      if (c <= K - half) continue;
      uint32_t y0, y1;
      threefry(k20, k21, 0u, uint32_t(h), y0, y1);
      const int bit = int((y0 ^ y1) & 1u);
      float* row = rows + (size_t)h * K;
      for (int i = tid; i < K; i += T) {
        const float v = row[i];
        rowv[i] = v;
        okey[i] = order_key(v);
      }
      __syncthreads();
      // A row is mostly one or two sorted runs (an insert appends a sorted
      // chunk or sorted survivors, and a level compacts once it holds two):
      // count the descents between neighbours, each found one naming its split.
      int descents = 0;
      for (int base = 0; base < K - 1; base += T) {
        const int i = base + tid;
        const bool down = i < K - 1 && okey[i] > okey[i + 1];
        if (down) split = i + 1;
        descents += __syncthreads_count(down);
      }
      const bool two_runs = descents <= 1;
      if (two_runs) {
        // merge runs A = [0, m) and B = [m, K): a tie orders A's entry (the lower slot) first
        const int m = descents == 0 ? K : split;
        for (int i = tid; i < K; i += T) {
          const uint32_t k = okey[i];
          int lo = i < m ? m : 0, hi = i < m ? K : m;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (i < m ? okey[mid] < k : okey[mid] <= k) lo = mid + 1; else hi = mid;
          }
          order[i < m ? i + (lo - m) : (i - m) + lo] = uint32_t(i);
        }
        __syncthreads();
      } else {
        for (int i = tid; i < P2; i += T) sorted[i] = i < K ? ((unsigned long long)order_key(rowv[i]) << 32) | uint32_t(i) : ~0ull;
        __syncthreads();
        bitonic_sort(sorted, P2);
      }
      const int n_surv = max((c + 1 - bit) / 2, 0);
      auto pick = [&](int i) { return rowv[two_runs ? order[bit + 2 * i] : uint32_t(sorted[bit + 2 * i])]; };
      if (h + 1 < L) {
        const int c_next = scnt[h + 1];
        float* dst = rows + (size_t)(h + 1) * K + min(max(c_next, 0), K - half);
        for (int i = tid; i < half; i += T) dst[i] = i < n_surv ? pick(i) : kInf;
        for (int i = tid; i < K; i += T) row[i] = kInf;
        __syncthreads();
        scnt[h] = 0;
        scnt[h + 1] = c_next + n_surv;
      } else {
        for (int i = tid; i < K; i += T) row[i] = (i < half && i < n_surv) ? pick(i) : kInf;
        __syncthreads();
        scnt[h] = n_surv;
      }
      compactions += 1;
      __syncthreads();
    }

    const int c_level = scnt[level];
    float* dst = rows + (size_t)level * K + min(max(c_level, 0), K - half);
    const float* chunk = chunk0 + (size_t)t * half;
    for (int i = tid; i < half; i += T) dst[i] = i < valid ? chunk[i] : kInf;
    __syncthreads();
    scnt[level] = c_level + valid;
    __syncthreads();
  }

  for (int h = tid; h < L; h += T) cnt[(size_t)s * L + h] = scnt[h];
  if (tid == 0) {
    key[2 * s] = key0;
    key[2 * s + 1] = key1;
    nc[s] = compactions;
  }
}

}  // namespace

extern "C" {

// buf: (S, L, K) float32; cnt: (S, L) int32; key: (S, 2) uint32; nc: (S,) int32, all updated in place;
// chunks: (S, n, K / 2) float32; valids: (S, n) int32; levels: (n,) int32.  Returns a CUDA error code.
int kll_fold(void* buf, void* cnt, void* key, void* nc, const void* chunks, const void* valids,
             const void* levels, int64_t s, int64_t n, int64_t L, int64_t K, void* stream) {
  int p2 = 1;
  while (p2 < K) p2 <<= 1;
  const int threads = p2 / 2 < 64 ? 64 : (p2 / 2 > 1024 ? 1024 : p2 / 2);
  const size_t shared = (size_t)p2 * 8 + (size_t)K * 4 + (size_t)L * 4;
  cudaError_t err = cudaFuncSetAttribute(kll_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  kll_fold_kernel<<<(unsigned)s, threads, shared, (cudaStream_t)stream>>>(
      (float*)buf, (int*)cnt, (uint32_t*)key, (int*)nc, (const float*)chunks, (const int*)valids,
      (const int*)levels, (int)n, (int)L, (int)K, p2);
  return (int)cudaGetLastError();
}

}  // extern "C"
