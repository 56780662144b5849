// Greedy COCO matching in rank space on Hopper: one launch per call.
//
// Replaces metrics_tpu/detection/device.py::_match_kernel (a lax.fori_loop
// over the D detections under three jax.vmaps, not a Pallas kernel), which XLA
// compiles into one program; in eager PyTorch the same formulation is about
// ten device operations per detection step (ops/coco_match.py's plain
// version), a thousand per compute() at D = 100.
//
// Inputs: ranks (B, D, G) int32, each det x gt IoU's rank in the epoch's
// sorted unique float64 IoUs, -1 for padding; gig (A, B, G) bool (one byte),
// the gts each area range ignores; thr (T,) int32, each IoU threshold's rank.
// Output: codes (A, B, T, D) uint8: 0 unmatched, 1 matched to a counted gt,
// 2 matched to an ignored gt.  For each (area a, block b, threshold t) the
// dets are walked in order; at det d, among the gts still free whose rank is
// at least thr[t], the one with the highest rank + (ignored ? 0 : 2^30) is
// taken, ties to the highest gt index, and is no longer free.  Ranks are
// below 2^30, so every counted gt outranks every ignored one, as the host
// matcher's walk of non-ignored gts first has it.  Integer comparisons only:
// the codes are bitwise those of the plain version and the JAX package.
//
// Design: a warp's lanes share one block b (their (a, t) pairs are
// blockIdx.y * 32 + lane).  The warp first finds the block's extent: the last
// row and column holding a rank that reaches the lowest threshold (padding
// is -1, below all of them), so only the block's real detections and gts are
// walked.  Then one LANE per (a, b, t) walks those detections, and for each
// the gts in increasing order, keeping the best (key, g) with `>=` (so ties
// go to the higher index); it owns its free-gt bitmask (32 gts a word, one
// column of a warp's shared memory, conflict-free) and stores its own codes.
// No lane waits for another in the walk; each rank the lanes read is one
// broadcast load through the read-only cache.  A block of the grid holds
// kWarps consecutive blocks b (one warp when the bitmasks of G gts outgrow
// 48 KB for four).
//
// What bounds it on an H100: bytes.  The padded ranks are read once for the
// extent (671 MB on phase 14 (a)'s operands) and the A B T D codes written
// once: 0.33 ms at 3.35 TB/s; the walk over the real pairs is a few integer
// instructions each (99.7 % of those slots are padding).  The codes past the
// extent, nearly all of them, are zeroed by the warp in coalesced stores: a
// lane storing its own row's bytes would touch a sector per byte.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kPref = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSharedDefault = 48 * 1024;  // a block's dynamic shared memory without the opt-in
constexpr int kSharedMax = 232448;         // with it, on Hopper

__global__ void coco_match_kernel(const int* __restrict__ ranks, const uint8_t* __restrict__ gig,
                                  const int* __restrict__ thr, uint8_t* __restrict__ codes, int A, int B, int T,
                                  int D, int G, int warps) {
  extern __shared__ uint32_t free_bits[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp: no barrier follows
  const int* block = ranks + (size_t)b * D * G;

  // The block's extent, with all 32 lanes: the last row and the last column holding a rank that
  // reaches the lowest threshold.  Nothing outside it is ever eligible, so rows past it are
  // unmatched and columns past it are never read (padding is -1, below every threshold rank).
  int thr_min = INT_MAX;
  for (int i = lane; i < T; i += 32) thr_min = min(thr_min, __ldg(thr + i));
  thr_min = __reduce_min_sync(kFull, thr_min);
  int d_last = -1;
  int g_last = -1;
#pragma unroll 4
  for (int i = lane; i < D * G; i += 32) {
    if (__ldg(block + i) >= thr_min) {
      const int d = i / G;
      d_last = d;  // i grows with the loop
      g_last = max(g_last, i - d * G);
    }
  }
  const int d_end = __reduce_max_sync(kFull, d_last) + 1;
  const int g_end = __reduce_max_sync(kFull, g_last) + 1;

  // The codes past the extent are 0.  Each (a, t) row of D codes is contiguous, so the warp zeroes
  // its rows' tails together, 32 consecutive bytes a store, before any lane walks.
  const int first = blockIdx.y * 32;
  const int last = min(first + 32, A * T);
  for (int p = first; p < last; ++p) {
    const int pa = p / T;
    uint8_t* row = codes + (((size_t)pa * B + b) * T + (p - pa * T)) * D;
    for (int d = d_end + lane; d < D; d += 32) row[d] = 0;
  }
  __syncwarp();

  const int pair = first + lane;
  if (pair >= A * T) return;
  const int a = pair / T;
  const int t = pair - a * T;
  const int words = (g_end + 31) >> 5;
  uint32_t* avail = free_bits + (size_t)warp * ((G + 31) >> 5) * 32 + lane;  // this lane's word j at avail[32 j]
  for (int j = 0; j < words; ++j) avail[32 * j] = 0xffffffffu;

  const int thr_rank = thr[t];
  const uint8_t* ignored = gig + ((size_t)a * B + b) * G;
  uint8_t* out = codes + (((size_t)a * B + b) * T + t) * D;
  for (int d = 0; d < d_end; ++d) {
    const int* row = block + (size_t)d * G;
    int best = -1;
    int best_g = -1;
    for (int j = 0; j < words; ++j) {
      const uint32_t free_j = avail[32 * j];
      const int n = min(32, g_end - 32 * j);
      for (int k = 0; k < n; ++k) {
        const int g = 32 * j + k;
        const int r = __ldg(row + g);
        if (((free_j >> k) & 1u) && r >= thr_rank) {
          const int key = r + (__ldg(ignored + g) ? 0 : kPref);
          if (key >= best) {  // g grows: of equal keys the later (higher) index wins
            best = key;
            best_g = g;
          }
        }
      }
    }
    out[d] = best < 0 ? 0 : (__ldg(ignored + best_g) ? 2 : 1);
    if (best >= 0) avail[32 * (best_g >> 5)] &= ~(1u << (best_g & 31));
  }
}

// Warps a block of the grid holds, and the shared memory their bitmasks take, for G gts.
void geometry(int64_t G, int* warps, size_t* shared) {
  const size_t per_warp = (size_t)32 * ((G + 31) / 32) * sizeof(uint32_t);
  *warps = per_warp * kWarps <= (size_t)kSharedDefault ? kWarps : 1;
  *shared = per_warp * (size_t)*warps;
}

}  // namespace

extern "C" {

// The most gts a block may hold: one warp's bitmasks in a block's shared memory with the opt-in.
int coco_match_max_gts() { return kSharedMax / (32 * (int)sizeof(uint32_t)) * 32; }

// ranks: (B, D, G) int32; gig: (A, B, G) uint8; thr: (T,) int32; codes: (A, B, T, D) uint8, every
// element written.  Returns a CUDA error code (0 on success).
int coco_match(const void* ranks, const void* gig, const void* thr, void* codes, int64_t A, int64_t B, int64_t T,
               int64_t D, int64_t G, void* stream) {
  const int64_t pairs = A * T;
  if (B == 0 || pairs == 0 || D == 0) return 0;
  int warps = 0;
  size_t shared = 0;
  geometry(G, &warps, &shared);
  if (shared > (size_t)kSharedDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(coco_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((B + warps - 1) / warps), (unsigned)((pairs + 31) / 32));
  coco_match_kernel<<<grid, warps * 32, shared, (cudaStream_t)stream>>>(
      (const int*)ranks, (const uint8_t*)gig, (const int*)thr, (uint8_t*)codes, (int)A, (int)B, (int)T, (int)D,
      (int)G, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
