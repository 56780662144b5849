// The KLL sketch's chunk fold on Hopper: one call folds n chunks into each of
// S sketches, in place, as four stages on the stream.
//
// Replaces metrics_tpu/streaming/sketches.py::_fold_chunks, a lax.scan (not a
// Pallas kernel): per chunk, a split of the sketch's PRNG key, then (if the
// chunk holds any value) a top-down pass of one lax.cond per level that
// compacts each full level, then a slice write of the chunk.  Per chunk t:
//   1. key, sub = split(key); k2 = split(sub)[1]; the coin of level h is
//      (y0 ^ y1) & 1 of threefry(k2, (0, h)): jax.random.randint(sub, (L,),
//      0, 2) under the partitionable threefry.  The key advances for every
//      chunk, an all-padding one too (the split comes before the cond).
//   2. If valid[t] > 0, for h = L-1 down to level[t], where cnt[h] > K - half:
//      sort row h (stable, -0.0 equal to +0.0, as XLA's sort compares), keep
//      picks[i] = sorted[coin + 2i] for i < n_surv = max((cnt + 1 - coin) / 2,
//      0), write them at cnt[h+1] of row h+1 and reset row h to +inf (the top
//      level keeps them in place), and count the compaction.
//   3. Write the chunk's first valid[t] values at cnt[level[t]] of that row.
// The function is ops/kll.py::kll_fold_plain, bit for bit: the kernel
// compares and moves floats and never does arithmetic on them.
//
// What bounds it on an H100: the key chain.  key <- threefry(key, (0, 0))
// once per chunk is n dependent hashes of 20 rounds, and nothing about the
// fold is known before it.  The rest splits in two.  Where a compaction
// fires, with which coin, how many survivors it keeps and where they land
// follow from the counts, the valid counts, the levels and the coins alone,
// not from the values.  And the values of a compaction at level h are the
// runs appended to row h since its last reset (the initial row, chunks,
// survivors of compactions at h - 1), so the compactions of one level are
// independent of each other, except at the top level, which compacts in
// place.  So one call is:
//
//   1. kll_fold_plan, one block of 256 threads per sketch: a pipeline of
//      steps of 64 chunks, one barrier a step, no thread reading device
//      memory per chunk.  Thread 0 runs the key chain of step k into shared
//      memory.  Warps 5-6 compute the coins of every level for step k-1 (one
//      chunk a thread; a chunk's L hashes are independent) and load its
//      valid counts and levels.  The walk of the counts is split by level:
//      level h's counts depend only on the levels below it, whose compactions
//      at a chunk come after h's check there.  So lane 0 of warp h + 1 walks
//      level h (h < 3) in registers over step k-2-h, taking the compactions
//      the level below made at each chunk from shared memory, and lane 0 of
//      warp 7 walks levels 3 and up over step k-5 from shared memory, with
//      the levels over K - half in a mask, so a chunk visits only the levels
//      that compact.  Each level lists its events (a compaction: coin, c,
//      and the slice of the level's run list that row h holds then) and its
//      runs (source: chunk t, survivors of an event of the level below or,
//      at the top, of its own, or the initial row; position in the row;
//      length).  Every run lands at the count itself: the slice write's clamp
//      min(cnt, K - half) never moves it within the contract (counts in
//      [0, K], valid counts at most K / 2), which tests/test_torch_kll_plan.py
//      shows; outside it the plan clamps every index and stays in bounds.
//      It writes cnt, nc, the key, and each row's final run slice and first
//      slab row.  The chain is the floor of the call.
//   2. kll_fold_execute, once per level h = 0 .. L-2, a grid of (enough blocks
//      to fill the card's SMs, S): each block takes events of level h; it
//      gathers the event's runs into shared memory with 4-byte cp.async
//      copies, one warp a run, each at its place in the row; it orders the c
//      valid entries only (not the K slots): with at most one descent between
//      neighbours (two sorted runs, the usual case: a sorted chunk or sorted
//      survivors after another) each entry finds its rank by a binary search
//      in the other run, ties to the lower slot, and with more a bitonic
//      network sorts (order key << 32 | slot) pairs, which is stable by the
//      slot.  Each entry at a picked rank writes its own bits (a -0.0 stays
//      -0.0) to the event's survivors in a scratch slab.  The K - c slots of
//      padding that the walk's sort sees are +inf and sort after every value
//      but a NaN; a pick that falls on them writes +inf.
//   3. kll_fold_execute for the top level with one block per sketch, which
//      runs its events in order: each reads the survivors of the last.
//   4. kll_fold_assemble, a block per (level, sketch): a row that was written
//      or compacted becomes its final runs, then +inf.
//
// L + 2 launches a call; the wrapper allocates the scratch (ops/kll.py
// states its sizes: events and runs per level, and a slab of K / 2 floats
// per event).  The levels' events keep the card busy (at K = 2048 an update
// of 2,400 chunks makes about 1,200 merges of two 1,024-runs at level 0, 600
// at level 1, ...).
//
// Tested against the plain version on a card by tests/test_torch_cuda.py (-m cuda)
// and chip_smoke.py phase 11; tests/test_torch_kll_plan.py models the stages on the CPU.
//
// Shared memory of an execute block: P2 * 8 + K * 4 bytes, P2 the power of two
// >= K (K = 2048: 24 KB).  The wrapper refuses a capacity above 16384 (P2 =
// 16384: 192 KB of the 227 KB a block may use) and more than 64 levels (the
// plan's masks).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr int kMaxLevels = 64;
constexpr int kStep = 64;       // chunks per step of the plan's pipeline
constexpr int kOwnLevels = 3;   // levels walked in a thread's registers, one thread each; one more thread walks the rest
constexpr int kRing = kOwnLevels + 2;  // steps of chunk records alive at once: the coins' and each walker's
// warp 0: the key chain; warps 1-3: the own-level walkers; warps 5-6: coins and loads; warp 7: the upper
// walker (warp w issues on the SM's scheduler w % 4: the chain's has nothing else to issue)
constexpr int kPlanThreads = 256, kCoinWarp = 5, kUpperWarp = 7;
static_assert(kOwnLevels == 3 && kCoinWarp > kOwnLevels && kUpperWarp % 4 != 0, "the plan's warps");
// a run's source, in the top two bits of its first word: a chunk, the survivors of the level below's
// event, the initial row, the survivors of the top level's own event
constexpr int kChunk = 0, kBelow = 1, kRow = 2, kOwn = 3;

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

// a run: (source << 30 | index, position | length << 16); positions and lengths fit: K <= 16384
__device__ __forceinline__ int2 make_run(int source, int index, int pos, int len) {
  return make_int2(int((uint32_t(source) << 30) | uint32_t(index)), pos | (len << 16));
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

// Stage 1.  events: (S, L, EV) int4 of (coin << 31, c, first run, end run); runs: (S, L, R) int2;
// rows: (S, L) int4 of (first run of the final contents, runs, events, slab row of the level's first
// event | written or compacted << 31).
__global__ void __launch_bounds__(kPlanThreads) kll_fold_plan(
    int* __restrict__ cnt, uint32_t* __restrict__ key, int* __restrict__ nc, const int* __restrict__ valids,
    const int* __restrict__ levels, int4* __restrict__ events, int2* __restrict__ runs, int4* __restrict__ rows,
    int n, int L, int K, int EV, int R) {
  __shared__ uint2 subs[2][kStep];
  __shared__ int4 chunk_of[kRing][kStep];      // (valid, level, coins' low word, coins' high word)
  __shared__ int2 push_of[kOwnLevels][2][kStep];  // a walker's compaction at the chunk: (event, survivors), or -1
  __shared__ int4 state[kMaxLevels];           // per level: count, first run of its contents, runs, events
  __shared__ int first_runs[kMaxLevels];

  const int s = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = K / 2, room = K - half;
  int2* run_of = runs + (size_t)s * L * R;
  int4* event_of = events + (size_t)s * L * EV;
  if (tid < L) {
    const int c = cnt[(size_t)s * L + tid];
    if (c > 0) run_of[(size_t)tid * R] = make_run(kRow, tid, 0, min(c, K));
    state[tid] = make_int4(c, 0, c > 0 ? 1 : 0, 0);
    first_runs[tid] = c > 0 ? 1 : 0;
  }
  __syncthreads();

  // Warp w = 1 .. kOwnLevels: its lane 0 walks level w - 1 in registers, a step behind the level below
  // it (level h's counts depend only on the levels below, whose compactions at a chunk come after h's
  // check there); warp kUpperWarp's lane 0 walks the levels above those from shared memory.  Each
  // level numbers its own events; the slab rows follow from the counts at the end.
  const int own = warp == kUpperWarp ? kOwnLevels : warp - 1;
  const bool walker = lane == 0 && ((warp >= 1 && warp <= kOwnLevels) || warp == kUpperWarp);
  uint32_t key0 = 0, key1 = 0;
  int4 mine = make_int4(0, 0, 0, 0);  // an own-level walker's level
  unsigned long long full = 0;        // the upper walker's levels over K - half, a bit each
  if (tid == 0) {
    key0 = key[2 * s];
    key1 = key[2 * s + 1];
  } else if (walker && own < kOwnLevels && own < L) {
    mine = state[own];
  } else if (walker && own == kOwnLevels) {
    for (int h = kOwnLevels; h < L; ++h) full |= (unsigned long long)(state[h].x > room) << h;
  }

  const int steps = (n + kStep - 1) / kStep;
  for (int step = 0; step < steps + kOwnLevels + 2; ++step) {
    if (tid == 0) {
      if (step < steps) {
        uint2* out = subs[step & 1];
        const int m = min(kStep, n - step * kStep);
        for (int j = 0; j < m; ++j) {
          uint32_t a, b, c0, c1;
          threefry(key0, key1, 0u, 1u, a, b);    // sub
          threefry(key0, key1, 0u, 0u, c0, c1);  // the next key: independent of sub, so the two overlap
          out[j] = make_uint2(a, b);
          key0 = c0;
          key1 = c1;
        }
      }
    } else if (warp >= kCoinWarp && warp < kUpperWarp) {
      const int block = step - 1, j = tid - 32 * kCoinWarp, t = block * kStep + j;
      if (j < kStep && block >= 0 && block < steps && t < n) {
        const uint2 sub = subs[block & 1][j];
        uint32_t k20, k21;
        threefry(sub.x, sub.y, 0u, 1u, k20, k21);  // k2 of split(sub)
        unsigned long long bits = 0;
#pragma unroll 4
        for (int h = 0; h < L; ++h) {
          uint32_t y0, y1;
          threefry(k20, k21, 0u, uint32_t(h), y0, y1);
          bits |= (unsigned long long)((y0 ^ y1) & 1u) << h;
        }
        chunk_of[block % kRing][j] = make_int4(valids[(size_t)s * n + t], levels[t], int(uint32_t(bits)), int(uint32_t(bits >> 32)));
      }
    } else if (walker && own < kOwnLevels) {
      const int block = step - 2 - own;
      if (own < L && block >= 0 && block < steps) {
        const int slot = block % kRing, m = min(kStep, n - block * kStep);
        int2* pushes = push_of[own][block & 1];
        const int2* below = push_of[own > 0 ? own - 1 : 0][block & 1];
        int2* run_at = run_of + (size_t)own * R;
        for (int j = 0; j < m; ++j) {
          const int4 chunk = chunk_of[slot][j];
          const int valid = chunk.x, level = chunk.y;
          const int2 in = own > 0 ? below[j] : make_int2(-1, 0);
          int2 out = make_int2(-1, 0);
          if (valid > 0 && uint32_t(level) < uint32_t(L)) {  // an all-padding chunk only advances the key
            if (level <= own && mine.x > room) {  // the pass checks this level before the levels below it push
              const int bit = int(uint32_t(chunk.z) >> own) & 1;
              const int n_surv = max((mine.x + 1 - bit) >> 1, 0);
              const int i = min(mine.w, EV - 1);
              event_of[(size_t)own * EV + i] = make_int4(int(uint32_t(bit) << 31), mine.x, mine.y, mine.z);
              mine.w += 1;
              mine.y = mine.z;
              if (own + 1 < L) {
                out = make_int2(i, n_surv);
                mine.x = 0;
              } else {  // the top level keeps its survivors in place
                run_at[min(mine.z, R - 1)] = make_run(kOwn, i, 0, min(n_surv, half));
                mine.z += 1;
                mine.x = n_surv;
              }
            }
            if (in.x >= 0) {  // the level below compacted at this chunk, into this level
              run_at[min(mine.z, R - 1)] = make_run(kBelow, in.x, min(max(mine.x, 0), room), min(in.y, half));
              mine.z += 1;
              mine.x += in.y;
            }
            if (level == own) {
              run_at[min(mine.z, R - 1)] = make_run(kChunk, block * kStep + j, min(max(mine.x, 0), room), min(valid, half));
              mine.z += 1;
              mine.x += valid;
            }
          }
          pushes[j] = out;
        }
      }
    } else if (walker) {  // the levels above the own-level walkers'
      const int block = step - 2 - kOwnLevels;
      if (L > kOwnLevels && block >= 0 && block < steps) {
        const int slot = block % kRing, m = min(kStep, n - block * kStep);
        const int2* below = push_of[kOwnLevels - 1][block & 1];
        for (int j = 0; j < m; ++j) {
          const int4 chunk = chunk_of[slot][j];
          const int valid = chunk.x, level = chunk.y;
          if (valid <= 0 || uint32_t(level) >= uint32_t(L)) continue;
          // the levels the top-down pass compacts here; nothing is written into a level before its check
          unsigned long long pending = full & (~0ull << max(level, kOwnLevels));
          if (pending) {
            const unsigned long long bits = (unsigned long long)uint32_t(chunk.w) << 32 | uint32_t(chunk.z);
            do {
              const int h = 63 - __clzll(pending);
              pending ^= 1ull << h;
              full ^= 1ull << h;
              int4 st = state[h];
              const int bit = int(bits >> h) & 1;
              const int n_surv = max((st.x + 1 - bit) >> 1, 0);
              const int i = min(st.w, EV - 1);
              event_of[(size_t)h * EV + i] = make_int4(int(uint32_t(bit) << 31), st.x, st.y, st.z);
              st.w += 1;
              st.y = st.z;
              if (h + 1 < L) {
                int4 up = state[h + 1];
                run_of[(size_t)(h + 1) * R + min(up.z, R - 1)] = make_run(kBelow, i, min(max(up.x, 0), room), min(n_surv, half));
                up.z += 1;
                up.x += n_surv;
                full |= (unsigned long long)(up.x > room) << (h + 1);
                state[h + 1] = up;
                st.x = 0;
              } else {  // the top level keeps its survivors in place
                run_of[(size_t)h * R + min(st.z, R - 1)] = make_run(kOwn, i, 0, min(n_surv, half));
                st.z += 1;
                st.x = n_surv;
                full |= (unsigned long long)(n_surv > room) << h;
              }
              state[h] = st;
            } while (pending);
          }
          const int2 in = below[j];
          if (in.x >= 0) {  // the highest own level compacted at this chunk, after the levels above it
            int4 up = state[kOwnLevels];
            run_of[(size_t)kOwnLevels * R + min(up.z, R - 1)] = make_run(kBelow, in.x, min(max(up.x, 0), room), min(in.y, half));
            up.z += 1;
            up.x += in.y;
            full |= (unsigned long long)(up.x > room) << kOwnLevels;
            state[kOwnLevels] = up;
          }
          if (level >= kOwnLevels) {
            int4 st = state[level];
            run_of[(size_t)level * R + min(st.z, R - 1)] = make_run(kChunk, block * kStep + j, min(max(st.x, 0), room), min(valid, half));
            st.z += 1;
            st.x += valid;
            full |= (unsigned long long)(st.x > room) << level;
            state[level] = st;
          }
        }
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    key[2 * s] = key0;
    key[2 * s + 1] = key1;
  } else if (walker && own < kOwnLevels && own < L) {
    state[own] = mine;
  }
  __syncthreads();
  if (tid == 0) {
    int events_so_far = 0;
    for (int h = 0; h < L; ++h) {
      // a row was written or compacted where its contents no longer start at its first run, or have more runs
      const int4 st = state[h];
      const bool written = st.y != 0 || st.z != first_runs[h];
      cnt[(size_t)s * L + h] = st.x;
      rows[(size_t)s * L + h] = make_int4(st.y, st.z, st.w, int(uint32_t(events_so_far) | (uint32_t(written) << 31)));
      events_so_far += st.w;
    }
    nc[s] += events_so_far;
  }
}

// a run's first float: a chunk, survivors in the slab (of level h's event, or of the level below's), or a row
__device__ __forceinline__ const float* run_source(int2 run, const float* chunk0, const float* slab0,
                                                   const float* row0, int base, int base_below, int half, int K,
                                                   int EB) {
  const int source = int(uint32_t(run.x) >> 30), index = run.x & 0x3FFFFFFF;
  if (source == kChunk) return chunk0 + (size_t)index * half;
  if (source == kRow) return row0 + (size_t)index * K;
  return slab0 + (size_t)min((source == kOwn ? base : base_below) + index, EB - 1) * half;
}

// Stages 2 and 3: the events of level h, each a block's, or in order on one block per sketch (serial).
// slab: (S, EB, K / 2) floats; the survivors of level h's event i at row (level h's first row) + i.
__global__ void __launch_bounds__(1024) kll_fold_execute(
    const float* __restrict__ buf, const float* __restrict__ chunks, float* slab, const int4* __restrict__ events,
    const int2* __restrict__ runs, const int4* __restrict__ rows, int h, int n, int L, int K, int P2, int EV, int R,
    int EB, int serial) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* pairs = smem;                   // the bitonic sort's (order key, slot) pairs
  uint32_t* okey = reinterpret_cast<uint32_t*>(smem);  // or the c order keys, in the same space
  float* vals = reinterpret_cast<float*>(smem + P2);   // the c values of the row, each at its slot
  __shared__ int nans_seen, descents_seen, split_at;

  const float kInf = __int_as_float(0x7F800000);
  const int s = blockIdx.y, tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = T >> 5;
  const int half = K / 2;
  const int4 info = rows[(size_t)s * L + h];
  const int count = min(info.z, EV);
  const int base = info.w & 0x7FFFFFFF, base_below = h > 0 ? rows[(size_t)s * L + h - 1].w & 0x7FFFFFFF : 0;
  const int4* event_of = events + ((size_t)s * L + h) * EV;
  const int2* run_of = runs + ((size_t)s * L + h) * R;
  const float* row0 = buf + (size_t)s * L * K;
  const float* chunk0 = chunks + (size_t)s * n * half;
  float* slab0 = slab + (size_t)s * EB * half;

  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int4 ev = event_of[i];
    const int e = base + i, bit = int(uint32_t(ev.x) >> 31);
    const int c = min(max(ev.y, 0), K);
    const int n_surv = min(max((ev.y + 1 - bit) / 2, 0), half);
    for (int r = ev.z + warp; r < min(ev.w, R); r += warps) {
      const int2 run = run_of[r];
      const int pos = run.y & 0xFFFF, len = int(uint32_t(run.y) >> 16);
      const float* src = run_source(run, chunk0, slab0, row0, base, base_below, half, K, EB);
      for (int j = lane; j < len && pos + j < K; j += 32) __pipeline_memcpy_async(vals + pos + j, src + j, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    if (tid == 0) {
      nans_seen = 0;
      descents_seen = 0;
      split_at = c;
    }
    __syncthreads();
    // each entry's order key, the NaNs, and the descents between neighbours, in one pass
    int nans = 0, descents = 0;
    for (int j = tid; j < c; j += T) {
      const float v = vals[j];
      const uint32_t k = order_key(v);
      nans += v != v;
      okey[j] = k;
      if (j + 1 < c && k > order_key(vals[j + 1])) {
        ++descents;
        split_at = j + 1;  // read only where it is the one descent
      }
    }
    if (nans) atomicAdd(&nans_seen, nans);
    if (descents) atomicAdd(&descents_seen, descents);
    __syncthreads();
    const int m_nan = nans_seen, split = split_at;
    float* out = slab0 + (size_t)e * half;
    const bool keep = e < EB;
    // the full row's sorted slot of the value at rank r: the K - c slots of +inf padding sort after
    // every value but the NaNs; a value at a picked slot writes its own bits
    auto place = [&](int r, float v) {
      const int q = (r < c - m_nan ? r : r + (K - c)) - bit;
      if (keep && q >= 0 && !(q & 1) && (q >> 1) < n_surv) out[q >> 1] = v;
    };
    if (descents_seen <= 1) {
      // merge runs A = [0, split) and B = [split, c): a tie orders A's entry (the lower slot) first
      for (int j = tid; j < c; j += T) {
        const uint32_t k = okey[j];
        const bool in_a = j < split;
        int lo = in_a ? split : 0, hi = in_a ? c : split;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (in_a ? okey[mid] < k : okey[mid] <= k) lo = mid + 1; else hi = mid;
        }
        place(in_a ? j + (lo - split) : (j - split) + lo, vals[j]);
      }
    } else {
      int p2 = 1;
      while (p2 < c) p2 <<= 1;
      // the pairs overwrite the order keys, which no thread reads past the barrier above
      for (int j = tid; j < p2; j += T)
        pairs[j] = j < c ? ((unsigned long long)order_key(vals[j]) << 32) | uint32_t(j) : ~0ull;
      __syncthreads();
      bitonic_sort(pairs, p2);
      for (int r = tid; r < c; r += T) place(r, vals[uint32_t(pairs[r])]);
    }
    if (keep) {
      for (int q = tid; q < n_surv; q += T) {
        const int p = bit + 2 * q;
        if (p >= c - m_nan && p < K - m_nan) out[q] = kInf;
      }
    }
    if (serial) __threadfence();  // the next event of the top level reads these survivors
    __syncthreads();
  }
}

// Stage 4: a written or compacted row becomes its final runs, then +inf.
__global__ void kll_fold_assemble(float* __restrict__ buf, const int* __restrict__ cnt,
                                  const float* __restrict__ chunks, const float* __restrict__ slab,
                                  const int2* __restrict__ runs, const int4* __restrict__ rows, int n, int L, int K,
                                  int R, int EB) {
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int4 info = rows[(size_t)s * L + h];
  if (!(uint32_t(info.w) >> 31)) return;
  const int half = K / 2;
  const int base = info.w & 0x7FFFFFFF, base_below = h > 0 ? rows[(size_t)s * L + h - 1].w & 0x7FFFFFFF : 0;
  float* row = buf + ((size_t)s * L + h) * K;
  const int2* run_of = runs + ((size_t)s * L + h) * R;
  for (int r = info.x; r < min(info.y, R); ++r) {  // the block copies each run, several loads in flight a thread
    const int2 run = run_of[r];
    if (int(uint32_t(run.x) >> 30) == kRow) continue;  // the initial row's prefix is in place
    const int pos = run.y & 0xFFFF, len = min(int(uint32_t(run.y) >> 16), K - pos);
    const float* src = run_source(run, chunks + (size_t)s * n * half, slab + (size_t)s * EB * half, buf, base,
                                  base_below, half, K, EB);
#pragma unroll 4
    for (int j = tid; j < len; j += blockDim.x) row[pos + j] = src[j];
  }
  const float kInf = __int_as_float(0x7F800000);
  for (int j = max(cnt[(size_t)s * L + h], 0) + tid; j < K; j += blockDim.x) row[j] = kInf;
}

}  // namespace

extern "C" {

// buf: (S, L, K) float32; cnt: (S, L) int32; key: (S, 2) uint32; nc: (S,) int32, all updated in place;
// chunks: (S, n, K / 2) float32; valids: (S, n) int32; levels: (n,) int32.  Scratch: events (S, L, EV)
// int4, runs (S, L, R) int2, rows (S, L) int4, slab (S, EB, K / 2) float32.  Returns a CUDA error code.
int kll_fold(void* buf, void* cnt, void* key, void* nc, const void* chunks, const void* valids, const void* levels,
             void* events, void* runs, void* rows, void* slab, int64_t s, int64_t n, int64_t L, int64_t K,
             int64_t EV, int64_t R, int64_t EB, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int p2 = 1;
  while (p2 < K) p2 <<= 1;
  const int threads = p2 / 2 < 64 ? 64 : (p2 / 2 > 1024 ? 1024 : p2 / 2);
  const size_t shared = (size_t)p2 * 8 + (size_t)K * 4;
  cudaError_t err = cudaFuncSetAttribute(kll_fold_execute, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kll_fold_execute, threads, shared);
  if (err != cudaSuccess) return (int)err;
  const int64_t fill = (per_sm * sms + s - 1) / s;  // blocks along a level's events, per sketch: the card's worth
  const int wide = fill > 1 ? (int)fill : 1;

  kll_fold_plan<<<(unsigned)s, kPlanThreads, 0, st>>>(
      (int*)cnt, (uint32_t*)key, (int*)nc, (const int*)valids, (const int*)levels, (int4*)events, (int2*)runs,
      (int4*)rows, (int)n, (int)L, (int)K, (int)EV, (int)R);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int h = 0; h < L; ++h) {
    const bool top = h == L - 1;
    kll_fold_execute<<<dim3(top ? 1 : wide, (unsigned)s), threads, shared, st>>>(
        (const float*)buf, (const float*)chunks, (float*)slab, (const int4*)events, (const int2*)runs,
        (const int4*)rows, h, (int)n, (int)L, (int)K, p2, (int)EV, (int)R, (int)EB, top ? 1 : 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  kll_fold_assemble<<<dim3((unsigned)L, (unsigned)s), 256, 0, st>>>(
      (float*)buf, (const int*)cnt, (const float*)chunks, (const float*)slab, (const int2*)runs, (const int4*)rows,
      (int)n, (int)L, (int)K, (int)R, (int)EB);
  return (int)cudaGetLastError();
}

}  // extern "C"
