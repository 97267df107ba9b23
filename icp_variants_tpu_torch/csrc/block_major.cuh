// The block-major kd block search, shared by kd_block_search.cu (each
// query's top-k blocks from per-query starting bounds) and
// cached_block_search.cu (one seeded block per query from a common bound,
// optionally moving the queries by a pose as they are loaded).
//
// Semantics: `sel` (B, N, k) holds each query's picks (ids < 0 are no
// pick, ids past nc - 1 are clipped to nc - 1, a block repeated in one row
// counts once, at its earliest position); the starting bound of row r is
// binit[r], or `binit_value` where `binit` is null. The result is the least
// (d2, pick position, slot) in lexicographic order over the points of the
// row's picks whose squared distance d2 = sum_j (t_j - q_j)^2 (feature 0
// first, direct differences, every product and sum rounded on its own) is
// strictly below the start; idx is the pair-local page index
// block * cap_pad + slot. Where no point is below the start, (start, -1).
//
// With POSE ((B, 16) f32, row-major 4 x 4 per pair) the queries are raw
// features and each query's three spatial columns are moved as the walk
// loads it: x'_r = ((P_r0 x + P_r1 y) + P_r2 z) + P_r3, every product and
// sum rounded on its own (core/se3.transform_points' order); the other
// features pass through.
//
// Layout: five launches on the caller's stream (block_major_launch).
//  1. bin: counting sort, first pass. Each CTA takes 1,024 (row, pick)
//     entries of one pair, drops no-picks and repeats, counts its entries
//     per block in shared memory, adds each block's count to the pair's
//     global histogram with one atomic and keeps each entry's rank in its
//     (pair, block) bucket; it also sets each row's merge key.
//  2. scan: one CTA; bucket offsets and chunk offsets (a bucket is cut into
//     chunks of KdbShape's chunk entries). The scan and the walk's small
//     helpers are common.cuh's, shared with kd_radius_search.cu.
//  3. scatter: entries into bucket order (query row * 16 + pick position).
//  4. walk: one CTA per chunk. One thread issues a single cp.async.bulk of
//     the block's first D page rows (D x cap_pad f32) into shared memory on
//     an mbarrier while every thread loads its own queries; then each
//     thread walks the block's slots for Q whole queries held in
//     registers, reading four consecutive slots of a feature with one
//     broadcast LDS.128, so one shared load serves 4 slots x Q queries. A
//     chunk of G = ceil(entries / Q) <= 256 query groups fills the CTA's
//     256 threads: each group's slots are split over floor(256 / G)
//     threads, so a small bucket still keeps every lane on a live (query,
//     block) pair. At D = 6 the walk first sums the three spatial
//     features and adds the colour ones only where one of the thread's
//     4 x Q partial sums is still below its query's best (a partial sum of
//     terms >= 0 only grows, so this skips no winner). Each thread's best
//     (d2, slot) for each of its (query, position) pairs goes to the row's
//     key with one 64-bit atomicMin. The launch shape (chunk, Q) is fixed
//     per D and mode (KdbShape below).
//  5. out: each row's key into (d2, idx).
// The merge key is (d2 bits << 32) | ((position + 1) << 27) | slot, and a
// row starts at (start bits << 32) (0, where the start is not > 0: nothing
// can beat it). d2 >= 0, so the key orders (d2, position, slot)
// lexicographically and a d2 equal to the start never wins; the result is
// the same in any order of the atomics.
//
// With PROBE (a measurement aid: the JAX kernel's probe >= 1) the bucketing
// runs and every chunk still stages its block, but no distance is taken and
// every row gets (start, -1).
//
// With `counters` (null: none) the launches add their work to three int64
// counters: [0] rows with a pick (the bucketing, one atomic a CTA), [1]
// (query, block) entries bucketed and [2] bucket chunks staged (the
// scan's totals, one thread). Nothing else changes.
//
// The including source defines BM_KERNEL(part), the name of each
// __global__ (its own prefix, so a profile attributes each launch to the
// C entry that made it). Built with -DKDB_LANE_COUNT (kd_block_search.cu's
// measurement build), the walk also counts, at each warp step, the lanes
// that __activemask() reports active, into kdb_lanes.
#pragma once

#include "common.cuh"

#ifndef BM_KERNEL
#error "define BM_KERNEL(part) before including block_major.cuh"
#endif

#define KDB_THREADS 256      // threads of every launch but the scan
#define KDB_BIN_EPT 4        // entries per thread of the bucketing launches
#define KDB_SCAN_THREADS 1024
#define KDB_SLOT_BITS 27     // key: slot in the low 27 bits, position + 1 above

namespace {

// The launch shape by D, and SEEDED (the seeded search: k = 1 from a common
// start): the entries of one (pair, block) bucket that one CTA takes, and
// the queries each thread holds; chunk <= Q * KDB_THREADS (one query group
// per thread at most). Other shapes are timed against these at the ETH and
// colour shapes, and at colour checks16's seeded shapes, by
// scripts/kd_variants.py (readings in PERF.md). The seeded D = 6 shape
// (colour checks16: a bucket holds a block's ~1,200 rows) is its own
// measured one; the seeded D = 3 shape, on no main path, is the kd one.
template <int D, bool SEEDED> struct KdbShape;
template <> struct KdbShape<3, false> { static constexpr int chunk = 64, queries = 1; };
template <> struct KdbShape<6, false> { static constexpr int chunk = 512, queries = 2; };
template <> struct KdbShape<3, true> { static constexpr int chunk = 64, queries = 1; };
template <> struct KdbShape<6, true> { static constexpr int chunk = 256, queries = 1; };

struct Workspace {
  unsigned long long* keys;  // (B, N) merge keys
  int* counts;               // (B * nc) entries per bucket
  int* boff;                 // (B * nc + 1) bucket offsets
  int* coff;                 // (B * nc + 1) chunk offsets
  int* rank;                 // (B, N, k) rank of each entry in its bucket, -1 = none
  int* ent;                  // (B * N * k) entries in bucket order
};

// The workspace's layout from `base` (null: offsets only); returns the
// bytes it needs. ops/kdtree.py (_block_search_workspace_bytes) allocates
// the same sum.
size_t workspace_layout(char* base, int B, int N, int nc, int k, Workspace* w) {
  const size_t rows = static_cast<size_t>(B) * N, nb = static_cast<size_t>(B) * nc;
  IcpCarve ws{base};
  w->keys = ws.take<unsigned long long>(8 * rows);
  w->counts = ws.take<int>(4 * nb);
  w->boff = ws.take<int>(4 * (nb + 1));
  w->coff = ws.take<int>(4 * (nb + 1));
  w->rank = ws.take<int>(4 * rows * k);
  w->ent = ws.take<int>(4 * rows * k);
  return ws.off;
}

// Row r's starting bound (the bucketing and output launches; the walk takes
// it from its SEEDED template argument).
__device__ __forceinline__ float start_of(const float* __restrict__ binit, float binit_value,
                                          size_t r) {
  return binit != nullptr ? binit[r] : binit_value;
}

}  // namespace

// 1. Histogram and ranks; the rows' merge keys.
__global__ void __launch_bounds__(KDB_THREADS)
BM_KERNEL(bin)(const int32_t* __restrict__ sel, const float* __restrict__ binit,
               float binit_value, unsigned long long* __restrict__ keys,
               int* __restrict__ counts, int* __restrict__ rank, int N, int nc, int k,
               unsigned long long* __restrict__ counters) {
  extern __shared__ int sh[];
  __shared__ int s_rows;  // rows whose first pick lies in this CTA (counters only)
  int* hist = sh;
  int* base = sh + nc;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) s_rows = 0;
  __syncthreads();
  const int b = blockIdx.y;
  const size_t nk = static_cast<size_t>(N) * k;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * KDB_THREADS * KDB_BIN_EPT;
  const int32_t* psel = sel + b * nk;
  int blk[KDB_BIN_EPT], lr[KDB_BIN_EPT];
  int rows = 0;
#pragma unroll
  for (int i = 0; i < KDB_BIN_EPT; ++i) {
    const size_t e = e0 + i * KDB_THREADS + threadIdx.x;
    blk[i] = -1;
    if (e >= nk) continue;
    const int pos = static_cast<int>(e % k);
    if (pos == 0) {
      const size_t row = static_cast<size_t>(b) * N + e / k;
      const float r = start_of(binit, binit_value, row);
      keys[row] = r > 0.0f ? static_cast<unsigned long long>(__float_as_uint(r)) << 32 : 0ull;
    }
    const int c = icp_clip_pick(psel[e], nc);
    if (c < 0) continue;
    bool dup = false, first = true;
    for (int p = 1; p <= pos; ++p) {
      const int o = icp_clip_pick(psel[e - p], nc);
      dup |= o == c;
      first &= o < 0;
    }
    if (dup) continue;
    rows += first;
    blk[i] = c;
    lr[i] = atomicAdd(&hist[c], 1);
  }
  if (counters != nullptr && rows) atomicAdd(&s_rows, rows);
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const int h = hist[i];
    base[i] = h ? atomicAdd(&counts[b * nc + i], h) : 0;
  }
  if (counters != nullptr && threadIdx.x == 0 && s_rows)
    atomicAdd(&counters[0], static_cast<unsigned long long>(s_rows));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < KDB_BIN_EPT; ++i) {
    const size_t e = e0 + i * KDB_THREADS + threadIdx.x;
    if (e < nk) rank[b * nk + e] = blk[i] >= 0 ? base[blk[i]] + lr[i] : -1;
  }
}

// 2. Exclusive scans of the bucket sizes and of their chunk counts; the
// last thread, which writes the totals, adds them to the counters.
__global__ void __launch_bounds__(KDB_SCAN_THREADS)
BM_KERNEL(scan)(int* __restrict__ counts, int* __restrict__ boff, int* __restrict__ coff,
                int nb, int chunk, unsigned long long* __restrict__ counters) {
  icp_bucket_scan<KDB_SCAN_THREADS, false>(counts, boff, coff, nb, chunk);
  if (counters != nullptr && threadIdx.x == KDB_SCAN_THREADS - 1) {
    atomicAdd(&counters[1], static_cast<unsigned long long>(boff[nb]));
    atomicAdd(&counters[2], static_cast<unsigned long long>(coff[nb]));
  }
}

// 3. Entries into bucket order.
__global__ void __launch_bounds__(KDB_THREADS)
BM_KERNEL(scatter)(const int32_t* __restrict__ sel, const int* __restrict__ rank,
                   const int* __restrict__ boff, int* __restrict__ ent, int N, int nc, int k) {
  const int b = blockIdx.y;
  const size_t nk = static_cast<size_t>(N) * k;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * KDB_THREADS * KDB_BIN_EPT;
#pragma unroll
  for (int i = 0; i < KDB_BIN_EPT; ++i) {
    const size_t e = e0 + i * KDB_THREADS + threadIdx.x;
    if (e >= nk) continue;
    const int r = rank[b * nk + e];
    if (r < 0) continue;
    const int c = icp_clip_pick(sel[b * nk + e], nc);
    ent[boff[b * nc + c] + r] = static_cast<int>(e / k) * 16 + static_cast<int>(e % k);
  }
}

#ifdef KDB_LANE_COUNT
// [0] active lanes over the walk's warp steps on the first H features, [1]
// 32 per such step; [2], [3] the same over the steps that add the colour
// terms (D = 6). A warp step is counted by its lowest active lane.
__device__ unsigned long long kdb_lanes[4];
#define KDB_COUNT_LANES(i)                                            \
  do {                                                                \
    const unsigned m_ = __activemask();                               \
    if ((threadIdx.x & 31) == __ffs(m_) - 1) {                        \
      lanes[i] += __popc(m_);                                         \
      lanes[(i) + 1] += 32;                                           \
    }                                                                 \
  } while (0)
#else
#define KDB_COUNT_LANES(i) \
  do {                     \
  } while (0)
#endif

// 4. The block-major walk: one CTA per chunk of one (pair, block) bucket.
// SEEDED: every row starts at binit_value (binit is not read); else at
// binit[row]. POSE (SEEDED only): the queries are moved as they are loaded.
template <int D, bool PROBE, bool SEEDED, bool POSE>
__global__ void __launch_bounds__(KDB_THREADS)
BM_KERNEL(walk)(const float* __restrict__ q, const float* __restrict__ pose,
                const float* __restrict__ binit, float binit_value,
                const float* __restrict__ pages, const int* __restrict__ boff,
                const int* __restrict__ coff, const int* __restrict__ ent,
                unsigned long long* __restrict__ keys, int N, int nc, int cap_pad, int nb) {
  constexpr int Q = KdbShape<D, SEEDED>::queries, chunk = KdbShape<D, SEEDED>::chunk;
  static_assert(chunk <= Q * KDB_THREADS, "one query group per thread at most");
  static_assert(SEEDED || !POSE, "the pose operand is the seeded search's");
  // Features summed before the walk tests whether any of a thread's 4 x Q
  // partial distances can still win (the spatial three of the colour
  // features).
  constexpr int H = D > 3 ? 3 : D;
  extern __shared__ float4 tile4[];  // D x cap_pad f32: the block's first D page rows
  __shared__ alignas(8) unsigned long long bar;
  const int c = blockIdx.x;
  if (c >= coff[nb]) return;  // the grid is an upper bound on the chunks
  int lo = 0, hi = nb;        // the bucket u with coff[u] <= c < coff[u + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (coff[mid] <= c) lo = mid; else hi = mid;
  }
  const int u = lo, b = u / nc, blk = u % nc;
  const int e_lo = boff[u] + (c - coff[u]) * chunk;
  const int n_e = min(boff[u + 1] - e_lo, chunk);

  const uint32_t bar_a = icp_smem_addr(&bar);
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(D) * cap_pad * sizeof(float);
    const float* src = pages + (static_cast<size_t>(b) * nc + blk) * 8 * cap_pad;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_a), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(icp_smem_addr(tile4)), "l"(src), "r"(bytes), "r"(bar_a) : "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it

  // Query groups: G <= KDB_THREADS groups of Q entries (group g holds
  // entries g + i * G); P threads share a group's slots.
  const int G = (n_e + Q - 1) / Q;
  const int P = KDB_THREADS / G;
  const int part = threadIdx.x / G, g = threadIdx.x % G;
  const int n4 = cap_pad / 4;
  const int per = (n4 + P - 1) / P;
  const int s_lo = min(n4, part * per), s_hi = min(n4, s_lo + per);
  auto wait_tile = [&]() {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar_a) : "memory");
    }
  };
  if (PROBE || part >= P) {
    // The probe stages and stops; a thread past the last part has no slots,
    // but thread 0 (part 0) stays, so the CTA outlives its copy.
    if (PROBE) wait_tile();
    return;
  }
  const float4* t4 = tile4;
#ifdef KDB_LANE_COUNT
  unsigned long long lanes[4] = {0, 0, 0, 0};
#endif
  float qv[Q][D], best[Q];
  int slot[Q], row[Q], pos[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int e = g + i * G;
    slot[i] = -1;
    if (e < n_e) {
      const int v = ent[e_lo + e];
      row[i] = b * N + (v >> 4);
      pos[i] = v & 15;
      best[i] = SEEDED ? binit_value : binit[row[i]];
#pragma unroll
      for (int j = 0; j < D; ++j) qv[i][j] = q[static_cast<size_t>(row[i]) * D + j];
      if (POSE) {
        const float* P4 = pose + static_cast<size_t>(b) * 16;
        const float x = qv[i][0], y = qv[i][1], z = qv[i][2];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          qv[i][r] = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(x, P4[4 * r]), __fmul_rn(y, P4[4 * r + 1])),
                        __fmul_rn(z, P4[4 * r + 2])),
              P4[4 * r + 3]);
      }
    } else {
      row[i] = pos[i] = 0;
      best[i] = -1.0f;  // an empty entry: no distance is below it
#pragma unroll
      for (int j = 0; j < D; ++j) qv[i][j] = 0.0f;
    }
  }
  wait_tile();
  // Unrolled by hand: left to itself nvcc does not unroll this loop; 4 deep
  // against 1, 2 and 8: scripts/kd_variants.py (readings in PERF.md).
#pragma unroll 4
  for (int s4 = s_lo; s4 < s_hi; ++s4) {
    // Each query's distances to 4 slots, first over the leading H features.
    float4 t[D], dq[Q];
    bool live = false;
    KDB_COUNT_LANES(0);
#pragma unroll
    for (int j = 0; j < H; ++j) t[j] = t4[j * n4 + s4];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      dq[i] = make_float4(icp_diff2(t[0].x, qv[i][0]), icp_diff2(t[0].y, qv[i][0]),
                          icp_diff2(t[0].z, qv[i][0]), icp_diff2(t[0].w, qv[i][0]));
#pragma unroll
      for (int j = 1; j < H; ++j) icp_add_diff2(dq[i], t[j], qv[i][j]);
      live |= icp_min4(dq[i]) < best[i];
    }
    if (H < D) {
      // A partial sum only grows (every term >= 0, rounding is monotone),
      // so where no partial is below its query's best no full sum is.
      if (!live) continue;
      KDB_COUNT_LANES(2);
#pragma unroll
      for (int j = H; j < D; ++j) t[j] = t4[j * n4 + s4];
#pragma unroll
      for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = H; j < D; ++j) icp_add_diff2(dq[i], t[j], qv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (icp_min4(dq[i]) < best[i]) {
        // In slot order with a strict <: the lowest slot among equals.
        const int s = 4 * s4;
        if (dq[i].x < best[i]) best[i] = dq[i].x, slot[i] = s;
        if (dq[i].y < best[i]) best[i] = dq[i].y, slot[i] = s + 1;
        if (dq[i].z < best[i]) best[i] = dq[i].z, slot[i] = s + 2;
        if (dq[i].w < best[i]) best[i] = dq[i].w, slot[i] = s + 3;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (slot[i] < 0) continue;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(best[i])) << 32) |
        (static_cast<unsigned long long>(pos[i] + 1) << KDB_SLOT_BITS) |
        static_cast<unsigned long long>(slot[i]);
    atomicMin(&keys[row[i]], key);
  }
#ifdef KDB_LANE_COUNT
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lanes[i]) atomicAdd(&kdb_lanes[i], lanes[i]);
#endif
}

// 5. Keys into (d2, idx).
__global__ void __launch_bounds__(KDB_THREADS)
BM_KERNEL(out)(const unsigned long long* __restrict__ keys, const int32_t* __restrict__ sel,
               const float* __restrict__ binit, float binit_value, float* __restrict__ d2,
               int32_t* __restrict__ idx, size_t rows, int nc, int cap_pad, int k) {
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const unsigned long long key = keys[r];
  const uint32_t low = static_cast<uint32_t>(key);
  if (low == 0) {
    d2[r] = start_of(binit, binit_value, r);
    idx[r] = -1;
    return;
  }
  const int pos = static_cast<int>(low >> KDB_SLOT_BITS) - 1;
  const int slot = static_cast<int>(low & ((1u << KDB_SLOT_BITS) - 1));
  d2[r] = __uint_as_float(static_cast<uint32_t>(key >> 32));
  idx[r] = icp_clip_pick(sel[r * k + pos], nc) * cap_pad + slot;
}

// Refuse what the layout cannot hold: k outside [1, ICP_MAX_K], cap_pad not
// a multiple of 4 (the walk reads 4 slots at once), no blocks, more than
// 2^31 entries (indexed by int), N >= 2^27 (an entry is row * 16 +
// position), cap_pad past the key's slot bits, pages not 16-byte aligned
// (the bulk copy), or a workspace smaller than the layout. B == 0 or N == 0
// is nothing to do: *empty is set.
static cudaError_t block_major_check(const float* pages, long long ws_bytes, int B, int N,
                                     int nc, int cap_pad, int k, bool* empty) {
  *empty = false;
  if (k < 1 || k > ICP_MAX_K || cap_pad % 4 != 0 || nc < 1) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) {
    *empty = true;
    return cudaSuccess;
  }
  if (static_cast<long long>(B) * N * k >= (1ll << 31) || N >= (1 << 27) ||
      cap_pad >= (1 << KDB_SLOT_BITS) || reinterpret_cast<uintptr_t>(pages) % 16 != 0)
    return cudaErrorInvalidValue;
  Workspace w;
  if (static_cast<long long>(workspace_layout(nullptr, B, N, nc, k, &w)) > ws_bytes)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The five launches on stream s (arguments checked by block_major_check).
// SEEDED: binit is null and every row starts at binit_value. counters: null,
// or the three work counters the launches add to.
template <int D, bool PROBE, bool SEEDED, bool POSE>
static cudaError_t block_major_launch(const float* q, const float* pose, const int32_t* sel,
                                      const float* binit, float binit_value, const float* pages,
                                      float* d2, int32_t* idx, void* ws, int B, int N, int nc,
                                      int cap_pad, int k, unsigned long long* counters,
                                      cudaStream_t s) {
  constexpr int chunk = KdbShape<D, SEEDED>::chunk;
  Workspace w;
  workspace_layout(static_cast<char*>(ws), B, N, nc, k, &w);
  const int nb = B * nc;
  cudaError_t err = cudaMemsetAsync(w.counts, 0, sizeof(int) * nb, s);
  if (err != cudaSuccess) return err;
  const size_t nk = static_cast<size_t>(N) * k;
  const size_t bin_smem = 2 * sizeof(int) * nc;
  if ((err = icp_allow_smem(BM_KERNEL(bin), bin_smem)) != cudaSuccess) return err;
  const dim3 bin_grid(static_cast<unsigned>((nk + KDB_THREADS * KDB_BIN_EPT - 1) /
                                            (KDB_THREADS * KDB_BIN_EPT)), B);
  BM_KERNEL(bin)<<<bin_grid, KDB_THREADS, bin_smem, s>>>(sel, binit, binit_value, w.keys,
                                                         w.counts, w.rank, N, nc, k, counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  BM_KERNEL(scan)<<<1, KDB_SCAN_THREADS, 0, s>>>(w.counts, w.boff, w.coff, nb, chunk,
                                                  counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  BM_KERNEL(scatter)<<<bin_grid, KDB_THREADS, 0, s>>>(sel, w.rank, w.boff, w.ent, N, nc, k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t walk_smem = static_cast<size_t>(D) * cap_pad * sizeof(float);
  if ((err = icp_allow_smem(BM_KERNEL(walk)<D, PROBE, SEEDED, POSE>, walk_smem)) !=
      cudaSuccess)
    return err;
  const long long entries = static_cast<long long>(B) * N * k;
  const long long grid = (entries + chunk - 1) / chunk + nb;  // >= the chunks of any histogram
  BM_KERNEL(walk)<D, PROBE, SEEDED, POSE>
      <<<static_cast<unsigned>(grid), KDB_THREADS, walk_smem, s>>>(
          q, pose, binit, binit_value, pages, w.boff, w.coff, w.ent, w.keys, N, nc, cap_pad, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t rows = static_cast<size_t>(B) * N;
  BM_KERNEL(out)<<<static_cast<unsigned>((rows + KDB_THREADS - 1) / KDB_THREADS), KDB_THREADS,
                   0, s>>>(w.keys, sel, binit, binit_value, d2, idx, rows, nc, cap_pad, k);
  return cudaGetLastError();
}
