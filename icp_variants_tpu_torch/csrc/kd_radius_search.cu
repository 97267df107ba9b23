// kd_radius_search: per query, the exact nearest point strictly below its
// own radius among the points of its member kd blocks, for page tables of
// any size.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py _make_bitmap_kernel
// (launched by _run_bitmap_kernel_flat): the warm-start radius search that
// the JAX package runs on tables past its resident VMEM rule. That kernel
// compacted hot/cold code rows with quantized bounds on the scalar core and
// double-buffered page DMAs between VMEM and HBM; none of it carries over.
//
// Semantics (held against the plain version in ops/knn.py bit for bit):
// a row's members are its picks in `sel` (B, N, k) when given (box_topk's
// top-k at the row's radius, -1 = none, ids past nc - 1 clipped to nc - 1,
// a repeat counts once), else (k = 0) every block whose squared box lower
// bound
//   lb = sum_j max(max(bmin_j - q_j, q_j - bmax_j), 0)^2
// is <= the row's radius; a pick whose lb exceeds the radius is no member.
// Over the members' points, d2 = sum_j (t_j - q_j)^2 (feature 0 first,
// direct differences, every step rounded on its own); the answer is the
// smallest d2 strictly below the radius, ties to the lowest pair-local page
// index block * cap_pad + slot. A row with a negative radius is frozen; a
// frozen row, or one where nothing beats its radius, returns idx -1 and
// d2 = its radius.
//
// What bounds it on the H100: f32 issue, 3D operations per (query, needed
// block, slot), each rounded on its own (built with -fmad=false); on the
// dense path about one block of ~2,000 points a row is needed. The gate
// design this replaces (one CTA per 32 rows walking the union of their
// picks) worked a lane only where the block was its own row's pick, staged
// every union block whole with no overlap, and sorted and deduplicated each
// gate's list in O(n^2): it reached 6% of the bound. Here the work is
// block-major, as in kd_block_search.cu, and the walk is pruned against
// each row's running best.
//
// Layout: one C entry; the (row, member block) entries are walked in
// rounds, each a counting sort and a walk, on the caller's stream:
//  round 0   k > 0: each row's pick 0 (box_topk gives picks by ascending
//            bound, so it is usually the block that holds the query);
//            k = 0: the member of least lb (lowest id on ties).
//  round 1   k > 0: the row's other picks, less repeats, whose lb is <= the
//            row's best after round 0.
//  round 1.. k = 0: the members in id spans of RS_SPAN blocks, less round
//            0's block, whose lb is <= the row's best at that round.
// Each round: kd_radius_search_bin (one thread per row: the round's
// entries, counted per (pair, block) in a shared histogram with
// warp-aggregated atomics, one global atomic per block and CTA),
// kd_radius_search_scan (one CTA: bucket and chunk offsets; it zeroes the
// counts for the next round), kd_radius_search_scatter (entries, each a
// row, into bucket order) and kd_radius_search_walk: persistent CTAs, each
// taking chunks of one (pair, block) bucket in turn. One thread issues a single
// cp.async.bulk of the block's first D page rows into shared memory on an
// mbarrier while every thread loads its Q queries into registers; each
// thread then walks its share of the slots, four at a time from one
// broadcast LDS.128, and a small chunk's slots are split over several
// threads so that every lane serves a live (row, block) pair. At D = 6 the
// colour terms are added only where a spatial partial can still win.
// kd_radius_search_out turns the row keys into (d2, idx).
//
// Merge: a row's key is (d2 bits << 32) | page index, started at (radius
// bits << 32), and every thread's best goes to it by one 64-bit atomicMin,
// so the result orders (d2, page index) as the contract does whatever the
// order of walk and atomics, and a d2 equal to the radius never wins. Prune:
// an entry whose lb is strictly above the row's current best (read from its
// key) holds no winner, since bests only fall; an entry whose lb equals the
// best is walked (a tie at a lower index can still win). The walk starts a
// row found at d2 = x from the next float above x, so an equal d2 at a
// lower page index still reaches the atomic.
//
// The counting sort's scan and the walk's small helpers are common.cuh's,
// shared with kd_block_search.cu. Walking every pick in one round (no
// second pass) was measured slower at the dense shapes (PERF.md §6).
//
// Measurement build (scripts/radius_split.py; never on the main path):
// -DRS_PROBE: the walk stages each chunk's block and takes no distance
// (every row returns (radius, -1)), so its round-0 launch times the
// bucketed staging alone.
#include <algorithm>

#include "common.cuh"

#define RS_THREADS 256       // threads of every launch but the scan
#define RS_SCAN_THREADS 1024
#define RS_SPAN 32           // blocks of one k = 0 round after round 0

namespace {

// The walk's launch shape by D (as kd_block_search's KdbShape): entries of
// one bucket a CTA takes, and the queries each thread holds.
template <int D> struct RsShape;
template <> struct RsShape<3> { static constexpr int chunk = 64, queries = 1; };
template <> struct RsShape<6> { static constexpr int chunk = 512, queries = 2; };

struct Workspace {
  unsigned long long* keys;  // (B, N) merge keys
  int* counts;               // (B * nc) entries per bucket in this round
  int* boff;                 // (B * nc + 1) bucket offsets
  int* coff;                 // (B * nc + 1) chunk offsets
  int* first;                // (B, N) k = 0: round 0's block, -1 = none
  int* eblk;                 // (B, N, slots) the round's blocks of each row, -1 ends
  int* erank;                // (B, N, slots) each entry's place in its bucket
  int* ent;                  // (B * N * slots) rows in bucket order
};

// Entries a row may give in one round.
__host__ __device__ inline int slots_for(int k) { return k > 0 ? k : RS_SPAN; }

// The workspace's layout from `base` (null: offsets only); returns its
// bytes. ops/knn.py (_radius_search_workspace_bytes) allocates the same sum.
size_t workspace_layout(char* base, int B, int N, int nc, int k, Workspace* w) {
  const size_t rows = static_cast<size_t>(B) * N, nb = static_cast<size_t>(B) * nc;
  const size_t ents = rows * slots_for(k);
  IcpCarve ws{base};
  w->keys = ws.take<unsigned long long>(8 * rows);
  w->counts = ws.take<int>(4 * nb);
  w->boff = ws.take<int>(4 * (nb + 1));
  w->coff = ws.take<int>(4 * (nb + 1));
  w->first = ws.take<int>(4 * rows);
  w->eblk = ws.take<int>(4 * ents);
  w->erank = ws.take<int>(4 * ents);
  w->ent = ws.take<int>(4 * ents);
  return ws.off;
}

__device__ __forceinline__ unsigned long long start_key(float r) {
  return static_cast<unsigned long long>(__float_as_uint(r)) << 32;
}

// The row's best so far: the key's d2 where a point beat the radius r,
// else r; `found` says which.
__device__ __forceinline__ float key_best(unsigned long long key, float r, bool* found) {
  *found = key < start_key(r);
  return *found ? __uint_as_float(static_cast<uint32_t>(key >> 32)) : r;
}

// Squared box lower bound of `qv` to the box (lo, hi), rounded like the
// plain version (knn.box_lb).
template <int D>
__device__ __forceinline__ float box_lb(const float* qv, const float* lo, const float* hi) {
  float lb = icp_gap2(qv[0], lo[0], hi[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) lb = __fadd_rn(lb, icp_gap2(qv[j], lo[j], hi[j]));
  return lb;
}

// Rank of this lane's entry in bucket v: one shared atomic per distinct v
// among the lanes that arrive together.
__device__ __forceinline__ int agg_rank(int* hist, int v) {
  const unsigned act = __activemask();
  const unsigned peers = __match_any_sync(act, v);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&hist[v], __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1));
}

}  // namespace

// 1. One round's entries: per row, its blocks in eblk and their ranks in
// their buckets in erank; the histogram into counts. Round 0 also starts
// the row keys. One thread per row, grid (ceil(N / RS_THREADS), B).
template <int D>
__global__ void __launch_bounds__(RS_THREADS)
kd_radius_search_bin(const float* __restrict__ q, const float* __restrict__ binit,
                     const float* __restrict__ bmin, const float* __restrict__ bmax,
                     const int32_t* __restrict__ sel, unsigned long long* __restrict__ keys,
                     int* __restrict__ first, int* __restrict__ counts, int* __restrict__ eblk,
                     int* __restrict__ erank, int N, int nc, int k, int round) {
  extern __shared__ int sh[];
  int* hist = sh;
  int* base = sh + nc;
  float* s_lo = reinterpret_cast<float*>(sh + 2 * nc);  // k = 0: the round's boxes
  const int b = blockIdx.y;
  const int slots = slots_for(k);
  // k = 0: the boxes of this round, [c_lo, c_hi).
  const int c_lo = round == 0 ? 0 : (round - 1) * RS_SPAN;
  const int c_hi = round == 0 ? nc : min(nc, c_lo + RS_SPAN);
  const int span = k == 0 ? c_hi - c_lo : 0;
  float* s_hi = s_lo + span * D;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) hist[i] = 0;
  for (int i = threadIdx.x; i < span * D; i += blockDim.x) {
    const size_t off = (static_cast<size_t>(b) * nc + c_lo) * D + i;
    s_lo[i] = bmin[off];
    s_hi[i] = bmax[off];
  }
  __syncthreads();

  const int n = blockIdx.x * RS_THREADS + threadIdx.x;
  const size_t row = static_cast<size_t>(b) * N + n;
  int cnt = 0;
  if (n < N) {
    const float r = binit[row];
    const bool live = r > 0.0f;  // d2 >= 0: nothing is below a radius <= 0
    float qv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qv[j] = q[row * D + j];
    float best = r;
    if (round == 0) {
      keys[row] = live ? start_key(r) : 0ull;
    } else if (live) {
      bool found;
      best = key_best(__ldcg(&keys[row]), r, &found);
    }
    int* my_blk = eblk + row * slots;
    int* my_rank = erank + row * slots;
    auto emit = [&](int c) {
      my_blk[cnt] = c;
      my_rank[cnt] = agg_rank(hist, c);
      ++cnt;
    };
    if (live && k > 0) {
      const int32_t* ps = sel + row * k;
      const int p_lo = round == 0 ? 0 : 1, p_hi = round == 0 ? 1 : k;
      for (int p = p_lo; p < p_hi; ++p) {
        const int c = icp_clip_pick(ps[p], nc);
        if (c < 0) continue;
        bool dup = false;
        for (int e = 0; e < p; ++e) dup |= icp_clip_pick(ps[e], nc) == c;
        if (dup) continue;
        const size_t off = (static_cast<size_t>(b) * nc + c) * D;
        float lo[D], hi[D];
#pragma unroll
        for (int j = 0; j < D; ++j) lo[j] = __ldg(&bmin[off + j]), hi[j] = __ldg(&bmax[off + j]);
        if (box_lb<D>(qv, lo, hi) <= best) emit(c);
      }
    } else if (live && round == 0) {
      // k = 0, round 0: the member of least lb.
      float m = INFINITY;
      int mc = -1;
      for (int c = 0; c < nc; ++c) {
        const float lb = box_lb<D>(qv, s_lo + c * D, s_hi + c * D);
        if (mc < 0 || lb < m) m = lb, mc = c;
      }
      mc = m <= r ? mc : -1;
      first[row] = mc;
      if (mc >= 0) emit(mc);
    } else if (live) {
      // k = 0, a later round: this span's members within the best, less
      // round 0's block.
      const int skip = first[row];
      for (int c = c_lo; c < c_hi; ++c) {
        if (c == skip) continue;
        if (box_lb<D>(qv, s_lo + (c - c_lo) * D, s_hi + (c - c_lo) * D) <= best) emit(c);
      }
    }
    if (cnt < slots) eblk[row * slots + cnt] = -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const int h = hist[i];
    base[i] = h ? atomicAdd(&counts[b * nc + i], h) : 0;
  }
  __syncthreads();
  for (int e = 0; e < cnt; ++e) erank[row * slots + e] += base[eblk[row * slots + e]];
}

// 2. Exclusive scans of the bucket sizes and of their chunk counts; the
// counts are zeroed for the next round.
__global__ void __launch_bounds__(RS_SCAN_THREADS)
kd_radius_search_scan(int* __restrict__ counts, int* __restrict__ boff, int* __restrict__ coff,
                      int nb, int chunk) {
  icp_bucket_scan<RS_SCAN_THREADS, true>(counts, boff, coff, nb, chunk);
}

// 3. Entries into bucket order: each bucket holds the rows (within the
// pair) that walk its block this round.
__global__ void __launch_bounds__(RS_THREADS)
kd_radius_search_scatter(const int* __restrict__ eblk, const int* __restrict__ erank,
                         const int* __restrict__ boff, int* __restrict__ ent, int N, int nc,
                         int slots) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * RS_THREADS + threadIdx.x;
  if (n >= N) return;
  const size_t e0 = (static_cast<size_t>(b) * N + n) * slots;
  for (int e = 0; e < slots; ++e) {
    const int c = eblk[e0 + e];
    if (c < 0) break;
    ent[boff[b * nc + c] + erank[e0 + e]] = n;
  }
}

// 4. The walk: persistent CTAs, each taking chunks c = blockIdx.x,
// blockIdx.x + gridDim.x, ... of the round's coff[nb] chunks.
template <int D>
__global__ void __launch_bounds__(RS_THREADS)
kd_radius_search_walk(const float* __restrict__ q, const float* __restrict__ binit,
                      const float* __restrict__ bmin, const float* __restrict__ bmax,
                      const float* __restrict__ pages, const int* __restrict__ boff,
                      const int* __restrict__ coff, const int* __restrict__ ent,
                      unsigned long long* __restrict__ keys, int N, int nc, int cap_pad, int nb) {
  constexpr int Q = RsShape<D>::queries, chunk = RsShape<D>::chunk;
  static_assert(chunk <= Q * RS_THREADS, "one query group per thread at most");
  constexpr int H = D > 3 ? 3 : D;  // features summed before the colour skip
  extern __shared__ float4 tile4[];  // D x cap_pad f32: the block's first D page rows
  __shared__ alignas(8) unsigned long long bar;
  const int n_chunks = coff[nb];
  if (blockIdx.x >= n_chunks) return;  // uniform: the whole CTA leaves
  const uint32_t bar_a = icp_smem_addr(&bar);
  const uint32_t bytes = static_cast<uint32_t>(D) * cap_pad * sizeof(float);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n4 = cap_pad / 4;
  const float4* t4 = tile4;
  uint32_t phase = 0;
#pragma unroll 1
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x, phase ^= 1) {
    __syncthreads();  // the barrier is set up, or the previous block is no longer read
    int lo = 0, hi = nb;  // the bucket u with coff[u] <= c < coff[u + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (coff[mid] <= c) lo = mid; else hi = mid;
    }
    const int u = lo, b = u / nc, blk = u % nc;
    const int e_lo = boff[u] + (c - coff[u]) * chunk;
    const int n_e = min(boff[u + 1] - e_lo, chunk);
    if (threadIdx.x == 0) {
      const float* src = pages + (static_cast<size_t>(b) * nc + blk) * 8 * cap_pad;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar_a), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(icp_smem_addr(tile4)), "l"(src), "r"(bytes), "r"(bar_a) : "memory");
    }
    // Query groups: G <= RS_THREADS groups of Q entries (group g holds
    // entries g + i * G); P threads share a group's slots.
    const int G = (n_e + Q - 1) / Q;
    const int P = RS_THREADS / G;
    const int part = threadIdx.x / G, g = threadIdx.x % G;
    const int per = (n4 + P - 1) / P;
    const int s_lo = part < P ? min(n4, part * per) : n4, s_hi = min(n4, s_lo + per);
    float lo_b[D], hi_b[D];
    const size_t box = (static_cast<size_t>(b) * nc + blk) * D;
#pragma unroll
    for (int j = 0; j < D; ++j) lo_b[j] = __ldg(&bmin[box + j]), hi_b[j] = __ldg(&bmax[box + j]);
    float qv[Q][D], best[Q];
    int slot[Q], row[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int e = g + i * G;
      slot[i] = -1;
      best[i] = -1.0f;  // an empty entry: no distance is below it
      row[i] = 0;
#pragma unroll
      for (int j = 0; j < D; ++j) qv[i][j] = 0.0f;
      if (s_lo < s_hi && e < n_e) {
        row[i] = b * N + ent[e_lo + e];
#pragma unroll
        for (int j = 0; j < D; ++j) qv[i][j] = q[static_cast<size_t>(row[i]) * D + j];
        const float r = binit[row[i]];
        bool found;
        const float cur = key_best(__ldcg(&keys[row[i]]), r, &found);
        // Exact prune: lb > the running best holds no winner. A row found
        // at cur starts just above it, so an equal d2 at a lower index
        // still reaches the merge.
        if (!(box_lb<D>(qv[i], lo_b, hi_b) > cur))
          best[i] = found ? __uint_as_float(__float_as_uint(cur) + 1) : cur;
      }
    }
    {  // wait for the block
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar_a), "r"(phase) : "memory");
      }
    }
#ifdef RS_PROBE
    continue;
#endif
#pragma unroll 4
    for (int s4 = s_lo; s4 < s_hi; ++s4) {
      float4 t[D], dq[Q];
      bool live = false;
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
        // A partial sum only grows (every term >= 0, rounding is monotone).
        if (!live) continue;
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
          static_cast<unsigned long long>(blk * cap_pad + slot[i]);
      atomicMin(&keys[row[i]], key);
    }
  }
}

// 5. Keys into (d2, idx).
__global__ void __launch_bounds__(RS_THREADS)
kd_radius_search_out(const unsigned long long* __restrict__ keys, const float* __restrict__ binit,
                     float* __restrict__ d2, int32_t* __restrict__ idx, size_t rows) {
  const size_t r = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float rad = binit[r];
  const unsigned long long key = keys[r];
  const bool found = rad > 0.0f && key < start_key(rad);
  d2[r] = found ? __uint_as_float(static_cast<uint32_t>(key >> 32)) : rad;
  idx[r] = found ? static_cast<int32_t>(static_cast<uint32_t>(key)) : -1;
}

template <int D>
static cudaError_t launch(const float* q, const float* binit, const float* bmin,
                          const float* bmax, const float* pages, const int32_t* sel, float* d2,
                          int32_t* idx, void* ws, int B, int N, int nc, int cap_pad, int k,
                          cudaStream_t s) {
  constexpr int chunk = RsShape<D>::chunk;
  Workspace w;
  workspace_layout(static_cast<char*>(ws), B, N, nc, k, &w);
  const int nb = B * nc, slots = slots_for(k);
  cudaError_t err = cudaMemsetAsync(w.counts, 0, sizeof(int) * nb, s);
  if (err != cudaSuccess) return err;
  const size_t bin_smem = 2 * sizeof(int) * nc + (k == 0 ? 2 * sizeof(float) * D * nc : 0);
  const size_t walk_smem = static_cast<size_t>(D) * cap_pad * sizeof(float);
  int sms = 0, per_sm = 0;
  if ((err = icp_launch_fit(kd_radius_search_bin<D>, RS_THREADS, bin_smem, &sms, &per_sm)) !=
          cudaSuccess ||
      (err = icp_launch_fit(kd_radius_search_walk<D>, RS_THREADS, walk_smem, &sms, &per_sm)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long chunks_max = static_cast<long long>(B) * N * slots / chunk + nb;
  const unsigned walk_grid =
      static_cast<unsigned>(std::min<long long>(chunks_max, static_cast<long long>(sms) * per_sm));
  const dim3 row_grid((N + RS_THREADS - 1) / RS_THREADS, B);
  const int rounds = k > 0 ? (k == 1 ? 1 : 2) : 1 + (nc + RS_SPAN - 1) / RS_SPAN;
  for (int round = 0; round < rounds; ++round) {
    kd_radius_search_bin<D><<<row_grid, RS_THREADS, bin_smem, s>>>(
        q, binit, bmin, bmax, sel, w.keys, w.first, w.counts, w.eblk, w.erank, N, nc, k, round);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kd_radius_search_scan<<<1, RS_SCAN_THREADS, 0, s>>>(w.counts, w.boff, w.coff, nb, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kd_radius_search_scatter<<<row_grid, RS_THREADS, 0, s>>>(w.eblk, w.erank, w.boff, w.ent, N,
                                                              nc, slots);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kd_radius_search_walk<D><<<walk_grid, RS_THREADS, walk_smem, s>>>(
        q, binit, bmin, bmax, pages, w.boff, w.coff, w.ent, w.keys, N, nc, cap_pad, nb);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t rows = static_cast<size_t>(B) * N;
  kd_radius_search_out<<<static_cast<unsigned>((rows + RS_THREADS - 1) / RS_THREADS),
                         RS_THREADS, 0, s>>>(w.keys, binit, d2, idx, rows);
  return cudaGetLastError();
}

extern "C" int kd_radius_search_launch(const float* q, const float* binit, const float* bmin,
                                       const float* bmax, const float* pages, const int32_t* sel,
                                       float* d2, int32_t* idx, void* ws, long long ws_bytes,
                                       int B, int N, int nc, int cap_pad, int k, int D,
                                       void* stream) {
  if (k < 0 || k > ICP_MAX_K || (k > 0) != (sel != nullptr)) return cudaErrorInvalidValue;
  if (nc < 1 || nc > 1024 || cap_pad % 4 != 0 || cap_pad < 4) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  // A page index fits the key's low word as an int; entries are indexed by int.
  if (static_cast<long long>(nc) * cap_pad >= (1ll << 31) ||
      static_cast<long long>(B) * N * slots_for(k) >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(pages) % 16 != 0)
    return cudaErrorInvalidValue;
  Workspace w;
  if (static_cast<long long>(workspace_layout(nullptr, B, N, nc, k, &w)) > ws_bytes)
    return cudaErrorInvalidValue;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, binit, bmin, bmax, pages, sel, d2, idx,
                                         ws, B, N, nc, cap_pad, k,
                                         static_cast<cudaStream_t>(stream)));
}
