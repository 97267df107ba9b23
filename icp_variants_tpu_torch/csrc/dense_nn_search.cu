// dense_nn_search / pruned_nn_search: exact 1-NN by the expansion
// |q|^2 + |t|^2 - 2 q.t, over every target row (dense) or over the target
// tiles that a visit mask lets through, strictly below a bound (pruned).
//
// Replaces two TPU kernels of icp_variants_tpu/ops/knn.py:
//   _make_nn_kernel (launched by nn_search_pallas; entry knn.nn_search /
//   knn.match): dense_nn_search_launch; and
//   _make_pruned_kernel (launched by nn_search_pruned): pruned_nn_search_launch.
// Both walked (query tile, target tile) grid cells in order on one core,
// carrying the running (min, argmin) in VMEM from one target tile to the
// next, with the product q.t on the MXU at HIGHEST precision. Here the
// product is summed feature by feature on the FP32 units (no tensor cores,
// no TF32: a lower-precision product flips near-tie winners).
//
// Semantics (held against knn.nn_search_xla and knn.pruned_nn_search_plain):
//   d2(q, t) = (qn2 + tn2) - 2 * g,  g = ((q_0 t_0 + q_1 t_1) + q_2 t_2) ...
// over the D features of the query, every product and sum rounded on its own
// (-fmad=false and __fmul_rn / __fadd_rn), with qn2 and tn2 the rows' norm2
// summed the same way in column order (as knn.norm2 does; computed here as
// the queries are loaded and the targets packed). The last step is
// __fmaf_rn(-2, g, s): 2g is exact in f32 (a power-of-two scale; g stays
// below about 1.2e13 even at sentinel rows, far from overflow), so the
// fused -2g + s rounds once, exactly as the plain version's s - (2 * g)
// does. Among equal distances the lowest
// target row wins. The dense entry takes every row's least d2 (ties to the
// lowest row); the pruned entry keeps a target only if its d2 is strictly
// below `bound`, looks only at the target tiles whose visit entry (B,
// ceil(N / tile_q), n_tiles) is set for the row's query tile, and returns
// (-1, bound) where nothing is kept.
//
// What bounds it on the H100: f32 issue. The contract forbids contracting
// g, so each (query, target) pair costs D FMUL, D - 1 FADD, one FADD for
// qn2 + tn2, one FFMA for s - 2g and one FMNMX for the running minimum:
// 2D + 2 instructions at one a lane a clock, half the 67 TFLOP/s that counts
// an FMA as two operations. The design keeps everything else off that path:
//  - each thread holds NnShape::R queries in registers, so one broadcast
//    LDS.128 of a staged target record [t_0 .. t_{D-1}, tn2] (two at D = 6)
//    serves R pairs;
//  - no per-pair index: a thread keeps each query's running minimum with
//    fminf and, every NN_GROUP target rows, marks the group where that
//    minimum last fell strictly. At the end (dense) or at the end of a run
//    (pruned, below) it rescans that one group for the first row
//    whose recomputed d2 equals the minimum: the same operations give the
//    same bits, the strict mark keeps the earliest group among ties, and
//    the rescan the lowest row inside it;
//  - the records are staged in shared memory by cp.async.bulk on an
//    mbarrier, NN_STAGES chunks in flight, so the copy of the next chunks
//    overlaps the distances of this one (one __syncthreads a chunk).
//
// Layout. The targets are first packed (B, n_tiles, tile_pad) records of
// nn_words<D>() float4 each into the caller's workspace: tile_pad = tile_t
// rounded up to NN_GROUP, pad rows with tn2 = +inf (their d2 is +inf and
// never wins). The dense entry is one tile of M rows.
//  - dense_nn_search: 2 launches. pack, then walk: one CTA per (band of
//    NN_BAND query rows, pair) walks every target chunk in ascending order
//    and writes its rows' (d2, idx).
//  - pruned_nn_search: 4 launches. pack (also each row's merge key and the
//    item count), list: the (pair, query tile, band of the tile, target
//    tile) items whose cell is visited, compacted on the card with a warp
//    ballot and a CTA prefix (one global atomic a CTA, no host sync); walk:
//    persistent CTAs filling the card, each taking an even share of the
//    list in list order, so consecutive items of one band in ascending tile
//    order (a run) keep its queries and running minima in registers (the
//    list's CTAs land in any order, so a lower tile starts a new run: the
//    strict mark keeps the lowest row among ties only while rows ascend);
//    each run's rows merge into the 64-bit key (ordered d2 << 32) | target
//    row with atomicMin, only where the minimum lies strictly below the
//    bound, so ties across runs go to the lowest row in any order of the
//    atomics; out: keys to (d2, idx).
// The d2 of the expansion can be negative (cancellation), so the key's
// high word is the order-preserving map of the f32 bits (every bit flipped
// for a negative value, the sign bit set for a non-negative one; -0 folded
// to +0 first, though s - 2g with s >= 0 never gives -0). A row's key
// starts at (bound, 0xffffffff): it decodes to (bound, -1) unless a
// candidate strictly below the bound came in.
//
// Built with -DNN_RESCAN_COUNT (a measurement build, loaded by chip_smoke's
// phase 7 and the card contract test; never on a main path), the walk also
// counts its (query, group) steps, the group marks that moved, the run
// flushes with a mark, the rescans, the rescans that found no row (0 in a
// right run) and the runs that a lower tile of their band ended, read by
// nn_search_counts. Built for D = 3 and D = 6.
#include <algorithm>

#include "common.cuh"

#define NN_THREADS 64  // threads of pack and list
#define NN_GROUP 32    // target rows a mark covers: the rescan's length
#define NN_STAGES 2    // chunks of target records in flight in shared memory
#define NN_BAND 256    // query rows of a band: NnShape<D>::threads * R

namespace {

// The walk's shape by D: threads a CTA, R queries a thread, chunk target
// rows a stage (a multiple of NN_GROUP). Timed on the H100 against 32 x 8,
// 64 x 4 and 128 x 2 and chunks of 128-1,024 rows (PERF.md, Findings): at
// D = 3 the 128 x 2 CTA's extra warps hide more latency than its second
// LDS.128 a pair costs; at D = 6, two LDS.128 a record, 64 x 4 wins.
template <int D>
struct NnShape;
template <>
struct NnShape<3> {
  static constexpr int threads = 128, R = 2, chunk = 512;
};
template <>
struct NnShape<6> {
  static constexpr int threads = 64, R = 4, chunk = 512;
};
static_assert(NnShape<3>::threads * NnShape<3>::R == NN_BAND &&
                  NnShape<6>::threads * NnShape<6>::R == NN_BAND,
              "a band is NN_BAND rows at every D (ops/knn.py NN_BAND)");

template <int D>
__host__ __device__ constexpr int nn_words() {
  return (D + 4) / 4;  // float4 words of a packed record [t_0 .. t_{D-1}, tn2]
}

#ifdef NN_RESCAN_COUNT
// (query, group) steps, marks moved, run flushes with a mark, rescans,
// rescans that found no row, runs ended by a lower tile of their band.
__device__ unsigned long long nn_counts[6];
#define NN_COUNT(i, v) nn_tally[i] += (v)
#else
#define NN_COUNT(i, v)
#endif

// The order-preserving map of an f32 onto u32 (and back).
__device__ __forceinline__ uint32_t nn_ord(float f) {
  const uint32_t u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float nn_unord(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int D>
__device__ __forceinline__ void nn_unpack(const float4* __restrict__ p,
                                          float (&t)[4 * nn_words<D>()]) {
#pragma unroll
  for (int w = 0; w < nn_words<D>(); ++w) {
    const float4 v = p[w];
    t[4 * w] = v.x;
    t[4 * w + 1] = v.y;
    t[4 * w + 2] = v.z;
    t[4 * w + 3] = v.w;
  }
}

// sum_j x_j^2 in column order, every step rounded on its own (knn.norm2).
template <int D>
__device__ __forceinline__ float nn_norm2(const float (&x)[D]) {
  float n = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) n = __fadd_rn(n, __fmul_rn(x[j], x[j]));
  return n;
}

// d2 of one (query, record): (qs + tn2) - 2 g, every step rounded on its own.
template <int D>
__device__ __forceinline__ float nn_d2(const float (&qv)[D], float qs,
                                       const float (&t)[4 * nn_words<D>()]) {
  float g = __fmul_rn(qv[0], t[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) g = __fadd_rn(g, __fmul_rn(qv[j], t[j]));
  return __fmaf_rn(-2.0f, g, __fadd_rn(qs, t[D]));
}

// Each query's running minimum over the NN_GROUP records at `s` (shared
// memory; every thread reads the same record at once: a broadcast).
template <int D, int R>
__device__ __forceinline__ void nn_group(const float4* __restrict__ s, const float (&qv)[R][D],
                                         const float (&qs)[R], float (&best)[R]) {
  constexpr int W = nn_words<D>();
#pragma unroll 4
  for (int r = 0; r < NN_GROUP; r += 2) {
    float a[4 * W], c[4 * W];
    nn_unpack<D>(s + r * W, a);
    nn_unpack<D>(s + (r + 1) * W, c);
#pragma unroll
    for (int i = 0; i < R; ++i)
      best[i] = fminf(best[i], fminf(nn_d2<D>(qv[i], qs[i], a), nn_d2<D>(qv[i], qs[i], c)));
  }
}

struct NnArgs {
  const float* q;
  const float4* rec;  // (B, n_tiles, tile_pad) packed records
  float* d2;
  int32_t* idx;
  unsigned long long* keys;  // pruned: (B, N) merge keys
  const int* items;          // pruned: the listed items
  const int* count;          // pruned: their number
  float init;                // dense: +inf; pruned: the bound
  int N, M, n_tiles, tile_t, tile_pad, tile_q, nqt, nbq;
};

// One band of query rows [r0, r1) of pair b against target tile `tile`;
// `band` identifies the band.
struct NnItem {
  int band, b, r0, r1, tile;
};

template <bool DENSE>
__device__ __forceinline__ NnItem nn_item(const NnArgs& a, long long i) {
  NnItem it;
  if (DENSE) {
    it.b = blockIdx.y;
    it.r0 = blockIdx.x * NN_BAND;
    it.r1 = min(it.r0 + NN_BAND, a.N);
    it.tile = 0;
    it.band = 0;
    return it;
  }
  // item = ((b * nqt + qt) * nbq + j) * n_tiles + tile
  const int x = a.items[i];
  it.tile = x % a.n_tiles;
  it.band = x / a.n_tiles;
  const int j = it.band % a.nbq, cell = it.band / a.nbq;
  const int qt = cell % a.nqt;
  it.b = cell / a.nqt;
  it.r0 = qt * a.tile_q + j * NN_BAND;
  it.r1 = min(min(qt * a.tile_q + a.tile_q, it.r0 + NN_BAND), a.N);
  return it;
}

// The target row of packed record p of a pair, or -1 for a pad record.
__device__ __forceinline__ int nn_target_row(const NnArgs& a, int p) {
  const int tile = p / a.tile_pad, off = p % a.tile_pad;
  const int row = tile * a.tile_t + off;
  return off < a.tile_t && row < a.M ? row : -1;
}

// The first row of the NN_GROUP records from packed record `mark` whose d2
// equals `best`, or -1.
template <int D>
__device__ __forceinline__ int nn_rescan(const NnArgs& a, int b, int mark, const float (&qv)[D],
                                         float qs, float best) {
  constexpr int W = nn_words<D>();
  const int end = min(mark + NN_GROUP, a.n_tiles * a.tile_pad);
  const float4* p = a.rec + static_cast<size_t>(b) * a.n_tiles * a.tile_pad * W;
  for (int r = mark; r < end; ++r) {
    float t[4 * W];
    nn_unpack<D>(p + static_cast<size_t>(r) * W, t);
    if (nn_d2<D>(qv, qs, t) == best) {
      const int row = nn_target_row(a, r);
      if (row >= 0) return row;
    }
  }
  return -1;
}

__device__ __forceinline__ void nn_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The walk, shared by both entries. The CTA's chunk stream is its items in
// order, each cut into nck chunks of at most `chunk` records; chunk k goes
// to stage k % NN_STAGES.
template <int D, bool DENSE>
__device__ __forceinline__ void nn_walk(const NnArgs& a) {
  constexpr int T = NnShape<D>::threads, R = NnShape<D>::R, C = NnShape<D>::chunk;
  constexpr int W = nn_words<D>();
  extern __shared__ float4 s_rec[];  // NN_STAGES x C records
  __shared__ alignas(8) unsigned long long s_bar[NN_STAGES];

  long long i0 = 0, i1 = 1;
  if (!DENSE) {
    const long long cnt = *a.count;
    i0 = cnt * blockIdx.x / gridDim.x;
    i1 = cnt * (blockIdx.x + 1) / gridDim.x;
  }
  const int nck = (a.tile_pad + C - 1) / C;
  const long long K = (i1 - i0) * nck;

  auto issue = [&](long long k) {
    const NnItem it = nn_item<DENSE>(a, i0 + k / nck);
    const int c = static_cast<int>(k % nck);
    const int rows = min(C, a.tile_pad - c * C);
    const float4* src =
        a.rec + ((static_cast<size_t>(it.b) * a.n_tiles + it.tile) * a.tile_pad + c * C) * W;
    const int s = static_cast<int>(k % NN_STAGES);
    const uint32_t bar = icp_smem_addr(&s_bar[s]);
    const uint32_t bytes = static_cast<uint32_t>(rows) * W * 16;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(icp_smem_addr(s_rec + static_cast<size_t>(s) * C * W)),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NN_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(icp_smem_addr(&s_bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long k = 0; k < K && k < NN_STAGES; ++k) issue(k);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

#ifdef NN_RESCAN_COUNT
  unsigned long long nn_tally[6] = {0, 0, 0, 0, 0, 0};
#endif
  float qv[R][D], qs[R], best[R], last[R];
  int mark[R];
  NnItem cur{-1, 0, 0, 0, 0};
  // The run's rows into (d2, idx) (dense) or into their keys (pruned).
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int n = cur.r0 + threadIdx.x + i * T;
      if (n >= cur.r1) continue;
      const size_t row = static_cast<size_t>(cur.b) * a.N + n;
      if (DENSE) {
        a.d2[row] = best[i];
        a.idx[row] = nn_rescan<D>(a, cur.b, mark[i], qv[i], qs[i], best[i]);
        NN_COUNT(3, 1);
        NN_COUNT(4, a.idx[row] < 0 && best[i] < INFINITY);
        continue;
      }
      if (mark[i] < 0) continue;  // nothing strictly below the bound
      NN_COUNT(2, 1);
      const uint32_t hi = nn_ord(best[i]);
      // A key only falls, so a stale read can only keep a rescan that a
      // fresh one would skip.
      if (static_cast<uint32_t>(__ldcg(&a.keys[row]) >> 32) < hi) continue;
      NN_COUNT(3, 1);
      const int t = nn_rescan<D>(a, cur.b, mark[i], qv[i], qs[i], best[i]);
      NN_COUNT(4, t < 0);
      atomicMin(&a.keys[row], (static_cast<unsigned long long>(hi) << 32) |
                                  static_cast<uint32_t>(t));
    }
  };

  for (long long k = 0; k < K; ++k) {
    const NnItem it = nn_item<DENSE>(a, i0 + k / nck);
    const int c = static_cast<int>(k % nck);
    // A run: items of one band in ascending tile order (the list's CTAs
    // land in any order, and the strict mark keeps the lowest row among
    // ties only while rows ascend). A new band or a lower tile ends it.
    if (c == 0 && (it.band != cur.band || it.tile < cur.tile)) {
      NN_COUNT(5, threadIdx.x == 0 && it.band == cur.band);
      if (cur.band >= 0) flush();
      const bool load = it.band != cur.band;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int n = it.r0 + threadIdx.x + i * T;
        const bool live = n < it.r1;
        const size_t row = static_cast<size_t>(it.b) * a.N + n;
        if (load) {
#pragma unroll
          for (int j = 0; j < D; ++j) qv[i][j] = live ? a.q[row * D + j] : 0.0f;
          qs[i] = nn_norm2<D>(qv[i]);
        }
        best[i] = last[i] = a.init;
        mark[i] = DENSE ? 0 : -1;
      }
    }
    if (c == 0) cur = it;
    const int s = static_cast<int>(k % NN_STAGES);
    nn_wait(icp_smem_addr(&s_bar[s]), static_cast<uint32_t>((k / NN_STAGES) & 1));
    const int rows = min(C, a.tile_pad - c * C);
    const int p0 = it.tile * a.tile_pad + c * C;  // the chunk's first packed record
    const float4* chunk = s_rec + static_cast<size_t>(s) * C * W;
#pragma unroll 1
    for (int g = 0; g < rows; g += NN_GROUP) {
      nn_group<D, R>(chunk + g * W, qv, qs, best);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (best[i] < last[i]) {
          mark[i] = p0 + g;
          NN_COUNT(1, 1);
        }
        last[i] = best[i];
      }
      NN_COUNT(0, R);
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && k + NN_STAGES < K) issue(k + NN_STAGES);
  }
  if (cur.band >= 0) flush();
#ifdef NN_RESCAN_COUNT
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (nn_tally[i]) atomicAdd(&nn_counts[i], nn_tally[i]);
#endif
}

// Records of packed rows [0, total): row (b, tile, off) holds target row
// tile * tile_t + off of pair b and its norm2, or a pad record (features 0,
// tn2 +inf).
template <int D>
__device__ __forceinline__ void nn_pack(const float* __restrict__ t, float4* __restrict__ rec,
                                        long long total, int M, int t_stride, int n_tiles,
                                        int tile_t, int tile_pad) {
  constexpr int W = nn_words<D>();
  const long long per_pair = static_cast<long long>(n_tiles) * tile_pad;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < total;
       p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = p / per_pair;
    const int rem = static_cast<int>(p % per_pair);
    const int off = rem % tile_pad, row = rem / tile_pad * tile_t + off;
    float v[4 * W];
#pragma unroll
    for (int j = 0; j < 4 * W; ++j) v[j] = 0.0f;
    if (off < tile_t && row < M) {
      const size_t r = static_cast<size_t>(b) * M + row;
      float f[D];
#pragma unroll
      for (int j = 0; j < D; ++j) v[j] = f[j] = t[r * t_stride + j];
      v[D] = nn_norm2<D>(f);
    } else {
      v[D] = INFINITY;
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
      rec[p * W + w] = make_float4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
  }
}

// The workspace: packed records, then (pruned) the keys, the item count
// and the item list. ops/knn.py (_dense_search_workspace_bytes,
// _pruned_search_workspace_bytes) allocates the same sums.
struct NnWorkspace {
  float4* rec;
  unsigned long long* keys;
  int* count;
  int* items;
};

size_t nn_workspace(char* base, int D, int B, int N, int n_tiles, int tile_pad,
                    long long n_items, NnWorkspace* w) {
  NnWorkspace unused;
  if (w == nullptr) w = &unused;
  IcpCarve c{base};
  w->rec = c.take<float4>(static_cast<size_t>(B) * n_tiles * tile_pad * 16 * ((D + 4) / 4));
  if (n_items < 0) return c.off;  // the dense entry: records only
  w->keys = c.take<unsigned long long>(8 * static_cast<size_t>(B) * N);
  w->count = c.take<int>(4);
  w->items = c.take<int>(4 * static_cast<size_t>(n_items));
  return c.off;
}

}  // namespace

template <int D>
__global__ void __launch_bounds__(NN_THREADS)
dense_nn_search_pack(const float* __restrict__ t, float4* __restrict__ rec, long long total,
                     int M, int tile_pad) {
  nn_pack<D>(t, rec, total, M, D, 1, M, tile_pad);
}

template <int D>
__global__ void __launch_bounds__(NnShape<D>::threads, 8) dense_nn_search_walk(NnArgs a) {
  nn_walk<D, true>(a);
}

// The pack, and each row's key at (bound, 0xffffffff) and the item count at 0.
template <int D>
__global__ void __launch_bounds__(NN_THREADS)
pruned_nn_search_pack(const float* __restrict__ t, float4* __restrict__ rec, long long total,
                      int M, int t_stride, int n_tiles, int tile_t, int tile_pad,
                      unsigned long long* __restrict__ keys, long long rows, float bound,
                      int* __restrict__ count) {
  nn_pack<D>(t, rec, total, M, t_stride, n_tiles, tile_t, tile_pad);
  const unsigned long long init = (static_cast<unsigned long long>(nn_ord(bound)) << 32) |
                                  0xffffffffull;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < rows;
       r += static_cast<long long>(gridDim.x) * blockDim.x)
    keys[r] = init;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = 0;
}

// The visited items, item x = ((b * nqt + qt) * nbq + j) * n_tiles + tile
// for x < total: a warp ballot and a CTA prefix, one global atomic a CTA, so
// each CTA's items keep their order.
__global__ void __launch_bounds__(NN_THREADS)
pruned_nn_search_list(const uint8_t* __restrict__ visit, int* __restrict__ count,
                      int* __restrict__ items, int total, int n_tiles, int nbq) {
  constexpr int WARPS = NN_THREADS / 32;
  __shared__ int s_warp[WARPS];
  __shared__ int s_base;
  const int x = blockIdx.x * NN_THREADS + threadIdx.x;
  bool on = false;
  if (x < total) {
    const int tile = x % n_tiles, band = x / n_tiles;
    on = visit[static_cast<size_t>(band / nbq) * n_tiles + tile] != 0;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, on);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_warp[w];
      s_warp[w] = n;
      n += c;
    }
    s_base = n ? atomicAdd(count, n) : 0;
  }
  __syncthreads();
  if (on) items[s_base + s_warp[warp] + __popc(ballot & ((1u << lane) - 1))] = x;
}

template <int D>
__global__ void __launch_bounds__(NnShape<D>::threads, 8) pruned_nn_search_walk(NnArgs a) {
  nn_walk<D, false>(a);
}

// Keys into (d2, idx): (bound, -1) where no candidate came in.
__global__ void __launch_bounds__(256)
pruned_nn_search_out(const unsigned long long* __restrict__ keys, float bound,
                     float* __restrict__ d2, int32_t* __restrict__ idx, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const unsigned long long key = keys[r];
  const uint32_t low = static_cast<uint32_t>(key);
  d2[r] = low == 0xffffffffu ? bound : nn_unord(static_cast<uint32_t>(key >> 32));
  idx[r] = low == 0xffffffffu ? -1 : static_cast<int32_t>(low);
}

namespace {

// Blocks of NN_THREADS for a grid-stride pass over n entries.
unsigned nn_pass_grid(long long n) {
  return static_cast<unsigned>(std::min<long long>((n + NN_THREADS - 1) / NN_THREADS, 1 << 16) +
                               (n == 0));
}

template <int D>
size_t nn_stage_bytes() {
  return static_cast<size_t>(NN_STAGES) * NnShape<D>::chunk * nn_words<D>() * 16;
}

template <int D>
cudaError_t dense_launch(const float* q, const float* t, float* d2, int32_t* idx, void* ws,
                         int B, int N, int M, cudaStream_t s) {
  const int tile_pad = (M + NN_GROUP - 1) / NN_GROUP * NN_GROUP;
  NnWorkspace w;
  nn_workspace(static_cast<char*>(ws), D, B, N, 1, tile_pad, -1, &w);
  const long long total = static_cast<long long>(B) * tile_pad;
  dense_nn_search_pack<D><<<nn_pass_grid(total), NN_THREADS, 0, s>>>(t, w.rec, total, M,
                                                                     tile_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = nn_stage_bytes<D>();
  if ((err = icp_allow_smem(dense_nn_search_walk<D>, smem)) != cudaSuccess) return err;
  NnArgs a{q, w.rec, d2, idx, nullptr, nullptr, nullptr, INFINITY, N, M, 1, M, tile_pad,
           NN_BAND, 1, 1};
  dense_nn_search_walk<D>
      <<<dim3((N + NN_BAND - 1) / NN_BAND, B), NnShape<D>::threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t pruned_launch(const float* q, const float* t, const uint8_t* visit, float bound,
                          float* d2, int32_t* idx, void* ws, int B, int N, int M, int t_stride,
                          int tile_q, int tile_t, cudaStream_t s) {
  const int n_tiles = (M + tile_t - 1) / tile_t;
  const int tile_pad = (tile_t + NN_GROUP - 1) / NN_GROUP * NN_GROUP;
  const int nqt = (N + tile_q - 1) / tile_q, nbq = (tile_q + NN_BAND - 1) / NN_BAND;
  const long long n_items = static_cast<long long>(B) * nqt * nbq * n_tiles;
  NnWorkspace w;
  nn_workspace(static_cast<char*>(ws), D, B, N, n_tiles, tile_pad, n_items, &w);
  const long long total = static_cast<long long>(B) * n_tiles * tile_pad;
  const long long rows = static_cast<long long>(B) * N;
  pruned_nn_search_pack<D><<<nn_pass_grid(std::max(total, rows)), NN_THREADS, 0, s>>>(
      t, w.rec, total, M, t_stride, n_tiles, tile_t, tile_pad, w.keys, rows, bound,
      w.count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_items > 0) {
    pruned_nn_search_list<<<static_cast<unsigned>((n_items + NN_THREADS - 1) / NN_THREADS),
                            NN_THREADS, 0, s>>>(visit, w.count, w.items,
                                                static_cast<int>(n_items), n_tiles, nbq);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t smem = nn_stage_bytes<D>();
    int sms = 0, per_sm = 0;
    if ((err = icp_launch_fit(pruned_nn_search_walk<D>, NnShape<D>::threads, smem, &sms,
                              &per_sm)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long grid = std::min<long long>(n_items, static_cast<long long>(sms) * per_sm);
    NnArgs a{q, w.rec, d2, idx, w.keys, w.items, w.count, bound, N, M, n_tiles, tile_t,
             tile_pad, tile_q, nqt, nbq};
    pruned_nn_search_walk<D><<<static_cast<unsigned>(grid), NnShape<D>::threads, smem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  pruned_nn_search_out<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, s>>>(w.keys, bound,
                                                                                 d2, idx, rows);
  return cudaGetLastError();
}

}  // namespace

// q (B, N, D), t (B, M, D); d2 / idx (B, N); ws
// (ws_bytes) the packed records, B * ceil(M / NN_GROUP) * NN_GROUP * 16 *
// ceil((D + 1) / 4) bytes.
extern "C" int dense_nn_search_launch(const float* q, const float* t, float* d2, int32_t* idx,
                                      void* ws, long long ws_bytes, int B, int N, int M, int D,
                                      void* stream) {
  if (B < 0 || N < 0 || M < 0 || (D != 3 && D != 6)) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const int tile_pad = (M + NN_GROUP - 1) / NN_GROUP * NN_GROUP;
  if (M > (1 << 30) || reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      static_cast<long long>(nn_workspace(nullptr, D, B, N, 1, tile_pad, -1, nullptr)) >
          ws_bytes)
    return cudaErrorInvalidValue;
  return static_cast<int>(ICP_DISPATCH_D(D, dense_launch, q, t, d2, idx, ws, B, N, M,
                                         static_cast<cudaStream_t>(stream)));
}

// q (B, N, D), t (B, M, t_stride) with the features in its first D
// columns, visit (B, ceil(N / tile_q), ceil(M / tile_t)) bytes;
// d2 / idx (B, N), idx -1 and d2 = bound where nothing lies strictly below
// the bound; ws (ws_bytes) as nn_workspace lays it out. Refused: tile_q or
// tile_t < 1, t_stride < D, a packed row or an item id past an int, or a
// workspace smaller than the layout.
extern "C" int pruned_nn_search_launch(const float* q, const float* t, const uint8_t* visit,
                                       float bound, float* d2, int32_t* idx, void* ws,
                                       long long ws_bytes, int B, int N, int M, int t_stride,
                                       int tile_q, int tile_t, int D, void* stream) {
  if (tile_q < 1 || tile_t < 1 || t_stride < D || B < 0 || N < 0 || M < 0 ||
      (D != 3 && D != 6))
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const long long tile_pad = (tile_t + NN_GROUP - 1) / NN_GROUP * NN_GROUP;
  const long long n_tiles = (M + tile_t - 1) / tile_t;
  const long long nqt = (N + tile_q - 1) / tile_q, nbq = (tile_q + NN_BAND - 1) / NN_BAND;
  const long long n_items = B * nqt * nbq * n_tiles;
  if (n_tiles * tile_pad >= (1ll << 31) || n_items >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      static_cast<long long>(nn_workspace(nullptr, D, B, N, static_cast<int>(n_tiles),
                                          static_cast<int>(tile_pad), n_items, nullptr)) >
          ws_bytes)
    return cudaErrorInvalidValue;
  return static_cast<int>(ICP_DISPATCH_D(D, pruned_launch, q, t, visit, bound, d2, idx, ws, B,
                                         N, M, t_stride, tile_q, tile_t,
                                         static_cast<cudaStream_t>(stream)));
}

#ifdef NN_RESCAN_COUNT
// The measurement build's counts into `out` (the 6 values of nn_counts),
// then zeroed when `reset`; synchronous.
extern "C" int nn_search_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, nn_counts, sizeof(nn_counts));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(nn_counts, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
