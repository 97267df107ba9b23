// visited_ablate: the visited-list 1-NN of the JAX package's ablation
// microbenchmark, in seven modes that each drop or change one part of the
// work, so that timing them splits the search's cost by cause.
//
// Replaces the TPU kernel scripts/knn_ablate.py make_kernel (launched by
// its `search`). The modes' semantics are held against the plain version,
// icp_variants_tpu_torch/scripts/knn_ablate.py ablate_search_plain.
//
// Inputs: 256-row query tiles; q_aug (nqt * 256, 8) f32, the features with
// column 7 = -1; qn2 (nqt * 256) f32; pages (n_tiles, 8, tile_t) f32 whose
// row 7 holds 0.5 |t|^2; per query tile i its visit list vlist[i] (max_v
// int32 tile ids), the suffix minimum of their box lower bounds suffix[i]
// (max_v f32) and its chunk count counts[i]; a scalar bound.
//
// Per query tile: best = bound, idx = -1; chunk k covers list positions
// [k * chunk, (k + 1) * chunk) and is scored as one row of C = chunk *
// tile_t columns, column c = j * tile_t + slot standing for target row
// vlist[k * chunk + j] * tile_t + slot.
//   expansion modes (full, noprune, maxonly, default, high):
//     g = sum_f q_aug[f] * t[f] over the features f < D, then f = 7 (the
//     padding rows D..6 hold zeros and add nothing), rounded step by step;
//     the chunk's answer is qn2 - 2 max g at the first column reaching the
//     max;
//   direct: sum_j (t_j - q_j)^2 over the D features, first minimum;
//   a chunk's answer replaces the running best only if strictly smaller.
// Prune (every mode but noprune and dmaonly): before chunk k is scored,
// chunk k + 1 is staged only if suffix[(k + 1) * chunk] <= the largest
// running best of the tile's 256 rows (the best before chunk k, as the TPU
// kernel read it: this one-chunk lag lets chunk k + 1's staging overlap
// chunk k's scoring); the suffix never decreases and the best never grows,
// so a pruned chunk ends the walk.
//   full:    prune, argmax;           noprune: every chunk, argmax;
//   maxonly: full's distances, idx -1; dmaonly: every chunk staged, no
//            arithmetic, (bound, -1);
//   default: g by TF32 tensor-core products (mma.sync m16n8k8, operands
//            rounded by cvt.rna), f32 accumulation;
//   high:    split TF32, lo*hi + hi*lo + hi*hi, f32 accumulation;
//   direct:  direct differences, no tensor cores.
// The exact modes equal the plain version bit for bit (no FMA contraction:
// nvcc -fmad=false and __fmul_rn / __fadd_rn); default and high lie within
// the rounding bounds that knn_ablate.tf32_order_bound and
// tf32_error_bound state.
//
// Layout: one thread block cluster of ABL_CLUSTER (16) CTAs per query tile
// (cudaLaunchKernelEx with a cluster dimension, a size past the portable 8
// allowed by cudaFuncAttributeNonPortableClusterSizeAllowed; grid nqt *
// ABL_CLUSTER). Cluster c takes the query tile of rank c in descending
// order of chunk counts, so the longest walks are placed first (19 tiles
// need 2 waves of 14 resident clusters at phase 8's shapes). CTA rank r of
// the cluster owns the chunk columns [r w, r w + w) of every chunk, w =
// ceil(C / ABL_CLUSTER) rounded up to 4 (a slice may be short, empty or
// span tiles), and stages only that slice, R rows of it (D + 1, or D for
// direct), by cp.async.bulk on an mbarrier, two stages deep (lane 0 of
// warp w copies rows w, w + warps, ...). Its ABL_GROUPS (2) groups of 128
// threads split the slice again; each group scores all 256 rows of the
// tile against its columns:
//   scalar modes: 2 rows a thread, one broadcast LDS.128 of each staged row
//     serving 4 columns x 2 rows; a running max (min for direct) a row, and
//     every ABL_MARK columns a mark where it last rose strictly, so at the
//     end one rescan of ABL_MARK columns finds the first column reaching it
//     (the same operations give the same bits);
//   default / high: 64 rows a warp (four m16 tiles), mma.sync m16n8k8 per
//     8 columns, then compare and select per accumulator element; each
//     lane's B offsets are fixed before the loop and every B load is
//     unconditional (an unstaged feature reads row 0 and is replaced by
//     0). wgmma is not used: for TF32 it takes only K-major operands from
//     shared memory, and the pages are feature-major, so it would need a
//     transposing stage for a product that is not what bounds these modes.
// Per chunk, the groups' partials (value and column, a row) merge in the
// CTA's shared memory, and the CTA pushes each row's partial to every CTA
// of the cluster through distributed shared memory: st.async into the
// peer's receive buffer (by chunk parity and sending rank), completing
// bytes on the peer's receive mbarrier. Each CTA waits on its own barrier
// for all ABL_CLUSTER partials of the chunk and reduces them the same way,
// so all hold the tile's same running best and reach the same prune
// decision. No cluster barrier a chunk: barrier.cluster's release and
// acquire compile to a GPU-scope MEMBAR and an L1 invalidate. A peer pushes
// chunk k + 2 into a buffer only after this CTA's chunk k + 1 partial came,
// which this CTA sends after merging chunk k, so the parity buffers need no
// other guard. Cluster barriers only at the start (the receive barriers
// are initialised before any push) and at the end (no CTA leaves while a
// peer may still touch its shared memory). Rank 0 writes the tile's (d2,
// idx).
//
// The merge rule. Two different g can round to one d2, so the slices merge
// on the value that the chunk's winner is chosen by, never on d2:
//   full, default, high: (g larger, column smaller), then d2 = qn2 - 2 g;
//   direct: (d2 smaller, column smaller); maxonly: g larger alone;
//   noprune has no per-chunk exchange: each thread keeps a row's best chunk
//     of its own columns, (d2, chunk, g, column), replaced only by a
//     strictly smaller d2, and the slices merge once at the end (a cluster
//     barrier and ld.shared::cluster reads) on (d2 smaller, chunk smaller,
//     g larger, column smaller), which picks the plain version's chunk,
//     then its argmax;
//   dmaonly merges nothing.
//
// What bounds it on the H100: instruction issue on the CUDA cores, along
// the longest walk. Per (row, column) the scalar modes take D + 1 FMUL, D
// FADD and one FMNMX (2D + 2: full, noprune, maxonly) or D FADD, D FMUL,
// D - 1 FADD and one FMNMX (3D: direct); the TF32 modes' products are cheap
// and each accumulator element takes a compare and two selects (3). The
// tile with the longest walk (89 of phase 8's 615 chunks in full mode)
// sets a chain floor that no split goes below: its chunks x one chunk's
// issue on ABL_CLUSTER SMs, 0.18 ms for full; it shares its SMs with other
// tiles' CTAs, and each chunk waits for the slowest of its 16 CTAs and for
// the exchange.
//
// Measurement builds (loaded by chip_smoke's phase 8 and the card contract
// test; never on a main path): -DABL_COUNT writes the chunks each CTA
// scored (staged, for dmaonly) into abl_chunks[tile * ABL_CLUSTER + rank],
// read by visited_ablate_counts.
#include <climits>

#include "common.cuh"

#define ABL_CLUSTER 16                // CTAs of a cluster: one query tile's
#define ABL_GROUPS 2                  // column groups of 128 threads in a CTA
#define ABL_TQ 256                    // query rows of a tile
#define ABL_GT 128                    // threads of a column group
#define ABL_T (ABL_GT * ABL_GROUPS)   // threads of a CTA: one a row for the merge
#define ABL_Q (ABL_TQ / ABL_GT)       // rows a thread scores (scalar modes)
#define ABL_MARK 16                   // columns a mark covers: the rescan's length
#define ABL_SMEM_MAX (227 * 1024)
#define ABL_COUNT_MAX (1 << 16)       // CTAs the counting build records
#define ABL_ORDER_MAX 512             // query tiles ordered by their walks' length

static_assert(ABL_CLUSTER >= 1 && ABL_CLUSTER <= 16, "a cluster holds 1 to 16 CTAs");
static_assert(ABL_T == ABL_TQ, "a thread merges and writes one row of the tile");
static_assert(ABL_Q == 2 && ABL_GT == 4 * 32, "a group: 4 warps of 64 rows, 2 rows a thread");

enum AblateMode { FULL = 0, NOPRUNE, MAXONLY, DMAONLY, DEFAULT_TF32, HIGH_TF32, DIRECT };

#ifdef ABL_COUNT
__device__ int abl_chunks[ABL_COUNT_MAX];
#endif

namespace {

// The slice geometry (scripts/knn_ablate.py cluster_slices mirrors it):
// slice width, a group's width within it, and the staged row pitch in
// floats (= 8 mod 32, so a B fragment's four feature rows fall in distinct
// banks; a multiple of 4, so every staged row is 16-byte aligned).
__host__ __device__ constexpr int abl_round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int abl_slice_width(int cols) {
  return abl_round4((cols + ABL_CLUSTER - 1) / ABL_CLUSTER);
}
__host__ __device__ constexpr int abl_group_width(int w) {
  return abl_round4((w + ABL_GROUPS - 1) / ABL_GROUPS);
}
__host__ __device__ constexpr int abl_pitch(int w) { return (w + 31) / 32 * 32 + 8; }

template <int D, int MODE>
__host__ __device__ constexpr int abl_rows() {
  return MODE == DIRECT ? D : D + 1;
}

// Modes that prune, and so merge the cluster's partials after every chunk.
__host__ __device__ constexpr bool abl_prunes(int mode) {
  return mode != NOPRUNE && mode != DMAONLY;
}

// Dynamic shared memory: the receive buffer (prune modes), two stages of R
// rows of the slice, then the tile's visit list and suffix (max_v entries
// each).
size_t abl_smem_bytes(int R, bool prune, int cols, int max_v) {
  return (prune ? static_cast<size_t>(2) * ABL_CLUSTER * ABL_TQ * 8 : 0) +
         static_cast<size_t>(2) * R * abl_pitch(abl_slice_width(cols)) * sizeof(float) +
         static_cast<size_t>(max_v) * (sizeof(int32_t) + sizeof(float));
}

__device__ __forceinline__ unsigned abl_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: writes before it are seen by
// reads after it, in shared memory of any CTA of the cluster.
__device__ __forceinline__ void abl_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t abl_mapa(uint32_t addr, unsigned rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 abl_ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void abl_wait(uint32_t bar, uint32_t parity) {
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

// f32 -> TF32 (round to nearest, ties away from zero), as a .b32 whose
// low 13 bits are cleared (the conversion leaves them unspecified), so that
// it also reads as the f32 value the tensor core multiplies.
__device__ __forceinline__ uint32_t abl_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// D = A (16 x 8, row) * B (8 x 8, col) + C in TF32 with f32 accumulation.
__device__ __forceinline__ void abl_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Staged row of feature f: f < D -> f, f = 7 -> D, else none (-1).
template <int D>
__device__ __forceinline__ int abl_row_of(int f) {
  return f < D ? f : (f == 7 ? D : -1);
}

// True where a value `a` beats `b`: larger g, or (direct) smaller d2.
template <int MODE>
__device__ __forceinline__ bool abl_better(float a, float b) {
  return MODE == DIRECT ? a < b : a > b;
}

// A slice partial (value, column) beats the running one: the better value,
// then the smaller column (maxonly: its column is never read).
template <int MODE>
__device__ __forceinline__ bool abl_wins(float g, int p, float bg, int bp) {
  return abl_better<MODE>(g, bg) || (g == bg && p < bp);
}

// Stage chunk k's slice [lo, hi), R rows of it, into `dst` (a stage of R
// rows of `pitch` floats), completing on the barrier `bar`: thread 0 arms
// the barrier and lane 0 of warp w copies the rows w, w + warps, ... (so
// no warp issues more than its share; a copy may land before the barrier
// is armed, its bytes then counted against the expected ones).
template <int D, int R>
__device__ __forceinline__ void abl_issue(float* dst, uint32_t bar, const float* __restrict__ pages,
                                          const int32_t* __restrict__ vrow, int k, int chunk,
                                          int tile_t, int lo, int hi, int pitch) {
  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(R) * (hi - lo) * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
  }
  if (threadIdx.x % 32 != 0) return;
  for (int r = threadIdx.x / 32; r < R; r += ABL_T / 32) {
    for (int c = lo; c < hi;) {
      const int j = c / tile_t, slot = c % tile_t;
      const int n = min(hi - c, tile_t - slot);
      const size_t tile = static_cast<size_t>(vrow[k * chunk + j]);
      const float* src = pages + (tile * 8 + (r < D ? r : 7)) * tile_t + slot;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(icp_smem_addr(dst + r * pitch + (c - lo))),
          "l"(src), "r"(static_cast<uint32_t>(n * sizeof(float))), "r"(bar)
          : "memory");
      c += n;
    }
  }
}

// g (expansion) or d2 (direct) of one query against one staged column,
// every step rounded on its own in the plain version's order.
template <int MODE, int R>
__device__ __forceinline__ float abl_val(const float (&q)[R], const float (&t)[R]) {
  if constexpr (MODE == DIRECT) {
    float d = icp_diff2(t[0], q[0]);
#pragma unroll
    for (int j = 1; j < R; ++j) d = __fadd_rn(d, icp_diff2(t[j], q[j]));
    return d;
  } else {
    float g = __fmul_rn(q[0], t[0]);
#pragma unroll
    for (int j = 1; j < R; ++j) g = __fadd_rn(g, __fmul_rn(q[j], t[j]));
    return g;
  }
}

// The R staged rows of 4 columns at float offset `off` (broadcast when all
// lanes read one offset).
template <int R>
__device__ __forceinline__ void abl_load4(const float* s, int pitch, int off, float (&t)[4][R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(s + r * pitch + off);
    t[0][r] = v.x;
    t[1][r] = v.y;
    t[2][r] = v.z;
    t[3][r] = v.w;
  }
}

// The thread's rows' running max (min for direct) over 4 columns.
template <int MODE, int R>
__device__ __forceinline__ void abl_columns(const float* s, int pitch, int off,
                                            const float (&q)[ABL_Q][R], float (&m)[ABL_Q]) {
  float t[4][R];
  abl_load4<R>(s, pitch, off, t);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int i = 0; i < ABL_Q; ++i) {
      const float v = abl_val<MODE, R>(q[i], t[e]);
      m[i] = MODE == DIRECT ? fminf(m[i], v) : fmaxf(m[i], v);
    }
  }
}

// The first column of [from, to) whose value equals m (chunk columns; the
// stage holds the slice from column lo).
template <int MODE, int R>
__device__ __forceinline__ int abl_rescan(const float* s, int pitch, int lo, int from, int to,
                                          const float (&q)[R], float m) {
#pragma unroll 1
  for (int c = from; c < to; c += 4) {
    float t[4][R];
    abl_load4<R>(s, pitch, c - lo, t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (abl_val<MODE, R>(q, t[e]) == m) return c + e;
  }
  return INT_MAX;  // not reached while m came from these columns
}

// Scalar modes: the thread's ABL_Q rows against the group's columns [glo,
// ghi): each row's best value m and its first column p (INT_MAX when the
// group has no column).
template <int MODE, int R>
__device__ __forceinline__ void abl_score_scalar(const float* s, int pitch, int lo, int glo,
                                                 int ghi, const float (&q)[ABL_Q][R],
                                                 float (&m)[ABL_Q], int (&p)[ABL_Q]) {
  const float WORST = MODE == DIRECT ? INFINITY : -INFINITY;
  float last[ABL_Q];
  int mark[ABL_Q];
#pragma unroll
  for (int i = 0; i < ABL_Q; ++i) {
    m[i] = last[i] = WORST;
    mark[i] = glo;
    p[i] = INT_MAX;
  }
#pragma unroll 1
  for (int c = glo; c < ghi; c += ABL_MARK) {
    if (c + ABL_MARK <= ghi) {
#pragma unroll
      for (int u = 0; u < ABL_MARK; u += 4) abl_columns<MODE, R>(s, pitch, c - lo + u, q, m);
    } else {
#pragma unroll 1
      for (int u = c; u < ghi; u += 4) abl_columns<MODE, R>(s, pitch, u - lo, q, m);
    }
    if constexpr (MODE != MAXONLY) {
#pragma unroll
      for (int i = 0; i < ABL_Q; ++i) {
        if (abl_better<MODE>(m[i], last[i])) mark[i] = c;
        last[i] = m[i];
      }
    }
  }
  if constexpr (MODE != MAXONLY) {
    if (glo < ghi) {
#pragma unroll
      for (int i = 0; i < ABL_Q; ++i)
        p[i] = abl_rescan<MODE, R>(s, pitch, lo, mark[i], min(mark[i] + ABL_MARK, ghi), q[i],
                                   m[i]);
    }
  }
}

// A lane's part of a B fragment (mma.sync m16n8k8): the staged rows of its
// features tq and tq + 4 (row 0 where the feature is not staged, its value
// then replaced by 0, so that every load is unconditional) at column grp,
// and the accumulator columns 2 tq, 2 tq + 1 it holds.
struct AblLane {
  int o0, o1;    // float offsets of the lane's two B elements from the stage
  bool k0, k1;   // the feature is staged
  int grp, c2;   // B column, first accumulator column (2 tq)
};

template <int D>
__device__ __forceinline__ AblLane abl_lane(int pitch, int lo) {
  const int lane = threadIdx.x % 32, grp = lane >> 2, tq = lane & 3;
  const int r0 = abl_row_of<D>(tq), r1 = abl_row_of<D>(tq + 4);
  return AblLane{max(r0, 0) * pitch + grp - lo, max(r1, 0) * pitch + grp - lo,
                 r0 >= 0, r1 >= 0, grp, 2 * tq};
}

// Tensor-core modes: one step of 8 columns from n0 for the warp's four m16
// tiles; with MASK the columns from ghi on are left out (their loads stay
// inside the stage's padded row).
template <int MODE, bool MASK>
__device__ __forceinline__ void abl_mma_step(const float* s, const AblLane& l, int n0, int ghi,
                                             const uint32_t (&a_hi)[4][4],
                                             const uint32_t (&a_lo)[4][4], float (&gm)[4][2],
                                             int (&gp)[4][2]) {
  const bool in = !MASK || n0 + l.grp < ghi;
  const float x0 = s[l.o0 + n0], x1 = s[l.o1 + n0];
  const float bv0 = in && l.k0 ? x0 : 0.0f;
  const float bv1 = in && l.k1 ? x1 : 0.0f;
  const uint32_t b0 = abl_tf32(bv0), b1 = abl_tf32(bv1);
  uint32_t t0 = 0, t1 = 0;
  if constexpr (MODE == HIGH_TF32) {
    t0 = abl_tf32(__fsub_rn(bv0, __uint_as_float(b0)));
    t1 = abl_tf32(__fsub_rn(bv1, __uint_as_float(b1)));
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (MODE == HIGH_TF32) {
      abl_mma(acc, a_lo[mt], b0, b1);
      abl_mma(acc, a_hi[mt], t0, t1);
    }
    abl_mma(acc, a_hi[mt], b0, b1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = acc[2 * h + e];
        const int c = n0 + l.c2 + e;
        if ((!MASK || c < ghi) && v > gm[mt][h]) {
          gm[mt][h] = v;
          gp[mt][h] = c;
        }
      }
    }
  }
}

struct AblArgs {
  const float* q_aug;
  const float* qn2;
  const float* pages;
  const int32_t* vlist;
  const float* suffix;
  const int32_t* counts;
  float bound;
  float* d2;
  int32_t* idx;
  int nqt, max_v, tile_t, chunk;
};

}  // namespace

// Push a row's partial (g, column bits) for a chunk to every CTA of the
// cluster: `peer` holds each CTA's receive buffer and receive barriers in
// the cluster's shared window, `off` is the row's place in the buffer (the
// same in every CTA) and `st` the chunk's parity; st.async stores into each
// buffer and completes 8 bytes on that CTA's barrier.
__device__ __forceinline__ void abl_push(const uint32_t (*peer)[ABL_CLUSTER], uint32_t off, int st,
                                         float g, int p) {
#pragma unroll
  for (int r = 0; r < ABL_CLUSTER; ++r)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
            peer[0][r] + off),
        "f"(g), "f"(__int_as_float(p)), "r"(peer[1][r] + 8 * st)
        : "memory");
}

template <int D, int MODE>
__global__ void __launch_bounds__(ABL_T) visited_ablate_kernel(AblArgs a) {
  constexpr int R = abl_rows<D, MODE>();
  constexpr bool PRUNE = abl_prunes(MODE);
  constexpr bool TENSOR = MODE == DEFAULT_TF32 || MODE == HIGH_TF32;
  constexpr bool SCALAR = !TENSOR && MODE != DMAONLY;
  // Dynamic shared memory: the receive buffer (prune modes: by chunk parity
  // and sending rank, a (value, column bits) a row), two stages of R rows of
  // the slice, the tile's visit list and suffix.
  extern __shared__ float4 abl_smem4[];
  float2* recv = reinterpret_cast<float2*>(abl_smem4);
  float* buf = reinterpret_cast<float*>(recv + (PRUNE ? 2 * ABL_CLUSTER * ABL_TQ : 0));
  // The groups' partials of a chunk, merged in the CTA before the push.
  __shared__ alignas(16) float2 s_loc[PRUNE ? ABL_GROUPS : 1][PRUNE ? ABL_TQ : 1];
  // noprune: each group's best chunk a row, (d2, chunk, g, column bits).
  __shared__ alignas(16) float4 s_end[MODE == NOPRUNE ? ABL_GROUPS : 1][MODE == NOPRUNE ? ABL_TQ : 1];
  __shared__ float s_red[ABL_T / 32];
  __shared__ alignas(8) unsigned long long s_bar[4];  // stages 0, 1; receive 0, 1
  __shared__ uint32_t s_peer[2][ABL_CLUSTER];         // each CTA's recv and rbar0

  const int tid = threadIdx.x, gt = tid % ABL_GT, h = tid / ABL_GT;
  const unsigned rank = abl_rank();
  // Cluster c takes the query tile of rank c in descending order of chunk
  // counts (ties by tile), so the longest walks are placed first; past
  // ABL_ORDER_MAX tiles, tile c.
  __shared__ int s_tile;
  if (a.nqt <= ABL_ORDER_MAX) {
    const int c = blockIdx.x / ABL_CLUSTER;
    for (int t = tid; t < a.nqt; t += ABL_T) {
      const int n = a.counts[t];
      int r = 0;
      for (int u = 0; u < a.nqt; ++u) {
        const int m = a.counts[u];
        r += m > n || (m == n && u < t);
      }
      if (r == c) s_tile = t;
    }
  } else if (tid == 0) {
    s_tile = blockIdx.x / ABL_CLUSTER;
  }
  __syncthreads();
  const int i = s_tile;
  const int row0 = i * ABL_TQ;
  const int C = a.chunk * a.tile_t;
  const int w = abl_slice_width(C), pitch = abl_pitch(w);
  const int lo = min(C, static_cast<int>(rank) * w), hi = min(C, lo + w);
  const int gw = abl_group_width(w);
  const int glo = min(hi, lo + h * gw), ghi = min(hi, glo + gw);
  const int n_chunks = a.counts[i];
  // The tile's list and suffix, the entries its chunks read, in shared
  // memory (the TPU kernel's scalar-memory copies).
  int32_t* vrow = reinterpret_cast<int32_t*>(buf + 2 * R * pitch);
  float* srow = reinterpret_cast<float*>(vrow + a.max_v);
  for (int e = tid; e < n_chunks * a.chunk; e += ABL_T) {
    vrow[e] = a.vlist[static_cast<size_t>(i) * a.max_v + e];
    srow[e] = a.suffix[static_cast<size_t>(i) * a.max_v + e];
  }
  const uint32_t bar0 = icp_smem_addr(&s_bar[0]), rbar0 = bar0 + 16;
  if (tid < ABL_CLUSTER) {
    s_peer[0][tid] = abl_mapa(icp_smem_addr(recv), tid);
    s_peer[1][tid] = abl_mapa(rbar0, tid);
  }

  // Row tid, which this thread merges and writes.
  float best = a.bound;
  int bidx = -1;
  const float mqn2 = a.qn2[row0 + tid];
  if (tid % 32 == 0) s_red[tid / 32] = a.bound;

  // Scalar modes: this thread's rows gt + 128 u and their features.
  float q[ABL_Q][R];
  float sqn2[ABL_Q];
  if constexpr (SCALAR) {
#pragma unroll
    for (int u = 0; u < ABL_Q; ++u) {
      const size_t qrow = static_cast<size_t>(row0 + gt + u * ABL_GT) * 8;
#pragma unroll
      for (int r = 0; r < R; ++r) q[u][r] = a.q_aug[qrow + (r < D ? r : 7)];
      sqn2[u] = a.qn2[row0 + gt + u * ABL_GT];
    }
  }
  // noprune: each scored row's best chunk of this group's columns so far.
  float rd[ABL_Q], rg[ABL_Q];
  int rk[ABL_Q], rp[ABL_Q];
#pragma unroll
  for (int u = 0; u < ABL_Q; ++u) {
    rd[u] = a.bound;
    rg[u] = 0.0f;
    rk[u] = INT_MAX;
    rp[u] = INT_MAX;
  }
  // Tensor-core modes: the A fragments of the warp's four m16 tiles (rows
  // wrow .. wrow + 63 of the tile) and the lane's B offsets.
  uint32_t a_hi[4][4] = {}, a_lo[4][4] = {};
  const int wrow = (gt / 32) * 64;
  const AblLane lane = abl_lane<D>(pitch, lo);
  if constexpr (TENSOR) {
    const int tq = tid & 3, grp = (tid % 32) >> 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wrow + mt * 16 + grp + (e & 1) * 8;
        const int f = tq + (e >> 1) * 4;
        const float x = a.q_aug[static_cast<size_t>(r) * 8 + f];
        a_hi[mt][e] = abl_tf32(x);
        a_lo[mt][e] = abl_tf32(__fsub_rn(x, __uint_as_float(a_hi[mt][e])));
      }
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers, the list and s_red are ready
  // Every CTA's receive barriers are initialised before any peer pushes.
  if (PRUNE && n_chunks > 0) abl_cluster_sync();
  if (n_chunks > 0) abl_issue<D, R>(buf, bar0, a.pages, vrow, 0, a.chunk, a.tile_t, lo, hi, pitch);

  int done = 0;  // chunks scored (staged, for dmaonly)
  for (int k = 0; k < n_chunks; ++k) {
    // s_red, a free stage for chunk k + 1 (every thread is done with chunk
    // k - 1's) and a free receive buffer for chunk k + 1 (every thread is
    // done merging chunk k - 1) hold past this point.
    __syncthreads();
    bool next = k + 1 < n_chunks;
    if constexpr (PRUNE) {
      float wb = s_red[0];
#pragma unroll
      for (int u = 1; u < ABL_T / 32; ++u) wb = fmaxf(wb, s_red[u]);
      next = next && srow[(k + 1) * a.chunk] <= wb;
    }
    const int st = k & 1;
    if (next)
      abl_issue<D, R>(buf + (st ^ 1) * R * pitch, bar0 + 8 * (st ^ 1), a.pages, vrow, k + 1,
                      a.chunk, a.tile_t, lo, hi, pitch);
    if (PRUNE && tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(rbar0 + 8 * st),
                   "r"(ABL_CLUSTER * ABL_TQ * static_cast<uint32_t>(sizeof(float2)))
                   : "memory");
    abl_wait(bar0 + 8 * st, static_cast<uint32_t>((k >> 1) & 1));
    const float* cur = buf + st * R * pitch;
    done = k + 1;

    if constexpr (SCALAR) {
      float m[ABL_Q];
      int p[ABL_Q];
      abl_score_scalar<MODE, R>(cur, pitch, lo, glo, ghi, q, m, p);
#pragma unroll
      for (int u = 0; u < ABL_Q; ++u) {
        if constexpr (MODE == NOPRUNE) {
          const float d = __fsub_rn(sqn2[u], __fmul_rn(2.0f, m[u]));
          if (d < rd[u]) {
            rd[u] = d;
            rk[u] = k;
            rg[u] = m[u];
            rp[u] = p[u];
          }
        } else {
          s_loc[h][gt + u * ABL_GT] = make_float2(m[u], __int_as_float(p[u]));
        }
      }
    } else if constexpr (TENSOR) {
      float gm[4][2];
      int gp[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        gm[mt][0] = gm[mt][1] = -INFINITY;
        gp[mt][0] = gp[mt][1] = INT_MAX;
      }
      int n0 = glo;
#pragma unroll 2
      for (; n0 + 8 <= ghi; n0 += 8)
        abl_mma_step<MODE, false>(cur, lane, n0, ghi, a_hi, a_lo, gm, gp);
      if (n0 < ghi) abl_mma_step<MODE, true>(cur, lane, n0, ghi, a_hi, a_lo, gm, gp);
      // The first column reaching the max across the four lanes of a row.
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const float og = __shfl_xor_sync(0xffffffffu, gm[mt][hh], off);
            const int op = __shfl_xor_sync(0xffffffffu, gp[mt][hh], off);
            if (abl_wins<MODE>(og, op, gm[mt][hh], gp[mt][hh])) {
              gm[mt][hh] = og;
              gp[mt][hh] = op;
            }
          }
          if (lane.c2 == 0)
            s_loc[h][wrow + mt * 16 + hh * 8 + lane.grp] =
                make_float2(gm[mt][hh], __int_as_float(gp[mt][hh]));
        }
      }
    }

    if constexpr (PRUNE) {
      // The groups' partials of row tid into one, pushed to the cluster.
      __syncthreads();
      float bg = s_loc[0][tid].x;
      int bp = __float_as_int(s_loc[0][tid].y);
#pragma unroll
      for (int g = 1; g < ABL_GROUPS; ++g) {
        const float2 v = s_loc[g][tid];
        if (abl_wins<MODE>(v.x, __float_as_int(v.y), bg, bp)) {
          bg = v.x;
          bp = __float_as_int(v.y);
        }
      }
      // Row tid's place in every CTA's receive buffer of chunk k.
      abl_push(s_peer, ((st * ABL_CLUSTER + rank) * ABL_TQ + tid) * sizeof(float2), st, bg, bp);
      // Every CTA's partials of chunk k into the running best.
      abl_wait(rbar0 + 8 * st, static_cast<uint32_t>((k >> 1) & 1));
      const float2* part = recv + st * ABL_CLUSTER * ABL_TQ;
      bg = MODE == DIRECT ? INFINITY : -INFINITY;
      bp = INT_MAX;
#pragma unroll
      for (int r = 0; r < ABL_CLUSTER; ++r) {
        const float2 v = part[r * ABL_TQ + tid];
        if (abl_wins<MODE>(v.x, __float_as_int(v.y), bg, bp)) {
          bg = v.x;
          bp = __float_as_int(v.y);
        }
      }
      const float lmin = MODE == DIRECT ? bg : __fsub_rn(mqn2, __fmul_rn(2.0f, bg));
      if (lmin < best) {
        best = lmin;
        if constexpr (MODE != MAXONLY)
          bidx = vrow[k * a.chunk + bp / a.tile_t] * a.tile_t + bp % a.tile_t;
      }
      float wmax = best;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
      if (tid % 32 == 0) s_red[tid / 32] = wmax;
    }
    if (!next) break;
  }

  if constexpr (MODE == NOPRUNE) {
    if (n_chunks > 0) {
      // The slices' best chunks, merged once on (d2, chunk, -g, column).
#pragma unroll
      for (int u = 0; u < ABL_Q; ++u)
        s_end[h][gt + u * ABL_GT] =
            make_float4(rd[u], __int_as_float(rk[u]), rg[u], __int_as_float(rp[u]));
      abl_cluster_sync();
      if (rank == 0) {
        const uint32_t end0 = icp_smem_addr(&s_end[0][0]);
        float bd = a.bound, bg = 0.0f;
        int bk = INT_MAX, bp = INT_MAX;
#pragma unroll
        for (int r = 0; r < ABL_CLUSTER; ++r) {
          const uint32_t base = abl_mapa(end0, r);
#pragma unroll
          for (int g = 0; g < ABL_GROUPS; ++g) {
            const float4 v = abl_ld_cluster4(base + (g * ABL_TQ + tid) * sizeof(float4));
            const int vk = __float_as_int(v.y), vp = __float_as_int(v.w);
            if (v.x < bd ||
                (v.x == bd && (vk < bk || (vk == bk && (v.z > bg || (v.z == bg && vp < bp)))))) {
              bd = v.x;
              bk = vk;
              bg = v.z;
              bp = vp;
            }
          }
        }
        if (bk != INT_MAX) {
          best = bd;
          bidx = vrow[bk * a.chunk + bp / a.tile_t] * a.tile_t + bp % a.tile_t;
        }
      }
    }
  }
  // No CTA leaves while a peer may still read or write its shared memory.
  if ((PRUNE || MODE == NOPRUNE) && n_chunks > 0) abl_cluster_sync();
  if (rank == 0) {
    a.d2[row0 + tid] = best;
    a.idx[row0 + tid] = bidx;
  }
#ifdef ABL_COUNT
  if (tid == 0) abl_chunks[i * ABL_CLUSTER + rank] = done;
#endif
  (void)done;
}

namespace {

template <int D, int MODE>
cudaError_t abl_config(int nqt, int max_v, int tile_t, int chunk, cudaStream_t s,
                       cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr, int* per_sm) {
  const size_t smem = abl_smem_bytes(abl_rows<D, MODE>(), abl_prunes(MODE), chunk * tile_t, max_v);
  if (smem > ABL_SMEM_MAX) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = icp_launch_fit(visited_ablate_kernel<D, MODE>, ABL_T, smem, &sms, per_sm);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  // 16 CTAs is past the portable cluster size of 8.
  if ((err = cudaFuncSetAttribute(visited_ablate_kernel<D, MODE>,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
      cudaSuccess)
    return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(nqt) * ABL_CLUSTER);
  cfg->blockDim = dim3(ABL_T);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ABL_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int D, int MODE>
cudaError_t launch_mode(const AblArgs& a, int nqt, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int per_sm = 0;
  cudaError_t err = abl_config<D, MODE>(nqt, a.max_v, a.tile_t, a.chunk, s, &cfg, &attr, &per_sm);
  if (err != cudaSuccess) return err;
  if ((err = cudaLaunchKernelEx(&cfg, visited_ablate_kernel<D, MODE>, a)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// The launch's fit: out = {cluster size, clusters resident at once, CTAs an
// SM holds, threads a CTA, dynamic shared memory a CTA}.
template <int D, int MODE>
cudaError_t fit_mode(int nqt, int max_v, int tile_t, int chunk, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int per_sm = 0, clusters = 0;
  cudaError_t err = abl_config<D, MODE>(nqt, max_v, tile_t, chunk, 0, &cfg, &attr, &per_sm);
  if (err != cudaSuccess ||
      (err = cudaOccupancyMaxActiveClusters(&clusters, visited_ablate_kernel<D, MODE>, &cfg)) !=
          cudaSuccess)
    return err;
  out[0] = ABL_CLUSTER;
  out[1] = clusters;
  out[2] = per_sm;
  out[3] = ABL_T;
  out[4] = static_cast<int>(cfg.dynamicSmemBytes);
  return cudaSuccess;
}

#define ABL_MODES(X) X(FULL) X(NOPRUNE) X(MAXONLY) X(DMAONLY) X(DEFAULT_TF32) X(HIGH_TF32) X(DIRECT)

template <int D>
cudaError_t launch(const AblArgs& a, int nqt, int mode, cudaStream_t s) {
#define ABL_CASE(M) \
  case M:           \
    return launch_mode<D, M>(a, nqt, s);
  switch (mode) {
    ABL_MODES(ABL_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef ABL_CASE
}

template <int D>
cudaError_t fit(int nqt, int max_v, int tile_t, int chunk, int mode, int* out) {
#define ABL_CASE(M) \
  case M:           \
    return fit_mode<D, M>(nqt, max_v, tile_t, chunk, out);
  switch (mode) {
    ABL_MODES(ABL_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef ABL_CASE
}

bool abl_shape_ok(int nqt, int max_v, int tile_t, int chunk) {
  return nqt >= 0 && tile_t > 0 && tile_t % 8 == 0 && chunk >= 1 && max_v % chunk == 0 &&
         static_cast<long long>(chunk) * tile_t < (1 << 30)
#ifdef ABL_COUNT
         && static_cast<long long>(nqt) * ABL_CLUSTER <= ABL_COUNT_MAX
#endif
      ;
}

}  // namespace

extern "C" int visited_ablate_launch(const float* q_aug, const float* qn2, const float* pages,
                                     const int32_t* vlist, const float* suffix,
                                     const int32_t* counts, float bound, float* d2,
                                     int32_t* idx, int nqt, int max_v, int tile_t, int chunk,
                                     int mode, int D, void* stream) {
  if (!abl_shape_ok(nqt, max_v, tile_t, chunk)) return cudaErrorInvalidValue;
  if (nqt == 0) return cudaSuccess;
  const AblArgs a{q_aug, qn2, pages, vlist, suffix, counts, bound, d2, idx, nqt, max_v, tile_t,
                  chunk};
  return static_cast<int>(
      ICP_DISPATCH_D(D, launch, a, nqt, mode, static_cast<cudaStream_t>(stream)));
}

// The fit of a launch of `mode` at these shapes into out[0..4] (see
// fit_mode); no launch.
extern "C" int visited_ablate_fit(int nqt, int max_v, int tile_t, int chunk, int mode, int D,
                                  int* out) {
  if (!abl_shape_ok(nqt, max_v, tile_t, chunk) || nqt < 1) return cudaErrorInvalidValue;
  return static_cast<int>(ICP_DISPATCH_D(D, fit, nqt, max_v, tile_t, chunk, mode, out));
}

#ifdef ABL_COUNT
// The counting build's chunks scored by each of the first n CTAs (CTA
// tile * ABL_CLUSTER + rank) of the last launch; synchronous.
extern "C" int visited_ablate_counts(int* out, int n) {
  if (n < 0 || n > ABL_COUNT_MAX) return cudaErrorInvalidValue;
  return static_cast<int>(cudaMemcpyFromSymbol(out, abl_chunks, sizeof(int) * n));
}
#endif
