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
// [k * chunk, (k + 1) * chunk) and is scored as one row of chunk * tile_t
// columns, column c = j * tile_t + slot standing for target row
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
// kernel read it); the suffix never decreases and the best never grows,
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
// the rounding bounds that knn_ablate.tf32_error_bound states.
//
// Layout: one CTA of 256 threads per query tile, grid (nqt). The scalar
// modes give each thread one query row; the tensor-core modes give each
// warp 32 rows, two m16 tiles, walking the chunk 8 columns at a time. A
// chunk's staged rows (D + 1, or D for direct) sit in shared memory with
// a row pitch of chunk * tile_t + 8 floats (so a B fragment's four feature
// rows fall in distinct banks); two chunk buffers, the next one filled by
// cp.async while the current one is scored: 128 KB at D = 3, chunk 8 and
// tile_t 512.
//
// What bounds it on the H100: f32 operations, 2(D + 1) per (query, column)
// in the expansion modes (3D in direct), on 19 CTAs at the ETH ablation's
// shapes: 19 of 132 SMs work, the occupancy fault this microbenchmark
// exposes. The TF32 modes are bound by the same single-SM issue rate.
#include "common.cuh"

#define ABL_TQ 256
#define ABL_WARPS (ABL_TQ / 32)

enum AblateMode { FULL = 0, NOPRUNE, MAXONLY, DMAONLY, DEFAULT_TF32, HIGH_TF32, DIRECT };

__device__ __forceinline__ void abl_cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void abl_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void abl_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Stage chunk k (R rows of chunk * tile_t floats) into `dst` by cp.async;
// one commit group per call.
template <int D, int R>
__device__ __forceinline__ void abl_issue(float* dst, const float* __restrict__ pages,
                                          const int32_t* __restrict__ vrow, int k, int chunk,
                                          int tile_t, int pitch) {
  const int per = tile_t / 4;
  const int total = R * chunk * per;
  for (int e = threadIdx.x; e < total; e += ABL_TQ) {
    const int p = e % per;
    const int rest = e / per;
    const int j = rest % chunk;
    const int r = rest / chunk;
    const int tile = vrow[k * chunk + j];
    const int row = r < D ? r : 7;
    abl_cp_async16(dst + r * pitch + j * tile_t + 4 * p,
                   pages + (static_cast<size_t>(tile) * 8 + row) * tile_t + 4 * p);
  }
  abl_cp_commit();
}

// Scalar modes: thread `row` scores its query against the staged chunk.
template <int D, int R, int MODE>
__device__ __forceinline__ void abl_score_scalar(const float* buf, int pitch, int C, int row,
                                                 const float* qv, float q7, float qn2,
                                                 float* s_best, int32_t* s_idx,
                                                 const int32_t* vrow, int k, int chunk,
                                                 int tile_t) {
  float gbest = MODE == DIRECT ? INFINITY : -INFINITY;
  int gpos = 0;
  for (int c = 0; c < C; c += 4) {
    float t[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(buf + r * pitch + c);
      t[r][0] = v.x;
      t[r][1] = v.y;
      t[r][2] = v.z;
      t[r][3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MODE == DIRECT) {
        float d = icp_diff2(t[0][e], qv[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) d = __fadd_rn(d, icp_diff2(t[j][e], qv[j]));
        if (d < gbest) {
          gbest = d;
          gpos = c + e;
        }
      } else {
        float g = __fmul_rn(qv[0], t[0][e]);
#pragma unroll
        for (int j = 1; j < D; ++j) g = __fadd_rn(g, __fmul_rn(qv[j], t[j][e]));
        g = __fadd_rn(g, __fmul_rn(q7, t[D][e]));
        if constexpr (MODE == MAXONLY) {
          gbest = fmaxf(gbest, g);
        } else if (g > gbest) {
          gbest = g;
          gpos = c + e;
        }
      }
    }
  }
  float lmin = gbest;
  if constexpr (MODE != DIRECT) lmin = __fsub_rn(qn2, __fmul_rn(2.0f, gbest));
  if (lmin < s_best[row]) {
    s_best[row] = lmin;
    if constexpr (MODE != MAXONLY)
      s_idx[row] = vrow[k * chunk + gpos / tile_t] * tile_t + gpos % tile_t;
  }
}

// Tensor-core modes: warp w scores the tile's rows 32w .. 32w + 31 (two
// m16 tiles). a_hi / a_lo are the A fragments of both tiles (a_lo used by
// HIGH only); qn2 points at the tile's first row.
template <int D, int MODE>
__device__ __forceinline__ void abl_score_mma(const float* buf, int pitch, int C,
                                              const uint32_t (&a_hi)[2][4],
                                              const uint32_t (&a_lo)[2][4],
                                              const float* __restrict__ qn2,
                                              float* s_best, int32_t* s_idx,
                                              const int32_t* vrow, int k, int chunk,
                                              int tile_t) {
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2, tq = lane & 3;
  const int r0 = abl_row_of<D>(tq), r1 = abl_row_of<D>(tq + 4);
  float gm[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  int gp[2][2] = {{0, 0}, {0, 0}};
  for (int n0 = 0; n0 < C; n0 += 8) {
    const float bv0 = r0 >= 0 ? buf[r0 * pitch + n0 + grp] : 0.0f;
    const float bv1 = r1 >= 0 ? buf[r1 * pitch + n0 + grp] : 0.0f;
    const uint32_t b0 = abl_tf32(bv0), b1 = abl_tf32(bv1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if constexpr (MODE == HIGH_TF32) {
        const uint32_t l0 = abl_tf32(__fsub_rn(bv0, __uint_as_float(b0)));
        const uint32_t l1 = abl_tf32(__fsub_rn(bv1, __uint_as_float(b1)));
        abl_mma(acc, a_lo[mt], b0, b1);
        abl_mma(acc, a_hi[mt], l0, l1);
      }
      abl_mma(acc, a_hi[mt], b0, b1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[2 * h + e];
          if (v > gm[mt][h]) {
            gm[mt][h] = v;
            gp[mt][h] = n0 + 2 * tq + e;
          }
        }
      }
    }
  }
  // The first column reaching the max across the four lanes of a row.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float og = __shfl_xor_sync(0xffffffffu, gm[mt][h], off);
        const int op = __shfl_xor_sync(0xffffffffu, gp[mt][h], off);
        if (og > gm[mt][h] || (og == gm[mt][h] && op < gp[mt][h])) {
          gm[mt][h] = og;
          gp[mt][h] = op;
        }
      }
      if (tq == 0) {
        const int row = (threadIdx.x / 32) * 32 + mt * 16 + h * 8 + grp;
        const float lmin = __fsub_rn(qn2[row], __fmul_rn(2.0f, gm[mt][h]));
        if (lmin < s_best[row]) {
          s_best[row] = lmin;
          s_idx[row] = vrow[k * chunk + gp[mt][h] / tile_t] * tile_t + gp[mt][h] % tile_t;
        }
      }
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(ABL_TQ)
visited_ablate_kernel(const float* __restrict__ q_aug, const float* __restrict__ qn2,
                      const float* __restrict__ pages, const int32_t* __restrict__ vlist,
                      const float* __restrict__ suffix, const int32_t* __restrict__ counts,
                      float bound, float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
                      int max_v, int tile_t, int chunk) {
  constexpr int R = MODE == DIRECT ? D : D + 1;
  constexpr bool PRUNE = MODE != NOPRUNE && MODE != DMAONLY;
  constexpr bool TENSOR = MODE == DEFAULT_TF32 || MODE == HIGH_TF32;
  extern __shared__ float4 abl_smem4[];
  float* buf = reinterpret_cast<float*>(abl_smem4);
  __shared__ float s_best[ABL_TQ];
  __shared__ int32_t s_idx[ABL_TQ];
  __shared__ float s_red[ABL_WARPS];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int row0 = i * ABL_TQ;
  const int C = chunk * tile_t;
  const int pitch = C + 8;
  const int n_chunks = counts[i];
  const int32_t* vrow = vlist + static_cast<size_t>(i) * max_v;
  const float* srow = suffix + static_cast<size_t>(i) * max_v;
  s_best[tid] = bound;
  s_idx[tid] = -1;

  // This thread's query row (scalar modes).
  const size_t qrow = static_cast<size_t>(row0 + tid) * 8;
  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = q_aug[qrow + j];
  const float q7 = q_aug[qrow + 7];
  const float qn2v = qn2[row0 + tid];

  // The A fragments of this warp's two m16 tiles (tensor-core modes).
  uint32_t a_hi[2][4] = {}, a_lo[2][4] = {};
  if constexpr (TENSOR) {
    const int lane = tid % 32, grp = lane >> 2, tq = lane & 3;
    const int wrow = row0 + (tid / 32) * 32;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wrow + mt * 16 + grp + (e & 1) * 8;
        const int f = tq + (e >> 1) * 4;
        const float x = q_aug[static_cast<size_t>(r) * 8 + f];
        a_hi[mt][e] = abl_tf32(x);
        a_lo[mt][e] = abl_tf32(__fsub_rn(x, __uint_as_float(a_hi[mt][e])));
      }
    }
  }
  __syncthreads();

  if (n_chunks > 0) abl_issue<D, R>(buf, pages, vrow, 0, chunk, tile_t, pitch);
  for (int k = 0; k < n_chunks; ++k) {
    float* cur = buf + (k & 1) * R * pitch;
    float* nxt = buf + ((k + 1) & 1) * R * pitch;
    bool next = k + 1 < n_chunks;
    if constexpr (PRUNE) {
      // The tile's largest running best before chunk k.
      float v = s_best[tid];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (tid % 32 == 0) s_red[tid / 32] = v;
      __syncthreads();
      float wb = s_red[0];
#pragma unroll
      for (int w = 1; w < ABL_WARPS; ++w) wb = fmaxf(wb, s_red[w]);
      next = next && srow[(k + 1) * chunk] <= wb;
    }
    if (next) {
      abl_issue<D, R>(nxt, pages, vrow, k + 1, chunk, tile_t, pitch);
      abl_cp_wait<1>();
    } else {
      abl_cp_wait<0>();
    }
    __syncthreads();
    if constexpr (TENSOR) {
      abl_score_mma<D, MODE>(cur, pitch, C, a_hi, a_lo, qn2 + row0, s_best, s_idx, vrow, k,
                             chunk, tile_t);
    } else if constexpr (MODE != DMAONLY) {
      abl_score_scalar<D, R, MODE>(cur, pitch, C, tid, qv, q7, qn2v, s_best, s_idx, vrow, k,
                                   chunk, tile_t);
    }
    __syncthreads();  // `cur` is read by all before it is refilled
    if (!next) break;
  }
  d2_out[row0 + tid] = s_best[tid];
  idx_out[row0 + tid] = s_idx[tid];
}

template <int D, int MODE>
static cudaError_t launch_mode(const float* q_aug, const float* qn2, const float* pages,
                               const int32_t* vlist, const float* suffix,
                               const int32_t* counts, float bound, float* d2, int32_t* idx,
                               int nqt, int max_v, int tile_t, int chunk, cudaStream_t s) {
  constexpr int R = MODE == DIRECT ? D : D + 1;
  const size_t smem = static_cast<size_t>(2) * R * (chunk * tile_t + 8) * sizeof(float);
  cudaError_t err = icp_allow_smem(visited_ablate_kernel<D, MODE>, smem);
  if (err != cudaSuccess) return err;
  visited_ablate_kernel<D, MODE><<<nqt, ABL_TQ, smem, s>>>(
      q_aug, qn2, pages, vlist, suffix, counts, bound, d2, idx, max_v, tile_t, chunk);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch(const float* q_aug, const float* qn2, const float* pages,
                          const int32_t* vlist, const float* suffix, const int32_t* counts,
                          float bound, float* d2, int32_t* idx, int nqt, int max_v,
                          int tile_t, int chunk, int mode, cudaStream_t s) {
#define ABL_CASE(M)                                                                    \
  case M:                                                                              \
    return launch_mode<D, M>(q_aug, qn2, pages, vlist, suffix, counts, bound, d2, idx, \
                             nqt, max_v, tile_t, chunk, s);
  switch (mode) {
    ABL_CASE(FULL)
    ABL_CASE(NOPRUNE)
    ABL_CASE(MAXONLY)
    ABL_CASE(DMAONLY)
    ABL_CASE(DEFAULT_TF32)
    ABL_CASE(HIGH_TF32)
    ABL_CASE(DIRECT)
    default:
      return cudaErrorInvalidValue;
  }
#undef ABL_CASE
}

extern "C" int visited_ablate_launch(const float* q_aug, const float* qn2, const float* pages,
                                     const int32_t* vlist, const float* suffix,
                                     const int32_t* counts, float bound, float* d2,
                                     int32_t* idx, int nqt, int max_v, int tile_t, int chunk,
                                     int mode, int D, void* stream) {
  if (tile_t % 8 != 0 || chunk < 1 || max_v % chunk != 0) return cudaErrorInvalidValue;
  if (nqt == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q_aug, qn2, pages, vlist, suffix, counts,
                                         bound, d2, idx, nqt, max_v, tile_t, chunk, mode,
                                         static_cast<cudaStream_t>(stream)));
}
