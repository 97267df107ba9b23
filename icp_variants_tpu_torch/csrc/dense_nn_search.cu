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
// next, with the product q.t on the MXU at HIGHEST precision. Here a CTA
// owns a band of query rows and walks the target rows itself; the product
// is summed feature by feature on the FP32 units (no tensor cores, no TF32:
// a lower-precision product flips near-tie winners).
//
// Semantics (held against knn.nn_search_xla and knn.pruned_nn_search_plain):
//   d2(q, t) = (qn2 + tn2) - 2 * g,  g = ((q_0 t_0 + q_1 t_1) + q_2 t_2) ...
// over the D features of the query, every product and sum rounded on its own
// (-fmad=false and __fmul_rn / __fadd_rn), with qn2 and tn2 the caller's
// norm2 of the rows. Each row starts at (init, -1) and takes a target only
// on a strictly smaller d2, scanning target rows in ascending order; so
// among equal distances the lowest target row wins. The dense entry starts
// at +inf; the pruned entry at the bound and skips every target tile whose
// visit entry (B, ceil(N / tile_q), n_tiles) is 0 for the row's query tile.
//
// Layout: one CTA of NN_ROWS * NN_PARTS threads per (pair, band of NN_ROWS
// query rows), grid (ceil(N / NN_ROWS), B). Thread t serves row t % NN_ROWS
// over part t / NN_ROWS of each staged chunk, so the 32 threads of a warp
// read the same staged row at once (shared-memory broadcast). Target rows
// are staged NN_STAGE at a time as packed records [t_0 .. t_{D-1}, tn2]
// (one float4 at D = 3, two at D = 6); each thread keeps its query's
// features, qn2 and its running (d2, idx) in registers, and at the end the
// parts merge lexicographically on (d2, idx). A band lies inside one query
// tile of the visit mask (tile_q a multiple of NN_ROWS), so a skipped tile
// is skipped by the whole CTA. Built for D = 3 and D = 6.
//
// What bounds it on the H100: f32 operations, about 3D per (query, target
// row) pair (D products and D - 1 adds for g, then 3 more and the compare);
// the targets are re-read from L2 by each CTA.
#include "common.cuh"

#define NN_ROWS 64    // query rows per CTA
#define NN_PARTS 4    // threads per query row
#define NN_STAGE 512  // target rows staged in shared memory at a time

template <int D>
__global__ void __launch_bounds__(NN_ROWS * NN_PARTS)
nn_search_kernel(const float* __restrict__ q, const float* __restrict__ qn2,
                 const float* __restrict__ t, const float* __restrict__ tn2,
                 const uint8_t* __restrict__ visit, float init, float* __restrict__ d2_out,
                 int32_t* __restrict__ idx_out, int N, int M, int t_stride, int tile_q,
                 int tile_t) {
  constexpr int W = (D + 4) / 4;  // float4 words per staged record
  __shared__ float4 s_t4[NN_STAGE * W];
  __shared__ float s_d[NN_PARTS][NN_ROWS];
  __shared__ int s_i[NN_PARTS][NN_ROWS];
  float* s_t = reinterpret_cast<float*>(s_t4);

  const int b = blockIdx.y;
  const int lane = threadIdx.x % NN_ROWS;
  const int part = threadIdx.x / NN_ROWS;
  const int n0 = blockIdx.x * NN_ROWS;
  const int n = n0 + lane;
  const bool live = n < N;
  const size_t row = static_cast<size_t>(b) * N + n;
  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = live ? q[row * D + j] : 0.0f;
  const float qs = live ? qn2[row] : 0.0f;
  float best = init;
  int bidx = -1;

  const float* tb = t + static_cast<size_t>(b) * M * t_stride;
  const float* tnb = tn2 + static_cast<size_t>(b) * M;
  const int n_tiles = (M + tile_t - 1) / tile_t;
  const uint8_t* vis = nullptr;
  if (visit != nullptr) {
    const int nqt = (N + tile_q - 1) / tile_q;
    vis = visit + (static_cast<size_t>(b) * nqt + n0 / tile_q) * n_tiles;
  }
  constexpr int PER = NN_STAGE / NN_PARTS;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (vis != nullptr && vis[tile] == 0) continue;  // uniform across the CTA
    const int t_end = min(M, (tile + 1) * tile_t);
    for (int c0 = tile * tile_t; c0 < t_end; c0 += NN_STAGE) {
      const int cn = min(NN_STAGE, t_end - c0);
      __syncthreads();  // the previous chunk is no longer read
      for (int i = threadIdx.x; i < cn; i += blockDim.x) {
        const float* src = tb + static_cast<size_t>(c0 + i) * t_stride;
        float* dst = s_t + i * 4 * W;
#pragma unroll
        for (int j = 0; j < D; ++j) dst[j] = src[j];
        dst[D] = tnb[c0 + i];
      }
      __syncthreads();
      if (!live) continue;
      const int hi = min(cn, (part + 1) * PER);
      for (int s = part * PER; s < hi; ++s) {
        float tv[4 * W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float4 v = s_t4[s * W + w];
          tv[4 * w] = v.x;
          tv[4 * w + 1] = v.y;
          tv[4 * w + 2] = v.z;
          tv[4 * w + 3] = v.w;
        }
        float g = __fmul_rn(qv[0], tv[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) g = __fadd_rn(g, __fmul_rn(qv[j], tv[j]));
        const float d = __fsub_rn(__fadd_rn(qs, tv[D]), __fmul_rn(2.0f, g));
        if (d < best) {
          best = d;
          bidx = c0 + s;
        }
      }
    }
  }

  s_d[part][lane] = best;
  s_i[part][lane] = bidx;
  __syncthreads();
  if (part != 0 || !live) return;
  for (int p = 1; p < NN_PARTS; ++p) {
    const int pi = s_i[p][lane];
    const float pd = s_d[p][lane];
    if (pi >= 0 && (pd < best || (pd == best && (bidx < 0 || pi < bidx)))) {
      best = pd;
      bidx = pi;
    }
  }
  d2_out[row] = best;
  idx_out[row] = bidx;
}

template <int D>
static cudaError_t launch(const float* q, const float* qn2, const float* t, const float* tn2,
                          const uint8_t* visit, float init, float* d2, int32_t* idx, int B,
                          int N, int M, int t_stride, int tile_q, int tile_t, cudaStream_t s) {
  const dim3 grid((N + NN_ROWS - 1) / NN_ROWS, B);
  nn_search_kernel<D><<<grid, NN_ROWS * NN_PARTS, 0, s>>>(q, qn2, t, tn2, visit, init, d2, idx,
                                                          N, M, t_stride, tile_q, tile_t);
  return cudaGetLastError();
}

// q (B, N, D), qn2 (B, N), t (B, M, D), tn2 (B, M); d2 / idx (B, N).
extern "C" int dense_nn_search_launch(const float* q, const float* qn2, const float* t,
                                      const float* tn2, float* d2, int32_t* idx, int B, int N,
                                      int M, int D, void* stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, qn2, t, tn2, nullptr, INFINITY, d2, idx,
                                         B, N, M, D, NN_ROWS, M > 0 ? M : 1,
                                         static_cast<cudaStream_t>(stream)));
}

// q (B, N, D), qn2 (B, N), t (B, M, t_stride) with the features in its first
// D columns, tn2 (B, M), visit (B, ceil(N / tile_q), ceil(M / tile_t)) bytes;
// d2 / idx (B, N), idx -1 and d2 = bound where nothing beats the bound.
extern "C" int pruned_nn_search_launch(const float* q, const float* qn2, const float* t,
                                       const float* tn2, const uint8_t* visit, float bound,
                                       float* d2, int32_t* idx, int B, int N, int M,
                                       int t_stride, int tile_q, int tile_t, int D,
                                       void* stream) {
  if (tile_q < NN_ROWS || tile_q % NN_ROWS != 0 || tile_t < 1 || t_stride < D)
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, qn2, t, tn2, visit, bound, d2, idx, B, N,
                                         M, t_stride, tile_q, tile_t,
                                         static_cast<cudaStream_t>(stream)));
}
