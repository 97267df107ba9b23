// visited_search: exact 1-NN against a tiled target index with per-query
// search radii; a negative radius freezes the query out.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py _make_visited_kernel
// in its per-query-bound mode (launched by _run_visited_kernel through
// nn_search_pruned_v2(per_query_bound=..., use_phase1=False)), which serves
// the exact arm's certificate-failure fallback.
//
// Semantics (held against the plain version in ops/knn.py):
//   live = radius >= 0; a live query returns the target row of smallest
//   squared distance strictly below its radius (lowest row on ties), or
//   idx -1 and d2 = radius; a frozen query returns idx -1, d2 = radius.
//   idx is the tiled position tile * tile_t + slot (TargetIndex.perm maps
//   it to the original row).
//
// Layout: one CTA of 128 threads per (pair, 128-query tile), one thread per
// query, grid (ceil(N/128), B). The CTA reduces its live queries' bounding
// box and largest radius, then walks the target tiles in index order and
// visits a tile only if the squared lower bound between its bounding box
// and the query box is <= the largest live radius (rounded the same way
// as the distances, so the skip is exact: a skipped tile holds no point
// below any live radius). A visited tile's first D feature rows
// (D x 1024 f32 = 12 KB) are staged in shared memory and every live thread
// runs its direct-difference running minimum over them. Tiles with no
// live query exit at once, which is the common case in the fallback.
// Sorting tiles by lower bound and suffix-min pruning, as the TPU kernel
// did, are left for later.
//
// What bounds it on the H100: f32 operations, 9 per (live query, visited
// tile slot), plus the lower-bound scan of every tile per CTA.
#include "common.cuh"

#define TQ 128

__global__ void __launch_bounds__(TQ)
visited_search_kernel(const float* __restrict__ q, const float* __restrict__ radius,
                      const float* __restrict__ pages, const float* __restrict__ tmin,
                      const float* __restrict__ tmax, float* __restrict__ d2_out,
                      int32_t* __restrict__ idx_out, int N, int n_tiles, int tile_t) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  __shared__ float s_red[TQ / 32][2 * D + 1];
  __shared__ float s_box[2 * D + 1];

  const int b = blockIdx.y;
  const int n = blockIdx.x * TQ + threadIdx.x;
  const size_t row = static_cast<size_t>(b) * N + n;
  const float r = (n < N) ? radius[row] : -1.0f;
  const bool live = r >= 0.0f;
  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = (n < N) ? q[row * D + j] : 0.0f;

  // Live-query bounding box and largest live radius.
  float red[2 * D + 1];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    red[j] = live ? qv[j] : INFINITY;
    red[D + j] = live ? qv[j] : -INFINITY;
  }
  red[2 * D] = live ? r : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      red[j] = fminf(red[j], __shfl_xor_sync(0xffffffffu, red[j], off));
      red[D + j] = fmaxf(red[D + j], __shfl_xor_sync(0xffffffffu, red[D + j], off));
    }
    red[2 * D] = fmaxf(red[2 * D], __shfl_xor_sync(0xffffffffu, red[2 * D], off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int j = 0; j < 2 * D + 1; ++j) s_red[warp][j] = red[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < 2 * D + 1; ++j) {
      float v = s_red[0][j];
      for (int w = 1; w < TQ / 32; ++w)
        v = (j < D) ? fminf(v, s_red[w][j]) : fmaxf(v, s_red[w][j]);
      s_box[j] = v;
    }
  }
  __syncthreads();
  const float max_r = s_box[2 * D];

  float best = r;
  int bidx = -1;
  if (max_r >= 0.0f) {  // uniform: the tile holds a live query
    const int n4 = D * tile_t / 4;
    for (int t = 0; t < n_tiles; ++t) {
      const size_t box = (static_cast<size_t>(b) * n_tiles + t) * 8;
      // Squared gap between the intervals [qmin, qmax] and [tmin, tmax].
      float lb = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float g = fmaxf(fmaxf(__fsub_rn(s_box[j], tmax[box + j]),
                                    __fsub_rn(tmin[box + j], s_box[D + j])),
                              0.0f);
        lb = __fadd_rn(lb, __fmul_rn(g, g));
      }
      if (lb > max_r) continue;  // uniform
      const float4* src = reinterpret_cast<const float4*>(
          pages + (static_cast<size_t>(b) * n_tiles + t) * 8 * tile_t);
      __syncthreads();
      for (int i = threadIdx.x; i < n4; i += TQ) tile4[i] = src[i];
      __syncthreads();
      if (!live) continue;
      for (int s = 0; s < tile_t; ++s) {
        float d = icp_diff2(tile[s], qv[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) d = __fadd_rn(d, icp_diff2(tile[j * tile_t + s], qv[j]));
        if (d < best) {
          best = d;
          bidx = t * tile_t + s;
        }
      }
    }
  }
  if (n < N) {
    d2_out[row] = best;
    idx_out[row] = bidx;
  }
}

extern "C" int visited_search_launch(const float* q, const float* radius, const float* pages,
                                     const float* tmin, const float* tmax, float* d2,
                                     int32_t* idx, int B, int N, int n_tiles, int tile_t,
                                     void* stream) {
  if (tile_t % 4 != 0) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(D) * tile_t * sizeof(float);
  const dim3 grid((N + TQ - 1) / TQ, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = icp_allow_smem(visited_search_kernel, smem);
  if (err != cudaSuccess) return err;
  visited_search_kernel<<<grid, TQ, smem, s>>>(q, radius, pages, tmin, tmax, d2, idx, N, n_tiles,
                                               tile_t);
  return static_cast<int>(cudaGetLastError());
}
