// box_topk: per query, the k kd blocks with the smallest squared box lower
// bound, and the certificate residual (the (k+1)-th smallest bound).
//
// Replaces the TPU kernel icp_variants_tpu/ops/kdtree.py
// _make_prefix_kernel (launched by _radius_prefix). That kernel also
// emitted per-tile member/hot/min-lb rows, per-8-row subgroup bit words and
// per-gate block spans; those gated the TPU search kernel's VMEM walks and
// are not needed here: the block search reads each query's picks directly.
//
// Semantics (held against the plain version in ops/kdtree.py bit for bit):
//   lb[c]  = sum_j max(max(bmin[c,j] - q_j, q_j - bmax[c,j]), 0)^2
//   k rounds of argmin over lb with already-picked blocks set to +inf,
//   lowest block index on ties (jnp.argmin's / torch.argmin's rule);
//   sel[r] = pick r if lb[pick r] <= binit else -1 (no member);
//   resid  = min of lb over the blocks left after k rounds.
//
// Layout: one thread per query, 128 queries per CTA, grid (ceil(N/128), B).
// The pair's block boxes (nc x D x 2 f32: 3 KB at D = 3 and nc = 128,
// 12 KB at D = 6 and nc = 256) sit in shared memory; every thread reads the
// same box at the same time (broadcast). Built for D = 3 and D = 6.
// Rather than keep nc bounds per thread, each round recomputes them:
// (k + 1) * nc * D gap terms per query. What bounds it on the H100: f32
// operations, some 20 per (query, block, round), far below one
// microsecond of the card at the main path's 4,352 queries x 128 blocks;
// at that size launch latency dominates.
#include "common.cuh"

template <int D>
__global__ void __launch_bounds__(128)
box_topk_kernel(const float* __restrict__ q, const float* __restrict__ binit,
                const float* __restrict__ bmin, const float* __restrict__ bmax,
                int32_t* __restrict__ sel, float* __restrict__ resid,
                int N, int nc, int k) {
  extern __shared__ float smem[];
  float* smin = smem;
  float* smax = smem + nc * D;
  const int b = blockIdx.y;
  const size_t box_off = static_cast<size_t>(b) * nc * D;
  for (int i = threadIdx.x; i < nc * D; i += blockDim.x) {
    smin[i] = bmin[box_off + i];
    smax[i] = bmax[box_off + i];
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t row = static_cast<size_t>(b) * N + n;
  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = q[row * D + j];
  const float radius = binit[row];

  int picks[ICP_MAX_K];
  for (int r = 0; r <= k; ++r) {
    float best = 0.0f, best_lb = 0.0f;
    int arg = -1;
    for (int c = 0; c < nc; ++c) {
      float lb = icp_gap2(qv[0], smin[c * D], smax[c * D]);
#pragma unroll
      for (int j = 1; j < D; ++j)
        lb = __fadd_rn(lb, icp_gap2(qv[j], smin[c * D + j], smax[c * D + j]));
      bool taken = false;
      for (int p = 0; p < r; ++p) taken |= (picks[p] == c);
      const float w = taken ? INFINITY : lb;
      if (arg < 0 || w < best) {
        best = w;
        best_lb = lb;
        arg = c;
      }
    }
    if (r < k) {
      picks[r] = arg;
      sel[row * k + r] = (best_lb <= radius) ? arg : -1;
    } else {
      resid[row] = best;
    }
  }
}

template <int D>
static cudaError_t launch(const float* q, const float* binit, const float* bmin,
                          const float* bmax, int32_t* sel, float* resid, int B, int N, int nc,
                          int k, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(nc) * D * sizeof(float);
  cudaError_t err = icp_allow_smem(box_topk_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 127) / 128, B);
  box_topk_kernel<D><<<grid, 128, smem, s>>>(q, binit, bmin, bmax, sel, resid, N, nc, k);
  return cudaGetLastError();
}

extern "C" int box_topk_launch(const float* q, const float* binit, const float* bmin,
                               const float* bmax, int32_t* sel, float* resid, int B,
                               int N, int nc, int k, int D, void* stream) {
  if (k < 1 || k > ICP_MAX_K || k > nc) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, binit, bmin, bmax, sel, resid, B, N, nc,
                                         k, static_cast<cudaStream_t>(stream)));
}
