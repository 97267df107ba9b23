// cached_block_search: per query, the nearest point of exactly one cached
// kd block, strictly below a common bound (the approximate arm's seeded
// block-membership mode).
//
// Replaces two TPU kernels that ran back to back:
//   icp_variants_tpu/ops/kdtree.py _make_cached_prefix_kernel (launched by
//   _cached_prefix): each row's cached block id -> one-hot subgroup mask
//   words and per-gate [jmin, jend) block spans; and
//   icp_variants_tpu/ops/knn.py _make_resident_kernel in its restrict_col
//   mode (launched by _run_resident_kernel_flat from nn_search_kd_cached),
//   which walked those spans out of VMEM and masked each row to its own
//   block. The masks and spans only gated VMEM walks. Here a CTA builds its
//   gate's distinct-block list in shared memory itself (the cached prefix's
//   job) and scores each row against its own block only (restrict_col).
//
// With a pose ((B, 16) f32; null = none) the kernel also replaces row 2's
// transform_pose mode (icp_variants_tpu/ops/knn.py _make_resident_kernel,
// transform_pose=True; entry nn_search_kd_cached(pose=)): the queries are
// raw source features, and each row's spatial columns are moved by the
// pair's pose as the row is loaded (common.cuh), 15 operations a row.
//
// Semantics (held against kdtree.nn_search_kd_cached_oracle): blk < 0
// searches nothing (idx -1, d2 = bound); otherwise the lowest slot of the
// smallest squared distance in block blk, if strictly below `bound`, as the
// pair-local page index blk * cap_pad + slot; else idx -1, d2 = bound. Ids
// past nc - 1 are clipped to nc - 1, as the JAX package clips them.
//
// Layout: icp_gate_block_search in common.cuh with k = 1: one CTA of 128
// threads per (pair, gate of 32 consecutive rows), grid (ceil(N/32), B).
// The rows are in 6-dim Morton order, so a gate holds about 3 distinct
// blocks; each is staged once (D x cap_pad f32: 30 KB at D = 6 and cap_pad
// 1,280). Built for D = 3 and D = 6.
//
// What bounds it on the H100: f32 operations, 3D per (row, slot of its
// block), and reading each distinct (pair, block) page once.
#include "common.cuh"

template <int D>
__global__ void __launch_bounds__(ICP_GATE * ICP_PARTS)
cached_block_search_kernel(const float* __restrict__ q, const int32_t* __restrict__ blk,
                           const float* __restrict__ pose, float bound,
                           const float* __restrict__ pages, float* __restrict__ d2_out,
                           int32_t* __restrict__ idx_out, int N, int nc, int cap_pad) {
  icp_gate_block_search<D>(q, pose, blk, nullptr, bound, pages, d2_out, idx_out, N, nc, cap_pad,
                           1);
}

template <int D>
static cudaError_t launch(const float* q, const int32_t* blk, const float* pose, float bound,
                          const float* pages, float* d2, int32_t* idx, int B, int N, int nc,
                          int cap_pad, cudaStream_t s) {
  const size_t smem = icp_gate_smem<D>(cap_pad);
  cudaError_t err = icp_allow_smem(cached_block_search_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ICP_GATE - 1) / ICP_GATE, B);
  cached_block_search_kernel<D><<<grid, ICP_GATE * ICP_PARTS, smem, s>>>(
      q, blk, pose, bound, pages, d2, idx, N, nc, cap_pad);
  return cudaGetLastError();
}

// pose: null, or (B, 16) f32 (the transform_pose mode: q holds raw features).
extern "C" int cached_block_search_launch(const float* q, const int32_t* blk, const float* pose,
                                          float bound, const float* pages, float* d2,
                                          int32_t* idx, int B, int N, int nc, int cap_pad, int D,
                                          void* stream) {
  if (cap_pad % 4 != 0 || nc < 1) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, blk, pose, bound, pages, d2, idx, B, N,
                                         nc, cap_pad, static_cast<cudaStream_t>(stream)));
}
