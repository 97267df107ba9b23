// kd_block_search: per query, the exact nearest point among the points of
// its own top-k kd blocks, below a per-query starting bound.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py
// _make_resident_kernel in its base mode (launched by
// _run_resident_kernel_flat). On the TPU a pair's whole page table stayed
// resident in VMEM; an H100 SM has at most 227 KB of shared memory, so here
// each CTA stages one kd block at a time instead.
//
// Semantics and layout: icp_gate_block_search in common.cuh, with `sel`
// (B, N, k) the box_topk picks and `binit` (B, N) the per-query starting
// bounds; one CTA per (pair, gate of 32 queries), grid (ceil(N/32), B).
// Each block's first D page rows (D x cap_pad f32: 35 KB at D = 3 and
// cap_pad 2,944, 58 KB at D = 6 and cap_pad 2,432) are staged once per gate
// that picks it, and a thread scores only its own query's picks. Built for
// D = 3 (geometry) and D = 6 (colour features).
//
// With probe != 0 (a measurement aid: the JAX kernel's probe >= 1) each
// gate still builds its pick and walk lists and stages its blocks, but runs
// no distance loop and writes (binit, -1) on every row; the probe = 0
// instantiation is the production kernel.
//
// What bounds it on the H100: f32 operations, 3D per (query, member
// block, slot); the block bytes are read once per gate that needs them,
// from L2 when gates of one pair share blocks.
#include "common.cuh"

template <int D, bool PROBE>
__global__ void __launch_bounds__(ICP_GATE * ICP_PARTS)
kd_block_search_kernel(const float* __restrict__ q, const int32_t* __restrict__ sel,
                       const float* __restrict__ binit, const float* __restrict__ pages,
                       float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
                       int N, int nc, int cap_pad, int k) {
  icp_gate_block_search<D, PROBE>(q, nullptr, sel, binit, 0.0f, pages, d2_out, idx_out, N, nc, cap_pad,
                           k);
}

template <int D, bool PROBE>
static cudaError_t launch_mode(const float* q, const int32_t* sel, const float* binit,
                               const float* pages, float* d2, int32_t* idx, int B, int N,
                               int nc, int cap_pad, int k, cudaStream_t s) {
  const size_t smem = icp_gate_smem<D>(cap_pad);
  cudaError_t err = icp_allow_smem(kd_block_search_kernel<D, PROBE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ICP_GATE - 1) / ICP_GATE, B);
  kd_block_search_kernel<D, PROBE><<<grid, ICP_GATE * ICP_PARTS, smem, s>>>(
      q, sel, binit, pages, d2, idx, N, nc, cap_pad, k);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch(const float* q, const int32_t* sel, const float* binit,
                          const float* pages, float* d2, int32_t* idx, int B, int N, int nc,
                          int cap_pad, int k, int probe, cudaStream_t s) {
  return probe ? launch_mode<D, true>(q, sel, binit, pages, d2, idx, B, N, nc, cap_pad, k, s)
               : launch_mode<D, false>(q, sel, binit, pages, d2, idx, B, N, nc, cap_pad, k, s);
}

extern "C" int kd_block_search_launch(const float* q, const int32_t* sel, const float* binit,
                                      const float* pages, float* d2, int32_t* idx, int B,
                                      int N, int nc, int cap_pad, int k, int probe, int D,
                                      void* stream) {
  if (k < 1 || k > ICP_MAX_K || cap_pad % 4 != 0) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, sel, binit, pages, d2, idx, B, N, nc,
                                         cap_pad, k, probe, static_cast<cudaStream_t>(stream)));
}
