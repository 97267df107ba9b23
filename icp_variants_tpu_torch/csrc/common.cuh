// Shared helpers of the port's kernels. Each kernel source is compiled
// into its own shared library (ops/_cuda.py), so the extern "C" error
// helper below is defined once per library.
//
// Every kernel is a template on D, the features per point: 3 for the
// geometric matcher, 6 for the colour-ICP features [x, y, z, r, g, b]/255.
// Each C entry point takes D as an int and launches the D = 3 or D = 6
// instantiation (ICP_DISPATCH_D); any other D is refused.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define ICP_MAX_K 16  // largest top-k block count the kd kernels take

// Call `launch_fn<D>(args...)` for the D given at run time.
#define ICP_DISPATCH_D(d, launch_fn, ...)                                \
  ((d) == 3 ? launch_fn<3>(__VA_ARGS__)                                  \
            : (d) == 6 ? launch_fn<6>(__VA_ARGS__) : cudaErrorInvalidValue)

extern "C" const char* icp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Allow a kernel `bytes` of dynamic shared memory: past 48 KB of static plus
// dynamic memory a launch needs this opt-in, so it is always made.
template <typename Kernel>
static cudaError_t icp_allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Squared gap between a coordinate and a [lo, hi] interval, rounded step
// by step like the plain PyTorch version: max(max(lo - x, x - hi), 0)^2.
__device__ __forceinline__ float icp_gap2(float x, float lo, float hi) {
  const float g = fmaxf(fmaxf(__fsub_rn(lo, x), __fsub_rn(x, hi)), 0.0f);
  return __fmul_rn(g, g);
}

// (t - x)^2, rounded like the plain version's `diff * diff`.
__device__ __forceinline__ float icp_diff2(float t, float x) {
  const float d = __fsub_rn(t, x);
  return __fmul_rn(d, d);
}

// ---------------------------------------------------------------------------
// Gate block search of cached_block_search (one cached block per query;
// written for k picks per query, the kd block search's layout before it went
// block-major in csrc/kd_block_search.cu).
//
// One CTA of ICP_GATE * ICP_PARTS threads serves a gate of ICP_GATE
// consecutive query rows of pair b. Thread t serves row t % ICP_GATE over
// slot part t / ICP_GATE, so the 32 threads of a warp read the same staged
// point at once (shared-memory broadcast). The CTA first lists the distinct
// blocks of its rows' picks in shared memory (first occurrence in (row,
// pick) order), then stages each listed block's first D rows of its
// (8, cap_pad) page once (16-byte loads; D x cap_pad f32 of dynamic shared
// memory) and each thread scores its own row's point slots against it only
// where the block is one of its row's picks. At the end the parts merge
// their running (distance, pick position, slot) lexicographically.
//
// With a non-null `pose` ((B, 16) f32, row-major 4 x 4 per pair) the
// queries are raw features and each row's three spatial columns are moved
// as it is loaded: x'_r = ((P_r0 x + P_r1 y) + P_r2 z) + P_r3, every product
// and sum rounded on its own (core/se3.transform_points' order); the other
// features pass through.
//
// With PROBE (a staging-only measurement mode, the kd block search's probe
// before its redesign; no kernel instantiates it now) each gate still lists
// and stages its blocks but runs no distance loop: every row writes its
// start and -1.
//
// Semantics: best = binit (the row's entry of `binit`, or `binit_value`
// when `binit` is null), idx = -1; over the row's picks in order (ids < 0
// are no pick; ids past nc - 1 are clipped to nc - 1) and their slots in
// ascending order, a point counts only if its squared distance
// sum_j (t_j - q_j)^2 is strictly below the running best. So among equal
// distances the earliest pick, then the lowest slot, wins. idx is the
// pair-local page index block * cap_pad + slot; where nothing beat the
// start, d2 = the start and idx = -1. Distances are direct differences
// rounded like the plain versions (no FMA contraction).
// ---------------------------------------------------------------------------

#define ICP_GATE 32
#define ICP_PARTS 4

template <int D, bool PROBE = false>
__device__ __forceinline__ void icp_gate_block_search(
    const float* __restrict__ q, const float* __restrict__ pose, const int32_t* __restrict__ sel,
    const float* __restrict__ binit, float binit_value, const float* __restrict__ pages,
    float* __restrict__ d2_out, int32_t* __restrict__ idx_out, int N, int nc, int cap_pad,
    int k) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  __shared__ int s_sel[ICP_GATE * ICP_MAX_K];
  __shared__ int s_first[ICP_GATE * ICP_MAX_K];
  __shared__ float s_d[ICP_PARTS][ICP_GATE];
  __shared__ int s_pos[ICP_PARTS][ICP_GATE];
  __shared__ int s_blk[ICP_PARTS][ICP_GATE];
  __shared__ int s_slot[ICP_PARTS][ICP_GATE];

  const int b = blockIdx.y;
  const int g0 = blockIdx.x * ICP_GATE;
  const int lane = threadIdx.x % ICP_GATE;
  const int part = threadIdx.x / ICP_GATE;
  const int n = g0 + lane;
  const bool live = n < N;
  const size_t row = static_cast<size_t>(b) * N + n;
  const int n_ent = ICP_GATE * k;

  for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
    const int qn = g0 + e / k;
    const int v = (qn < N) ? sel[(static_cast<size_t>(b) * N + qn) * k + e % k] : -1;
    s_sel[e] = v < 0 ? -1 : min(v, nc - 1);
  }
  __syncthreads();
  // First occurrence of each block among the gate's picks: the walk list.
  for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
    const int blk = s_sel[e];
    int first = blk >= 0;
    for (int f = 0; f < e && first; ++f) first = (s_sel[f] != blk);
    s_first[e] = first;
  }

  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = live ? q[row * D + j] : 0.0f;
  if (pose != nullptr) {
    const float* P = pose + static_cast<size_t>(b) * 16;
    const float x = qv[0], y = qv[1], z = qv[2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      qv[r] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, P[4 * r]), __fmul_rn(y, P[4 * r + 1])),
                                  __fmul_rn(z, P[4 * r + 2])),
                        P[4 * r + 3]);
  }
  float best = live ? (binit != nullptr ? binit[row] : binit_value) : 0.0f;
  int bpos = -1, bblk = -1, bslot = -1;
  const int per = (cap_pad + ICP_PARTS - 1) / ICP_PARTS;
  const int s_lo = part * per;
  const int s_hi = min(cap_pad, s_lo + per);
  const int n4 = D * cap_pad / 4;
  __syncthreads();

  for (int e = 0; e < n_ent; ++e) {
    if (!s_first[e]) continue;  // uniform across the CTA
    const int blk = s_sel[e];
    const float4* src = reinterpret_cast<const float4*>(
        pages + (static_cast<size_t>(b) * nc + blk) * 8 * cap_pad);
    __syncthreads();  // the previous block is no longer read
    for (int i = threadIdx.x; i < n4; i += blockDim.x) tile4[i] = src[i];
    __syncthreads();
    if (PROBE || !live) continue;
    int pos = -1;
    for (int p = k - 1; p >= 0; --p)
      if (s_sel[lane * k + p] == blk) pos = p;
    if (pos < 0) continue;
    for (int s = s_lo; s < s_hi; ++s) {
      float d = icp_diff2(tile[s], qv[0]);
#pragma unroll
      for (int j = 1; j < D; ++j) d = __fadd_rn(d, icp_diff2(tile[j * cap_pad + s], qv[j]));
      if (d < best || (d == best && bpos >= 0 && pos < bpos)) {
        best = d;
        bpos = pos;
        bblk = blk;
        bslot = s;
      }
    }
  }

  s_d[part][lane] = best;
  s_pos[part][lane] = bpos;
  s_blk[part][lane] = bblk;
  s_slot[part][lane] = bslot;
  __syncthreads();
  if (part != 0 || !live) return;
  for (int p = 1; p < ICP_PARTS; ++p) {
    const int pp = s_pos[p][lane];
    if (pp < 0) continue;
    const float pd = s_d[p][lane];
    const int ps = s_slot[p][lane];
    if (bpos < 0 || pd < best ||
        (pd == best && (pp < bpos || (pp == bpos && ps < bslot)))) {
      best = pd;
      bpos = pp;
      bblk = s_blk[p][lane];
      bslot = ps;
    }
  }
  d2_out[row] = best;
  idx_out[row] = bpos >= 0 ? bblk * cap_pad + bslot : -1;
}

// Dynamic shared memory of one gate block search: one staged block.
template <int D>
static size_t icp_gate_smem(int cap_pad) {
  return static_cast<size_t>(D) * cap_pad * sizeof(float);
}
