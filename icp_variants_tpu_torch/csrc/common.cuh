// Shared helpers of the port's kernels. Each kernel source is compiled
// into its own shared library (ops/_cuda.py), so the extern "C" error
// helper below is defined once per library.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define ICP_MAX_K 16  // largest top-k block count the kd kernels take

// Coordinates per point. The kernels serve the 3-D matcher; the 6-D colour
// features of color-ICP are not searched on the card yet.
constexpr int D = 3;

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
