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
#include <mutex>
#include <vector>

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

// A kernel's fit on the current device: the SMs, and the CTAs of `kernel`
// one SM holds at `threads` threads and `smem` bytes of dynamic shared
// memory. The shared-memory opt-in only ever rises (a launch of fewer bytes
// than the largest allowed so far needs none). Both are cached per device
// and kernel, so a repeated launch makes no CUDA query.
template <typename Kernel>
static cudaError_t icp_launch_fit(Kernel kernel, int threads, size_t smem, int* sms,
                                  int* per_sm) {
  struct Fit {
    int dev;
    const void* fn;
    int threads;  // -1: the entry holds the opt-in, `smem` bytes allowed
    size_t smem;
    int sms, per_sm;
  };
  static std::mutex mu;
  static std::vector<Fit> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(mu);
  Fit* allowed = nullptr;
  for (Fit& f : fits) {
    if (f.dev != dev || f.fn != fn) continue;
    if (f.threads < 0) {
      allowed = &f;
    } else if (f.threads == threads && f.smem == smem) {
      *sms = f.sms;
      *per_sm = f.per_sm;
      return cudaSuccess;
    }
  }
  if (allowed == nullptr || allowed->smem < smem) {
    if ((err = icp_allow_smem(kernel, smem)) != cudaSuccess) return err;
    if (allowed == nullptr) {
      fits.push_back(Fit{dev, fn, -1, smem, 0, 0});
    } else {
      allowed->smem = smem;
    }
  }
  Fit f{dev, fn, threads, smem, 0, 0};
  if ((err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return err;
  fits.push_back(f);
  *sms = f.sms;
  *per_sm = f.per_sm;
  return cudaSuccess;
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
// Shared by the block-major kd searches (block_major.cuh, used by
// kd_block_search.cu and cached_block_search.cu; kd_radius_search.cu): the
// workspace carving, the pick clip, the bucket scan of their counting sort,
// and the walk's helpers.
// ---------------------------------------------------------------------------

static inline size_t icp_align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Carves a workspace from `base` in 16-byte aligned pieces (null base:
// offsets only, so `off` ends at the bytes needed).
struct IcpCarve {
  char* base;
  size_t off = 0;
  template <typename T>
  T* take(size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += icp_align16(bytes);
    return reinterpret_cast<T*>(p);
  }
};

// A pick id: < 0 is no pick (-1), past nc - 1 is clipped to nc - 1.
__device__ __forceinline__ int icp_clip_pick(int v, int nc) { return v < 0 ? -1 : min(v, nc - 1); }

// Exclusive scans of the nb bucket sizes in `counts` (bucket offsets into
// boff) and of their chunk counts at `chunk` entries a chunk (into coff);
// boff[nb] and coff[nb] get the totals. One CTA of THREADS threads. With
// ZERO the counts are zeroed for the next histogram.
template <int THREADS, bool ZERO>
__device__ __forceinline__ void icp_bucket_scan(int* __restrict__ counts, int* __restrict__ boff,
                                                int* __restrict__ coff, int nb, int chunk) {
  __shared__ int s_a[THREADS], s_c[THREADS];
  const int t = threadIdx.x;
  const int per = (nb + THREADS - 1) / THREADS;
  const int lo = min(nb, t * per), hi = min(nb, lo + per);
  int a = 0, c = 0;
  for (int u = lo; u < hi; ++u) {
    const int n = counts[u];
    a += n;
    c += (n + chunk - 1) / chunk;
  }
  s_a[t] = a;
  s_c[t] = c;
  __syncthreads();
  for (int off = 1; off < THREADS; off *= 2) {
    const int ta = t >= off ? s_a[t - off] : 0, tc = t >= off ? s_c[t - off] : 0;
    __syncthreads();
    s_a[t] += ta;
    s_c[t] += tc;
    __syncthreads();
  }
  int ra = s_a[t] - a, rc = s_c[t] - c;  // exclusive
  for (int u = lo; u < hi; ++u) {
    const int n = counts[u];
    boff[u] = ra;
    coff[u] = rc;
    ra += n;
    rc += (n + chunk - 1) / chunk;
    if (ZERO) counts[u] = 0;
  }
  if (t == THREADS - 1) {
    boff[nb] = s_a[t];
    coff[nb] = s_c[t];
  }
}

// d += (t - x)^2 on each of four slots, rounded like the plain version.
__device__ __forceinline__ void icp_add_diff2(float4& d, const float4& t, float x) {
  d.x = __fadd_rn(d.x, icp_diff2(t.x, x));
  d.y = __fadd_rn(d.y, icp_diff2(t.y, x));
  d.z = __fadd_rn(d.z, icp_diff2(t.z, x));
  d.w = __fadd_rn(d.w, icp_diff2(t.w, x));
}

__device__ __forceinline__ float icp_min4(const float4& d) {
  return fminf(fminf(d.x, d.y), fminf(d.z, d.w));
}

__device__ __forceinline__ uint32_t icp_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
