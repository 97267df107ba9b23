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
// Shared by the block-major kd searches (kd_block_search.cu,
// kd_radius_search.cu): the workspace carving, the pick clip, the bucket
// scan of their counting sort, and the walk's helpers.
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
