// projective_window_search: per query, the nearest valid target pixel
// within +-window of its projected pixel (u0, v0), among pixels inside the
// image (projective ICP matching, NearestNeighbor.h:368-407).
//
// Replaces icp_variants_tpu/ops/knn.py _make_resident_kernel in its
// pixel_window mode (launched by _run_resident_kernel from
// icp_variants_tpu/ops/projective.py projective_match_resident). On the TPU
// the whole image block table sat in VMEM, and each 32-row gate walked the
// bounding rectangle of its rows' block neighbourhoods with every lane masked
// by the exact window test; the subgroup bit words and gate spans only gated
// those VMEM walks. Here the window is read straight from the image-shaped
// target through L1 / L2 (one frame's coordinates are 3.7 MB; eight frames
// fit the 50 MB L2).
//
// Semantics (held against ops/projective.projective_match_plain, the JAX
// package's block-gather window scan): best = BIG, idx = -1; over the
// in-image pixels of the window in (block, slot) order -- block rows, then
// block columns of the BLOCK x BLOCK grid, then the rows and columns inside
// each block, the plain version's first-argmin order, not raster order -- a
// pixel counts if its squared distance dx*dx + dy*dy + dz*dz (dx = t - q, in
// x, y, z order, each step rounded, no FMA) is strictly below the running
// best. Invalid pixels count at PAD_COORD, as in the plain version's image,
// so they never beat BIG. idx is the linear pixel v * width + u. The plain
// version's clipped block neighbourhood holds every in-image pixel of the
// window, so the two see the same candidates.
//
// Layout: one warp per query, 8 Morton-consecutive queries a CTA (their
// windows overlap, so neighbouring warps share L1 lines). Lane l takes the
// window's column u = u_lo + l (and u_lo + l + 32, ... for windows wider
// than 32 columns) and walks the rows v_lo..v_hi: each row is one load of
// the valid bytes and three of the x, y, z words across the lanes, adjacent
// pixels on adjacent lanes, and every lane of the warp runs the same trip
// count. The layout it replaces (one thread a query, four scalar loads a
// pixel, 32 windows apart on the 32 lanes of each load) read 1.10 ms at
// the projective tracker's shapes, this one 0.47. None of the variants
// timed at those shapes read more than 10% faster, and none was kept
// (PERF.md): the image as x, y, z planes from a pre-pass, 2 to 8 rows'
// loads in flight, the union of a CTA's windows staged in shared memory,
// 25 rows unrolled for the default window.
// Tie order: within one column the rank
//   ((v / BLOCK) * wb + u / BLOCK) * BLOCK^2 + (v % BLOCK) * BLOCK + u % BLOCK
// (the plain version's order; wb = ceil(width / BLOCK)) grows with v, so a
// lane's strict < over ascending v keeps the first pixel among equals; the
// warp then takes the least d2 and, where several lanes (or several column
// chunks of a lane) hold it, the least rank.
//
// What bounds it on the H100: f32 operations, 9 per in-window pixel, and
// load issue: 4 loads a window row a query (the image itself, 13 bytes a
// pixel, comes once from device memory).
//
// Built with -DPWS_LOADS_ONLY (a measurement build, loaded by
// chip_smoke.py's projective phase; never on the main path), each lane
// reads the same pixels but only folds their bits together, no distance is
// taken, and every row gets d2 = those bits (as a float), idx = -1: the
// kernel's time less the distances.
#include <climits>

#include "common.cuh"

#define PROJ_WARPS 8  // queries (warps) per CTA
#define PROJ_PAD_COORD 1.0e9f
#define PROJ_BIG 3.0e13f
#define PROJ_FULL 0xffffffffu

// Position of pixel (u, v) in the plain version's first-argmin order.
__device__ __forceinline__ long long proj_rank(int u, int v, int block, int wb) {
  return (static_cast<long long>(v / block) * wb + u / block) * block * block +
         (v % block) * block + u % block;
}

__global__ void __launch_bounds__(PROJ_WARPS * 32)
projective_window_search_kernel(const float* __restrict__ q, const int32_t* __restrict__ pix,
                                const float* __restrict__ tgt,
                                const uint8_t* __restrict__ tvalid, float* __restrict__ d2_out,
                                int32_t* __restrict__ idx_out, int N, int width, int height,
                                int window, int block) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * PROJ_WARPS + threadIdx.x / 32;
  if (n >= N) return;  // the whole warp
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * N + n;
  const size_t n_pix = static_cast<size_t>(width) * height;
  const float* img = tgt + static_cast<size_t>(b) * n_pix * 3;
  const uint8_t* ok = tvalid + static_cast<size_t>(b) * n_pix;
  const float qx = q[row * 3], qy = q[row * 3 + 1], qz = q[row * 3 + 2];
  const int u0 = pix[row * 2], v0 = pix[row * 2 + 1];
  const int u_lo = max(u0 - window, 0), u_hi = min(u0 + window, width - 1);
  const int v_lo = max(v0 - window, 0), v_hi = min(v0 + window, height - 1);
  const int wb = (width + block - 1) / block;

  // The lane's best over its columns: d2, and its pixel (bu, bv).
  float best = PROJ_BIG;
  int bu = -1, bv = -1;
#ifdef PWS_LOADS_ONLY
  uint32_t acc = 0;
#endif
  // Empty windows (u_lo > u_hi or v_lo > v_hi) run no trip. Both loops
  // have runtime bounds and stay rolled: unrolled, nvcc 12.9 at -O3 once
  // ran a loop of this kind past its bound (the card test of every offset
  // mod 16 in tests/test_torch_projective.py holds this one).
#pragma unroll 1
  for (int c0 = u_lo; c0 <= u_hi; c0 += 32) {
    const int u = c0 + lane;
    const bool col = u <= u_hi && v_lo <= v_hi;
    float cb = PROJ_BIG;
    int cv = -1;
#pragma unroll 1
    for (int v = v_lo; v <= v_hi; ++v) {
      if (!col) continue;
      const int p = v * width + u;
      const bool valid = __ldg(ok + p) != 0;
      const float tx = __ldg(img + 3 * p), ty = __ldg(img + 3 * p + 1),
                  tz = __ldg(img + 3 * p + 2);
#ifdef PWS_LOADS_ONLY
      acc ^= __float_as_uint(tx) ^ __float_as_uint(ty) ^ __float_as_uint(tz) ^ valid;
#else
      const float d = __fadd_rn(
          __fadd_rn(icp_diff2(valid ? tx : PROJ_PAD_COORD, qx),
                    icp_diff2(valid ? ty : PROJ_PAD_COORD, qy)),
          icp_diff2(valid ? tz : PROJ_PAD_COORD, qz));
      if (d < cb) {
        cb = d;
        cv = v;
      }
#endif
    }
    if (cv >= 0 && (cb < best || (cb == best && proj_rank(u, cv, block, wb) <
                                                    proj_rank(bu, bv, block, wb)))) {
      best = cb;
      bu = u;
      bv = cv;
    }
  }
#ifdef PWS_LOADS_ONLY
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc ^= __shfl_xor_sync(PROJ_FULL, acc, o);
  if (lane == 0) {
    d2_out[row] = __uint_as_float(acc);
    idx_out[row] = -1;
  }
  return;
#endif
  // The warp's least d2; among the lanes that hold it, the least rank.
  float dmin = best;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) dmin = fminf(dmin, __shfl_xor_sync(PROJ_FULL, dmin, o));
  const bool mine = bv >= 0 && best == dmin;
  unsigned tied = __ballot_sync(PROJ_FULL, mine);
  if (__popc(tied) > 1) {
    long long r = mine ? proj_rank(bu, bv, block, wb) : LLONG_MAX;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      const long long other = __shfl_xor_sync(PROJ_FULL, r, o);
      r = other < r ? other : r;
    }
    tied = __ballot_sync(PROJ_FULL, mine && proj_rank(bu, bv, block, wb) == r);
  }
  const int src = tied ? __ffs(tied) - 1 : 0;
  const int p = __shfl_sync(PROJ_FULL, bv * width + bu, src);
  if (lane == 0) {
    d2_out[row] = dmin;
    idx_out[row] = tied ? p : -1;
  }
}

extern "C" int projective_window_search_launch(const float* q, const int32_t* pix,
                                               const float* tgt, const uint8_t* tvalid,
                                               float* d2, int32_t* idx, int B, int N, int width,
                                               int height, int window, int block, void* stream) {
  if (width < 1 || height < 1 || window < 0 || block < 1) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  // Pixel indices are int.
  if (static_cast<long long>(width) * height >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid((N + PROJ_WARPS - 1) / PROJ_WARPS, B);
  projective_window_search_kernel<<<grid, PROJ_WARPS * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      q, pix, tgt, tvalid, d2, idx, N, width, height, window, block);
  return static_cast<int>(cudaGetLastError());
}
