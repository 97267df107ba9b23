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
// those VMEM walks. Here each thread serves one query and scans its window
// straight from the image-shaped target through L1 / L2 (one frame's
// coordinates are 3.7 MB; eight frames fit the 50 MB L2). Queries come in
// xyz-Morton order, so a warp's windows overlap and share cache lines.
//
// Semantics (held against ops/projective.projective_match_plain, the JAX
// package's block-gather window scan): best = BIG, idx = -1; over the
// in-image pixels of the window in (block, slot) order -- block rows, then
// block columns of the BLOCK x BLOCK grid, then the rows and columns inside
// each block, the plain version's first-argmin order, not raster order -- a
// pixel counts if its squared distance dx*dx + dy*dy + dz*dz (dx = t - q, in
// x, y, z order, each step rounded, no FMA) is strictly below the running
// best. Invalid pixels count at PAD_COORD, as in the plain version's image,
// so they never beat BIG. idx is the linear pixel v * width + u. With
// window 12 and BLOCK 16 the window always lies inside the plain version's
// clipped 3 x 3 block neighbourhood, so the two see the same candidates.
//
// What bounds it on the H100: f32 operations, 9 per in-window pixel, and
// load issue (the window's 625 pixels are read per query; the image itself,
// 13 bytes a pixel, comes once from device memory). Staging a gate's union
// window in shared memory is later work.
#include "common.cuh"

#define PROJ_THREADS 128
#define PROJ_PAD_COORD 1.0e9f
#define PROJ_BIG 3.0e13f

__global__ void __launch_bounds__(PROJ_THREADS)
projective_window_search_kernel(const float* __restrict__ q, const int32_t* __restrict__ pix,
                                const float* __restrict__ tgt,
                                const uint8_t* __restrict__ tvalid, float* __restrict__ d2_out,
                                int32_t* __restrict__ idx_out, int N, int width, int height,
                                int window, int block) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * N + n;
  const size_t n_pix = static_cast<size_t>(width) * height;
  const float* img = tgt + static_cast<size_t>(b) * n_pix * 3;
  const uint8_t* ok = tvalid + static_cast<size_t>(b) * n_pix;
  const float qx = q[row * 3], qy = q[row * 3 + 1], qz = q[row * 3 + 2];
  const int u0 = pix[row * 2], v0 = pix[row * 2 + 1];
  const int u_lo = max(u0 - window, 0), u_hi = min(u0 + window, width - 1);
  const int v_lo = max(v0 - window, 0), v_hi = min(v0 + window, height - 1);

  float best = PROJ_BIG;
  int bidx = -1;
  if (u_lo <= u_hi && v_lo <= v_hi) {
    for (int br = v_lo / block; br <= v_hi / block; ++br) {
      const int vb_lo = max(v_lo, br * block), vb_hi = min(v_hi, br * block + block - 1);
      for (int bc = u_lo / block; bc <= u_hi / block; ++bc) {
        const int ub_lo = max(u_lo, bc * block), ub_hi = min(u_hi, bc * block + block - 1);
        // No unrolling: unrolled, nvcc 12.9 at -O3 runs this runtime-bounded
        // u loop past ub_hi, up to the end of the block column, and the
        // kernel then matches pixels outside the window.
#pragma unroll 1
        for (int v = vb_lo; v <= vb_hi; ++v) {
#pragma unroll 1
          for (int u = ub_lo; u <= ub_hi; ++u) {
            const int p = v * width + u;
            const bool valid = __ldg(ok + p) != 0;
            const float tx = valid ? __ldg(img + 3 * p) : PROJ_PAD_COORD;
            const float ty = valid ? __ldg(img + 3 * p + 1) : PROJ_PAD_COORD;
            const float tz = valid ? __ldg(img + 3 * p + 2) : PROJ_PAD_COORD;
            const float d = __fadd_rn(__fadd_rn(icp_diff2(tx, qx), icp_diff2(ty, qy)),
                                      icp_diff2(tz, qz));
            if (d < best) {
              best = d;
              bidx = p;
            }
          }
        }
      }
    }
  }
  d2_out[row] = best;
  idx_out[row] = bidx;
}

extern "C" int projective_window_search_launch(const float* q, const int32_t* pix,
                                               const float* tgt, const uint8_t* tvalid,
                                               float* d2, int32_t* idx, int B, int N, int width,
                                               int height, int window, int block, void* stream) {
  if (width < 1 || height < 1 || window < 0 || block < 1) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + PROJ_THREADS - 1) / PROJ_THREADS, B);
  projective_window_search_kernel<<<grid, PROJ_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, pix, tgt, tvalid, d2, idx, N, width, height, window, block);
  return static_cast<int>(cudaGetLastError());
}
