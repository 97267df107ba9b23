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
//   block. The masks and spans only gated VMEM walks; here the rows are
//   bucketed by (pair, block) instead (the cached prefix's job) and each
//   bucket's rows are scored against their own block only (restrict_col).
//
// With a pose ((B, 16) f32; null = none) the kernel also replaces row 2's
// transform_pose mode (icp_variants_tpu/ops/knn.py _make_resident_kernel,
// transform_pose=True; entry nn_search_kd_cached(pose=)): the queries are
// raw source features, and each row's spatial columns are moved by the
// pair's pose as the walk loads the row, 15 operations a row.
//
// Semantics (held against kdtree.nn_search_kd_cached_oracle): blk < 0
// searches nothing (idx -1, d2 = bound); otherwise the lowest slot of the
// smallest squared distance in block blk, if strictly below `bound`, as the
// pair-local page index blk * cap_pad + slot; else idx -1, d2 = bound. Ids
// past nc - 1 are clipped to nc - 1, as the JAX package clips them.
//
// Layout: seeded membership is kd_block_search with k = 1 from a constant
// start, so this entry runs block_major.cuh's five launches (bin, scan,
// scatter, walk, out) with `sel` = blk, k = 1, a null binit and `bound` as
// binit_value. At k = 1 the merge key (d2 bits << 32) | (1 << 27) | slot
// orders by (d2, slot): the lowest slot of the least d2, and a d2 equal to
// the bound never wins. A second entry in kd_block_search.cu would have
// served too; the header keeps this file the one that maps to TPU kernels
// 2c + 4, with its own kernel names (cached_block_search_*) in a profile.
// The chunk and queries per thread are KdbShape<D, true>'s: at colour
// checks16's 256 blocks a bucket holds a block's ~1,200 seeded rows, and
// chunks of 256 entries at one query a thread (five CTAs a bucket, 40
// registers against 58, more CTAs an SM) read 2.11-2.19 ms against
// 2.17-2.34 for the kd search's 512 x 2 over two calls
// (scripts/kd_variants.py, PERF.md).
//
// The gate-major layout this replaces (one CTA per 32 rows staging each of
// the gate's ~3 distinct blocks, a thread scoring only its own row) was
// bound by staging: each 30 KB page served about 11 rows. Block-major, a
// staged page serves up to 256 rows and every lane works on a live row.
//
// What bounds it on the H100: f32 operations, 3D per (row, slot of its
// block) (3 x 3 per slot at D = 6 where the spatial partial sum already
// loses), and reading each (pair, block) page once per chunk from L2.
#define BM_KERNEL(part) cached_block_search_##part
#include "block_major.cuh"

template <int D>
static cudaError_t launch(const float* q, const int32_t* blk, const float* pose, float bound,
                          const float* pages, float* d2, int32_t* idx, void* ws, int B, int N,
                          int nc, int cap_pad, cudaStream_t s) {
  return pose != nullptr
             ? block_major_launch<D, false, true, true>(q, pose, blk, nullptr, bound, pages, d2,
                                                        idx, ws, B, N, nc, cap_pad, 1, nullptr, s)
             : block_major_launch<D, false, true, false>(q, nullptr, blk, nullptr, bound, pages,
                                                         d2, idx, ws, B, N, nc, cap_pad, 1,
                                                         nullptr, s);
}

// pose: null, or (B, 16) f32 (the transform_pose mode: q holds raw features).
// ws: ws_bytes of scratch, at least block_major.cuh's workspace_layout at
// k = 1 (ops/kdtree.py _block_search_workspace_bytes(B, N, nc, 1)).
extern "C" int cached_block_search_launch(const float* q, const int32_t* blk, const float* pose,
                                          float bound, const float* pages, float* d2,
                                          int32_t* idx, void* ws, long long ws_bytes, int B,
                                          int N, int nc, int cap_pad, int D, void* stream) {
  bool empty;
  cudaError_t err = block_major_check(pages, ws_bytes, B, N, nc, cap_pad, 1, &empty);
  if (err != cudaSuccess || empty) return static_cast<int>(err);
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, blk, pose, bound, pages, d2, idx, ws, B,
                                         N, nc, cap_pad, static_cast<cudaStream_t>(stream)));
}
