// kd_block_search: per query, the exact nearest point among the points of
// its own top-k kd blocks, below a per-query starting bound.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py
// _make_resident_kernel in its base mode (launched by
// _run_resident_kernel_flat). On the TPU a pair's whole page table stayed
// resident in VMEM; an H100 SM has at most 227 KB of shared memory, so here
// each CTA stages one kd block at a time instead.
//
// Semantics (held against the plain version in ops/kdtree.py):
//   best = binit, idx = -1; over the query's blocks in sel order (sel < 0 =
//   no member) and their slots in ascending order, take a point whose
//   squared distance sum_j (t_j - q_j)^2 is strictly smaller than best.
//   So among equal distances the earliest sel position, then the lowest
//   slot, wins. idx is the pair-local page index block * cap_pad + slot.
//
// Layout: one CTA per (pair, gate of 32 queries), 128 threads: thread t
// serves query t % 32 over slot quarter t / 32, so the 32 threads of a warp
// read the same staged point at once (shared-memory broadcast). The CTA
// walks the union of its 32 queries' picks; each block's first D rows of
// its (8, cap_pad) page (D x 2944 f32 = 35 KB at the main path's shapes)
// are staged with 16-byte loads, and a thread skips blocks that are not
// its own query's. At the end the four quarters merge their running
// (distance, sel position, slot) lexicographically. Distances are direct
// differences rounded like the plain version (no FMA contraction).
//
// What bounds it on the H100: f32 operations, 9 per (query, member block,
// slot); the block bytes are read once per gate that needs them, from L2
// when gates of one pair share blocks.
#include "common.cuh"

#define GATE 32
#define PARTS 4

__global__ void __launch_bounds__(GATE * PARTS)
kd_block_search_kernel(const float* __restrict__ q, const int32_t* __restrict__ sel,
                       const float* __restrict__ binit, const float* __restrict__ pages,
                       float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
                       int N, int nc, int cap_pad, int k) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  __shared__ int s_sel[GATE * ICP_MAX_K];
  __shared__ int s_first[GATE * ICP_MAX_K];
  __shared__ float s_d[PARTS][GATE];
  __shared__ int s_pos[PARTS][GATE];
  __shared__ int s_blk[PARTS][GATE];
  __shared__ int s_slot[PARTS][GATE];

  const int b = blockIdx.y;
  const int g0 = blockIdx.x * GATE;
  const int lane = threadIdx.x % GATE;
  const int part = threadIdx.x / GATE;
  const int n = g0 + lane;
  const bool live = n < N;
  const size_t row = static_cast<size_t>(b) * N + n;
  const int n_ent = GATE * k;

  for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
    const int qn = g0 + e / k;
    s_sel[e] = (qn < N) ? sel[(static_cast<size_t>(b) * N + qn) * k + e % k] : -1;
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
  float best = live ? binit[row] : 0.0f;
  int bpos = -1, bblk = -1, bslot = -1;
  const int per = (cap_pad + PARTS - 1) / PARTS;
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
    if (!live) continue;
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
  for (int p = 1; p < PARTS; ++p) {
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

extern "C" int kd_block_search_launch(const float* q, const int32_t* sel, const float* binit,
                                      const float* pages, float* d2, int32_t* idx, int B,
                                      int N, int nc, int cap_pad, int k, void* stream) {
  if (k < 1 || k > ICP_MAX_K || cap_pad % 4 != 0) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(D) * cap_pad * sizeof(float);
  const dim3 grid((N + GATE - 1) / GATE, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = icp_allow_smem(kd_block_search_kernel, smem);
  if (err != cudaSuccess) return err;
  kd_block_search_kernel<<<grid, GATE * PARTS, smem, s>>>(q, sel, binit, pages, d2, idx, N, nc,
                                                          cap_pad, k);
  return static_cast<int>(cudaGetLastError());
}
