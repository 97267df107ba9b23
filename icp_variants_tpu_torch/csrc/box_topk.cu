// box_topk: per query, the k kd blocks with the smallest squared box lower
// bound, and the certificate residual (the (k+1)-th smallest bound).
//
// Replaces the TPU kernel icp_variants_tpu/ops/kdtree.py
// _make_prefix_kernel (launched by _radius_prefix). That kernel also
// emitted per-tile member/hot/min-lb rows, per-8-row subgroup bit words and
// per-gate block spans; those gated the TPU search kernel's VMEM walks and
// are not needed here: the block search reads each query's picks directly.
//
// Semantics (held against the plain version in ops/kdtree.py bit for bit):
//   lb[c]  = sum_j max(max(bmin[c,j] - q_j, q_j - bmax[c,j]), 0)^2,
//            feature 0 first, every product and sum rounded on its own;
//   k rounds of argmin over lb with already-picked blocks set to +inf,
//   lowest block index on ties (torch.argmin's rule);
//   sel[r] = pick r if lb[pick r] <= binit else -1 (no member);
//   resid  = min of lb over the blocks left after k rounds.
// The k rounds are the first k entries of the blocks of finite bound in
// (lb, block) order. Where fewer than k blocks have a finite bound, every
// later round sees +inf everywhere and argmin picks block 0 (possibly a
// block already picked): its sel is then 0 wherever lb[0] <= binit, and
// resid is +inf.
//
// Layout: one pass. One thread per query, 256 queries per CTA, grid
// (ceil(N/256), B). The pair's block boxes sit in shared memory packed so
// that one block's bounds are 2 * ceil(D/4) float4 (min then max, padded):
// two LDS.128 at D = 3, four at D = 6, read by every thread of a warp at
// once (broadcast). Each thread computes each block's bound once and keeps
// the KT + 1 smallest (bound, block) pairs sorted in registers (KT, a
// template argument, the least power of two >= k; so every index into the
// list is known at compile time and it never leaves registers). A block
// enters only on a strict < against the list's last entry and lands after
// every entry of equal bound, so among equal bounds the lower block index
// stays first.
//
// What bounds it on the H100: f32 issue, about 6D (sub, max, mul, add) + 1
// compare per (query, block): some 20 instructions per (query, block) at
// D = 3, 37 at D = 6; the insertion runs only when a block beats the list's
// last entry. The bytes (the queries, binit, sel and resid once) are far
// below that at every shape of the main paths.
#include "common.cuh"

#define BOX_THREADS 256

// One block's squared lower bound from its packed bounds in shared memory.
template <int D>
__device__ __forceinline__ float box_lb(const float4* __restrict__ box, const float (&qv)[D]) {
  constexpr int NV = (D + 3) / 4;
  float mn[4 * NV], mx[4 * NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 a = box[v], b = box[NV + v];
    mn[4 * v] = a.x, mn[4 * v + 1] = a.y, mn[4 * v + 2] = a.z, mn[4 * v + 3] = a.w;
    mx[4 * v] = b.x, mx[4 * v + 1] = b.y, mx[4 * v + 2] = b.z, mx[4 * v + 3] = b.w;
  }
  float lb = icp_gap2(qv[0], mn[0], mx[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) lb = __fadd_rn(lb, icp_gap2(qv[j], mn[j], mx[j]));
  return lb;
}

// Insert (v, c) into the sorted list, given v < lbs[KT] (a strict <, so a
// later block of equal bound never displaces an earlier one): it goes before
// the first strictly larger entry, and every entry from there on moves down
// one place; the last one drops out.
template <int KT>
__device__ __forceinline__ void topk_insert(float (&lbs)[KT + 1], int (&ids)[KT + 1], float v,
                                            int c) {
  bool moved = false;
#pragma unroll
  for (int i = 0; i <= KT; ++i) {
    const bool s = moved || v < lbs[i];
    const float tv = lbs[i];
    const int ti = ids[i];
    if (s) lbs[i] = v, ids[i] = c, v = tv, c = ti;
    moved = s;
  }
}

template <int D, int KT>
__global__ void __launch_bounds__(BOX_THREADS)
box_topk_kernel(const float* __restrict__ q, const float* __restrict__ binit,
                const float* __restrict__ bmin, const float* __restrict__ bmax,
                int32_t* __restrict__ sel, float* __restrict__ resid, int N, int nc, int k) {
  constexpr int NV = (D + 3) / 4;   // float4 per bound
  extern __shared__ float4 sbox[];  // nc x (NV mins, NV maxs)
  float* sf = reinterpret_cast<float*>(sbox);
  const int b = blockIdx.y;
  const float* gmin = bmin + static_cast<size_t>(b) * nc * D;
  const float* gmax = bmax + static_cast<size_t>(b) * nc * D;
  for (int i = threadIdx.x; i < nc * 8 * NV; i += blockDim.x) {
    const int c = i / (8 * NV), r = i % (8 * NV), j = r % (4 * NV);
    sf[i] = j < D ? (r < 4 * NV ? gmin : gmax)[c * D + j] : 0.0f;
  }
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t row = static_cast<size_t>(b) * N + n;
  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = q[row * D + j];

  float lbs[KT + 1];
  int ids[KT + 1];
#pragma unroll
  for (int i = 0; i <= KT; ++i) lbs[i] = INFINITY, ids[i] = -1;
  const float lb0 = box_lb<D>(sbox, qv);
  topk_insert<KT>(lbs, ids, lb0, 0);
  for (int c = 1; c < nc; ++c) {
    const float lb = box_lb<D>(sbox + c * 2 * NV, qv);
    if (lb < lbs[KT]) topk_insert<KT>(lbs, ids, lb, c);
  }

  const float radius = binit[row];
  float res = lbs[KT];
#pragma unroll
  for (int r = 0; r < KT; ++r) {
    if (r >= k) {
      if (r == k) res = lbs[r];
      continue;
    }
    const bool real = ids[r] >= 0;  // else every bound left is +inf: argmin is block 0
    const int pick = real ? ids[r] : 0;
    const float plb = real ? lbs[r] : lb0;
    sel[row * k + r] = plb <= radius ? pick : -1;
  }
  resid[row] = res;
}

template <int D, int KT>
static cudaError_t launch_k(const float* q, const float* binit, const float* bmin,
                            const float* bmax, int32_t* sel, float* resid, int B, int N, int nc,
                            int k, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(nc) * 2 * ((D + 3) / 4) * sizeof(float4);
  cudaError_t err = icp_allow_smem(box_topk_kernel<D, KT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BOX_THREADS - 1) / BOX_THREADS, B);
  box_topk_kernel<D, KT><<<grid, BOX_THREADS, smem, s>>>(q, binit, bmin, bmax, sel, resid, N,
                                                         nc, k);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch(const float* q, const float* binit, const float* bmin,
                          const float* bmax, int32_t* sel, float* resid, int B, int N, int nc,
                          int k, cudaStream_t s) {
  static_assert(ICP_MAX_K == 16, "the list sizes below cover k <= 16");
  if (k == 1) return launch_k<D, 1>(q, binit, bmin, bmax, sel, resid, B, N, nc, k, s);
  if (k == 2) return launch_k<D, 2>(q, binit, bmin, bmax, sel, resid, B, N, nc, k, s);
  if (k <= 4) return launch_k<D, 4>(q, binit, bmin, bmax, sel, resid, B, N, nc, k, s);
  if (k <= 8) return launch_k<D, 8>(q, binit, bmin, bmax, sel, resid, B, N, nc, k, s);
  return launch_k<D, 16>(q, binit, bmin, bmax, sel, resid, B, N, nc, k, s);
}

extern "C" int box_topk_launch(const float* q, const float* binit, const float* bmin,
                               const float* bmax, int32_t* sel, float* resid, int B,
                               int N, int nc, int k, int D, void* stream) {
  if (k < 1 || k > ICP_MAX_K || k > nc) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, binit, bmin, bmax, sel, resid, B, N, nc,
                                         k, static_cast<cudaStream_t>(stream)));
}
