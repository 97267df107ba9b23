// kd_radius_search: per query, the exact nearest point strictly below its
// own radius among the points of its member kd blocks, for page tables of
// any size.
//
// Replaces the TPU kernel icp_variants_tpu/ops/knn.py _make_bitmap_kernel
// (launched by _run_bitmap_kernel_flat): the warm-start radius search that
// the JAX package runs on tables past its resident VMEM rule. That kernel
// compacted hot/cold code rows with quantized bounds on the scalar core and
// double-buffered page DMAs between VMEM and HBM; none of it carries over.
//
// Semantics (held against the plain version in ops/knn.py bit for bit):
// a row's members are its picks in `sel` (B, N, k) when given (box_topk's
// top-k at the row's radius, -1 = none, ids past nc - 1 clipped to nc - 1),
// else (k = 0) every block whose squared box lower bound
//   lb = sum_j max(max(bmin_j - q_j, q_j - bmax_j), 0)^2
// is <= the row's radius. Over the members' points, d2 = sum_j (t_j - q_j)^2
// (direct differences, rounded step by step); the answer is the smallest d2
// strictly below the radius, ties to the lowest pair-local page index
// block * cap_pad + slot whatever the walk order. A row with a negative
// radius is frozen; a frozen row, or one where nothing beats its radius,
// returns idx -1 and d2 = its radius.
//
// Layout: one CTA of ICP_GATE * ICP_PARTS threads per gate of 32 query rows
// of one pair, grid (ceil(N/32), B); thread t serves row t % 32 over slot
// part t / 32. The CTA lists the gate's member-block union in shared memory
// with each block's gate-minimum lb over the rows that hold it, sorted by
// (gate-minimum lb, block id): blocks that contain a row's query (lb = 0)
// come first, then the rest in ascending bound. It walks the list once: a
// block whose gate-minimum lb exceeds the largest running best of the
// gate's live rows ends the walk (every later block is farther, and running
// bests only shrink: exact); otherwise the block's first D page rows are
// staged in shared memory (D x cap_pad f32) and each thread scores its
// part of them where the block is one of its row's members and its row's
// own lb is <= the row's running best. At the end the parts merge their
// (distance, page index) pairs lexicographically.
//
// What bounds it on the H100: f32 operations, 3D per (query, needed block,
// slot), and the page bytes of the needed blocks; the pages of a gate's
// union are staged once per gate (read from L2 when gates share them).
// Nothing here overlaps the staging with the scoring yet.
#include "common.cuh"

#define RS_MAX_NC 1024  // largest block count per pair the list holds

// Squared box lower bound of query `qv` to block `c` of this pair's boxes,
// rounded like the plain version (knn.box_lb).
template <int D>
__device__ __forceinline__ float rs_box_lb(const float* qv, const float* __restrict__ bmin,
                                           const float* __restrict__ bmax, size_t box_off) {
  float lb = icp_gap2(qv[0], bmin[box_off], bmax[box_off]);
#pragma unroll
  for (int j = 1; j < D; ++j) lb = __fadd_rn(lb, icp_gap2(qv[j], bmin[box_off + j], bmax[box_off + j]));
  return lb;
}

template <int D>
__global__ void __launch_bounds__(ICP_GATE * ICP_PARTS)
kd_radius_search_kernel(const float* __restrict__ q, const float* __restrict__ binit,
                        const float* __restrict__ bmin, const float* __restrict__ bmax,
                        const float* __restrict__ pages, const int32_t* __restrict__ sel,
                        float* __restrict__ d2_out, int32_t* __restrict__ idx_out,
                        int N, int nc, int cap_pad, int k) {
  extern __shared__ float4 tile4[];
  const float* tile = reinterpret_cast<const float*>(tile4);
  __shared__ float s_q[ICP_GATE * D];
  __shared__ float s_r[ICP_GATE];          // radius per row; -1 for rows past N
  __shared__ int s_sel[ICP_GATE * ICP_MAX_K];
  __shared__ float s_elb[ICP_GATE * ICP_MAX_K];
  __shared__ int s_cand[RS_MAX_NC];         // member union, unordered
  __shared__ float s_cand_lb[RS_MAX_NC];
  __shared__ int s_list[RS_MAX_NC];         // member union in walk order
  __shared__ float s_list_lb[RS_MAX_NC];
  __shared__ int s_count;
  __shared__ float s_rowbest[ICP_GATE];
  __shared__ float s_wb;                    // largest running best of the live rows
  __shared__ float s_d[ICP_PARTS][ICP_GATE];
  __shared__ int s_i[ICP_PARTS][ICP_GATE];

  const int b = blockIdx.y;
  const int g0 = blockIdx.x * ICP_GATE;
  const int lane = threadIdx.x % ICP_GATE;
  const int part = threadIdx.x / ICP_GATE;
  const int n = g0 + lane;
  const bool in_range = n < N;
  const size_t row = static_cast<size_t>(b) * N + n;
  const size_t box_base = static_cast<size_t>(b) * nc * D;

  if (threadIdx.x < ICP_GATE) s_r[lane] = in_range ? binit[row] : -1.0f;
  for (int e = threadIdx.x; e < ICP_GATE * D; e += blockDim.x) {
    const int qn = g0 + e / D;
    s_q[e] = (qn < N) ? q[(static_cast<size_t>(b) * N + qn) * D + e % D] : 0.0f;
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();

  // ---- the gate's member union with its gate-minimum bounds ---------------
  if (k > 0) {
    const int n_ent = ICP_GATE * k;
    for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
      const int r = e / k;
      const int qn = g0 + r;
      int v = (qn < N) ? sel[(static_cast<size_t>(b) * N + qn) * k + e % k] : -1;
      v = v < 0 ? -1 : min(v, nc - 1);
      float lb = INFINITY;
      if (v >= 0) lb = rs_box_lb<D>(&s_q[r * D], bmin, bmax, box_base + static_cast<size_t>(v) * D);
      // A pick beyond its row's radius (or of a frozen row) is no member.
      if (v >= 0 && !(lb <= s_r[r])) v = -1;
      s_sel[e] = v;
      s_elb[e] = lb;
    }
    __syncthreads();
#pragma unroll 1
    for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
      const int blk = s_sel[e];
      if (blk < 0) continue;
      bool first = true;
      float glb = s_elb[e];
#pragma unroll 1
      for (int f = 0; f < n_ent; ++f) {
        if (s_sel[f] != blk) continue;
        if (f < e) first = false;
        glb = fminf(glb, s_elb[f]);
      }
      if (first) {
        const int slot = atomicAdd(&s_count, 1);
        s_cand[slot] = blk;
        s_cand_lb[slot] = glb;
      }
    }
  } else {
#pragma unroll 1
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
      float lo[D], hi[D];
      const size_t off = box_base + static_cast<size_t>(c) * D;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        lo[j] = bmin[off + j];
        hi[j] = bmax[off + j];
      }
      float glb = INFINITY;
      bool member = false;
#pragma unroll 1
      for (int r = 0; r < ICP_GATE; ++r) {
        const float* qv = &s_q[r * D];
        float lb = icp_gap2(qv[0], lo[0], hi[0]);
#pragma unroll
        for (int j = 1; j < D; ++j) lb = __fadd_rn(lb, icp_gap2(qv[j], lo[j], hi[j]));
        if (lb <= s_r[r]) {
          member = true;
          glb = fminf(glb, lb);
        }
      }
      if (member) {
        const int slot = atomicAdd(&s_count, 1);
        s_cand[slot] = c;
        s_cand_lb[slot] = glb;
      }
    }
  }
  __syncthreads();
  const int count = s_count;

  // ---- walk order: ascending (gate-minimum lb, block id) ------------------
#pragma unroll 1
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const float le = s_cand_lb[e];
    const int ce = s_cand[e];
    int rank = 0;
#pragma unroll 1
    for (int f = 0; f < count; ++f) {
      const float lf = s_cand_lb[f];
      rank += (lf < le) || (lf == le && s_cand[f] < ce);
    }
    s_list[rank] = ce;
    s_list_lb[rank] = le;
  }

  // ---- the walk -------------------------------------------------------------
  float qv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) qv[j] = s_q[lane * D + j];
  const float radius = s_r[lane];
  const bool live = in_range && radius >= 0.0f;
  float best = radius;
  int bidx = -1;
  const int per = (cap_pad + ICP_PARTS - 1) / ICP_PARTS;
  const int s_lo = part * per;
  const int s_hi = min(cap_pad, s_lo + per);
  const int n4 = D * cap_pad / 4;
  if (threadIdx.x < ICP_GATE) s_rowbest[lane] = radius;
  if (threadIdx.x < 32) {
    float v = live ? radius : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x == 0) s_wb = v;
  }

#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    __syncthreads();  // s_wb / s_rowbest updated; the previous block no longer read
    if (s_list_lb[i] > s_wb) break;  // uniform across the CTA
    const int blk = s_list[i];
    const float4* src = reinterpret_cast<const float4*>(
        pages + (static_cast<size_t>(b) * nc + blk) * 8 * cap_pad);
    for (int t = threadIdx.x; t < n4; t += blockDim.x) tile4[t] = src[t];
    __syncthreads();
    if (live) {
      bool member = (k == 0);
#pragma unroll 1
      for (int p = 0; p < k; ++p) member |= (s_sel[lane * k + p] == blk);
      if (member) {
        const float lb = rs_box_lb<D>(qv, bmin, bmax, box_base + static_cast<size_t>(blk) * D);
        if (lb <= s_rowbest[lane]) {
          const int base = blk * cap_pad;
          for (int s = s_lo; s < s_hi; ++s) {
            float d = icp_diff2(tile[s], qv[0]);
#pragma unroll
            for (int j = 1; j < D; ++j) d = __fadd_rn(d, icp_diff2(tile[j * cap_pad + s], qv[j]));
            if (d < best || (d == best && bidx >= 0 && base + s < bidx)) {
              best = d;
              bidx = base + s;
            }
          }
        }
      }
    }
    s_d[part][lane] = best;
    __syncthreads();
    if (threadIdx.x < 32) {
      float rb = s_d[0][lane];
#pragma unroll
      for (int p = 1; p < ICP_PARTS; ++p) rb = fminf(rb, s_d[p][lane]);
      s_rowbest[lane] = rb;
      float v = live ? rb : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (threadIdx.x == 0) s_wb = v;
    }
  }

  __syncthreads();
  s_d[part][lane] = best;
  s_i[part][lane] = bidx;
  __syncthreads();
  if (part != 0 || !in_range) return;
  for (int p = 1; p < ICP_PARTS; ++p) {
    const int pi = s_i[p][lane];
    if (pi < 0) continue;
    const float pd = s_d[p][lane];
    if (bidx < 0 || pd < best || (pd == best && pi < bidx)) {
      best = pd;
      bidx = pi;
    }
  }
  d2_out[row] = bidx >= 0 ? best : radius;
  idx_out[row] = bidx;
}

template <int D>
static cudaError_t launch(const float* q, const float* binit, const float* bmin,
                          const float* bmax, const float* pages, const int32_t* sel, float* d2,
                          int32_t* idx, int B, int N, int nc, int cap_pad, int k, cudaStream_t s) {
  const size_t smem = icp_gate_smem<D>(cap_pad);
  cudaError_t err = icp_allow_smem(kd_radius_search_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + ICP_GATE - 1) / ICP_GATE, B);
  kd_radius_search_kernel<D><<<grid, ICP_GATE * ICP_PARTS, smem, s>>>(
      q, binit, bmin, bmax, pages, sel, d2, idx, N, nc, cap_pad, k);
  return cudaGetLastError();
}

extern "C" int kd_radius_search_launch(const float* q, const float* binit, const float* bmin,
                                       const float* bmax, const float* pages, const int32_t* sel,
                                       float* d2, int32_t* idx, int B, int N, int nc,
                                       int cap_pad, int k, int D, void* stream) {
  if (k < 0 || k > ICP_MAX_K || (k > 0) != (sel != nullptr)) return cudaErrorInvalidValue;
  if (nc < 1 || nc > RS_MAX_NC || cap_pad % 4 != 0) return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  return static_cast<int>(ICP_DISPATCH_D(D, launch, q, binit, bmin, bmax, pages, sel, d2, idx,
                                         B, N, nc, cap_pad, k,
                                         static_cast<cudaStream_t>(stream)));
}
