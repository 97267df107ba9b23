// normal_equations: the 6 x 6 normal equations ata, atb of the linear
// point-to-plane and symmetric solvers (solvers/linear.py), one launch an
// iteration.
//
// Replaces no TPU kernel: the JAX package leaves these sums to XLA as an
// einsum. Before this kernel the port built four (B, N, 6) Jacobians an
// iteration (the plane or symmetric row and the three point rows) and gave
// each to a batched cuBLAS product wJ^T J with M = N = 6 and K = N rows: one
// CTA a pair walking K in order (8 CTAs at the colour tracker's 8 x 307,200
// rows), about 28 ms an iteration for bytes that take about 30 us, plus some
// 70 launches of column stacks and elementwise products around it.
//
// Semantics (held against solvers/linear._accumulate_normal_equations_soa
// on the same rows, and against a float64 sum, within f32 sum order): for
// each row r of pair b, with w = weights * valid, s = src - c_src and
// d = tgt - c_tgt,
//   PLANE:     a = [n x s ; n] with n the target normal, its non-finite
//              components zeroed, rhs = n.d - n.s, weight
//              lambda_row * w * finite(n);
//   SYMMETRIC: a = [(s + d) x (ns + nt) ; ns + nt], rhs = (d - s).(ns + nt),
//              weight lambda_row * w * finite(ns) * finite(nt);
// and the three small-angle point rows of M s + t = d, rhs d - s, at weight
// lambda_point * w. With q = weight^2: ata += (q a_i) a_j, atb += (q a_i) rhs,
// in the plain version's order of products (its wJ = q J). The point rows'
// structural zeros are not formed. Every product and sum is rounded on its
// own (-fmad=false), so the two versions differ only in the order of the
// sums over rows.
//
// What bounds it on the H100: device memory. A row reads 12 B of source
// points, 24 B of target points and normals (12 more of source normals for
// SYMMETRIC), 4 B of weight and 1 B of valid: about 41 / 53 B for about 160
// f32 operations, under 4 operations a byte against the card's ~20.
//
// Layout: NE_THREADS threads a CTA, one CTA a (chunk, pair): `chunk_rows`
// consecutive rows of one pair, a multiple of NE_THREADS that the wrapper
// chooses from N alone (at most 2,048, so B x chunks fills the card at the
// main path's shapes). Thread t sums rows t, t + NE_THREADS, ... of its
// chunk, adjacent rows on adjacent lanes, into 27 registers: ata's upper
// triangle by rows (21), then atb (6). The CTA adds its threads by a
// warp-shuffle tree and then its warps in order through shared memory, and
// writes the 27 sums to the workspace. The pair's last CTA to finish (an int
// counter a pair, which that CTA sets back to 0) adds the pair's chunk sums
// by the same tree, each thread a fixed set of chunks, and writes ata (both
// triangles) and atb. Every sum's order is fixed by (N, chunk_rows): no float
// atomics, two launches give the same bits, and a pair's answer does not
// depend on the batch it is in.
#include "common.cuh"

#define NE_THREADS 256
#define NE_WARPS (NE_THREADS / 32)
#define NE_SUMS 27  // ata's upper triangle (21), then atb (6)
#define NE_ATB 21
#define NE_FULL 0xffffffffu

enum NeMetric { NE_PLANE = 0, NE_SYMMETRIC = 1 };

struct NeArgs {
  // (B, N, 3) rows; strides in floats (the last axis contiguous).
  const float* src;
  const float* tgt;
  const float* tnrm;
  const float* snrm;  // SYMMETRIC only
  long long src_b, src_n, tgt_b, tgt_n, tnrm_b, tnrm_n, snrm_b, snrm_n;
  const float* w;         // (B, N)
  const uint8_t* valid;   // (B, N) bool
  const float* c_src;     // (B, 3)
  const float* c_tgt;     // (B, 3)
  float* partials;        // (B, chunks, NE_SUMS) workspace
  int* counters;          // (B,) all 0 between launches
  float* ata;             // (B, 6, 6)
  float* atb;             // (B, 6)
  int N, chunk_rows, chunks;
  float lambda_row, lambda_point;
};

// Slot of ata[i][j], i <= j, in the upper triangle by rows.
__host__ __device__ constexpr int ne_ut(int i, int j) { return i * 6 - i * (i - 1) / 2 + j - i; }

// acc += (q a_i) a_j and (q a_i) rhs over the entries a_i that bit i of NZ
// marks as possibly nonzero (the others are zeros of the row's structure).
template <int NZ>
__device__ __forceinline__ void ne_add_row(float (&acc)[NE_SUMS], const float (&a)[6], float rhs,
                                           float q) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    if (!((NZ >> i) & 1)) continue;
    const float qa = __fmul_rn(q, a[i]);
#pragma unroll
    for (int j = i; j < 6; ++j) {
      if ((NZ >> j) & 1) acc[ne_ut(i, j)] = __fadd_rn(acc[ne_ut(i, j)], __fmul_rn(qa, a[j]));
    }
    acc[NE_ATB + i] = __fadd_rn(acc[NE_ATB + i], __fmul_rn(qa, rhs));
  }
}

// x with its non-finite value zeroed; `finite` cleared where it was not finite.
__device__ __forceinline__ float ne_finite_or_zero(float x, bool& finite) {
  const bool f = isfinite(x);
  finite = finite && f;
  return f ? x : 0.0f;
}

// The CTA's sum of every thread's acc: a shuffle tree in each warp, then the
// warps in order. The result is in thread k's return value for k < NE_SUMS.
__device__ __forceinline__ float ne_block_sum(float (&acc)[NE_SUMS],
                                              float (&warp_sums)[NE_WARPS][NE_SUMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NE_SUMS; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(NE_FULL, acc[k], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NE_SUMS; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < NE_SUMS) {
    s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int v = 1; v < NE_WARPS; ++v) s = __fadd_rn(s, warp_sums[v][threadIdx.x]);
  }
  return s;
}

template <int METRIC>
__global__ void __launch_bounds__(NE_THREADS) normal_equations_kernel(const NeArgs p) {
  __shared__ float warp_sums[NE_WARPS][NE_SUMS];
  __shared__ bool last;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int start = chunk * p.chunk_rows;
  const int end = min(start + p.chunk_rows, p.N);
  const float* src = p.src + b * p.src_b;
  const float* tgt = p.tgt + b * p.tgt_b;
  const float* tnrm = p.tnrm + b * p.tnrm_b;
  const float* snrm = METRIC == NE_SYMMETRIC ? p.snrm + b * p.snrm_b : nullptr;
  const float* w = p.w + static_cast<long long>(b) * p.N;
  const uint8_t* valid = p.valid + static_cast<long long>(b) * p.N;
  float cs[3], ct[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cs[k] = p.c_src[3 * b + k];
    ct[k] = p.c_tgt[3 * b + k];
  }

  float acc[NE_SUMS];
#pragma unroll
  for (int k = 0; k < NE_SUMS; ++k) acc[k] = 0.0f;

#pragma unroll 2
  for (int r = start + threadIdx.x; r < end; r += NE_THREADS) {
    const float wr = __fmul_rn(__ldg(w + r), __ldg(valid + r) ? 1.0f : 0.0f);
    float s[3], d[3], a[6], rhs;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[k] = __fsub_rn(__ldg(src + r * p.src_n + k), cs[k]);
      d[k] = __fsub_rn(__ldg(tgt + r * p.tgt_n + k), ct[k]);
    }
    if (METRIC == NE_PLANE) {
      float n[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        n[k] = ne_finite_or_zero(__ldg(tnrm + r * p.tnrm_n + k), finite);
      }
      a[0] = __fsub_rn(__fmul_rn(n[2], s[1]), __fmul_rn(n[1], s[2]));
      a[1] = __fsub_rn(__fmul_rn(n[0], s[2]), __fmul_rn(n[2], s[0]));
      a[2] = __fsub_rn(__fmul_rn(n[1], s[0]), __fmul_rn(n[0], s[1]));
      a[3] = n[0];
      a[4] = n[1];
      a[5] = n[2];
      const float nd = __fadd_rn(__fadd_rn(__fmul_rn(n[0], d[0]), __fmul_rn(n[1], d[1])),
                                 __fmul_rn(n[2], d[2]));
      const float ns = __fadd_rn(__fadd_rn(__fmul_rn(n[0], s[0]), __fmul_rn(n[1], s[1])),
                                 __fmul_rn(n[2], s[2]));
      rhs = __fsub_rn(nd, ns);
    } else {
      float n[3], sd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float ns = ne_finite_or_zero(__ldg(snrm + r * p.snrm_n + k), finite);
        const float nt = ne_finite_or_zero(__ldg(tnrm + r * p.tnrm_n + k), finite);
        n[k] = __fadd_rn(ns, nt);
        sd[k] = __fadd_rn(s[k], d[k]);
      }
      a[0] = __fsub_rn(__fmul_rn(sd[1], n[2]), __fmul_rn(sd[2], n[1]));
      a[1] = __fsub_rn(__fmul_rn(sd[2], n[0]), __fmul_rn(sd[0], n[2]));
      a[2] = __fsub_rn(__fmul_rn(sd[0], n[1]), __fmul_rn(sd[1], n[0]));
      a[3] = n[0];
      a[4] = n[1];
      a[5] = n[2];
      rhs = __fadd_rn(__fadd_rn(__fmul_rn(__fsub_rn(d[0], s[0]), n[0]),
                                __fmul_rn(__fsub_rn(d[1], s[1]), n[1])),
                      __fmul_rn(__fsub_rn(d[2], s[2]), n[2]));
    }
    const float wrow = __fmul_rn(__fmul_rn(p.lambda_row, wr), finite ? 1.0f : 0.0f);
    ne_add_row<0x3f>(acc, a, rhs, __fmul_rn(wrow, wrow));

    // The point rows: [0, s2, -s1, 1, 0, 0], [-s2, 0, s0, 0, 1, 0],
    // [s1, -s0, 0, 0, 0, 1] against d - s.
    const float wp = __fmul_rn(p.lambda_point, wr);
    const float qp = __fmul_rn(wp, wp);
    const float r0[6] = {0.0f, s[2], -s[1], 1.0f, 0.0f, 0.0f};
    const float r1[6] = {-s[2], 0.0f, s[0], 0.0f, 1.0f, 0.0f};
    const float r2[6] = {s[1], -s[0], 0.0f, 0.0f, 0.0f, 1.0f};
    ne_add_row<0x0e>(acc, r0, __fsub_rn(d[0], s[0]), qp);
    ne_add_row<0x15>(acc, r1, __fsub_rn(d[1], s[1]), qp);
    ne_add_row<0x23>(acc, r2, __fsub_rn(d[2], s[2]), qp);
  }

  const float chunk_sum = ne_block_sum(acc, warp_sums);
  float* part = p.partials + static_cast<long long>(b) * p.chunks * NE_SUMS;
  if (threadIdx.x < NE_SUMS) part[chunk * NE_SUMS + threadIdx.x] = chunk_sum;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&p.counters[b], 1) == p.chunks - 1;
  __syncthreads();
  if (!last) return;

  // The pair's last CTA: every chunk's sums are written and visible.
  __threadfence();
#pragma unroll
  for (int k = 0; k < NE_SUMS; ++k) acc[k] = 0.0f;
  for (int c = threadIdx.x; c < p.chunks; c += NE_THREADS) {
#pragma unroll
    for (int k = 0; k < NE_SUMS; ++k) acc[k] = __fadd_rn(acc[k], __ldcg(part + c * NE_SUMS + k));
  }
  const float total = ne_block_sum(acc, warp_sums);
  const int t = threadIdx.x;
  if (t < NE_ATB) {
    int i = 0, j = t;
    while (j >= 6 - i) {
      j -= 6 - i;
      ++i;
    }
    j += i;
    p.ata[b * 36 + i * 6 + j] = total;
    p.ata[b * 36 + j * 6 + i] = total;
  } else if (t < NE_SUMS) {
    p.atb[b * 6 + t - NE_ATB] = total;
  }
  if (t == 0) p.counters[b] = 0;
}

extern "C" int normal_equations_launch(const float* src, const float* tgt, const float* tnrm,
                                       const float* snrm, long long src_b, long long src_n,
                                       long long tgt_b, long long tgt_n, long long tnrm_b,
                                       long long tnrm_n, long long snrm_b, long long snrm_n,
                                       const float* w, const uint8_t* valid, const float* c_src,
                                       const float* c_tgt, float* partials, int* counters,
                                       float* ata, float* atb, int B, int N, int chunk_rows,
                                       float lambda_row, float lambda_point, int metric,
                                       void* stream) {
  if (B < 0 || B > 65535 || N < 0 || chunk_rows < NE_THREADS || chunk_rows % NE_THREADS != 0)
    return cudaErrorInvalidValue;
  if (metric != NE_PLANE && metric != NE_SYMMETRIC) return cudaErrorInvalidValue;
  if (metric == NE_SYMMETRIC && snrm == nullptr) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  NeArgs p;
  p.src = src;
  p.tgt = tgt;
  p.tnrm = tnrm;
  p.snrm = snrm;
  p.src_b = src_b;
  p.src_n = src_n;
  p.tgt_b = tgt_b;
  p.tgt_n = tgt_n;
  p.tnrm_b = tnrm_b;
  p.tnrm_n = tnrm_n;
  p.snrm_b = snrm_b;
  p.snrm_n = snrm_n;
  p.w = w;
  p.valid = valid;
  p.c_src = c_src;
  p.c_tgt = c_tgt;
  p.partials = partials;
  p.counters = counters;
  p.ata = ata;
  p.atb = atb;
  p.N = N;
  p.chunk_rows = chunk_rows;
  p.lambda_row = lambda_row;
  p.lambda_point = lambda_point;
  // At least one CTA a pair, so N = 0 writes zeros.
  p.chunks = N == 0 ? 1 : (N + chunk_rows - 1) / chunk_rows;
  const dim3 grid(p.chunks, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (metric == NE_PLANE) {
    normal_equations_kernel<NE_PLANE><<<grid, NE_THREADS, 0, s>>>(p);
  } else {
    normal_equations_kernel<NE_SYMMETRIC><<<grid, NE_THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
