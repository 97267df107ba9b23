// pose_step: the tail of the linear point-to-plane, symmetric and GICP
// solvers (solvers/linear.py), one launch an iteration after their normal
// equations: the 6 x 6 solve and the increment's recovery.
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA. Before
// this kernel the port ran it as some 50-70 small PyTorch ops an iteration
// (the diagonal term, torch.linalg.solve_ex's batched LU, the angle
// recovery and five 4 x 4 products): a few microseconds of
// device work behind about 1.5 ms of host issue.
//
// Semantics (held against solvers/linear._plain_pose_step run in float64 on
// the same f32 inputs): for each pair b,
//   x = (ata + diag I)^-1 atb, by LU with partial pivoting (the first entry
//       of largest magnitude in its column is the pivot, as LAPACK's getrf);
//   EULER (point-to-plane, GICP): R = Rx(x0) Ry(x1) Rz(x2), t = x3..5, about
//       the centre c = c_tgt: increment = T(c) [R | t] T(-c);
//   SYMMETRIC: tan-theta Rodrigues, a~ = x0..2 with theta = atan |a~| (the
//       identity where |a~| <= 1e-12), t = x3..5 cos(theta), about the means
//       mu_s = c_src and mu_t = c_tgt:
//       increment = T(mu_t) R T(t) R T(-mu_s).
// Everything is computed in float64 from the f32 inputs and rounded once to
// f32 on the way out. A zero pivot, or any non-finite component of x, writes
// NaN into every entry of that pair's increment (the plain version's
// division gives a non-finite increment in the same cases). `solution`, a
// test hook, receives x when given (NaN after a zero pivot): the rounded
// increment cannot show how well an ill-conditioned system was solved.
// The caller multiplies the pose by the increment, as for every other
// solver, so the driver's solve stays one function whatever the arm.
//
// What bounds it on the H100: latency. A pair's work is one thread's chain
// of some hundreds of dependent float64 operations (six pivots, the
// divisions, sincos); its bytes (about 0.3 KB a pair) and operations take
// well under a microsecond at any batch the solvers see. One thread a pair,
// PS_THREADS to a CTA: a pair's bits do not depend on its batch.
#include <math_constants.h>

#include "common.cuh"

#define PS_THREADS 32
#define PS_SMALL_ANGLE 1e-12

enum PsRecovery { PS_EULER = 0, PS_SYMMETRIC = 1 };

struct PsArgs {
  const float* ata;    // (B, 6, 6)
  const float* atb;    // (B, 6)
  const float* c_src;  // (B, 3): SYMMETRIC's source mean (EULER reads c_tgt only)
  const float* c_tgt;  // (B, 3)
  float* increment;    // (B, 4, 4)
  double* solution;    // (B, 6), or null
  int B;
  double diag;
};

// x = a^-1 b by LU with partial pivoting; false where a pivot is 0. The
// loops unroll fully, so every index is a constant and a row swap is a
// select on the pivot's row: a and b stay in registers.
__device__ __forceinline__ bool ps_solve6(double (&a)[6][6], double (&b)[6], double (&x)[6]) {
  bool regular = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    double best = fabs(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const double v = fabs(a[i][k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (p == i) {
#pragma unroll
        for (int j = k; j < 6; ++j) {
          const double t = a[k][j];
          a[k][j] = a[i][j];
          a[i][j] = t;
        }
        const double t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
    }
    regular = regular && a[k][k] != 0.0;
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const double l = a[i][k] / a[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) a[i][j] -= l * a[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= a[i][j] * x[j];
    x[i] = s / a[i][i];
  }
  return regular;
}

__device__ __forceinline__ void ps_matmul3(const double (&l)[3][3], const double (&r)[3][3],
                                           double (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[i][j] = l[i][0] * r[0][j] + l[i][1] * r[1][j] + l[i][2] * r[2][j];
    }
  }
}

// The increment's top three rows, [R | t], from x.
template <int RECOVERY>
__device__ __forceinline__ void ps_increment(const double (&x)[6], const double (&cs)[3],
                                             const double (&ct)[3], double (&m)[3][4]) {
  double R[3][3], t[3];
  if (RECOVERY == PS_EULER) {
    // R = Rx(a) Ry(b) Rz(g) (se3.euler_xyz_to_matrix); t + c - R c.
    double sa, ca, sb, cb, sg, cg;
    sincos(x[0], &sa, &ca);
    sincos(x[1], &sb, &cb);
    sincos(x[2], &sg, &cg);
    const double rx[3][3] = {{1.0, 0.0, 0.0}, {0.0, ca, -sa}, {0.0, sa, ca}};
    const double ry[3][3] = {{cb, 0.0, sb}, {0.0, 1.0, 0.0}, {-sb, 0.0, cb}};
    const double rz[3][3] = {{cg, -sg, 0.0}, {sg, cg, 0.0}, {0.0, 0.0, 1.0}};
    double rxy[3][3];
    ps_matmul3(rx, ry, rxy);
    ps_matmul3(rxy, rz, R);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      t[i] = x[3 + i] + ct[i] - (R[i][0] * ct[0] + R[i][1] * ct[1] + R[i][2] * ct[2]);
    }
  } else {
    // Rodrigues on the axis a~ / tan(theta) (se3.rodrigues_matrix), then
    // R R and mu_t + R t - R R mu_s.
    const double tan_t = sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
    const bool big = tan_t > PS_SMALL_ANGLE;
    const double safe = big ? tan_t : 1.0;
    const double k[3] = {x[0] / safe, x[1] / safe, x[2] / safe};
    const double sin_t = tan_t / sqrt(1.0 + tan_t * tan_t);
    const double cos_t = big ? sin_t / safe : 1.0;
    const double K[3][3] = {{0.0, -k[2], k[1]}, {k[2], 0.0, -k[0]}, {-k[1], k[0], 0.0}};
    double K2[3][3], Rr[3][3];
    ps_matmul3(K, K, K2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Rr[i][j] = big ? (i == j ? 1.0 : 0.0) + sin_t * K[i][j] + (1.0 - cos_t) * K2[i][j]
                       : (i == j ? 1.0 : 0.0);
      }
    }
    ps_matmul3(Rr, Rr, R);
    double tr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) tr[i] = x[3 + i] * cos_t;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      t[i] = ct[i] + (Rr[i][0] * tr[0] + Rr[i][1] * tr[1] + Rr[i][2] * tr[2])
             - (R[i][0] * cs[0] + R[i][1] * cs[1] + R[i][2] * cs[2]);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m[i][j] = R[i][j];
    m[i][3] = t[i];
  }
}

template <int RECOVERY>
__global__ void __launch_bounds__(PS_THREADS) pose_step_kernel(const PsArgs p) {
  const int b = blockIdx.x * PS_THREADS + threadIdx.x;
  if (b >= p.B) return;
  double a[6][6], rhs[6], x[6], cs[3], ct[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i][j] = static_cast<double>(p.ata[b * 36 + i * 6 + j]);
    a[i][i] += p.diag;
    rhs[i] = static_cast<double>(p.atb[b * 6 + i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cs[i] = static_cast<double>(p.c_src[b * 3 + i]);
    ct[i] = static_cast<double>(p.c_tgt[b * 3 + i]);
  }
  bool ok = ps_solve6(a, rhs, x);
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = CUDART_NAN;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(x[i]);
  if (p.solution != nullptr) {
#pragma unroll
    for (int i = 0; i < 6; ++i) p.solution[b * 6 + i] = x[i];
  }

  double m[3][4];
  ps_increment<RECOVERY>(x, cs, ct, m);
  float* inc = p.increment + b * 16;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) inc[i * 4 + j] = ok ? static_cast<float>(m[i][j]) : CUDART_NAN_F;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) inc[12 + j] = ok ? (j == 3 ? 1.0f : 0.0f) : CUDART_NAN_F;
}

extern "C" int pose_step_launch(const float* ata, const float* atb, const float* c_src,
                                const float* c_tgt, float* increment, double* solution, int B,
                                double diag, int recovery, void* stream) {
  if (B < 0) return cudaErrorInvalidValue;
  if (recovery != PS_EULER && recovery != PS_SYMMETRIC) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  PsArgs p;
  p.ata = ata;
  p.atb = atb;
  p.c_src = c_src;
  p.c_tgt = c_tgt;
  p.increment = increment;
  p.solution = solution;
  p.B = B;
  p.diag = diag;
  const dim3 grid((B + PS_THREADS - 1) / PS_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (recovery == PS_EULER) {
    pose_step_kernel<PS_EULER><<<grid, PS_THREADS, 0, s>>>(p);
  } else {
    pose_step_kernel<PS_SYMMETRIC><<<grid, PS_THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
