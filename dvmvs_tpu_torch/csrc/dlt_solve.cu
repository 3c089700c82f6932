// Batched solve of DELTAS's triangulation systems: the right singular
// vectors of many small (R x 4) matrices, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's DELTAS calls jnp.linalg.svd in
// dvmvs_tpu/baselines/deltas.py::triangulate_dlt, which XLA compiles into
// the model's one jitted forward. In PyTorch, torch.linalg.svd copies its
// convergence info to the host, so a CUDA graph cannot capture it; with
// this kernel DELTAS's whole forward is one graph.
//
// For each system A (R x 4, R = 2(V+1) rows: the reference camera and V
// measurement views, confidence-weighted) it writes Vh (4 x 4), the right
// singular vectors as rows in descending singular value, as
// torch.linalg.svd(A, full_matrices=False)[2] does. A vector's sign may
// differ from the library's: baselines/deltas.py::dlt_points divides the
// last one by its own last coordinate.
//
// Algorithm, one thread a system, everything in registers, in double
// precision (the smallest singular vector of a DLT system is sensitive to
// rounding; the work is tiny):
//   1. Givens QR: the rows stream through a 4x4 upper triangle R. A = QR
//      with Q orthogonal, so R has A's singular values and right singular
//      vectors, and any number of rows takes the same registers. A zero row
//      (a view masked out) leaves R as it is.
//   2. One-sided (Hestenes) Jacobi on R's four columns: each pair of columns
//      is rotated in its plane until they are orthogonal, the rotations
//      accumulated into V. Sweeps over the 6 pairs end when one rotates no
//      pair whose cosine exceeds kTol, or after kMaxSweeps. Jacobi on R
//      keeps the vectors as accurate as A's conditioning allows (it never
//      forms A^T A, which would square it).
//   3. The singular values are the column norms; the columns of V go out
//      as rows in descending norm, ties in column order, so a zero system
//      gives the identity. Every output is finite for finite input.
// No host check, no convergence flag, no allocation: the launch can be
// captured.
//
// Bound: each system reads 16 R bytes and writes 64 (96 and 64 bytes at
// DELTAS's V=2); reducing its rows to a triangle and checking the triangle's
// columns once take about 750 double-precision flops, so the bytes bound it
// (ops/sweep_measure.py::dlt_bound). That is a fraction of a microsecond at
// DELTAS's 512 systems: a launch's own latency bounds it on this card. One
// thread a system keeps it simple and free of shared memory and
// synchronisation.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 32;
constexpr double kTol = 1e-13;  // |cos| between two columns below which a pair is left alone

__global__ void __launch_bounds__(kThreads)
    dlt_solve_kernel(const float* __restrict__ A, float* __restrict__ vh, int64_t n, int rows) {
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const float* a = A + s * rows * 4;

  // 1. Givens QR of the rows into the upper triangle of u
  double u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) u[i][j] = 0.0;
  for (int row = 0; row < rows; ++row) {
    double x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = (double)a[row * 4 + j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (x[k] != 0.0) {
        const double h = hypot(u[k][k], x[k]);
        const double c = u[k][k] / h, sn = x[k] / h;
#pragma unroll
        for (int j = k; j < 4; ++j) {
          const double rk = u[k][j], xj = x[j];
          u[k][j] = c * rk + sn * xj;
          x[j] = c * xj - sn * rk;
        }
      }
    }
  }

  // 2. one-sided Jacobi on the columns of u, rotations accumulated in v
  double v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  int sweep = 0;
  bool rotated = true;
  while (rotated && sweep < kMaxSweeps) {
    rotated = false;
    ++sweep;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          alpha += u[i][p] * u[i][p];
          beta += u[i][q] * u[i][q];
          gamma += u[i][p] * u[i][q];
        }
        // also false for gamma == 0 (a zero column) and NaN
        if (fabs(gamma) > kTol * sqrt(alpha * beta)) {
          rotated = true;
          const double zeta = (beta - alpha) / (2.0 * gamma);
          const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
          const double c = rsqrt(1.0 + t * t), sn = c * t;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const double up = u[i][p], uq = u[i][q];
            u[i][p] = c * up - sn * uq;
            u[i][q] = sn * up + c * uq;
            const double vp = v[i][p], vq = v[i][q];
            v[i][p] = c * vp - sn * vq;
            v[i][q] = sn * vp + c * vq;
          }
        }
      }
    }
  }

  // 3. column norms -> each column's rank in descending order, ties (and a
  // NaN, ranked last) in column order; V's column j is row rank[j] of Vh
  double norm[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double ss = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss += u[i][j] * u[i][j];
    norm[j] = isnan(ss) ? -1.0 : ss;
  }
  float* out = vh + s * 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int rank = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) rank += norm[m] > norm[j] || (norm[m] == norm[j] && m < j);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[rank * 4 + i] = (float)v[i][j];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. A: n contiguous float32 systems of
// `rows` x 4 on the device; vh: n x 4 x 4 float32 out; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int dlt_solve(const float* A, float* vh, long long n, int rows, void* stream) {
  if (n < 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  dlt_solve_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, vh, (int64_t)n, rows);
  return (int)cudaGetLastError();
}
