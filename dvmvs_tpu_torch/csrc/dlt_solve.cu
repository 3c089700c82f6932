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
// measurement views, confidence-weighted; any R >= 1) it writes Vh (4 x 4),
// the right singular vectors as rows in descending singular value, as
// torch.linalg.svd(A, full_matrices=False)[2] does. A vector's sign may
// differ from the library's: baselines/deltas.py::dlt_points divides the
// last one by its own last coordinate.
//
// Algorithm, in double precision (the smallest singular vector of a DLT
// system is sensitive to rounding; the work is tiny):
//   1. Householder QR: the rows are reduced to a 4x4 upper triangle T.
//      A = QT with Q orthogonal, so T has A's singular values and right
//      singular vectors. The rows go through registers kChunk at a time,
//      each chunk after the first stacked under the triangle so far, so any
//      number of rows takes the same registers. A zero row (a view masked
//      out, or the padding of a short chunk) adds nothing to any sum and is
//      left zero, so it leaves T as it is.
//   2. One-sided (Hestenes) Jacobi on T's four columns: each pair of columns
//      is rotated in its plane until they are orthogonal, the rotations
//      accumulated into V. A sweep is three rounds of two disjoint pairs,
//      (0,1)(2,3), (0,2)(1,3), (0,3)(1,2). Sweeps end when one rotates no
//      pair whose cosine exceeds kTol, or after kMaxSweeps. Jacobi on T
//      keeps the vectors as accurate as A's conditioning allows (it never
//      forms A^T A, which would square it).
//   3. The singular values are the column norms; the columns of V go out
//      as rows in descending norm, ties in column order, so a zero system
//      gives the identity. Every output is finite for finite input.
// No host check, no convergence flag, no allocation: the launch can be
// captured, and two launches are bit-equal.
//
// Layout. Neither bytes nor flops bound the solve (ops/sweep_measure.py::
// dlt_bound: a fraction of a microsecond at DELTAS's 512 systems): its time
// is one chain of dependent float64 operations, the longest of them square
// roots and divisions (software sequences of DFMAs on this card), plus the
// launch. So the design shortens the chain and spreads the systems:
//   - Four lanes a system, lane j holding column j of the chunk, of T and of
//     V in registers: 8 systems a warp, 16 a block of 64 threads, so a
//     keyframe's 512 systems take 32 SMs. The lanes of a system exchange
//     values by __shfl_sync inside their group of four; there is no shared
//     memory and no __syncthreads.
//   - Householder step k: lane k's column goes to the other lanes by
//     shuffles, every lane forms its dot product with it at once, lane k
//     makes the reflection from two reciprocal square roots (no square
//     root, no division), and the other lanes update their own columns,
//     side by side.
//   - In a Jacobi round each lane rotates its own columns of T and V with
//     its partner's (shuffled): both lanes of a pair compute the same
//     rotation from the same values in the same arithmetic, so they agree
//     bit for bit. A rotation takes two reciprocal square roots, and its
//     test compares squares. The four lanes leave the sweep loop together,
//     by a vote.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 64;  // 16 systems a block
constexpr int kLanes = 4;     // lanes a system, one a column
constexpr int kMaxSweeps = 32;
constexpr double kTol = 1e-13;  // |cos| between two columns below which a pair is left alone
constexpr double kTol2 = kTol * kTol;

// kChunk: rows in registers at once, 8 (any R <= 8: DELTAS's default of 6
// rows among them) or 16 (after the first chunk, the triangle's 4 and 12
// new ones); a short chunk is padded with zero rows, which change nothing
template <int kChunk>
__global__ void __launch_bounds__(kThreads)
    dlt_solve_kernel(const float* __restrict__ A, float* __restrict__ vh, int64_t n, int rows) {
  const int t = threadIdx.x, j = t & (kLanes - 1), lane = t & 31;
  const int64_t s = ((int64_t)blockIdx.x * kThreads + t) / kLanes;
  if (s >= n) return;  // all four lanes of a system leave together
  const unsigned group = 0xFu << (lane - j);
  const float* a = A + s * rows * 4 + j;

  // 1. Householder QR of the rows, chunk by chunk; x: this lane's column of
  // the chunk, u: of the triangle (zero below row j)
  double u[4] = {0.0, 0.0, 0.0, 0.0};
  for (int done = 0; done < rows;) {
    const int top = done == 0 ? 0 : 4;  // rows of the triangle stacked above the chunk
    const int m = min(rows - done, kChunk - top);
    double x[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int row = done + i - top;
      x[i] = i < top ? u[i & 3] : i < top + m ? (double)a[row * 4] : 0.0;
    }
    done += m;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // lane k's column below row k, and its dot with this lane's in two
      // halves (lane k: its own squares)
      double pivot[kChunk], dot[2] = {0.0, 0.0};
#pragma unroll
      for (int i = k + 1; i < kChunk; ++i) {
        pivot[i] = __shfl_sync(group, x[i], k, kLanes);
        dot[i & 1] = fma(pivot[i], x[i], dot[i & 1]);
      }
      // lane k: the reflection H = I - tau w w^T that maps its column to
      // alpha e_k, with w = column - alpha e_k (w_k = akk - alpha, the rest
      // pivot's), alpha of the sign opposite to akk, and tau = -beta:
      // 1 / beta = alpha w_k = -(sigma + |akk| sqrt(sigma))
      double alpha = 0.0, wk = 0.0, beta = 0.0;
      if (j == k) {
        const double akk = x[k], sigma = fma(akk, akk, dot[0] + dot[1]);
        if (sigma > 0.0) {  // else a zero column: nothing to do
          const double root = sigma * rsqrt(sigma);
          alpha = -copysign(root, akk);
          wk = akk - alpha;
          const double r = rsqrt(fma(fabs(akk), root, sigma));
          beta = -r * r;
        }
      }
      wk = __shfl_sync(group, wk, k, kLanes);
      beta = __shfl_sync(group, beta, k, kLanes);
      if (j > k) {  // this column -= tau (w . column) w
        const double f = fma(wk, x[k], dot[0] + dot[1]) * beta;
        x[k] = fma(f, wk, x[k]);
#pragma unroll
        for (int i = k + 1; i < kChunk; ++i) x[i] = fma(f, pivot[i], x[i]);
      }
      u[k] = j > k ? x[k] : j == k ? alpha : 0.0;
    }
  }

  // 2. one-sided Jacobi on the triangle's columns, rotations accumulated in
  // v (this lane's column of V); round r pairs lane j with lane j ^ r
  double v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < kMaxSweeps;) {
    bool rotated = false;
#pragma unroll
    for (int r = 1; r < kLanes; ++r) {
      double pu[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pu[i] = __shfl_xor_sync(group, u[i], r, kLanes);
        pv[i] = __shfl_xor_sync(group, v[i], r, kLanes);
      }
      const bool low = j < (j ^ r);  // this lane holds the pair's first column
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double x = low ? u[i] : pu[i], y = low ? pu[i] : u[i];
        alpha = fma(x, x, alpha);
        beta = fma(y, y, beta);
        gamma = fma(x, y, gamma);
      }
      // also false for gamma == 0 (a zero column) and NaN
      if (gamma * gamma > kTol2 * alpha * beta) {
        rotated = true;
        // the angle that makes the pair orthogonal: tan = g2 / den with
        // den = d + sign(d) sqrt(d^2 + g2^2), so cos = |den| / sqrt(den^2 +
        // g2^2), sin = cos tan; no division and no square root
        const double d = beta - alpha, g2 = 2.0 * gamma, g22 = g2 * g2, h2 = fma(d, d, g22);
        const double den = d + copysign(h2 * rsqrt(h2), d), q = rsqrt(fma(den, den, g22));
        const double c = fabs(den) * q, sn = (den < 0.0 ? -g2 : g2) * q;
        const double sx = low ? c : sn, sy = low ? -sn : c;  // first: c x - s y; second: s x + c y
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double x = low ? u[i] : pu[i], y = low ? pu[i] : u[i];
          const double vx = low ? v[i] : pv[i], vy = low ? pv[i] : v[i];
          u[i] = fma(sx, x, sy * y);
          v[i] = fma(sx, vx, sy * vy);
        }
      }
    }
    ++sweep;
    if (!__any_sync(group, rotated)) break;
  }

  // 3. column norms -> this column's rank in descending order, ties (and a
  // NaN, ranked last) in column order; V's column j is row rank of Vh
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) ss = fma(u[i], u[i], ss);
  const double norm = isnan(ss) ? -1.0 : ss;
  int rank = 0;
#pragma unroll
  for (int m = 0; m < kLanes; ++m) {
    const double other = __shfl_sync(group, norm, m, kLanes);
    rank += other > norm || (other == norm && m < j);
  }
  float* out = vh + s * 16 + rank * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (float)v[i];
}

}  // namespace

// Plain C entry point, loaded with ctypes. A: n contiguous float32 systems of
// `rows` x 4 on the device; vh: n x 4 x 4 float32 out; `stream` is a
// cudaStream_t. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dlt_solve(const float* A, float* vh, long long n, int rows, void* stream) {
  if (n < 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long systems = kThreads / kLanes, blocks = (n + systems - 1) / systems;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel = rows <= 8 ? dlt_solve_kernel<8> : dlt_solve_kernel<16>;
  kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, vh, (int64_t)n,
                                                                              rows);
  return (int)cudaGetLastError();
}
