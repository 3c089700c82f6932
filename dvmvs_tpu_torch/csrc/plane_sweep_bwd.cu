// Backward of the dot-product plane sweep, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels that share one contract:
//   K5 dvmvs_tpu/ops/pallas/cost_volume_vjp.py::_plane_sweep_bwd_padded
//      (body _kernel_bwd: banded transposed-interpolation matmuls, exact only
//      when the band covers each row's source span)
//   K6 dvmvs_tpu/ops/pallas/cost_volume_vjp.py::_plane_sweep_dyn_bwd_padded
//      (body _kernel_dyn_bwd: runtime trip count over 8-row chunks, exact for
//      any geometry)
// The forward is csrc/plane_sweep.cu in dot mode:
//   out[b, p, y, x] = sum_v w[b, v] / C * sum_c ref[b, y, x, c] * warped_{v,p}[b, y, x, c]
// with warped_{v,p} the bilinear sample (zeros padding, align_corners=True) of
// meas[b, v] at M[b, v, p] [x, y, 1]. Given g = dL/dout (B, P, H, W):
//   d_ref[b, y, x, c]    = sum_v w_v / C * sum_p g[b, p, y, x] * warped_{v,p}[b, y, x, c]
//   d_meas[b, v, sy, sx, c] += w_v / C * g[b, p, y, x] * ref[b, y, x, c] * tap(sy, sx)
// the second being the transposed bilinear scatter onto the four source taps
// of every (v, p, y, x). The matrices and the view weights get no gradient.
// Training calls it with V = 1 and w = 1 (K5/K6 exactly); the online path's
// V = 2 with a masked view takes the same kernel, zero-weight views skipped.
//
// Bound: per (pixel, plane, view) a thread loads and scatters 4 taps of C
// floats; the d_meas scatter is f32 atomics into L2, which bounds the kernel
// (B x H x W x P x 4 x C/4 vector atomics: 134 M at the training shape
// B=4, 128x128, P=64, C=32). Design: one thread per (b, y, x, group of four
// channels), channels fastest, so the threads of one pixel read and scatter
// one contiguous run of C floats per tap (coalesced), and a tap costs one
// 16-byte load and one 16-byte atomicAdd (sm_90 has float4 atomicAdd on
// global memory). Each thread recomputes the forward's coordinates for every
// (view, plane) with the forward's own code (plane_sweep_common.cuh), so it
// scatters to exactly the taps the forward read; it sums d_ref in registers
// and writes it once: d_ref needs no atomics and is deterministic; d_meas is
// summed by atomics in no fixed order. No band ladder and no span check: one
// kernel closes K5 and K6. Shared-memory staging, TMA and wgmma are left out.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "plane_sweep_common.cuh"

namespace {

template <bool VEC4>
__global__ void plane_sweep_bwd_kernel(const float* __restrict__ ref,      // (B, H, W, C)
                                       const float* __restrict__ meas,     // (B, V, H, W, C)
                                       const float* __restrict__ mats,     // (B, V, P, 3, 3)
                                       const float* __restrict__ weights,  // (B, V)
                                       const float* __restrict__ g,        // (B, P, H, W)
                                       float* __restrict__ d_ref,          // (B, H, W, C)
                                       float* __restrict__ d_meas,         // (B, V, H, W, C), zeroed
                                       int B, int V, int P, int H, int W, int C,
                                       float inv_channels) {
  constexpr int LANES = VEC4 ? 4 : 1;  // channels per thread
  const int groups = C / LANES;
  const int64_t n_threads = (int64_t)B * H * W * groups;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_threads) return;
  const int c0 = (int)(idx % groups) * LANES;
  int64_t rest = idx / groups;
  const int x = (int)(rest % W);
  rest /= W;
  const int y = (int)(rest % H);
  const int b = (int)(rest / H);

  const int64_t px = ((int64_t)b * H + y) * W + x;
  float r[LANES];
  if (VEC4) {
    const float4 rv = __ldg(reinterpret_cast<const float4*>(ref + px * C + c0));
    r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
  } else {
    r[0] = __ldg(ref + px * C + c0);
  }
  float acc[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) acc[k] = 0.0f;

  const float xf = (float)x;
  const float yf = (float)y;
  const float x_scale = plane_sweep::align_scale(W);
  const float y_scale = plane_sweep::align_scale(H);
  const int64_t plane_stride = (int64_t)H * W;
  const float* g_px = g + (int64_t)b * P * plane_stride + (int64_t)y * W + x;

  for (int v = 0; v < V; ++v) {
    const float wv = weights[b * V + v];
    if (wv == 0.0f) continue;  // a padded view has no gradient
    const float scale = wv * inv_channels;
    const int64_t view = ((int64_t)b * V + v) * plane_stride * C;
    const float* meas_v = meas + view;
    float* d_meas_v = d_meas + view;
    for (int p = 0; p < P; ++p) {
      // the forward's taps (plane_sweep_common.cuh); out of range all are zero
      const plane_sweep::Taps taps = plane_sweep::bilinear_taps(
          mats + (((int64_t)b * V + v) * P + p) * 9, xf, yf, x_scale, y_scale, W, H);
      if (!taps.in_range) continue;
      const float gp = __ldg(g_px + (int64_t)p * plane_stride) * scale;
      const int tx[2] = {taps.x0, taps.x0 + 1};
      const int ty[2] = {taps.y0, taps.y0 + 1};
      const float wx[2] = {taps.wx0, taps.wx1};
      const float wy[2] = {taps.wy0, taps.wy1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (ty[i] < 0 || ty[i] >= H) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (tx[j] < 0 || tx[j] >= W) continue;
          const float t = gp * wy[i] * wx[j];
          const int64_t off = ((int64_t)ty[i] * W + tx[j]) * C + c0;
          if (VEC4) {
            const float4 mv = __ldg(reinterpret_cast<const float4*>(meas_v + off));
            acc[0] += t * mv.x;
            acc[1] += t * mv.y;
            acc[2] += t * mv.z;
            acc[3] += t * mv.w;
            atomicAdd(reinterpret_cast<float4*>(d_meas_v + off),
                      make_float4(t * r[0], t * r[1], t * r[2], t * r[3]));
          } else {
            acc[0] += t * __ldg(meas_v + off);
            atomicAdd(d_meas_v + off, t * r[0]);
          }
        }
      }
    }
  }

  if (VEC4) {
    *reinterpret_cast<float4*>(d_ref + px * C + c0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    d_ref[px * C + c0] = acc[0];
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. All tensors are contiguous f32 on
// the device, d_meas zero-filled by the caller; `stream` is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int plane_sweep_backward(const float* ref, const float* meas, const float* mats,
                                    const float* weights, const float* g, float* d_ref,
                                    float* d_meas, int B, int V, int P, int H, int W, int C,
                                    void* stream) {
  if (B <= 0 || V <= 0 || P <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  // 16-byte loads and vector atomics need every channel group on a 16-byte
  // boundary; a tensor viewed at an odd offset takes the scalar kernel
  const uintptr_t any = reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(meas) |
                        reinterpret_cast<uintptr_t>(d_ref) | reinterpret_cast<uintptr_t>(d_meas);
  const bool vec4 = C % 4 == 0 && any % 16 == 0;
  const int64_t n_threads = (int64_t)B * H * W * (vec4 ? C / 4 : C);
  const int threads = 256;
  const int64_t blocks = (n_threads + threads - 1) / threads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_channels = 1.0f / (float)C;
  if (vec4) {
    plane_sweep_bwd_kernel<true><<<(unsigned int)blocks, threads, 0, s>>>(
        ref, meas, mats, weights, g, d_ref, d_meas, B, V, P, H, W, C, inv_channels);
  } else {
    plane_sweep_bwd_kernel<false><<<(unsigned int)blocks, threads, 0, s>>>(
        ref, meas, mats, weights, g, d_ref, d_meas, B, V, P, H, W, C, inv_channels);
  }
  return (int)cudaGetLastError();
}
