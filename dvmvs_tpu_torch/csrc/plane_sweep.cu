// Fused multi-view plane-sweep cost volume, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels that share one contract:
//   K1 dvmvs_tpu/ops/pallas/cost_volume_kernel.py::pallas_plane_sweep_multiview
//      (body _kernel_mv: banded hat-function matmuls, exact only when the
//      band covers each row's source span)
//   K2 dvmvs_tpu/ops/pallas/cost_volume_kernel.py::pallas_plane_sweep_multiview_dyn
//      (body _kernel_mv_dyn: runtime trip count over 8-row chunks, exact for
//      any geometry)
// Called with one view and weight 1 it is also the single-view training
// forward, so it stands for two more TPU kernels of the same contract:
//   K3 cost_volume_kernel.py::pallas_plane_sweep (banded)
//   K4 cost_volume_kernel.py::pallas_plane_sweep_dyn (exact for any geometry)
// Its dot mode is differentiable through ops/plane_sweep.py's autograd
// Function, whose backward is csrc/plane_sweep_bwd.cu (K5/K6).
// For every plane p and reference pixel (x, y):
//   out[b, p, y, x] = sum_v w[b, v] * reduce_c(ref[b, y, x, c],
//                                              bilinear(meas[b, v], M[b, v, p] [x, y, 1]))
// with reduce = sum_c ref * warped / C (dot mode) or sum_c |ref - warped|
// (L1 mode), zeros padding and align_corners=True sampling. The TPU kernels
// avoid gathers with a band ladder; here every thread gathers its four
// bilinear taps directly, so there is no band precondition and one kernel
// computes what both compute.
//
// Bound: each output reads V views x 4 taps x C channels (2 x 4 x 32 floats
// at the online path's 128 x 160 x 32 shape, i.e. 1 KiB) and does about two
// flops per float loaded. The measurement features (a few MB) stay resident
// in the 50 MB L2, so the kernel is bound by L1/L2 load bandwidth, not by
// arithmetic. Design: one thread per output pixel; consecutive threads take
// consecutive x of one (plane, row), so a warp's taps are neighbours in the
// source image. Features are channels-last, so each tap is one contiguous run
// of C floats, read as float4 when C % 4 == 0. Views are summed in registers
// and every output is written once: no atomics, no zeroing pass, and the
// result is deterministic. Shared-memory tiling, TMA and wgmma are left out.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

template <bool DOT>
__device__ __forceinline__ float reduce_step(float acc, float r, float warped) {
  return DOT ? acc + r * warped : acc + fabsf(r - warped);
}

template <bool VEC4, bool DOT>
__global__ void plane_sweep_kernel(const float* __restrict__ ref,      // (B, H, W, C)
                                   const float* __restrict__ meas,     // (B, V, H, W, C)
                                   const float* __restrict__ mats,     // (B, V, P, 3, 3)
                                   const float* __restrict__ weights,  // (B, V)
                                   float* __restrict__ out,            // (B, P, H, W)
                                   int B, int V, int P, int H, int W, int C,
                                   float inv_channels) {
  const int64_t n_out = (int64_t)B * P * H * W;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  const int x = (int)(idx % W);
  int64_t rest = idx / W;
  const int y = (int)(rest % H);
  rest /= H;
  const int p = (int)(rest % P);
  const int b = (int)(rest / P);

  const float* ref_px = ref + (((int64_t)b * H + y) * W + x) * C;
  const float xf = (float)x;
  const float yf = (float)y;
  // The reference normalises by W/2 and samples with align_corners=True;
  // together they scale a pixel coordinate by (W - 1) / W.
  const float x_scale = (W - 1.0f) / W;
  const float y_scale = (H - 1.0f) / H;

  float total = 0.0f;
  for (int v = 0; v < V; ++v) {
    const float wv = weights[b * V + v];
    if (wv == 0.0f) continue;  // a padded view contributes nothing
    const float* m = mats + (((int64_t)b * V + v) * P + p) * 9;
    const float den = m[6] * xf + m[7] * yf + m[8] + 1e-8f;
    const float xs = (m[0] * xf + m[1] * yf + m[2]) / den * x_scale;
    const float ys = (m[3] * xf + m[4] * yf + m[5]) / den * y_scale;

    // Range test on the float coordinate, before any conversion to int:
    // behind the camera or near den == 0 the coordinates are huge or inf,
    // and NaN fails every comparison. Out of range, all four taps are zero.
    const bool in_range = xs > -1.0f && xs < (float)W && ys > -1.0f && ys < (float)H;
    if (DOT && !in_range) continue;

    // An invalid tap reads the (always valid) reference pixel with weight 0.
    const float* t00 = ref_px;
    const float* t01 = ref_px;
    const float* t10 = ref_px;
    const float* t11 = ref_px;
    float w00 = 0.0f, w01 = 0.0f, w10 = 0.0f, w11 = 0.0f;
    if (in_range) {
      const float x0f = floorf(xs);
      const float y0f = floorf(ys);
      const int x0 = (int)x0f;  // in [-1, W - 1]
      const int y0 = (int)y0f;  // in [-1, H - 1]
      const float wx1 = xs - x0f;
      const float wy1 = ys - y0f;
      const float wx0 = 1.0f - wx1;
      const float wy0 = 1.0f - wy1;
      const bool vx0 = x0 >= 0, vx1 = x0 + 1 < W;
      const bool vy0 = y0 >= 0, vy1 = y0 + 1 < H;
      const float* base = meas + ((int64_t)b * V + v) * H * W * C;
      const float* row0 = base + (int64_t)y0 * W * C;
      const float* row1 = row0 + (int64_t)W * C;
      if (vy0 && vx0) { t00 = row0 + (int64_t)x0 * C;       w00 = wy0 * wx0; }
      if (vy0 && vx1) { t01 = row0 + (int64_t)(x0 + 1) * C; w01 = wy0 * wx1; }
      if (vy1 && vx0) { t10 = row1 + (int64_t)x0 * C;       w10 = wy1 * wx0; }
      if (vy1 && vx1) { t11 = row1 + (int64_t)(x0 + 1) * C; w11 = wy1 * wx1; }
    }

    float acc = 0.0f;
    if (VEC4) {
      for (int c = 0; c < C; c += 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(t00 + c));
        const float4 bb = __ldg(reinterpret_cast<const float4*>(t01 + c));
        const float4 cc = __ldg(reinterpret_cast<const float4*>(t10 + c));
        const float4 d = __ldg(reinterpret_cast<const float4*>(t11 + c));
        const float4 r = __ldg(reinterpret_cast<const float4*>(ref_px + c));
        acc = reduce_step<DOT>(acc, r.x, a.x * w00 + bb.x * w01 + cc.x * w10 + d.x * w11);
        acc = reduce_step<DOT>(acc, r.y, a.y * w00 + bb.y * w01 + cc.y * w10 + d.y * w11);
        acc = reduce_step<DOT>(acc, r.z, a.z * w00 + bb.z * w01 + cc.z * w10 + d.z * w11);
        acc = reduce_step<DOT>(acc, r.w, a.w * w00 + bb.w * w01 + cc.w * w10 + d.w * w11);
      }
    } else {
      for (int c = 0; c < C; ++c) {
        const float warped = __ldg(t00 + c) * w00 + __ldg(t01 + c) * w01 +
                             __ldg(t10 + c) * w10 + __ldg(t11 + c) * w11;
        acc = reduce_step<DOT>(acc, __ldg(ref_px + c), warped);
      }
    }
    total += wv * (DOT ? acc * inv_channels : acc);
  }
  out[idx] = total;
}

template <bool VEC4, bool DOT>
void launch(const float* ref, const float* meas, const float* mats, const float* weights,
            float* out, int B, int V, int P, int H, int W, int C, unsigned int blocks,
            int threads, cudaStream_t stream) {
  plane_sweep_kernel<VEC4, DOT><<<blocks, threads, 0, stream>>>(
      ref, meas, mats, weights, out, B, V, P, H, W, C, 1.0f / (float)C);
}

}  // namespace

// Plain C entry point, loaded with ctypes. All tensors are contiguous f32 on
// the device; `stream` is a cudaStream_t. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int plane_sweep_multiview(const float* ref, const float* meas, const float* mats,
                                     const float* weights, float* out, int B, int V, int P,
                                     int H, int W, int C, int dot_product, void* stream) {
  const int64_t n_out = (int64_t)B * P * H * W;
  if (n_out <= 0 || V <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n_out + threads - 1) / threads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int nb = (unsigned int)blocks;
  // float4 loads need every tap (a multiple of C floats from the base) on a
  // 16-byte boundary; a tensor viewed at an odd offset takes scalar loads
  const bool vec4 = C % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(meas)) % 16) == 0;
  if (dot_product) {
    if (vec4) launch<true, true>(ref, meas, mats, weights, out, B, V, P, H, W, C, nb, threads, s);
    else      launch<false, true>(ref, meas, mats, weights, out, B, V, P, H, W, C, nb, threads, s);
  } else {
    if (vec4) launch<true, false>(ref, meas, mats, weights, out, B, V, P, H, W, C, nb, threads, s);
    else      launch<false, false>(ref, meas, mats, weights, out, B, V, P, H, W, C, nb, threads, s);
  }
  return (int)cudaGetLastError();
}
