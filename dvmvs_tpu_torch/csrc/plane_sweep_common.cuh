// Coordinate arithmetic of the plane sweep, shared by the forward
// (plane_sweep.cu) and the backward (plane_sweep_bwd.cu), so that the
// backward scatters to exactly the taps the forward reads.
//
// A reference pixel (x, y) maps through the 3x3 plane matrix M to the
// source coordinate (M [x, y, 1]) / den. The reference normalises by W/2 and
// samples with align_corners=True; together they scale a pixel coordinate by
// (W - 1) / W. The float expressions below keep one order: changing it moves
// samples in the last bit and the two kernels apart.

#pragma once

#include <cuda_runtime.h>

namespace plane_sweep {

// (n - 1) / n: the W/2 normaliser folded with align_corners=True
__device__ __forceinline__ float align_scale(int n) { return (n - 1.0f) / n; }

// The bilinear footprint of one (pixel, plane, view): the top-left tap
// (x0, y0), the fractional weights along each axis, and whether any tap can
// be non-zero. Out of range (behind the camera, den near 0, far outside the
// image) every tap is zero and the other fields are not set.
struct Taps {
  bool in_range;
  int x0, y0;  // in [-1, W - 1] and [-1, H - 1]
  float wx0, wx1, wy0, wy1;
};

// The source coordinate (xs, ys) of pixel (xf, yf) under M (9 floats, row
// major); x_scale, y_scale: align_scale(W), align_scale(H).
__device__ __forceinline__ void project(const float* m, float xf, float yf, float x_scale,
                                        float y_scale, float& xs, float& ys) {
  const float den = m[6] * xf + m[7] * yf + m[8] + 1e-8f;
  xs = (m[0] * xf + m[1] * yf + m[2]) / den * x_scale;
  ys = (m[3] * xf + m[4] * yf + m[5]) / den * y_scale;
}

// The taps of the source coordinate (xs, ys) in a W x H image.
__device__ __forceinline__ Taps taps_at(float xs, float ys, int W, int H) {
  Taps t;
  // Range test on the float coordinate, before any conversion to int:
  // behind the camera or near den == 0 the coordinates are huge or inf, and
  // NaN fails every comparison.
  t.in_range = xs > -1.0f && xs < (float)W && ys > -1.0f && ys < (float)H;
  if (!t.in_range) return t;
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  t.x0 = (int)x0f;
  t.y0 = (int)y0f;
  t.wx1 = xs - x0f;
  t.wy1 = ys - y0f;
  t.wx0 = 1.0f - t.wx1;
  t.wy0 = 1.0f - t.wy1;
  return t;
}

__device__ __forceinline__ Taps bilinear_taps(const float* m, float xf, float yf, float x_scale,
                                              float y_scale, int W, int H) {
  float xs, ys;
  project(m, xf, yf, x_scale, y_scale, xs, ys);
  return taps_at(xs, ys, W, H);
}

}  // namespace plane_sweep
