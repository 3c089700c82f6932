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
// avoid gathers with a band ladder; here every pixel gathers its four
// bilinear taps directly, so there is no band precondition and one kernel
// computes what both compute. The coordinate arithmetic is
// plane_sweep_common.cuh's, which the backward shares.
//
// Bound: each output reads V views x 4 taps x C channels (2 x 4 x 128 B at
// the online shape B=1, C=32, 128x160, P=64: 1.34 GB through L1 per call) for
// 13 MB of compulsory device-memory traffic, and does 5 FMA per channel, view
// and output. The measurement features (2.6 MB a view there) stay in the
// 50 MB L2, so the gathers are served by L1 and L2; per (pixel, plane, view)
// the kernel also pays a projection (two IEEE divisions) and the tap
// arithmetic, which the channel work of one lane has to carry.
// Design:
//   - Lanes over channels. A group of kLanes lanes takes one reference pixel;
//     lane j holds channels [4j, 4j + 4) of every 4 * kLanes, so a warp-wide
//     load reads whole 128-byte lines of taps (coalesced). Each lane keeps its
//     slice of the reference pixel in registers for the whole plane loop.
//   - Tiles. A block takes kTileX consecutive x of kRows rows of one batch
//     element and a range of planes; neighbouring pixels' taps share lines,
//     and consecutive planes move the taps by about a pixel, so most gathers
//     hit L1. Planes are split over blocks only when the tiles alone would
//     not fill the card.
//   - The block's plane matrices and view weights are staged in shared memory
//     once. For each chunk of kChunk planes the block projects every (view,
//     plane, pixel) once, one thread each, into shared memory; the lanes of a
//     pixel read the coordinate back instead of each dividing again.
//   - One plane at a time, views summed in a register, then the channel sum
//     over the pixel's lanes by __shfl_xor_sync. The loop over planes is not
//     unrolled, and ptxas is held to 48 registers so five blocks fit an SM;
//     the C=32 kernel spills about 80 bytes there, which measured faster
//     than 64 registers and four blocks (apps/bench_plane_sweep.py).
//   - The chunk's results go through shared memory, so each plane row of the
//     tile is stored as kTileX consecutive floats.
// Every output is written once: no atomics, and the result is deterministic.
// Views beyond what a block's shared memory holds (about 50) are summed by
// further launches on the same stream, each adding to the output in place.
// TMA and wgmma are left out: the sweep has no matrix product, and the
// source rows a tile reads are unbounded under roll or behind the camera, so
// they are not staged in shared memory.
//
// Small channel counts (C <= 4: MVDepthNet's and GP-MVS's L1 sweep of the
// normalised RGB frames, C=3 at 256x320, P=64) take another kernel,
// plane_sweep_small_kernel, in either mode. There a group of lanes a pixel
// leaves most lanes idle and repeats the per-sample work (projection, taps,
// weights, addresses) on every lane for one scalar channel, and the
// shuffles and the shared-memory round trips exist only to share it.
// Bound: about 24 MB of compulsory traffic (7.1 us at 3.35 TB/s at that
// shape) against 10.5 M (pixel, plane, view) samples, each a projection (two
// IEEE divisions), the tap arithmetic and 4 x C scalar gathers: the kernel
// is bound by the instructions it issues a sample, not by device memory
// (float2 loads, which cut the L1 wavefronts of its gathers, gained nothing).
// Design:
//   - One thread a reference pixel; a warp takes 32 consecutive x of one
//     row. The pixel's C channels and sum_c |ref| stay in registers.
//   - For each (plane, view) the thread projects, computes the four tap
//     weights and bounds once, gathers 4 taps x C floats and keeps the
//     channel and view sums in registers: no shuffles, no s_xy. A sample
//     whose four taps are all inside the image (most of them) skips the
//     per-tap bounds and takes all four taps from one address; this cut the
//     time at the RGB shape by a tenth, where two planes a loop iteration
//     gained nothing (PERF.md).
//   - The block's plane matrices and view weights are staged in shared
//     memory and read as warp-wide broadcasts.
//   - Each plane row goes straight to out as one 128-byte store a warp (or
//     is added to it for a later view group); no s_out, no atomics.
//   - Planes are split over blocks so that the tiles (320 of 32x8 at
//     256x320) fill the card.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "plane_sweep_common.cuh"

namespace {

// Tile shape and register target: each was timed faster than the other
// settings tried (PERF.md): 8 and 2 lanes, 1 and 4 rows, 4 and 3 blocks an
// SM, 8192 target blocks.
constexpr int kLanes = 4;              // lanes per reference pixel
constexpr int kRows = 2;               // rows of the tile
constexpr int kMinBlocks = 5;          // resident blocks per SM that ptxas must fit in registers
constexpr int kTargetBlocks = 4096;    // blocks below which planes are split over blocks
constexpr int kTileX = 32;
constexpr int kPixels = kTileX * kRows;
constexpr int kThreads = kPixels * kLanes;
constexpr int kChunk = 8;       // planes projected and stored together
constexpr int kMatStride = 12;  // a 3x3 matrix padded to three float4
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8, "kLanes");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");
// dynamic shared memory beyond 48 KB needs an opt-in; Hopper allows 227 KB a block
constexpr int kStaticShared = (int)sizeof(float) * kChunk * kPixels;
constexpr int kDefaultShared = 48 * 1024 - kStaticShared;
constexpr int kMaxShared = 227 * 1024 - kStaticShared;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Dynamic shared memory of a block, in floats: the matrices (V,
// planes_per_block, 12), the coordinates of a chunk (V, kChunk, kPixels, 2)
// and the view weights (V,).
__host__ __device__ constexpr int64_t shared_floats(int V, int planes_per_block) {
  return (int64_t)V * planes_per_block * kMatStride + (int64_t)V * kChunk * kPixels * 2 + V;
}

// VEC: channels per load (4 = float4); CHUNKS: loads per lane and tap, kept
// in registers for the reference (0: any C, the reference re-read from L1).
// The launch sums V views, view v of batch element b at b * v_stride + v of
// meas, mats and weights; with `accumulate` it adds to out instead of
// storing.
template <int VEC, int CHUNKS, bool DOT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plane_sweep_kernel(const float* __restrict__ ref,      // (B, H, W, C)
                   const float* __restrict__ meas,     // (B, v_stride, H, W, C)
                   const float* __restrict__ mats,     // (B, v_stride, P, 3, 3)
                   const float* __restrict__ weights,  // (B, v_stride)
                   float* __restrict__ out,            // (B, P, H, W)
                   int V, int v_stride, int P, int H, int W, int C, int planes_per_block,
                   bool accumulate, float inv_channels) {
  extern __shared__ float4 shared4[];
  float* s_mats = reinterpret_cast<float*>(shared4);
  float2* s_xy = reinterpret_cast<float2*>(s_mats + V * planes_per_block * kMatStride);
  float* s_w = reinterpret_cast<float*>(s_xy + V * kChunk * kPixels);
  __shared__ float s_out[kChunk][kPixels];

  const int splits = (P + planes_per_block - 1) / planes_per_block;
  const int b = blockIdx.z / splits;
  const int p_begin = (blockIdx.z % splits) * planes_per_block;
  const int n_planes = min(P - p_begin, planes_per_block);

  for (int i = threadIdx.x; i < V * n_planes * 9; i += kThreads) {
    const int v = i / (n_planes * 9);
    const int p = i / 9 - v * n_planes;
    const int e = i % 9;
    s_mats[(v * planes_per_block + p) * kMatStride + e] =
        mats[(((int64_t)b * v_stride + v) * P + p_begin + p) * 9 + e];
  }
  for (int v = threadIdx.x; v < V; v += kThreads) s_w[v] = weights[b * v_stride + v];

  const int j = threadIdx.x % kLanes;     // lane within the pixel's group
  const int pix = threadIdx.x / kLanes;   // pixel within the tile
  const int x = blockIdx.x * kTileX + pix % kTileX;
  const int y = blockIdx.y * kRows + pix / kTileX;
  const bool valid = x < W && y < H;      // lanes off the image still shuffle
  const float x_scale = plane_sweep::align_scale(W);
  const float y_scale = plane_sweep::align_scale(H);

  constexpr int kStep = kLanes * VEC;     // channels between a lane's loads
  const int c_lane = j * VEC;
  const int n_loads = CHUNKS ? CHUNKS : (C + kStep - 1) / kStep;
  const float* ref_px = ref + (((int64_t)b * H + (valid ? y : 0)) * W + (valid ? x : 0)) * C;
  float r[CHUNKS ? CHUNKS : 1][VEC];
  float abs_r = 0.0f;  // L1 mode: this lane's sum_c |ref|, the cost of a zero sample
#pragma unroll
  for (int k = 0; k < n_loads; ++k) {
    const int c = c_lane + k * kStep;
    float rk[VEC];
    if (valid && c < C) {
      load_vec<VEC>(ref_px + c, rk);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) rk[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) abs_r += fabsf(rk[e]);
    if constexpr (CHUNKS > 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[k][e] = rk[e];
    }
  }

  for (int pc = 0; pc < n_planes; pc += kChunk) {
    const int n_chunk = min(kChunk, n_planes - pc);
    __syncthreads();  // the matrices are staged; the last chunk's s_xy and s_out are read
    // project every (view, plane, pixel) of the chunk once
    for (int i = threadIdx.x; i < V * n_chunk * kPixels; i += kThreads) {
      const int v = i / (n_chunk * kPixels);
      const int q = i / kPixels - v * n_chunk;
      const int px = i % kPixels;
      const float4* m4 = reinterpret_cast<const float4*>(
          s_mats + (v * planes_per_block + pc + q) * kMatStride);
      const float4 ma = m4[0], mb = m4[1], mc = m4[2];
      const float m[9] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w, mc.x};
      float2 xy;
      plane_sweep::project(m, (float)(blockIdx.x * kTileX + px % kTileX),
                           (float)(blockIdx.y * kRows + px / kTileX), x_scale, y_scale, xy.x,
                           xy.y);
      s_xy[(v * kChunk + q) * kPixels + px] = xy;
    }
    __syncthreads();

#pragma unroll 1
    for (int q = 0; q < n_chunk; ++q) {
      float total = 0.0f;
      for (int v = 0; v < V; ++v) {
        const float wv = s_w[v];
        if (wv == 0.0f) continue;  // a padded view contributes nothing
        const float2 xy = s_xy[(v * kChunk + q) * kPixels + pix];
        const plane_sweep::Taps t = plane_sweep::taps_at(xy.x, xy.y, W, H);
        float part = 0.0f;
        if (valid && !t.in_range) {
          part = DOT ? 0.0f : abs_r;  // all four taps are zero
        } else if (valid) {
          const float* base = meas + ((int64_t)b * v_stride + v) * H * W * C + c_lane;
          const bool vx0 = t.x0 >= 0, vx1 = t.x0 + 1 < W;
          const bool vy0 = t.y0 >= 0, vy1 = t.y0 + 1 < H;
          // an invalid tap reads pixel 0 of the view with weight 0
          const float w00 = vy0 && vx0 ? t.wy0 * t.wx0 : 0.0f;
          const float w01 = vy0 && vx1 ? t.wy0 * t.wx1 : 0.0f;
          const float w10 = vy1 && vx0 ? t.wy1 * t.wx0 : 0.0f;
          const float w11 = vy1 && vx1 ? t.wy1 * t.wx1 : 0.0f;
          const int row0 = t.y0 * W, row1 = row0 + W;
          const float* t00 = base + (int64_t)(vy0 && vx0 ? row0 + t.x0 : 0) * C;
          const float* t01 = base + (int64_t)(vy0 && vx1 ? row0 + t.x0 + 1 : 0) * C;
          const float* t10 = base + (int64_t)(vy1 && vx0 ? row1 + t.x0 : 0) * C;
          const float* t11 = base + (int64_t)(vy1 && vx1 ? row1 + t.x0 + 1 : 0) * C;
#pragma unroll
          for (int k = 0; k < n_loads; ++k) {
            const int c = c_lane + k * kStep;
            if (c >= C) break;
            const int off = k * kStep;
            float a[VEC], bb[VEC], cc[VEC], d[VEC], rk[VEC];
            load_vec<VEC>(t00 + off, a);
            load_vec<VEC>(t01 + off, bb);
            load_vec<VEC>(t10 + off, cc);
            load_vec<VEC>(t11 + off, d);
            if constexpr (CHUNKS > 0) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) rk[e] = r[k][e];
            } else {
              load_vec<VEC>(ref_px + c, rk);
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float warped = a[e] * w00 + bb[e] * w01 + cc[e] * w10 + d[e] * w11;
              part = DOT ? part + rk[e] * warped : part + fabsf(rk[e] - warped);
            }
          }
        }
        total += wv * (DOT ? part * inv_channels : part);
      }
      // the channel sum over the pixel's lanes; every lane gets it
#pragma unroll
      for (int s = kLanes / 2; s >= 1; s /= 2) total += __shfl_xor_sync(0xffffffffu, total, s);
      if (j == 0) s_out[q][pix] = total;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_chunk * kPixels; i += kThreads) {
      const int q = i / kPixels;
      const int px = i % kPixels;
      const int ox = blockIdx.x * kTileX + px % kTileX;
      const int oy = blockIdx.y * kRows + px / kTileX;
      if (ox < W && oy < H) {
        float* o = out + (((int64_t)b * P + p_begin + pc + q) * H + oy) * W + ox;
        *o = accumulate ? *o + s_out[q][px] : s_out[q][px];
      }
    }
  }
}

// Small-channel variant: tile, register target and plane split. Each was
// timed against the other settings tried (PERF.md).
constexpr int kSmallMaxChannels = 4;
constexpr int kSmallRows = 8;             // rows of the tile; kTileX columns
constexpr int kSmallThreads = kTileX * kSmallRows;
constexpr int kSmallMinBlocks = 4;        // resident blocks per SM that ptxas must fit
constexpr int kSmallTargetBlocks = 2048;  // blocks below which planes are split over blocks
constexpr int kSmallMaxShared = 227 * 1024;
static_assert(kSmallThreads % 32 == 0 && kSmallThreads <= 1024, "small block size");

// The C channels of four bilinear taps.
template <int C>
__device__ __forceinline__ void gather_taps(const float* t00, const float* t01, const float* t10,
                                            const float* t11, float (&a)[C], float (&bb)[C],
                                            float (&cc)[C], float (&d)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a[c] = __ldg(t00 + c);
    bb[c] = __ldg(t01 + c);
    cc[c] = __ldg(t10 + c);
    d[c] = __ldg(t11 + c);
  }
}

// One thread a reference pixel, C <= 4 channels in registers. Same
// arguments as plane_sweep_kernel; the block takes kTileX x kSmallRows
// pixels of batch element b and planes_per_block planes.
template <int C, bool DOT>
__global__ void __launch_bounds__(kSmallThreads, kSmallMinBlocks)
plane_sweep_small_kernel(const float* __restrict__ ref,      // (B, H, W, C)
                         const float* __restrict__ meas,     // (B, v_stride, H, W, C)
                         const float* __restrict__ mats,     // (B, v_stride, P, 3, 3)
                         const float* __restrict__ weights,  // (B, v_stride)
                         float* __restrict__ out,            // (B, P, H, W)
                         int V, int v_stride, int P, int H, int W, int planes_per_block,
                         bool accumulate) {
  extern __shared__ float4 shared4[];
  float* s_mats = reinterpret_cast<float*>(shared4);
  float* s_w = s_mats + V * planes_per_block * kMatStride;

  const int splits = (P + planes_per_block - 1) / planes_per_block;
  const int b = blockIdx.z / splits;
  const int p_begin = (blockIdx.z % splits) * planes_per_block;
  const int n_planes = min(P - p_begin, planes_per_block);

  for (int i = threadIdx.x; i < V * n_planes * 9; i += kSmallThreads) {
    const int v = i / (n_planes * 9);
    const int p = i / 9 - v * n_planes;
    const int e = i % 9;
    s_mats[(v * planes_per_block + p) * kMatStride + e] =
        mats[(((int64_t)b * v_stride + v) * P + p_begin + p) * 9 + e];
  }
  for (int v = threadIdx.x; v < V; v += kSmallThreads) s_w[v] = weights[b * v_stride + v];
  __syncthreads();  // the only barrier: threads off the image may leave after it

  const int x = blockIdx.x * kTileX + threadIdx.x % kTileX;
  const int y = blockIdx.y * kSmallRows + threadIdx.x / kTileX;
  if (x >= W || y >= H) return;
  const float xf = (float)x, yf = (float)y;
  const float x_scale = plane_sweep::align_scale(W);
  const float y_scale = plane_sweep::align_scale(H);

  const float* ref_px = ref + (((int64_t)b * H + y) * W + x) * C;
  float r[C];
  float abs_r = 0.0f;  // L1 mode: sum_c |ref|, the cost of a sample whose taps are all zero
#pragma unroll
  for (int c = 0; c < C; ++c) {
    r[c] = __ldg(ref_px + c);
    abs_r += fabsf(r[c]);
  }
  const float* meas_b = meas + (int64_t)b * v_stride * H * W * C;
  float* o = out + (((int64_t)b * P + p_begin) * H + y) * W + x;
  const int64_t plane_stride = (int64_t)H * W;

#pragma unroll 1
  for (int q = 0; q < n_planes; ++q, o += plane_stride) {
    float total = 0.0f;
#pragma unroll 1
    for (int v = 0; v < V; ++v) {
      const float wv = s_w[v];
      if (wv == 0.0f) continue;  // a padded view contributes nothing
      const float4* m4 =
          reinterpret_cast<const float4*>(s_mats + (v * planes_per_block + q) * kMatStride);
      const float4 ma = m4[0], mb = m4[1], mc = m4[2];
      const float m[9] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w, mc.x};
      const plane_sweep::Taps t =
          plane_sweep::bilinear_taps(m, xf, yf, x_scale, y_scale, W, H);
      float part = 0.0f;
      if (!t.in_range) {
        part = DOT ? 0.0f : abs_r;  // all four taps are zero
      } else {
        const float* base = meas_b + (int64_t)v * H * W * C;
        // the weights and channels of taps (x0, y0), (x0 + 1, y0), (x0, y0 + 1)
        // and (x0 + 1, y0 + 1)
        float w00, w01, w10, w11;
        float a[C], bb[C], cc[C], d[C];
        if (t.x0 >= 0 && t.x0 + 1 < W && t.y0 >= 0 && t.y0 + 1 < H) {
          // all four taps inside: two pairs of adjacent pixels, one address
          w00 = t.wy0 * t.wx0;
          w01 = t.wy0 * t.wx1;
          w10 = t.wy1 * t.wx0;
          w11 = t.wy1 * t.wx1;
          const float* t00 = base + (int64_t)(t.y0 * W + t.x0) * C;
          const float* t10 = t00 + (int64_t)W * C;
          gather_taps<C>(t00, t00 + C, t10, t10 + C, a, bb, cc, d);
        } else {
          const bool vx0 = t.x0 >= 0, vx1 = t.x0 + 1 < W;
          const bool vy0 = t.y0 >= 0, vy1 = t.y0 + 1 < H;
          // an invalid tap reads pixel 0 of the view with weight 0
          w00 = vy0 && vx0 ? t.wy0 * t.wx0 : 0.0f;
          w01 = vy0 && vx1 ? t.wy0 * t.wx1 : 0.0f;
          w10 = vy1 && vx0 ? t.wy1 * t.wx0 : 0.0f;
          w11 = vy1 && vx1 ? t.wy1 * t.wx1 : 0.0f;
          const int row0 = t.y0 * W, row1 = row0 + W;
          gather_taps<C>(base + (int64_t)(vy0 && vx0 ? row0 + t.x0 : 0) * C,
                         base + (int64_t)(vy0 && vx1 ? row0 + t.x0 + 1 : 0) * C,
                         base + (int64_t)(vy1 && vx0 ? row1 + t.x0 : 0) * C,
                         base + (int64_t)(vy1 && vx1 ? row1 + t.x0 + 1 : 0) * C, a, bb, cc, d);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float warped = a[c] * w00 + bb[c] * w01 + cc[c] * w10 + d[c] * w11;
          part = DOT ? part + r[c] * warped : part + fabsf(r[c] - warped);
        }
      }
      total += wv * (DOT ? part * (1.0f / C) : part);
    }
    *o = accumulate ? *o + total : total;
  }
}

template <int C>
int launch_small_c(bool dot, dim3 grid, size_t shared, cudaStream_t stream, const float* ref,
                   const float* meas, const float* mats, const float* weights, float* out, int V,
                   int v_stride, int P, int H, int W, int planes_per_block, bool accumulate) {
  auto kernel = plane_sweep_small_kernel<C, true>;
  if (!dot) kernel = plane_sweep_small_kernel<C, false>;
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kSmallThreads, shared, stream>>>(ref, meas, mats, weights, out, V, v_stride, P,
                                                   H, W, planes_per_block, accumulate);
  return (int)cudaGetLastError();
}

// One launch of the small-channel kernel over views [0, V), as launch_views.
int launch_small(const float* ref, const float* meas, const float* mats, const float* weights,
                 float* out, int B, int V, int v_stride, int P, int H, int W, int C, bool dot,
                 bool accumulate, cudaStream_t s) {
  const int64_t tiles_x = (W + kTileX - 1) / kTileX;
  const int64_t tiles_y = (H + kSmallRows - 1) / kSmallRows;
  const int64_t tiles = tiles_x * tiles_y * B;
  // split the planes over blocks while the tiles alone leave the card short
  // of blocks; the block's matrices and weights must fit its shared memory
  const int64_t want = kSmallTargetBlocks / tiles;
  const int splits = (int)(want < 1 ? 1 : want > P ? P : want);
  int planes_per_block = (P + splits - 1) / splits;
  const int64_t fit = (kSmallMaxShared - (int64_t)V * (int64_t)sizeof(float)) /
                      ((int64_t)V * kMatStride * (int64_t)sizeof(float));
  if (fit < 1) return (int)cudaErrorInvalidValue;
  if (planes_per_block > fit) planes_per_block = (int)fit;
  const int64_t blocks_z = (int64_t)B * ((P + planes_per_block - 1) / planes_per_block);
  if (tiles_y > 65535 || blocks_z > 65535 || tiles_x > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y, (unsigned)blocks_z);
  const size_t shared = sizeof(float) * ((size_t)V * planes_per_block * kMatStride + V);
#define PS_SMALL(CH)                                                                         \
  launch_small_c<CH>(dot, grid, shared, s, ref, meas, mats, weights, out, V, v_stride, P, H, \
                     W, planes_per_block, accumulate)
  switch (C) {
    case 1: return PS_SMALL(1);
    case 2: return PS_SMALL(2);
    case 3: return PS_SMALL(3);
    case 4: return PS_SMALL(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PS_SMALL
}

template <int VEC, int CHUNKS, bool DOT>
int launch_one(dim3 grid, size_t shared, cudaStream_t stream, const float* ref, const float* meas,
               const float* mats, const float* weights, float* out, int V, int v_stride, int P,
               int H, int W, int C, int planes_per_block, bool accumulate) {
  auto kernel = plane_sweep_kernel<VEC, CHUNKS, DOT>;
  if (shared > (size_t)kDefaultShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, shared, stream>>>(ref, meas, mats, weights, out, V, v_stride, P, H, W,
                                              C, planes_per_block, accumulate, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

template <int VEC, int CHUNKS>
int launch(bool dot, dim3 grid, size_t shared, cudaStream_t stream, const float* ref,
           const float* meas, const float* mats, const float* weights, float* out, int V,
           int v_stride, int P, int H, int W, int C, int planes_per_block, bool accumulate) {
  return dot ? launch_one<VEC, CHUNKS, true>(grid, shared, stream, ref, meas, mats, weights, out,
                                             V, v_stride, P, H, W, C, planes_per_block,
                                             accumulate)
             : launch_one<VEC, CHUNKS, false>(grid, shared, stream, ref, meas, mats, weights,
                                              out, V, v_stride, P, H, W, C, planes_per_block,
                                              accumulate);
}

// One launch over views [0, V) of (B, v_stride) views; the pointers are
// already offset to the first view.
int launch_views(const float* ref, const float* meas, const float* mats, const float* weights,
                 float* out, int B, int V, int v_stride, int P, int H, int W, int C, bool dot,
                 bool vec4, bool accumulate, cudaStream_t s) {
  if (C <= kSmallMaxChannels)
    return launch_small(ref, meas, mats, weights, out, B, V, v_stride, P, H, W, C, dot,
                        accumulate, s);
  const int64_t tiles_x = (W + kTileX - 1) / kTileX;
  const int64_t tiles_y = (H + kRows - 1) / kRows;
  const int64_t tiles = tiles_x * tiles_y * B;
  // split the planes (in whole chunks) over blocks while the tiles alone
  // leave the card short of blocks
  const int chunks = (P + kChunk - 1) / kChunk;
  const int64_t want = kTargetBlocks / tiles;
  const int splits = (int)(want < 1 ? 1 : want > chunks ? chunks : want);
  int planes_per_block = (chunks + splits - 1) / splits * kChunk;
  // the block's matrices, coordinates and weights must fit its shared memory
  const int64_t per_plane = (int64_t)V * kMatStride * sizeof(float);
  const int64_t fixed = shared_floats(V, 0) * (int64_t)sizeof(float);
  const int64_t fit = fixed >= kMaxShared ? 0 : (kMaxShared - fixed) / per_plane / kChunk * kChunk;
  if (fit < kChunk) return (int)cudaErrorInvalidValue;
  if (planes_per_block > fit) planes_per_block = (int)fit;
  const int64_t blocks_z = (int64_t)B * ((P + planes_per_block - 1) / planes_per_block);
  if (tiles_y > 65535 || blocks_z > 65535 || tiles_x > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y, (unsigned)blocks_z);
  const size_t shared = sizeof(float) * (size_t)shared_floats(V, planes_per_block);
  const int loads = (C + kLanes * (vec4 ? 4 : 1) - 1) / (kLanes * (vec4 ? 4 : 1));
#define PS_LAUNCH(VEC, CHUNKS)                                                                 \
  launch<VEC, CHUNKS>(dot, grid, shared, s, ref, meas, mats, weights, out, V, v_stride, P, H, W, \
                      C, planes_per_block, accumulate)
  if (vec4) {
    if (loads <= 1) return PS_LAUNCH(4, 1);
    if (loads <= 2) return PS_LAUNCH(4, 2);
    if (loads <= 4) return PS_LAUNCH(4, 4);
    return PS_LAUNCH(4, 0);
  }
  if (loads <= 4) return PS_LAUNCH(1, 4);
  if (loads <= 8) return PS_LAUNCH(1, 8);
  return PS_LAUNCH(1, 0);
#undef PS_LAUNCH
}

// The views one launch can take: a block holds one chunk of planes for each.
// The small-channel kernel takes the same groups (its block holds at least
// one plane's matrix a view), so the count of launches depends on V alone.
constexpr int kViewsPerLaunch = (int)(kMaxShared / (shared_floats(1, kChunk) * sizeof(float)));

}  // namespace

// Plain C entry points, loaded with ctypes. All tensors are contiguous f32 on
// the device; `stream` is a cudaStream_t. Returns cudaGetLastError() after
// the last launch (0 on success); plane_sweep_launches(V) launches it makes.
extern "C" int plane_sweep_multiview(const float* ref, const float* meas, const float* mats,
                                     const float* weights, float* out, int B, int V, int P,
                                     int H, int W, int C, int dot_product, void* stream) {
  if (B <= 0 || V <= 0 || P <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need every tap (a multiple of C floats from the base) on a
  // 16-byte boundary; a tensor viewed at an odd offset takes scalar loads
  const bool vec4 = C % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(meas)) % 16) == 0;
  const int group = kViewsPerLaunch < V ? kViewsPerLaunch : V;
  for (int v0 = 0; v0 < V; v0 += group) {
    const int n = V - v0 < group ? V - v0 : group;
    const int err = launch_views(ref, meas + (int64_t)v0 * H * W * C, mats + (int64_t)v0 * P * 9,
                                 weights + v0, out, B, n, V, P, H, W, C, dot_product != 0, vec4,
                                 v0 > 0, s);
    if (err != 0) return err;
  }
  return 0;
}

extern "C" int plane_sweep_launches(int V) {
  return V <= 0 ? 0 : (V + kViewsPerLaunch - 1) / kViewsPerLaunch;
}
