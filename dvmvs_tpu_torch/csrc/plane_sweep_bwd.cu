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
// V = 2 with a masked view takes the same kernel, zero-weight views skipped
// (their d_meas stays exactly 0).
//
// Bound: per in-range (pixel, plane, view) sample the kernel gathers 4 taps
// of C floats for d_ref, as the forward does, and adds 4 taps of C floats
// into d_meas. The data-sheet bound at the training shape (B=4, V=1, C=32,
// 128x128, P=64) is 21-23 us of float32 operations (50.3 MB of compulsory
// traffic is 15.0 us); what binds in practice is the gathers' L1 requests,
// their latency, and the scatter into d_meas. PR 2's kernel issued one
// float4 atomicAdd into L2 per (sample, tap, 4 channels), 134 M of them
// there, and recomputed each sample's projection on every lane of its pixel.
// Design, the forward's structure (csrc/plane_sweep.cu) carried over:
//   - Lanes over channels. kLanes lanes take one reference pixel; lane j
//     holds channels [4j, 4j + 4) of every 4 * kLanes and loads float4 taps
//     (coalesced). A block takes a kTileX x kRows tile of one batch element
//     and all its planes, so each lane sums its slice of d_ref in registers
//     in a fixed order and writes it once: no atomics on d_ref, and it is
//     the same to the bit from call to call.
//   - The view's matrices are staged in shared memory once. For each chunk
//     of kChunk planes the block projects every (plane, pixel) once, one
//     thread each (plane_sweep_common.cuh's project, so the taps are the
//     forward's), stages the chunk's g * w_v / C with coalesced loads, and
//     bounds the chunk's top-left taps by one block reduction.
//   - d_meas: route (A), the chunk's tap updates summed in the block and
//     then added to d_meas with one float4 atomicAdd per source pixel and 4
//     channels, but summed by binning instead of shared float atomics. The
//     chunk's samples are binned by their top-left tap (one shared int
//     atomic each); then kLanes lanes take each source pixel of the box and
//     sum, in registers, the contributions of the up to four bins whose
//     taps cover it. Under typical motion a chunk's 2048 tap updates land
//     on a box not much larger than the tile (taps move by under a pixel a
//     plane), so the global atomics are far fewer: a copy without them was
//     0.01 ms faster.
//     A sample whose bin is full (more than kSlots samples: a mapping that
//     shrinks the image) and a chunk whose box has more than kMaxBins bins
//     scatter straight to d_meas, one atomic per tap and 4 channels. Both
//     routes are exact for any geometry: no band precondition. d_meas is
//     summed across blocks by atomics in no fixed order.
//   Why (PERF.md section 6, apps/bench_plane_sweep.py --kernel backward,
//   the training shape, same-call timings on an H100 at 700 W): a copy with
//   the d_meas scatter cut took 0.16 ms against PR 3's kernel's 0.51 ms, so
//   d_meas's atomics took the rest. Route (A) as first written, a
//   shared-memory window summed by shared float atomicAdd, took 0.94 ms
//   (shared float atomics cost more than the L2 atomics they saved); every
//   tap straight to global memory from this kernel's lanes took 0.64-0.82
//   ms. The binned sum takes 0.39 ms, and a copy without its gather
//   0.22 ms: the per-source-pixel gather, latency-bound, is what is left
//   (2 lanes a source pixel took 0.46 ms, 8 lanes 0.51 ms). A gather over
//   the whole image per source pixel (route (B): an inverse-homography
//   bound per source pixel) was not built.
// TMA and wgmma are left out: there is no matrix product, and the source rows
// a tile reads are unbounded under roll or behind the camera.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "plane_sweep_common.cuh"

namespace {

// Tile shape, register target and bin budget (PERF.md section 6): 3 blocks
// an SM (80 registers) timed faster than 2 and 4, 4 lanes a source pixel
// faster than 1, 2 and 8.
constexpr int kLanes = 4;               // lanes per reference pixel, and per source pixel of d_meas
constexpr int kTileX = 32;
constexpr int kRows = 2;                // rows of the tile
constexpr int kMinBlocks = 3;           // resident blocks per SM that ptxas must fit in registers
constexpr int kMaxBins = 1024;          // top-left taps a chunk's box may hold to be gathered
constexpr int kSlots = 12;              // samples a bin holds
constexpr int kPixels = kTileX * kRows;
constexpr int kThreads = kPixels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;               // planes projected and scattered together
constexpr int kSamples = kChunk * kPixels;
constexpr int kPerThread = (kSamples + kThreads - 1) / kThreads;  // samples a thread projects
constexpr int kMatStride = 12;          // a 3x3 matrix padded to three float4
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8, "kLanes");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");
static_assert(kSamples <= 65536, "sample ids are 16 bits");
// dynamic shared memory (the view's matrices) beyond 48 KB in all needs an
// opt-in; Hopper allows 227 KB a block
constexpr int kStaticShared = (int)sizeof(float) * 7 * kSamples + (int)sizeof(int4) * kWarps +
                              (int)sizeof(int) * kMaxBins +
                              (int)sizeof(unsigned short) * kMaxBins * kSlots;
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

// Adds v to global memory at p: one vector atomic for VEC = 4.
template <int VEC>
__device__ __forceinline__ void atomic_add_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// d_ref's share of one chunk for one lane of a reference pixel: the
// forward's gather over the chunk's planes, weighted by g * w_v / C, summed
// into acc (CHUNKS > 0) or into d_ref in place (CHUNKS = 0). With SCATTER it
// also adds each tap's d_meas straight to global memory.
template <int VEC, int CHUNKS, bool SCATTER>
__device__ __forceinline__ void gather_d_ref(const float2* s_xy, const float* s_val,
                                             int n_samples, int pix, int W, int H, int C,
                                             int c_lane, const float* meas_v, float* d_meas_v,
                                             const float* ref_px, float* d_ref_px,
                                             float (&acc)[CHUNKS ? CHUNKS : 1][VEC]) {
  constexpr int kStep = kLanes * VEC;
  const int n_loads = CHUNKS ? CHUNKS : (C + kStep - 1) / kStep;
#pragma unroll 1
  for (int i = pix; i < n_samples; i += kPixels) {
    const float2 xy = s_xy[i];
    const plane_sweep::Taps t = plane_sweep::taps_at(xy.x, xy.y, W, H);
    if (!t.in_range) continue;  // all four taps are zero
    const float gs = s_val[i];
    const bool vx0 = t.x0 >= 0, vx1 = t.x0 + 1 < W;
    const bool vy0 = t.y0 >= 0, vy1 = t.y0 + 1 < H;
    // an invalid tap reads pixel 0 of the view with weight 0
    const float w00 = vy0 && vx0 ? t.wy0 * t.wx0 : 0.0f;
    const float w01 = vy0 && vx1 ? t.wy0 * t.wx1 : 0.0f;
    const float w10 = vy1 && vx0 ? t.wy1 * t.wx0 : 0.0f;
    const float w11 = vy1 && vx1 ? t.wy1 * t.wx1 : 0.0f;
    const int row0 = t.y0 * W, row1 = row0 + W;
    const int64_t o00 = (int64_t)(vy0 && vx0 ? row0 + t.x0 : 0) * C;
    const int64_t o01 = (int64_t)(vy0 && vx1 ? row0 + t.x0 + 1 : 0) * C;
    const int64_t o10 = (int64_t)(vy1 && vx0 ? row1 + t.x0 : 0) * C;
    const int64_t o11 = (int64_t)(vy1 && vx1 ? row1 + t.x0 + 1 : 0) * C;
#pragma unroll
    for (int k = 0; k < n_loads; ++k) {
      const int off = k * kStep;
      if (c_lane + off >= C) break;
      float a[VEC], bb[VEC], cc[VEC], d[VEC];
      load_vec<VEC>(meas_v + o00 + off, a);
      load_vec<VEC>(meas_v + o01 + off, bb);
      load_vec<VEC>(meas_v + o10 + off, cc);
      load_vec<VEC>(meas_v + o11 + off, d);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float sum = gs * (a[e] * w00 + bb[e] * w01 + cc[e] * w10 + d[e] * w11);
        if constexpr (CHUNKS > 0) {
          acc[k][e] += sum;
        } else {
          d_ref_px[off + e] += sum;
        }
      }
      if constexpr (SCATTER) {
        float rk[VEC];
        load_vec<VEC>(ref_px + off, rk);
        const float tw[4] = {gs * w00, gs * w01, gs * w10, gs * w11};
        const bool tv[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
        const int64_t to[4] = {o00, o01, o10, o11};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (!tv[n]) continue;
          float s[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) s[e] = tw[n] * rk[e];
          atomic_add_vec<VEC>(d_meas_v + to[n] + c_lane + off, s);
        }
      }
    }
  }
}

// d_meas of one chunk by source pixel: the source pixels that the binned
// samples' taps reach, kLanes lanes each. A sample of bin (bx, by)
// reaches (bx + dx, by + dy) with weight g * w_v / C * (dx ? wx1 : wx0) *
// (dy ? wy1 : wy0), from s_wt = (g * w_v / C * (wx0, wx1), wy0, wy1); each
// lane sums its channels in registers and adds them with one atomic per
// load. ref_tile: the tile's first reference pixel.
template <int VEC, int CHUNKS>
__device__ __forceinline__ void gather_d_meas(const int* s_count, const unsigned short* s_ids,
                                              const float4* s_wt, int4 box, int W, int H, int C,
                                              const float* ref_tile, float* d_meas_v) {
  constexpr int kStep = kLanes * VEC;
  const int c0 = (threadIdx.x % kLanes) * VEC;
  const int nbx = box.y - box.x + 1, nby = box.w - box.z + 1;
  const int sx0 = max(box.x, 0), sx1 = min(box.y + 1, W - 1);
  const int sy0 = max(box.z, 0), sy1 = min(box.w + 1, H - 1);
  const int nsx = sx1 - sx0 + 1;
  const int n_cells = nsx * (sy1 - sy0 + 1);
  const int row = W * C;
  for (int cell = threadIdx.x / kLanes; cell < n_cells; cell += kPixels) {
    const int sx = sx0 + cell % nsx, sy = sy0 + cell / nsx;
    float m[CHUNKS][VEC];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) m[k][e] = 0.0f;
    }
    bool any = false;
#pragma unroll 1
    for (int n = 0; n < 4; ++n) {
      const int dx = n & 1, dy = n >> 1;
      const int bx = sx - dx - box.x, by = sy - dy - box.z;
      if (bx < 0 || bx >= nbx || by < 0 || by >= nby) continue;
      const int bin = by * nbx + bx;
      const int count = min(s_count[bin], kSlots);
      any |= count > 0;
#pragma unroll 1
      for (int s = 0; s < count; ++s) {
        const int i = s_ids[bin * kSlots + s];
        const int p = i % kPixels;
        const float4 wt = s_wt[i];
        const float tw = (dx ? wt.y : wt.x) * (dy ? wt.w : wt.z);
        const float* rp = ref_tile + (p / kTileX) * row + (p % kTileX) * C + c0;
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
          if (c0 + k * kStep >= C) break;
          float rk[VEC];
          load_vec<VEC>(rp + k * kStep, rk);
#pragma unroll
          for (int e = 0; e < VEC; ++e) m[k][e] += tw * rk[e];
        }
      }
    }
    if (!any) continue;
    float* dst = d_meas_v + ((int64_t)sy * W + sx) * C + c0;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      if (c0 + k * kStep >= C) break;
      atomic_add_vec<VEC>(dst + k * kStep, m[k]);
    }
  }
}

// The d_meas of a sample whose bin is full, every channel by one thread,
// straight to global memory. rp: the sample's reference pixel.
__device__ __noinline__ void scatter_sample(float2 xy, float val, const float* rp, int W, int H,
                                            int C, float* d_meas_v) {
  const plane_sweep::Taps t = plane_sweep::taps_at(xy.x, xy.y, W, H);
#pragma unroll 1
  for (int n = 0; n < 4; ++n) {
    const int tx = t.x0 + (n & 1), ty = t.y0 + (n >> 1);
    if (tx < 0 || tx >= W || ty < 0 || ty >= H) continue;
    const float tw = val * (n >> 1 ? t.wy1 : t.wy0) * (n & 1 ? t.wx1 : t.wx0);
    float* dst = d_meas_v + ((int64_t)ty * W + tx) * C;
#pragma unroll 1
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, tw * __ldg(rp + c));
  }
}

// VEC: channels per load (4 = float4); CHUNKS: loads per lane and tap, with
// d_ref and a source pixel's d_meas summed in registers (0: any C, d_ref
// summed in place in global memory by its one owner thread, every chunk
// scattered straight to d_meas).
template <int VEC, int CHUNKS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
plane_sweep_bwd_kernel(const float* __restrict__ ref,      // (B, H, W, C)
                       const float* __restrict__ meas,     // (B, V, H, W, C)
                       const float* __restrict__ mats,     // (B, V, P, 3, 3)
                       const float* __restrict__ weights,  // (B, V)
                       const float* __restrict__ g,        // (B, P, H, W)
                       float* __restrict__ d_ref,          // (B, H, W, C)
                       float* __restrict__ d_meas,         // (B, V, H, W, C), zeroed
                       int V, int P, int H, int W, int C, float inv_channels) {
  extern __shared__ float4 shared4[];
  float* s_mats = reinterpret_cast<float*>(shared4);  // (P, kMatStride): one view's
  __shared__ float2 s_xy[kSamples];                    // the chunk's coordinates
  __shared__ float s_val[kSamples];                    // and g * w_v / C, by plane and pixel
  __shared__ float4 s_wt[kSamples];                    // and g * w_v / C * (wx0, wx1), wy0, wy1
  __shared__ int4 s_box[kWarps];                       // each warp's box of top-left taps
  __shared__ int s_count[kMaxBins];                    // samples claimed per bin
  __shared__ unsigned short s_ids[kMaxBins * kSlots];  // sample ids per bin

  const int b = blockIdx.z;
  const int j = threadIdx.x % kLanes;     // lane within the pixel's group
  const int pix = threadIdx.x / kLanes;   // pixel within the tile
  const int tile_x = blockIdx.x * kTileX, tile_y = blockIdx.y * kRows;
  const int x = tile_x + pix % kTileX;
  const int y = tile_y + pix / kTileX;
  const bool valid = x < W && y < H;
  const float x_scale = plane_sweep::align_scale(W);
  const float y_scale = plane_sweep::align_scale(H);
  const int64_t plane_stride = (int64_t)H * W;

  constexpr int kStep = kLanes * VEC;     // channels between a lane's loads
  const int c_lane = j * VEC;
  const float* ref_b = ref + (int64_t)b * plane_stride * C;
  const float* ref_tile = ref_b + ((int64_t)tile_y * W + tile_x) * C;
  const int64_t px = (int64_t)(valid ? y : 0) * W + (valid ? x : 0);
  const float* ref_px = ref_b + px * C + c_lane;
  float* d_ref_px = d_ref + (int64_t)b * plane_stride * C + px * C + c_lane;
  float acc[CHUNKS ? CHUNKS : 1][VEC];
#pragma unroll
  for (int k = 0; k < (CHUNKS ? CHUNKS : 1); ++k) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.0f;
  }
  if constexpr (CHUNKS == 0) {
    if (valid) {
      for (int c = c_lane; c < C; c += kStep) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) d_ref_px[c - c_lane + e] = 0.0f;
      }
    }
  }

  for (int v = 0; v < V; ++v) {
    const float wv = __ldg(weights + b * V + v);
    if (wv == 0.0f) continue;  // a padded view has no gradient: its d_meas stays 0
    const float scale = wv * inv_channels;
    const int64_t view = ((int64_t)b * V + v) * plane_stride * C;
    const float* meas_v = meas + view + c_lane;
    float* d_meas_v = d_meas + view;
    const float* mats_v = mats + ((int64_t)b * V + v) * P * 9;
    __syncthreads();  // the previous view's matrices are read
    for (int i = threadIdx.x; i < P * 9; i += kThreads) {
      s_mats[(i / 9) * kMatStride + i % 9] = __ldg(mats_v + i);
    }

    for (int pc = 0; pc < P; pc += kChunk) {
      const int n_samples = min(kChunk, P - pc) * kPixels;
      __syncthreads();  // the matrices are staged; the last chunk's shared data are read
      // project every (plane, pixel) sample of the chunk once, stage g * w_v
      // / C, and bound the top-left taps of the samples that touch the image
      int4 box = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);  // x lo, x hi, y lo, y hi
      int tap_x[kPerThread], tap_y[kPerThread];  // top-left taps; INT_MIN: no sample
#pragma unroll
      for (int n = 0; n < kPerThread; ++n) {
        const int i = threadIdx.x + n * kThreads;
        tap_x[n] = tap_y[n] = INT_MIN;
        if (i >= n_samples) continue;
        const int q = i / kPixels;
        const int p = i % kPixels;
        const int ox = tile_x + p % kTileX;
        const int oy = tile_y + p / kTileX;
        const float4* m4 = reinterpret_cast<const float4*>(s_mats + (pc + q) * kMatStride);
        const float4 ma = m4[0], mb = m4[1], mc = m4[2];
        const float m[9] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w, mc.x};
        float2 xy;
        plane_sweep::project(m, (float)ox, (float)oy, x_scale, y_scale, xy.x, xy.y);
        s_xy[i] = xy;
        const bool inside = ox < W && oy < H;
        const float val = inside ? __ldg(g + ((int64_t)b * P + pc + q) * plane_stride +
                                         (int64_t)oy * W + ox) * scale
                                 : 0.0f;
        s_val[i] = val;
        const plane_sweep::Taps t = plane_sweep::taps_at(xy.x, xy.y, W, H);
        if (inside && t.in_range) {
          s_wt[i] = make_float4(val * t.wx0, val * t.wx1, t.wy0, t.wy1);
          tap_x[n] = t.x0;
          tap_y[n] = t.y0;
          box = make_int4(min(box.x, t.x0), max(box.y, t.x0), min(box.z, t.y0),
                          max(box.w, t.y0));
        }
      }
      box.x = __reduce_min_sync(0xffffffffu, box.x);
      box.y = __reduce_max_sync(0xffffffffu, box.y);
      box.z = __reduce_min_sync(0xffffffffu, box.z);
      box.w = __reduce_max_sync(0xffffffffu, box.w);
      if (threadIdx.x % 32 == 0) s_box[threadIdx.x / 32] = box;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int4 o = s_box[w];
        box = make_int4(min(box.x, o.x), max(box.y, o.y), min(box.z, o.z), max(box.w, o.w));
      }
      if (box.x > box.y) continue;  // no sample of the chunk touches the image
      // bins: the top-left taps' box, in [-1, W - 1] x [-1, H - 1]
      const int nbx = box.y - box.x + 1;
      const int n_bins = nbx * (box.w - box.z + 1);

      if (CHUNKS == 0 || n_bins > kMaxBins) {  // every tap straight to d_meas
        if (valid) {
          gather_d_ref<VEC, CHUNKS, true>(s_xy, s_val, n_samples, pix, W, H, C, c_lane, meas_v,
                                          d_meas_v, ref_px, d_ref_px, acc);
        }
        continue;
      }
      if constexpr (CHUNKS > 0) {
        for (int i = threadIdx.x; i < n_bins; i += kThreads) s_count[i] = 0;
        __syncthreads();
        // each sample claims a slot in its bin; a full bin's sample scatters
        // straight to d_meas
#pragma unroll
        for (int n = 0; n < kPerThread; ++n) {
          if (tap_x[n] == INT_MIN) continue;
          const int i = threadIdx.x + n * kThreads;
          const int bin = (tap_y[n] - box.z) * nbx + tap_x[n] - box.x;
          const int slot = atomicAdd(s_count + bin, 1);
          if (slot < kSlots) {
            s_ids[bin * kSlots + slot] = (unsigned short)i;
          } else {
            const int p = i % kPixels;
            scatter_sample(s_xy[i], s_val[i],
                           ref_tile + (p / kTileX) * W * C + (p % kTileX) * C, W, H, C,
                           d_meas_v);
          }
        }
        __syncthreads();  // the bins are complete
        if (valid) {
          gather_d_ref<VEC, CHUNKS, false>(s_xy, s_val, n_samples, pix, W, H, C, c_lane, meas_v,
                                           d_meas_v, ref_px, d_ref_px, acc);
        }
        gather_d_meas<VEC, CHUNKS>(s_count, s_ids, s_wt, box, W, H, C, ref_tile, d_meas_v);
      }
    }
  }

  if constexpr (CHUNKS > 0) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        if (c_lane + k * kStep >= C) break;
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(d_ref_px + k * kStep) =
              make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        } else {
          d_ref_px[k * kStep] = acc[k][0];
        }
      }
    }
  }
}

template <int VEC, int CHUNKS>
int launch(dim3 grid, size_t shared, cudaStream_t stream, const float* ref, const float* meas,
           const float* mats, const float* weights, const float* g, float* d_ref, float* d_meas,
           int V, int P, int H, int W, int C) {
  auto kernel = plane_sweep_bwd_kernel<VEC, CHUNKS>;
  if (shared > (size_t)kDefaultShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, shared, stream>>>(ref, meas, mats, weights, g, d_ref, d_meas, V, P, H,
                                              W, C, 1.0f / (float)C);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. All tensors are contiguous f32 on
// the device, d_meas zero-filled by the caller; `stream` is a cudaStream_t.
// One launch for any V. Returns cudaGetLastError() after the launch (0 on
// success).
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
  const int64_t tiles_x = (W + kTileX - 1) / kTileX;
  const int64_t tiles_y = (H + kRows - 1) / kRows;
  if (tiles_y > 65535 || B > 65535 || tiles_x > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(float) * (size_t)P * kMatStride;
  if (shared > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_x, (unsigned)tiles_y, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int loads = (C + kLanes * (vec4 ? 4 : 1) - 1) / (kLanes * (vec4 ? 4 : 1));
#define PSB_LAUNCH(VEC, CHUNKS) \
  launch<VEC, CHUNKS>(grid, shared, s, ref, meas, mats, weights, g, d_ref, d_meas, V, P, H, W, C)
  if (vec4) {
    if (loads <= 1) return PSB_LAUNCH(4, 1);
    if (loads <= 2) return PSB_LAUNCH(4, 2);
    if (loads <= 4) return PSB_LAUNCH(4, 4);
    return PSB_LAUNCH(4, 0);
  }
  if (loads <= 4) return PSB_LAUNCH(1, 4);
  if (loads <= 8) return PSB_LAUNCH(1, 8);
  return PSB_LAUNCH(1, 0);
#undef PSB_LAUNCH
}
