// Modulated deformable convolution (DCNv2): the deformable sampling, as
// im2col columns, and its backward. Forward:
//     columns[p, k * Cin + c] = m[p, k] * sample(x, sy, sx)[c]
// for output pixel p = (i, j) of [Ho, Wo] and tap k = (a, b) of [kh, kw],
// where sy = (i * stride - padding + a * dilation) + offset[p, 2k],
//       sx = (j * stride - padding + b * dilation) + offset[p, 2k + 1],
// sample is the bilinear, zero-padded sample of x [H, W, Cin] (the four
// hat-weight corners, each corner's validity 0 <= y < H, 0 <= x < W folded
// into its weight) and m the tap's modulation (1 without a mask). x f32,
// offset [Ho, Wo, 2K] f32, mask [Ho, Wo, K] f32 or null, columns
// [Ho * Wo, K * Cin] f32. The wrapper contracts the columns with weight
// [K * Cin, Cout] in one f32 matmul (TF32 off).
//
// Replaces ops/deform_conv.py:modulated_deform_conv of the JAX package (a
// bilinear gather per tap through bilinear_sample_zero_pad, then an
// einsum; its backward by autodiff), itself the reference's DFConv2d over
// detectron2's ModulatedDeformConv CUDA op. The arithmetic is the plain
// version's (ops/deform_conv.py:deform_im2col_plain) in its order, with
// __fadd_rn/__fsub_rn/__fmul_rn so that no FMA contraction moves a sample
// across a pixel border: the corner taps v * w summed in the order
// top-left, top-right, bottom-left, bottom-right, then times the mask.
// Each corner reads x at its index clipped into the image, as the plain
// version does, so the columns are its bits.
//
// What bounds it on Hopper: bytes. Device memory must take the columns'
// stream (44.2 MB at 60 x 80 x 9 taps x 256 channels) and read x, the
// offsets and the mask once; each (pixel, tap) also reads 4 corner rows of
// Cin contiguous f32 (177 MB at that level), mostly from L1 and L2 (x is
// 4.9 MB there, and neighbouring samples share corners). A warp owns a
// (pixel, tap): it does the corner set-up once (the sample's coordinates,
// floors, hats, validity and clipped pixels, in 32-bit index arithmetic),
// and its lanes take the channels as float4 quads (lane + 32 j), two
// quads' four corner rows loaded with 16-byte __ldg before any arithmetic,
// each column row stored with 16-byte streaming stores (__stcs). A Cin %
// 4 != 0 or a pointer off a 16-byte boundary takes the same kernel with
// one channel a lane a step.
//
// Backward, for a loss through the columns (grad_columns = grad_out @
// weight^T, a matmul in the wrapper), as JAX's autodiff differentiates the
// plain version:
//   grad_x[corner, c]      += (g * m) * w_corner at each valid corner
//                             (atomics into a zeroed [H, W, Cin]: many taps
//                             sample the same pixels)
//   grad_mask[p, k]         = sum_c g * sample[c]
//   grad_offset[p, 2k(+1)]  = sum over corners of (sum_c (g * m) * v) *
//                             d w_corner / d(ly, lx), valid corners only;
//                             floor() has no gradient, so a sample on row -1
//                             keeps the row-0 corner's term (JAX's
//                             gradient, not mmcv's)
// The backward takes the forward's lane map: a warp a (pixel, tap), the
// corner set-up once, lanes over the channels' float4 quads (lane + 32 j),
// two quads a step whose 16-byte loads are all issued before any
// arithmetic (grad_columns streamed once with __ldcs, the four corner rows
// through __ldg); the first step's grad_columns loads, which need pk alone,
// go out with the offsets' loads, before the corner set-up waits for them.
// Each valid corner takes one float4 RED a quad (atomicAdd on a float4) of
// (g * m) * w. The five sums over Cin are per-lane partials over the lane's
// channels in order, each product rounded before its add (no FMA
// contraction), then reduced across the warp once: the four corner sums by
// a transposing butterfly (corner_sums, 10 shuffles in place of 20), the
// mask's by a butterfly; fixed trees, so grad_offset and grad_mask are the
// same every run. A Cin % 4 != 0, or x, grad_columns or grad_x off a
// 16-byte boundary, takes the same kernel with one channel a lane a step
// and one scalar RED a valid corner and channel.
//
// What bounds it on Hopper: the REDs. L2 adds f32 reductions at about 2.8
// TB/s of data on an H100, the same for float4 REDs, coalesced scalar ones
// and TMA bulk reductions (scripts/red_rate.py), so the float4 RED saves
// instructions, not L2 work: at 60 x 80 x 9 taps x 256 channels the ~3.9
// valid corners a sample add 173 MB into grad_x, ~61 us at that rate,
// against 16.5 us for the bytes the function must move; the loads and
// sums run under them. Fewer RED bytes need the terms summed before they
// leave the SM: a block over a tile of outputs adding into a shared window
// of grad_x was slower on this card, with shared f32 atomics
// (compare-and-swap loops) or with a lane a sample (loads of 32 rows a
// warp instruction); a gather by input pixel would read the 1 KB
// grad_columns row of each of the ~169 000 corner terms again.
//
// Built with -DEODT_COUNT (kernels/build.py, counting=True), the backward
// also counts what it issues: the bytes of grad_columns and of the corner
// rows its lanes load, and its REDs into grad_x, summed a warp and added
// to three device counters that deform_conv_tally reads and zeroes. The
// timed build counts nothing.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

#ifdef EODT_COUNT
// grad_columns bytes, corner bytes, REDs
__device__ unsigned long long g_tally[3];

// A lane's counts, added to g_tally once a warp (all 32 lanes call flush)
struct Tally {
  unsigned long long n[3] = {0, 0, 0};
  __device__ void add(int i, unsigned long long v) { n[i] += v; }
  __device__ void flush() {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      unsigned long long v = n[i];
      for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if ((threadIdx.x & 31) == 0 && v) atomicAdd(&g_tally[i], v);
    }
  }
};
#else
struct Tally {
  __device__ void add(int, unsigned long long) {}
  __device__ void flush() {}
};
#endif

struct Geometry {
  int h, w, cin, ho, wo, kh, kw, stride, padding, dilation;
};

// One sample's four corners: the flat pixel of each, clipped into the image
// (the plain version's gather index), its weight with the validity folded
// in, its validity, and the fractional parts.
struct Corners {
  int pix[4];
  float wgt[4];
  bool ok[4];
  float ly, lx;
};

__device__ __forceinline__ Corners corners(const Geometry& g, int i, int j,
                                           int a, int b, float dy, float dx) {
  Corners c;
  const float sy = __fadd_rn((float)(i * g.stride - g.padding + a * g.dilation),
                             dy);
  const float sx = __fadd_rn((float)(j * g.stride - g.padding + b * g.dilation),
                             dx);
  const float y0 = floorf(sy), x0 = floorf(sx);
  c.ly = __fsub_rn(sy, y0);
  c.lx = __fsub_rn(sx, x0);
  const float gy = __fsub_rn(1.f, c.ly), gx = __fsub_rn(1.f, c.lx);
  const float hat[4] = {__fmul_rn(gy, gx), __fmul_rn(gy, c.lx),
                        __fmul_rn(c.ly, gx), __fmul_rn(c.ly, c.lx)};
  // validity in float: y0, x0 are integral, so these are the integer tests,
  // and a coordinate too large for an int never converts unclipped
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float yy = y0 + (float)(k >> 1), xx = x0 + (float)(k & 1);
    c.ok[k] = yy >= 0.f && yy < (float)g.h && xx >= 0.f && xx < (float)g.w;
    const int yc = yy < 0.f ? 0 : (yy > (float)(g.h - 1) ? g.h - 1 : (int)yy);
    const int xc = xx < 0.f ? 0 : (xx > (float)(g.w - 1) ? g.w - 1 : (int)xx);
    c.pix[k] = yc * g.w + xc;
    c.wgt[k] = c.ok[k] ? hat[k] : 0.f;
  }
  return c;
}

// the column value of one channel: the corners in order, then the mask
__device__ __forceinline__ float sample(float v0, float v1, float v2,
                                        float v3, const Corners& cr,
                                        bool masked, float m) {
  float s = __fmul_rn(v0, cr.wgt[0]);
  s = __fadd_rn(s, __fmul_rn(v1, cr.wgt[1]));
  s = __fadd_rn(s, __fmul_rn(v2, cr.wgt[2]));
  s = __fadd_rn(s, __fmul_rn(v3, cr.wgt[3]));
  return masked ? __fmul_rn(s, m) : s;
}

__device__ __forceinline__ float4 sample4(const float4 (&v)[4],
                                          const Corners& cr, bool masked,
                                          float m) {
  return make_float4(sample(v[0].x, v[1].x, v[2].x, v[3].x, cr, masked, m),
                     sample(v[0].y, v[1].y, v[2].y, v[3].y, cr, masked, m),
                     sample(v[0].z, v[1].z, v[2].z, v[3].z, cr, masked, m),
                     sample(v[0].w, v[1].w, v[2].w, v[3].w, cr, masked, m));
}

// a warp a (pixel, tap) pk = p * K + k; kQuads: 16-byte lanes
template <bool kQuads>
__global__ void __launch_bounds__(kThreads)
    deform_im2col_fwd(const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ mask,
                      float* __restrict__ cols, const Geometry g,
                      int pairs) {
  const int pk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pk >= pairs) return;           // whole warps leave together
  const int taps = g.kh * g.kw;
  const int p = pk / taps, k = pk - p * taps;
  const int i = p / g.wo, j = p - i * g.wo;
  const int a = k / g.kw, b = k - a * g.kw;
  const Corners cr = corners(g, i, j, a, b, __ldg(offset + 2LL * pk),
                             __ldg(offset + 2LL * pk + 1));
  const bool masked = mask != nullptr;
  const float m = masked ? __ldg(mask + pk) : 1.f;
  const float* row[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) row[q] = x + (long long)cr.pix[q] * g.cin;
  float* out = cols + (long long)pk * g.cin;
  if (kQuads) {
    const int quads = g.cin >> 2;
    const float4* r4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) r4[q] = reinterpret_cast<const float4*>(row[q]);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int c = lane; c < quads; c += 64) {
      const bool two = c + 32 < quads;
      float4 v[4], u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __ldg(r4[q] + c);
      if (two) {
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = __ldg(r4[q] + c + 32);
      }
      __stcs(o4 + c, sample4(v, cr, masked, m));
      if (two) __stcs(o4 + c + 32, sample4(u, cr, masked, m));
    }
  } else {
    for (int c = lane; c < g.cin; c += 32)
      __stcs(out + c, sample(__ldg(row[0] + c), __ldg(row[1] + c),
                             __ldg(row[2] + c), __ldg(row[3] + c), cr,
                             masked, m));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The warp's four corner sums from the lanes' partials s[4], in lane 0's
// s[0..3]: lanes 16 apart swap two partials and add (the lower lane keeps
// corners 0, 1, the upper 2, 3), lanes 8 apart swap one (lane bits 4, 3
// now name the corner, 2 * b4 + b3), a butterfly over 4, 2, 1 completes
// each corner's sum in lanes 8q to 8q + 7, and every lane reads the four.
__device__ __forceinline__ void corner_sums(float (&s)[4]) {
  const int lane = threadIdx.x & 31;
  const bool hi = lane & 16, mid = lane & 8;
  const float t0 = __fadd_rn(hi ? s[2] : s[0],
                             __shfl_xor_sync(kFull, hi ? s[0] : s[2], 16));
  const float t1 = __fadd_rn(hi ? s[3] : s[1],
                             __shfl_xor_sync(kFull, hi ? s[1] : s[3], 16));
  float u = __fadd_rn(mid ? t1 : t0, __shfl_xor_sync(kFull, mid ? t0 : t1, 8));
#pragma unroll
  for (int off = 4; off; off >>= 1)
    u = __fadd_rn(u, __shfl_xor_sync(kFull, u, off));
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] = __shfl_sync(kFull, u, 8 * q);
}

// One channel of the backward: the lane's partials sw[q] += (g * m) * v_q
// and (with a mask) sm += g * sample, each product rounded, then added;
// returns g * m, whose product with each corner's weight is its grad_x
// term
__device__ __forceinline__ float channel_bwd(float g, const float (&v)[4],
                                             const Corners& cr, bool masked,
                                             float m, float (&sw)[4],
                                             float& sm) {
  const float gs = masked ? __fmul_rn(g, m) : g;
  if (masked)
    sm = __fadd_rn(sm, __fmul_rn(g, sample(v[0], v[1], v[2], v[3], cr,
                                           false, 1.f)));
#pragma unroll
  for (int q = 0; q < 4; ++q) sw[q] = __fadd_rn(sw[q], __fmul_rn(gs, v[q]));
  return gs;
}

__device__ __forceinline__ float part(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// One quad of 4 channels (channels x, y, z, w in order), then one float4
// RED of (g * m) * w_q into each valid corner's grad_x row
__device__ __forceinline__ void quad_bwd(const float4& g, const float4 (&v)[4],
                                         const Corners& cr, bool masked,
                                         float m, float4* const (&gx)[4],
                                         int quad, float (&sw)[4], float& sm,
                                         Tally& tally) {
  float gs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float vi[4] = {part(v[0], i), part(v[1], i), part(v[2], i),
                         part(v[3], i)};
    gs[i] = channel_bwd(part(g, i), vi, cr, masked, m, sw, sm);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (cr.ok[q]) {
      const float w = cr.wgt[q];
      atomicAdd(gx[q] + quad,
                make_float4(__fmul_rn(gs[0], w), __fmul_rn(gs[1], w),
                            __fmul_rn(gs[2], w), __fmul_rn(gs[3], w)));
      tally.add(2, 1);
    }
}

// a warp a (pixel, tap) pk = p * K + k; kQuads: 16-byte lanes and float4
// REDs
template <bool kQuads>
__global__ void __launch_bounds__(kThreads)
    deform_im2col_bwd(const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ mask,
                      const float* __restrict__ grad_cols,
                      float* __restrict__ grad_x,
                      float* __restrict__ grad_offset,
                      float* __restrict__ grad_mask, const Geometry g,
                      int pairs) {
  const int pk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pk >= pairs) return;           // whole warps leave together
  const int taps = g.kh * g.kw;
  const int p = pk / taps, k = pk - p * taps;
  const int i = p / g.wo, j = p - i * g.wo;
  const int a = k / g.kw, b = k - a * g.kw;
  const float dy = __ldg(offset + 2LL * pk), dx = __ldg(offset + 2LL * pk + 1);
  const bool masked = mask != nullptr;
  const float m = masked ? __ldg(mask + pk) : 1.f;
  const float* gc = grad_cols + (long long)pk * g.cin;
  // the first step's columns' gradient depends on pk alone: its loads go
  // out with the offsets', before the corner set-up waits for those
  const int quads = g.cin >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(gc);
  float4 ga, gb;
  float g1 = 0.f;
  if (kQuads) {
    if (lane < quads) ga = __ldcs(g4 + lane);
    if (lane + 32 < quads) gb = __ldcs(g4 + lane + 32);
  } else if (lane < g.cin) {
    g1 = __ldcs(gc + lane);
  }
  const Corners cr = corners(g, i, j, a, b, dy, dx);
  float sw[4] = {0.f, 0.f, 0.f, 0.f}, sm = 0.f;
  Tally tally;
  if (kQuads) {
    const float4* r4[4];
    float4* gx[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r4[q] = reinterpret_cast<const float4*>(x + (long long)cr.pix[q] * g.cin);
      gx[q] = reinterpret_cast<float4*>(grad_x + (long long)cr.pix[q] * g.cin);
    }
    for (int c = lane; c < quads; c += 64) {
      const bool two = c + 32 < quads;
      float4 v[4], u[4];
      if (c != lane) {
        ga = __ldcs(g4 + c);
        if (two) gb = __ldcs(g4 + c + 32);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __ldg(r4[q] + c);
      if (two) {
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = __ldg(r4[q] + c + 32);
      }
      tally.add(0, two ? 32 : 16);
      tally.add(1, two ? 128 : 64);
      quad_bwd(ga, v, cr, masked, m, gx, c, sw, sm, tally);
      if (two) quad_bwd(gb, u, cr, masked, m, gx, c + 32, sw, sm, tally);
    }
  } else {
    const float* row[4];
    float* gx[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      row[q] = x + (long long)cr.pix[q] * g.cin;
      gx[q] = grad_x + (long long)cr.pix[q] * g.cin;
    }
    for (int c = lane; c < g.cin; c += 32) {
      const float gcol = c == lane ? g1 : __ldcs(gc + c);
      const float v[4] = {__ldg(row[0] + c), __ldg(row[1] + c),
                          __ldg(row[2] + c), __ldg(row[3] + c)};
      tally.add(0, 4);
      tally.add(1, 16);
      const float gs = channel_bwd(gcol, v, cr, masked, m, sw, sm);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (cr.ok[q]) {
          atomicAdd(gx[q] + c, __fmul_rn(gs, cr.wgt[q]));
          tally.add(2, 1);
        }
    }
  }
  tally.flush();
  corner_sums(sw);
  if (masked) sm = warp_sum(sm);
  if (lane == 0) {
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = cr.ok[q] ? sw[q] : 0.f;
    // d w / d ly and d w / d lx of the four hats (1-ly)(1-lx), (1-ly)lx,
    // ly(1-lx), ly lx, each product rounded, added in order
    const float gy = __fsub_rn(1.f, cr.ly), gx = __fsub_rn(1.f, cr.lx);
    const float d_ly = __fadd_rn(
        __fadd_rn(__fsub_rn(__fmul_rn(-s[0], gx), __fmul_rn(s[1], cr.lx)),
                  __fmul_rn(s[2], gx)),
        __fmul_rn(s[3], cr.lx));
    const float d_lx = __fadd_rn(
        __fsub_rn(__fadd_rn(__fmul_rn(-s[0], gy), __fmul_rn(s[1], gy)),
                  __fmul_rn(s[2], cr.ly)),
        __fmul_rn(s[3], cr.ly));
    grad_offset[2LL * pk] = d_ly;
    grad_offset[2LL * pk + 1] = d_lx;
    if (masked) grad_mask[pk] = sm;
  }
}

bool make_geometry(int h, int w, int cin, int ho, int wo, int kh, int kw,
                   int stride, int padding, int dilation, Geometry* g) {
  if (h < 1 || w < 1 || cin < 1 || ho < 0 || wo < 0 || kh < 1 || kw < 1 ||
      stride < 1 || dilation < 1)
    return false;
  *g = Geometry{h, w, cin, ho, wo, kh, kw, stride, padding, dilation};
  return true;
}

}  // namespace

// mask: null for DCNv1. columns [Ho * Wo, kh * kw * Cin], written whole.
extern "C" int deform_im2col_launch(const void* x, const void* offset,
                                    const void* mask, void* columns, int h,
                                    int w, int cin, int ho, int wo, int kh,
                                    int kw, int stride, int padding,
                                    int dilation, void* stream) {
  Geometry g;
  if (!make_geometry(h, w, cin, ho, wo, kh, kw, stride, padding, dilation,
                     &g))
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)ho * wo * kh * kw;
  if (pairs == 0) return 0;
  // 32-bit (pixel, tap) indices and pixel indices
  if (pairs > 0x7fffffffLL - kWarps || (long long)h * w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((pairs + kWarps - 1) / kWarps);
  const bool quads = cin % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)columns % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (quads)
    deform_im2col_fwd<true><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)offset, (const float*)mask,
        (float*)columns, g, (int)pairs);
  else
    deform_im2col_fwd<false><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)offset, (const float*)mask,
        (float*)columns, g, (int)pairs);
  return (int)cudaGetLastError();
}

// grad_x: a zeroed f32 [H, W, Cin] buffer; grad_offset [Ho, Wo, 2K] and
// grad_mask [Ho, Wo, K] (null without a mask) are written whole.
extern "C" int deform_im2col_backward_launch(
    const void* x, const void* offset, const void* mask,
    const void* grad_columns, void* grad_x, void* grad_offset,
    void* grad_mask, int h, int w, int cin, int ho, int wo, int kh, int kw,
    int stride, int padding, int dilation, void* stream) {
  Geometry g;
  if (!make_geometry(h, w, cin, ho, wo, kh, kw, stride, padding, dilation,
                     &g) ||
      (mask == nullptr) != (grad_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)ho * wo * kh * kw;
  if (pairs == 0) return 0;
  // 32-bit (pixel, tap) indices and pixel indices
  if (pairs > 0x7fffffffLL - kWarps || (long long)h * w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((pairs + kWarps - 1) / kWarps);
  const bool quads = cin % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)grad_columns % 16 == 0 &&
                     (uintptr_t)grad_x % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (quads)
    deform_im2col_bwd<true><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)offset, (const float*)mask,
        (const float*)grad_columns, (float*)grad_x, (float*)grad_offset,
        (float*)grad_mask, g, (int)pairs);
  else
    deform_im2col_bwd<false><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)offset, (const float*)mask,
        (const float*)grad_columns, (float*)grad_x, (float*)grad_offset,
        (float*)grad_mask, g, (int)pairs);
  return (int)cudaGetLastError();
}

#ifdef EODT_COUNT
// counts: a host array of 3, given the grad_columns bytes and the corner
// bytes the backward loaded and the REDs it issued since the last call,
// which zeroes them. Waits for the card.
extern "C" int deform_conv_tally(unsigned long long* counts) {
  static const unsigned long long zero[3] = {0, 0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(counts, g_tally, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_tally, zero, sizeof(zero));
  return (int)err;
}
#endif
