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
//                             (f32 atomicAdd into a zeroed [H, W, Cin]:
//                             many taps sample the same pixels)
//   grad_mask[p, k]         = sum_c g * sample[c]
//   grad_offset[p, 2k(+1)]  = sum over corners of (sum_c (g * m) * v) *
//                             d w_corner / d(ly, lx), valid corners only;
//                             floor() has no gradient, so a sample on row -1
//                             keeps the row-0 corner's term (JAX's
//                             gradient, not mmcv's)
// One warp owns each (pixel, tap): lanes stride over the channels, and the
// five sums over Cin are __shfl_xor_sync reductions, deterministic and
// without atomics. What bounds the backward: bytes in principle (x and
// the columns' gradient read once, the three gradients written once), in
// practice its scalar loads and its scalar f32 atomics into grad_x, one a
// valid corner and channel; it is still the first, simple kernel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    deform_im2col_bwd(const float* __restrict__ x,
                      const float* __restrict__ offset,
                      const float* __restrict__ mask,
                      const float* __restrict__ grad_cols,
                      float* __restrict__ grad_x,
                      float* __restrict__ grad_offset,
                      float* __restrict__ grad_mask, const Geometry g,
                      long long pairs) {
  const long long pk = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pk >= pairs) return;           // whole warps leave together
  const int taps = g.kh * g.kw;
  const int k = (int)(pk % taps);
  const int p = (int)(pk / taps);
  const int i = p / g.wo, j = p - (p / g.wo) * g.wo;
  const int a = k / g.kw, b = k - (k / g.kw) * g.kw;
  const Corners cr = corners(g, i, j, a, b, __ldg(offset + 2 * pk),
                             __ldg(offset + 2 * pk + 1));
  const float m = mask ? __ldg(mask + pk) : 1.f;
  const float* gc = grad_cols + pk * g.cin;
  float sum_m = 0.f, sum_w[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < g.cin; c += 32) {
    const float gcol = __ldg(gc + c);
    const float gs = mask ? __fmul_rn(gcol, m) : gcol;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = __ldg(x + (long long)cr.pix[q] * g.cin + c);
    if (mask) {
      float s = __fmul_rn(v[0], cr.wgt[0]);
#pragma unroll
      for (int q = 1; q < 4; ++q) s = __fadd_rn(s, __fmul_rn(v[q], cr.wgt[q]));
      sum_m += gcol * s;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sum_w[q] += gs * v[q];
      if (cr.ok[q])
        atomicAdd(grad_x + (long long)cr.pix[q] * g.cin + c,
                  __fmul_rn(gs, cr.wgt[q]));
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) sum_w[q] = cr.ok[q] ? warp_sum(sum_w[q]) : 0.f;
  if (mask) sum_m = warp_sum(sum_m);
  if (lane == 0) {
    // d w / d ly and d w / d lx of the four hats (1-ly)(1-lx), (1-ly)lx,
    // ly(1-lx), ly lx
    const float gy = 1.f - cr.ly, gx = 1.f - cr.lx;
    const float d_ly = -sum_w[0] * gx - sum_w[1] * cr.lx + sum_w[2] * gx +
                       sum_w[3] * cr.lx;
    const float d_lx = -sum_w[0] * gy + sum_w[1] * gy - sum_w[2] * cr.ly +
                       sum_w[3] * cr.ly;
    grad_offset[2 * pk] = d_ly;
    grad_offset[2 * pk + 1] = d_lx;
    if (mask) grad_mask[pk] = sum_m;
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
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  deform_im2col_bwd<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)x, (const float*)offset, (const float*)mask,
      (const float*)grad_columns, (float*)grad_x, (float*)grad_offset,
      (float*)grad_mask, g, pairs);
  return (int)cudaGetLastError();
}
