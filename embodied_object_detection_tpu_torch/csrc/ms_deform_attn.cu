// Multi-scale deformable attention (the MSDeformAttn core op), forward and
// backward. Forward:
//     out[q, m*D + d] = sum over points p of sum over levels l of
//                       attn[q, m, l, p] * sample_l(loc[q, m, l, p])[m, d]
// where sample_l is the bilinear, zero-padded (grid_sample,
// align_corners=False) sample of level l's [H_l, W_l] rows of
// value[S, M, D] at x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5. value
// [S, M, D] f32 (S = sum H_l W_l, the levels flattened one after another),
// loc [Q, M, L, P, 2] f32 (x, y) normalised per level, attn [Q, M, L, P]
// f32, out [Q, M * D] f32.
//
// Replaces ops/ms_deform_attn.py:ms_deform_attn of the JAX package (a
// gather per tap, its backward by autodiff), itself the reference's
// vendored CUDA extension (ms_deform_im2col_cuda.cuh) and the only one the
// Deformable-DETR family calls: 6 encoder layers (Q = S) and 6 decoder
// layers (Q = 100 queries) a frame.
//
// The arithmetic is the plain version's (ops/ms_deform_attn.py:
// ms_deform_attn_plain) in its order, with __fmul_rn/__fadd_rn/__fsub_rn so
// that no FMA contraction moves a coordinate across a pixel border: the
// corners' hat weights (1 - fy)(1 - fx), (1 - fy) fx, fy (1 - fx), fy fx,
// each corner's validity (0 <= yi < H_l, 0 <= xi < W_l) folded into its
// weight, the four taps summed in that order, each sample times its
// attention weight, summed over the levels a point, then over the points.
//
// What bounds it on Hopper: bytes. The inputs are read once in principle
// (at the encoder's shape, 480x640: value 6.5 MB, locations 6.5 MB,
// weights 3.3 MB, the output 6.5 MB), but every (query, head) reads 4
// corners of each of its L x P samples: ~420 MB of gathers a call, from
// L2, since the value table fits in its 50 MB. So the layout serves the
// gathers: one warp per (query, head), one lane per channel. A corner's
// row is D = 32 contiguous f32 of one head, 128 bytes, which the warp
// reads as one coalesced request. The warp's lanes read the same
// locations and weights (a broadcast). Channels beyond 32 are taken by
// the same warp in chunks of 32 lanes; fewer leave lanes idle.
//
// Backward, the same walk, for the gradient of a loss through out:
//   grad_value[row, m, d] += (g[q, m*D + d] * a) * w_k at each valid
//                            corner k of each sample (f32 atomicAdd into
//                            a zeroed [S, M, D] buffer: many queries
//                            sample the same rows, in no fixed order)
//   grad_attn[q, m, l, p]  = sum_d g * sample
//   grad_loc[q, m, l, p]   = a * sum_d g * d(sample)/d(fx, fy) * (W_l, H_l)
// where only valid corners contribute and floor() has zero gradient, as
// in JAX's autodiff (which, unlike the reference's CUDA, also takes the
// row-0 corner's term of a sample on the -1 row). Each (q, m, l, p) is
// owned by one warp, so grad_attn and grad_loc come from the warp's
// __shfl_xor_sync sums over D, deterministic and without atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPoints = 8;
constexpr int kWarps = 8;            // warps a block, one (query, head) each

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];             // first row of the level in value
  int n;
};

// The four corners of one sample, top-left, top-right, bottom-left,
// bottom-right: the flat row of each (-1 when outside its level) and its
// hat weight with the validity folded in; fx, fy are the fractional parts.
struct Corners {
  int row[4];
  float wgt[4];
  float fx, fy;
};

__device__ __forceinline__ Corners corners(float loc_x, float loc_y, int h,
                                           int w, int start) {
  Corners c;
  const float x = __fsub_rn(__fmul_rn(loc_x, (float)w), 0.5f);
  const float y = __fsub_rn(__fmul_rn(loc_y, (float)h), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  c.fx = __fsub_rn(x, x0);
  c.fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.f, c.fx), gy = __fsub_rn(1.f, c.fy);
  const float hat[4] = {__fmul_rn(gy, gx), __fmul_rn(gy, c.fx),
                        __fmul_rn(c.fy, gx), __fmul_rn(c.fy, c.fx)};
  // validity in float: x0, y0 are integral, so these are the integer
  // tests, and a coordinate too large for an int never converts
  const bool okx[2] = {x0 >= 0.f && x0 < (float)w,
                       x0 + 1.f >= 0.f && x0 + 1.f < (float)w};
  const bool oky[2] = {y0 >= 0.f && y0 < (float)h,
                       y0 + 1.f >= 0.f && y0 + 1.f < (float)h};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const bool ok = oky[dy] && okx[dx];
    c.row[k] = ok ? start + ((int)y0 + dy) * w + (int)x0 + dx : -1;
    c.wgt[k] = ok ? hat[k] : 0.f;
  }
  return c;
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
    ms_deform_attn_fwd(const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       float* __restrict__ out, const Levels lv,
                       int num_pairs, int heads, int dim) {
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);  // q * M + m
  const int lane = threadIdx.x & 31;
  if (pair >= num_pairs) return;
  const int m = pair % heads;
  const float* pl = loc + (size_t)pair * lv.n * P * 2;
  const float* pa = attn + (size_t)pair * lv.n * P;
  const size_t row_stride = (size_t)heads * dim;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool live = d < dim;
    const float* v = value + (size_t)m * dim + d;
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    for (int l = 0; l < lv.n; ++l) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const Corners c = corners(__ldg(pl + 2 * i), __ldg(pl + 2 * i + 1),
                                  lv.h[l], lv.w[l], lv.start[l]);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float tap = (live && c.row[k] >= 0)
                                ? __fmul_rn(__ldg(v + c.row[k] * row_stride),
                                            c.wgt[k])
                                : 0.f;
          s = k ? __fadd_rn(s, tap) : tap;
        }
        acc[p] = __fadd_rn(acc[p], __fmul_rn(s, __ldg(pa + i)));
      }
    }
    if (live) {
      float o = acc[0];
#pragma unroll
      for (int p = 1; p < P; ++p) o = __fadd_rn(o, acc[p]);
      out[(size_t)pair * dim + d] = o;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
    ms_deform_attn_bwd(const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad_value,
                       float* __restrict__ grad_loc,
                       float* __restrict__ grad_attn, const Levels lv,
                       int num_pairs, int heads, int dim) {
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= num_pairs) return;     // whole warps leave together
  const int m = pair % heads;
  const float* pl = loc + (size_t)pair * lv.n * P * 2;
  const float* pa = attn + (size_t)pair * lv.n * P;
  const float* g_row = grad_out + (size_t)pair * dim;
  const size_t row_stride = (size_t)heads * dim;
  for (int l = 0; l < lv.n; ++l) {
    const float wl = (float)lv.w[l], hl = (float)lv.h[l];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const Corners c = corners(__ldg(pl + 2 * i), __ldg(pl + 2 * i + 1),
                                lv.h[l], lv.w[l], lv.start[l]);
      const float a = __ldg(pa + i);
      const float gx = 1.f - c.fx, gy = 1.f - c.fy;
      float sum_a = 0.f, sum_x = 0.f, sum_y = 0.f;
      for (int d = lane; d < dim; d += 32) {
        const float g = __ldg(g_row + d);
        const size_t col = (size_t)m * dim + d;
        float vk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          vk[k] = c.row[k] >= 0 ? __ldg(value + c.row[k] * row_stride + col)
                                : 0.f;
        float s = __fmul_rn(vk[0], c.wgt[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k) s = __fadd_rn(s, __fmul_rn(vk[k], c.wgt[k]));
        sum_a += g * s;
        sum_x += g * (gy * (vk[1] - vk[0]) + c.fy * (vk[3] - vk[2]));
        sum_y += g * (gx * (vk[2] - vk[0]) + c.fx * (vk[3] - vk[1]));
        const float ga = __fmul_rn(g, a);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c.row[k] >= 0)
            atomicAdd(grad_value + c.row[k] * row_stride + col,
                      __fmul_rn(ga, c.wgt[k]));
      }
      sum_a = warp_sum(sum_a);
      sum_x = warp_sum(sum_x);
      sum_y = warp_sum(sum_y);
      if (lane == 0) {
        const size_t o = (size_t)pair * lv.n * P + i;
        grad_attn[o] = sum_a;
        grad_loc[2 * o] = a * sum_x * wl;
        grad_loc[2 * o + 1] = a * sum_y * hl;
      }
    }
  }
}

bool make_levels(const int* heights, const int* widths, int num_levels,
                 Levels* lv) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  int start = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1) return false;
    lv->h[l] = heights[l];
    lv->w[l] = widths[l];
    lv->start[l] = start;
    start += heights[l] * widths[l];
  }
  lv->n = num_levels;
  return true;
}

}  // namespace

#define EODT_POINTS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// heights, widths: host arrays of num_levels entries. All tensors f32,
// contiguous, on the card; out [Q, M * D].
extern "C" int ms_deform_attn_launch(const void* value, const int* heights,
                                     const int* widths, int num_levels,
                                     const void* loc, const void* attn,
                                     void* out, int num_queries, int heads,
                                     int dim, int points, void* stream) {
  Levels lv;
  if (!make_levels(heights, widths, num_levels, &lv) || points < 1 ||
      points > kMaxPoints || heads < 1 || dim < 1)
    return (int)cudaErrorInvalidValue;
  const int pairs = num_queries * heads;
  if (pairs == 0) return 0;
  const dim3 grid((pairs + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  switch (points) {
#define EODT_FWD(N)                                                        \
  case N:                                                                  \
    ms_deform_attn_fwd<N><<<grid, block, 0, s>>>(                          \
        (const float*)value, (const float*)loc, (const float*)attn,        \
        (float*)out, lv, pairs, heads, dim);                               \
    break;
    EODT_POINTS(EODT_FWD)
#undef EODT_FWD
  }
  return (int)cudaGetLastError();
}

// grad_value: a zeroed f32 [S, M, D] buffer; grad_loc [Q, M, L, P, 2] and
// grad_attn [Q, M, L, P] are written whole.
extern "C" int ms_deform_attn_backward_launch(
    const void* value, const int* heights, const int* widths, int num_levels,
    const void* loc, const void* attn, const void* grad_out, void* grad_value,
    void* grad_loc, void* grad_attn, int num_queries, int heads, int dim,
    int points, void* stream) {
  Levels lv;
  if (!make_levels(heights, widths, num_levels, &lv) || points < 1 ||
      points > kMaxPoints || heads < 1 || dim < 1)
    return (int)cudaErrorInvalidValue;
  const int pairs = num_queries * heads;
  if (pairs == 0) return 0;
  const dim3 grid((pairs + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  switch (points) {
#define EODT_BWD(N)                                                        \
  case N:                                                                  \
    ms_deform_attn_bwd<N><<<grid, block, 0, s>>>(                          \
        (const float*)value, (const float*)loc, (const float*)attn,        \
        (const float*)grad_out, (float*)grad_value, (float*)grad_loc,      \
        (float*)grad_attn, lv, pairs, heads, dim);                         \
    break;
    EODT_POINTS(EODT_BWD)
#undef EODT_BWD
  }
  return (int)cudaGetLastError();
}
