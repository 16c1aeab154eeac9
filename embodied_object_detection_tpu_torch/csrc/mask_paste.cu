// Paste N M x M mask probabilities into the image plane (bilinear grid
// sampling, align_corners=False, zero padding), then threshold:
//     out[n, y, x] = sum_a sum_b ry[n, y, a] * masks[n, a, b] * rx[n, x, b]
// with the hat weights r[k] = max(0, 1 - |src - k|) of the pixel centre's
// source coordinate src = ((g + 1) * M - 1) / 2, g = (p + 0.5 - lo) /
// max(hi - lo, 1e-4) * 2 - 1. Columns are every x_stride-th pixel; the
// output is [N, H, W'] or, pixel-major, [H, W', N]; booleans `>= threshold`
// when threshold >= 0, else the f32 values.
//
// Replaces ops/mask_paste.py:paste_masks. The JAX package evaluates the
// separable form as two f32 HIGHEST einsums (R_y @ mask @ R_x^T), which
// keeps the TPU's matrix unit busy on a product that is almost all zeros:
// every row of R has at most two nonzero taps. Here each output element is
// a direct evaluation of those 2 x 2 taps: the weights are computed with
// the plain version's operations in its order (__fsub_rn/__fdiv_rn/
// __fmul_rn, no FMA contraction), so the taps and weights are the plain
// version's; only the 4-term sum may round differently, which can move a
// value that sits within f32 rounding of the threshold across it.
//
// What bounds it on Hopper: bytes, the output (30.7 MB of bool at N = 100,
// 480 x 640) written once; the masks (0.3 MB) stay in L2 and are read
// through __ldg. One block of 256 threads per tile of 16 rows x 16 output
// columns x up to 32 masks (25 KB of shared memory, so 8 blocks fill an
// SM): the tile's per-(mask, row) and per-(mask, column) taps and weights
// are computed once into shared memory; each
// thread owns one pixel of the tile and walks the masks, so a warp's four
// tap loads fall on neighbouring cells of one mask (a few L1 lines, not 32
// scattered ones). Pixel-major bool output, where the mask index is
// fastest, is staged in shared memory and stored in runs of consecutive
// bytes; the other layout stores runs of consecutive columns directly.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kCols = 16;
constexpr int kMasks = 32;    // at most; the masks split into even chunks

struct Taps {
  int k0, k1;      // tap indices, clamped into [0, M-1]
  float w0, w1;    // their weights; 0 for a tap outside [0, M-1]
};

__device__ __forceinline__ Taps hat_taps(float centre, float lo, float extent,
                                         int m) {
  const float g = __fsub_rn(
      __fmul_rn(__fdiv_rn(__fsub_rn(centre, lo), extent), 2.0f), 1.0f);
  const float src = __fdiv_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)m), 1.0f), 2.0f);
  Taps t = {0, 0, 0.0f, 0.0f};
  if (!(src > -1.0f && src < (float)m)) return t;
  const float f = floorf(src);
  const int k = (int)f;
  const float w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(src, f))), 0.0f);
  const float w1 = fmaxf(
      __fsub_rn(1.0f, fabsf(__fsub_rn(src, __fadd_rn(f, 1.0f)))), 0.0f);
  t.k0 = max(k, 0);
  t.k1 = min(k + 1, m - 1);
  t.w0 = k >= 0 ? w0 : 0.0f;
  t.w1 = k + 1 <= m - 1 ? w1 : 0.0f;
  return t;
}

template <typename Out>
__device__ __forceinline__ Out finish(float v, float threshold);

template <>
__device__ __forceinline__ bool finish<bool>(float v, float threshold) {
  return v >= threshold;
}

template <>
__device__ __forceinline__ float finish<float>(float v, float threshold) {
  return v;
}

template <typename Out>
__global__ void mask_paste_kernel(const float* __restrict__ masks,
                                  const float* __restrict__ boxes,
                                  Out* __restrict__ out, int n, int m,
                                  int height, int x_stride, int out_w,
                                  int chunk, float threshold,
                                  int pixel_major) {
  __shared__ Taps ytap[kMasks][kRows];
  __shared__ Taps xtap[kMasks][kCols];
  __shared__ unsigned char tile[kRows * kCols][kMasks + 4];  // odd words
  const int x_base = blockIdx.x * kCols;
  const int y_base = blockIdx.y * kRows;
  const int n_base = blockIdx.z * chunk;
  const int rows = min(kRows, height - y_base);
  const int cols = min(kCols, out_w - x_base);
  const int nm = min(chunk, n - n_base);
  const int t = threadIdx.x;
  if (nm <= 0) return;

  for (int e = t; e < (kRows + kCols) * nm; e += blockDim.x) {
    const int q = e / (kRows + kCols);
    const int j = e - q * (kRows + kCols);
    const float* b = boxes + 4LL * (n_base + q);
    if (j < kRows) {
      if (j < rows)
        ytap[q][j] = hat_taps((float)(y_base + j) + 0.5f, b[1],
                              fmaxf(__fsub_rn(b[3], b[1]), 1e-4f), m);
    } else {
      const int c = j - kRows;
      if (c < cols)
        xtap[q][c] = hat_taps((float)((x_base + c) * x_stride) + 0.5f, b[0],
                              fmaxf(__fsub_rn(b[2], b[0]), 1e-4f), m);
    }
  }
  __syncthreads();

  // one pixel of the tile per thread, the masks in turn
  const int r = t / kCols;
  const int c = t - r * kCols;
  const bool live = r < rows && c < cols;
  const bool stage = pixel_major && sizeof(Out) == 1;
  const int y = y_base + r;
  const int x = x_base + c;
#pragma unroll 4
  for (int q = 0; q < (live ? nm : 0); ++q) {
    const Taps ty = ytap[q][r];
    const Taps tx = xtap[q][c];
    const float* mk = masks + (long long)(n_base + q) * m * m;
    const float m00 = __ldg(mk + ty.k0 * m + tx.k0);
    const float m01 = __ldg(mk + ty.k0 * m + tx.k1);
    const float m10 = __ldg(mk + ty.k1 * m + tx.k0);
    const float m11 = __ldg(mk + ty.k1 * m + tx.k1);
    // the separable order: contract the mask rows first, then the columns
    const float t0 = fmaf(ty.w1, m10, __fmul_rn(ty.w0, m00));
    const float t1 = fmaf(ty.w1, m11, __fmul_rn(ty.w0, m01));
    const Out v = finish<Out>(fmaf(tx.w1, t1, __fmul_rn(tx.w0, t0)),
                              threshold);
    if (stage) {
      tile[t][q] = (unsigned char)v;
    } else if (pixel_major) {
      out[((long long)y * out_w + x) * n + n_base + q] = v;
    } else {
      out[((long long)(n_base + q) * height + y) * out_w + x] = v;
    }
  }
  if (!stage) return;
  __syncthreads();
  // pixel-major bytes: each warp stores one pixel's masks at a time
  const int lane = t & 31;
  for (int pix = t >> 5; pix < kRows * kCols; pix += blockDim.x >> 5) {
    const int pr = pix / kCols;
    const int pc = pix - pr * kCols;
    if (pr >= rows || pc >= cols) continue;
    unsigned char* dst = reinterpret_cast<unsigned char*>(out) +
        ((long long)(y_base + pr) * out_w + x_base + pc) * n + n_base;
    for (int q = lane; q < nm; q += 32) dst[q] = tile[pix][q];
  }
}

}  // namespace

extern "C" int mask_paste_launch(const void* masks, const void* boxes,
                                 void* out, int n, int m, int height,
                                 int width, int x_stride, float threshold,
                                 int pixel_major, void* stream) {
  if (n < 0 || m < 1 || height < 0 || width < 0 || x_stride < 1)
    return (int)cudaErrorInvalidValue;
  const int out_w = (width + x_stride - 1) / x_stride;
  if (n == 0 || height == 0 || out_w == 0) return 0;
  const int chunks = (n + kMasks - 1) / kMasks;
  const int chunk = (n + chunks - 1) / chunks;
  const dim3 grid((out_w + kCols - 1) / kCols, (height + kRows - 1) / kRows,
                  chunks);
  const int threads = kRows * kCols;
  cudaStream_t s = (cudaStream_t)stream;
  if (threshold >= 0.0f)
    mask_paste_kernel<bool><<<grid, threads, 0, s>>>(
        (const float*)masks, (const float*)boxes, (bool*)out, n, m, height,
        x_stride, out_w, chunk, threshold, pixel_major);
  else
    mask_paste_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)masks, (const float*)boxes, (float*)out, n, m, height,
        x_stride, out_w, chunk, threshold, pixel_major);
  return (int)cudaGetLastError();
}
