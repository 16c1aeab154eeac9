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
// every row of R has at most two nonzero taps. Here each live output
// element is a direct evaluation of those 2 x 2 taps: the weights are
// computed with the plain version's operations in its order (__fsub_rn/
// __fdiv_rn/__fmul_rn, no FMA contraction), so the taps and weights are the
// plain version's; only the 4-term sum may round differently, which can
// move a value that sits within f32 rounding of the threshold across it.
//
// What bounds it on Hopper: bytes, the output (30.7 MB of bool at N = 100,
// 480 x 640) written once; the masks (0.3 MB) stay in L2. One block of 256
// threads per tile of 8 rows x 32 output columns holds all N masks (in
// passes of 128 masks for bool, 32 for f32), so that:
// - Only the masks that reach the tile are evaluated. src is monotone in
//   the pixel, and a pixel's taps are all zero exactly when src <= -1 or
//   src >= M, so a mask whose src at the tile's last row is <= -1 or at its
//   first row is >= M (or likewise over its columns) has zero weights over
//   the whole tile: every such value is the sum of zero weights times
//   finite mask values, +0, and is written as finish(0) (with a threshold
//   of 0, `0 >= 0` is true). The live masks are compacted into a list in
//   index order, their per-row and per-column taps tabled in shared memory
//   16 masks at a time, and each thread evaluates its pixel against them.
// - The output is written in whole sectors. The tile is staged in 32 KB of
//   shared memory, first filled with finish(0). Pixel-major, each image row
//   of the tile is one contiguous run of cols x N values (32 x 100 = 3200
//   bytes) stored with 16-byte vector stores when it is 16-byte aligned;
//   with more masks than one pass holds, each pixel's slice is one
//   contiguous run. Mask-major, the stage is laid out [mask][pixel] and
//   each (mask, row) run of the tile's columns is stored contiguously.
// - The exact memory write's first pass rides along (pixel-major bool,
//   when `observed` is given): each thread ORs its pixel's staged values
//   of a pass, ANDed with valid[n] (a byte each in shared memory, 32-bit
//   words when the pass's span is a multiple of 4), into its flag:
//       observed[y, x] = any_n(out[y, x, n] && valid[n])
//   the OR of exactly the values stored, finish(0) included, so the flags
//   are those of the masks written. After the last pass it stores the flag
//   and each warp (one tile row) stores __popc of its ballot as the count
//   of (row, column tile): counts [H, ceil(W' / 32)], each written by one
//   block, so nobody zeroes them; csrc/write_select.cu sums them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kCols = 32;
constexpr int kPix = kRows * kCols;       // one thread a pixel
constexpr int kStageBytes = 32768;
constexpr int kGroup = 16;                // live masks tabled at once

struct Taps {
  int k0, k1;      // tap indices, clamped into [0, M-1]
  float w0, w1;    // their weights; 0 for a tap outside [0, M-1]
};

__device__ __forceinline__ float hat_src(float centre, float lo,
                                         float extent, int m) {
  const float g = __fsub_rn(
      __fmul_rn(__fdiv_rn(__fsub_rn(centre, lo), extent), 2.0f), 1.0f);
  return __fdiv_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)m), 1.0f), 2.0f);
}

__device__ __forceinline__ Taps hat_taps(float centre, float lo, float extent,
                                         int m) {
  const float src = hat_src(centre, lo, extent, m);
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

__device__ __forceinline__ float extent(float lo, float hi) {
  return fmaxf(__fsub_rn(hi, lo), 1e-4f);
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

// a 32-bit word of repeated `v`
__device__ __forceinline__ unsigned int fill_word(bool v) {
  return v ? 0x01010101u : 0u;
}

__device__ __forceinline__ unsigned int fill_word(float v) {
  return __float_as_uint(v);
}

// dst[0 .. count) = src[0 .. count), all threads of the block; 16-byte
// vectors where both ends are 16-byte aligned
template <typename Out>
__device__ __forceinline__ void store_run(Out* dst, const Out* src,
                                          int count) {
  const int t = threadIdx.x;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int bytes = count * (int)sizeof(Out);
    const int vecs = bytes >> 4;
    for (int e = t; e < vecs; e += kPix)
      reinterpret_cast<uint4*>(dst)[e] =
          reinterpret_cast<const uint4*>(src)[e];
    unsigned char* d = reinterpret_cast<unsigned char*>(dst);
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
    for (int e = (vecs << 4) + t; e < bytes; e += kPix) d[e] = s[e];
  } else {
    for (int e = t; e < count; e += kPix) dst[e] = src[e];
  }
}

template <typename Out>
__global__ void __launch_bounds__(kPix) mask_paste_kernel(
    const float* __restrict__ masks, const float* __restrict__ boxes,
    Out* __restrict__ out, int n, int m, int height, int x_stride, int out_w,
    float threshold, int pixel_major, const unsigned char* __restrict__ valid,
    unsigned char* __restrict__ observed, int* __restrict__ tile_counts) {
  constexpr int kPass = kStageBytes / (kPix * (int)sizeof(Out));
  __shared__ __align__(16) unsigned char stage_bytes[kStageBytes];
  __shared__ __align__(16) unsigned char valid_s[kPass];
  __shared__ Taps ytap[kGroup][kRows];
  __shared__ Taps xtap[kGroup][kCols];
  __shared__ int live[kPass];
  __shared__ int warp_live[(kPass + 31) / 32];
  Out* stage = reinterpret_cast<Out*>(stage_bytes);
  const int t = threadIdx.x;
  const int x_base = blockIdx.x * kCols;
  const int y_base = blockIdx.y * kRows;
  const int rows = min(kRows, height - y_base);
  const int cols = min(kCols, out_w - x_base);
  const int r = t / kCols;
  const int c = t - r * kCols;
  const bool mine = r < rows && c < cols;
  const Out zero = finish<Out>(0.0f, threshold);
  const unsigned int zero_word = fill_word(zero);
  // the pixel centres at the tile's edges
  const float y_first = (float)y_base + 0.5f;
  const float y_last = (float)(y_base + rows - 1) + 0.5f;
  const float x_first = (float)(x_base * x_stride) + 0.5f;
  const float x_last = (float)((x_base + cols - 1) * x_stride) + 0.5f;
  bool flag = false;           // this pixel's observed flag

  for (int q0 = 0; q0 < n; q0 += kPass) {
    const int span = min(kPass, n - q0);
    // the pass's masks that reach the tile, compacted in index order
    bool is_live = false;
    if (t < span) {
      const float* b = boxes + 4LL * (q0 + t);
      const float ey = extent(b[1], b[3]);
      const float ex = extent(b[0], b[2]);
      is_live = hat_src(y_last, b[1], ey, m) > -1.0f &&
                hat_src(y_first, b[1], ey, m) < (float)m &&
                hat_src(x_last, b[0], ex, m) > -1.0f &&
                hat_src(x_first, b[0], ex, m) < (float)m;
    }
    unsigned int ballot = 0u;
    if (t < kPass) {
      ballot = __ballot_sync(0xffffffffu, is_live);
      if ((t & 31) == 0) warp_live[t >> 5] = __popc(ballot);
    }
    __syncthreads();      // warp_live set; the last pass's stores are done
    int num_live = 0;
    for (int w = 0; w < (kPass + 31) / 32; ++w) {
      if (t < kPass && w == (t >> 5))
        if (is_live)
          live[num_live + __popc(ballot & ((1u << (t & 31)) - 1u))] = q0 + t;
      num_live += warp_live[w];
    }
    if (observed != nullptr && t < span) valid_s[t] = valid[q0 + t];
    // every value starts as finish(0)
    const int fill = (kPix * span * (int)sizeof(Out) + 15) >> 4;
    for (int e = t; e < fill; e += kPix)
      reinterpret_cast<uint4*>(stage_bytes)[e] =
          make_uint4(zero_word, zero_word, zero_word, zero_word);
    __syncthreads();

    for (int g0 = 0; g0 < num_live; g0 += kGroup) {
      const int gn = min(kGroup, num_live - g0);
      for (int e = t; e < gn * (kRows + kCols); e += kPix) {
        const int gi = e / (kRows + kCols);
        const int j = e - gi * (kRows + kCols);
        const float* b = boxes + 4LL * live[g0 + gi];
        if (j < kRows) {
          if (j < rows)
            ytap[gi][j] = hat_taps((float)(y_base + j) + 0.5f, b[1],
                                   extent(b[1], b[3]), m);
        } else {
          const int cc = j - kRows;
          if (cc < cols)
            xtap[gi][cc] = hat_taps((float)((x_base + cc) * x_stride) + 0.5f,
                                    b[0], extent(b[0], b[2]), m);
        }
      }
      __syncthreads();
      for (int gi = 0; gi < (mine ? gn : 0); ++gi) {
        const int q = live[g0 + gi];
        const Taps ty = ytap[gi][r];
        const Taps tx = xtap[gi][c];
        const float* mk = masks + (long long)q * m * m;
        const float m00 = __ldg(mk + ty.k0 * m + tx.k0);
        const float m01 = __ldg(mk + ty.k0 * m + tx.k1);
        const float m10 = __ldg(mk + ty.k1 * m + tx.k0);
        const float m11 = __ldg(mk + ty.k1 * m + tx.k1);
        // the separable order: contract the mask rows first, then the
        // columns
        const float t0 = fmaf(ty.w1, m10, __fmul_rn(ty.w0, m00));
        const float t1 = fmaf(ty.w1, m11, __fmul_rn(ty.w0, m01));
        stage[pixel_major ? t * span + q - q0 : (q - q0) * kPix + t] =
            finish<Out>(fmaf(tx.w1, t1, __fmul_rn(tx.w0, t0)), threshold);
      }
      __syncthreads();
    }
    if (observed != nullptr && mine) {
      // the pass's values of this pixel, ANDed with valid
      const unsigned char* px = stage_bytes + t * span;
      unsigned int any = 0u;
      if ((span & 3) == 0) {
        const unsigned int* pw = reinterpret_cast<const unsigned int*>(px);
        const unsigned int* vw =
            reinterpret_cast<const unsigned int*>(valid_s);
        for (int k = 0; k < span / 4; ++k) any |= pw[k] & vw[k];
      } else {
        for (int k = 0; k < span; ++k) any |= px[k] & valid_s[k];
      }
      flag = flag || any != 0u;
    }

    if (pixel_major && span == n) {
      // each image row of the tile: cols x n consecutive values
      for (int rr = 0; rr < rows; ++rr)
        store_run(out + ((long long)(y_base + rr) * out_w + x_base) * n,
                  stage + rr * kCols * n, cols * n);
    } else if (pixel_major) {
      // each pixel's slice of the pass: span consecutive values
      for (int e = t; e < kPix * span; e += kPix) {
        const int p = e / span;
        const int pr = p / kCols;
        const int pc = p - pr * kCols;
        if (pr < rows && pc < cols)
          out[((long long)(y_base + pr) * out_w + x_base + pc) * n + q0 +
              e - p * span] = stage[e];
      }
    } else {
      // [mask][pixel]: each (mask, row) run of the tile's columns
      for (int e = t; e < kPix * span; e += kPix) {
        const int q = e / kPix;
        const int p = e - q * kPix;
        const int pr = p / kCols;
        const int pc = p - pr * kCols;
        if (pr < rows && pc < cols)
          out[((long long)(q0 + q) * height + y_base + pr) * out_w + x_base +
              pc] = stage[e];
      }
    }
  }
  if (observed != nullptr) {
    if (mine) observed[(long long)(y_base + r) * out_w + x_base + c] = flag;
    const unsigned int ballot = __ballot_sync(0xffffffffu, flag);
    if (c == 0 && r < rows)
      tile_counts[(long long)(y_base + r) * gridDim.x + blockIdx.x] =
          __popc(ballot);
  }
}

}  // namespace

// valid, observed, tile_counts: null, or (pixel-major, threshold >= 0)
// valid [N] bytes (0/1), and outputs observed [H, W'] bytes and
// tile_counts [H, ceil(W' / 32)] int32, W' = ceil(W / x_stride).
extern "C" int mask_paste_launch(const void* masks, const void* boxes,
                                 void* out, int n, int m, int height,
                                 int width, int x_stride, float threshold,
                                 int pixel_major, const void* valid,
                                 void* observed, void* tile_counts,
                                 void* stream) {
  if (n < 0 || m < 1 || height < 0 || width < 0 || x_stride < 1)
    return (int)cudaErrorInvalidValue;
  if (observed != nullptr &&
      (!pixel_major || !(threshold >= 0.0f) || valid == nullptr ||
       tile_counts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int out_w = (width + x_stride - 1) / x_stride;
  if (n == 0 || height == 0 || out_w == 0) return 0;
  const dim3 grid((out_w + kCols - 1) / kCols, (height + kRows - 1) / kRows);
  cudaStream_t s = (cudaStream_t)stream;
  if (threshold >= 0.0f)
    mask_paste_kernel<bool><<<grid, kPix, 0, s>>>(
        (const float*)masks, (const float*)boxes, (bool*)out, n, m, height,
        x_stride, out_w, threshold, pixel_major,
        (const unsigned char*)valid, (unsigned char*)observed,
        (int*)tile_counts);
  else
    mask_paste_kernel<float><<<grid, kPix, 0, s>>>(
        (const float*)masks, (const float*)boxes, (float*)out, n, m, height,
        x_stride, out_w, threshold, pixel_major, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}
