// Multilevel ROIAlignV2 forward (aligned=True, fixed sampling ratio s):
//     out[r, ph, pw, c] = mean over the s x s samples of bin (ph, pw) of the
//                         bilinear sample of level lvl[r] at channel c
// levels: up to 4 contiguous [H_l, W_l, C] tensors (bf16 or f32, all one
// type), boxes [R, 4] f32 xyxy in image pixels, level_ids [R] int32 (the
// detectron2 assignment, computed by the caller), out [R, S, S, C] in the
// features' type.
//
// Replaces ops/roi_align.py:multilevel_roi_align (the box pooler's 7 x 7
// and the mask pooler's 14 x 14 over p3-p5). This is the tap form of
// ops/roi_align.py:_bilinear_flat / impl="v1", the CUDA ROIAlign semantics:
// a sample strictly outside [-1, size] gives 0; otherwise its coordinates
// clamp to [0, size-1] and the far tap is min(x0 + 1, size - 1). The JAX
// default impl="v4" is the same math re-associated as separable hat-weight
// matmuls, with bf16 weights and a bf16 intermediate in a bf16 config. The
// sample coordinates follow the tap form's operation order with
// __fdiv_rn/__fmul_rn/__fadd_rn (no FMA contraction), so the taps and their
// weights are the plain version's; the samples are accumulated in f32,
// averaged, and written once in the features' type.
//
// What bounds it on Hopper: bytes in principle (the levels, 3.2 MB of bf16
// at 480x640, read once; the output, 6.4 MB at R = 256, 7 x 7, written
// once), in practice the latency of the gathered taps, which hit L2. One
// block per (ROI, output row): its s * S * s sample positions, tap offsets
// and weights are computed once into shared memory; each thread owns two
// adjacent channels (one __nv_bfloat162 or float2 load per tap), so a warp
// reads 128 or 256 contiguous bytes of a level row per tap, and the block's
// output row is one contiguous store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 256;   // s * S * s positions of one output row

struct Levels {
  const void* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float stride[kMaxLevels];
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One axis of a sample: clamp rule, taps and weights as in _bilinear_flat.
struct Axis {
  int i0, i1;
  float lo, hi;   // weights of i0 and i1, times the in-range flag
  bool ok;
};

__device__ __forceinline__ Axis sample_axis(float c, int size) {
  Axis a;
  const float sf = (float)size;
  a.ok = c >= -1.0f && c <= sf;
  c = fminf(fmaxf(c, 0.0f), __fsub_rn(sf, 1.0f));
  const float c0 = floorf(c);
  const float l = __fsub_rn(c, c0);
  a.i0 = (int)c0;
  a.i1 = min(a.i0 + 1, size - 1);
  a.lo = __fsub_rn(1.0f, l);
  a.hi = l;
  return a;
}

template <typename T>
__global__ void roi_align_kernel(Levels lv, const float* __restrict__ boxes,
                                 const int* __restrict__ level_ids,
                                 T* __restrict__ out, int channels,
                                 int out_size, int s) {
  __shared__ int off[kMaxSamples][4];
  __shared__ float wgt[kMaxSamples][4];
  const int roi = blockIdx.x / out_size;
  const int ph = blockIdx.x - roi * out_size;
  const int lvl = level_ids[roi];
  const int h = lv.height[lvl];
  const int w = lv.width[lvl];
  const float stride = lv.stride[lvl];
  const T* __restrict__ f = static_cast<const T*>(lv.data[lvl]);

  const float* b = boxes + 4LL * roi;
  const float x1 = __fdiv_rn(b[0], stride);
  const float y1 = __fdiv_rn(b[1], stride);
  const float bin_w = __fdiv_rn(__fsub_rn(__fdiv_rn(b[2], stride), x1),
                                (float)out_size);
  const float bin_h = __fdiv_rn(__fsub_rn(__fdiv_rn(b[3], stride), y1),
                                (float)out_size);
  const int row_samples = out_size * s;          // x samples of the row
  const int samples = s * row_samples;
  for (int k = threadIdx.x; k < samples; k += blockDim.x) {
    const int iy = k / row_samples;              // sample row within the bin
    const int px = k - iy * row_samples;         // sample column, all bins
    const int py = ph * s + iy;
    const float gy = __fdiv_rn(__fadd_rn((float)py, 0.5f), (float)s);
    const float gx = __fdiv_rn(__fadd_rn((float)px, 0.5f), (float)s);
    const float sy = __fsub_rn(__fadd_rn(y1, __fmul_rn(gy, bin_h)), 0.5f);
    const float sx = __fsub_rn(__fadd_rn(x1, __fmul_rn(gx, bin_w)), 0.5f);
    const Axis ay = sample_axis(sy, h);
    const Axis ax = sample_axis(sx, w);
    const float okf = (ay.ok && ax.ok) ? 1.0f : 0.0f;
    off[k][0] = ay.i0 * w + ax.i0;
    off[k][1] = ay.i0 * w + ax.i1;
    off[k][2] = ay.i1 * w + ax.i0;
    off[k][3] = ay.i1 * w + ax.i1;
    wgt[k][0] = __fmul_rn(__fmul_rn(ay.lo, ax.lo), okf);
    wgt[k][1] = __fmul_rn(__fmul_rn(ay.lo, ax.hi), okf);
    wgt[k][2] = __fmul_rn(__fmul_rn(ay.hi, ax.lo), okf);
    wgt[k][3] = __fmul_rn(__fmul_rn(ay.hi, ax.hi), okf);
  }
  __syncthreads();

  const float inv = 1.0f / (float)(s * s);
  T* row_out = out + ((long long)roi * out_size + ph) * out_size * channels;
  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_size; ++pw) {
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int iy = 0; iy < s; ++iy) {
        for (int ix = 0; ix < s; ++ix) {
          const int k = iy * row_samples + pw * s + ix;
          float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            const float2 v = load2(f + (long long)off[k][tap] * channels + c);
            v0 = __fadd_rn(v0, __fmul_rn(v.x, wgt[k][tap]));
            v1 = __fadd_rn(v1, __fmul_rn(v.y, wgt[k][tap]));
          }
          acc0 = __fadd_rn(acc0, v0);
          acc1 = __fadd_rn(acc1, v1);
        }
      }
      store2(row_out + (long long)pw * channels + c, __fmul_rn(acc0, inv),
             __fmul_rn(acc1, inv));
    }
  }
}

}  // namespace

// levels, heights, widths, strides: host arrays of num_levels entries.
extern "C" int roi_align_launch(const void* const* levels, const int* heights,
                                const int* widths, const int* strides,
                                int num_levels, const void* boxes,
                                const void* level_ids, void* out,
                                int num_rois, int channels, int out_size,
                                int sampling_ratio, int is_bf16,
                                void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels % 2 != 0 ||
      out_size < 1 || sampling_ratio < 1 ||
      out_size * sampling_ratio * sampling_ratio > kMaxSamples)
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0 || channels == 0) return 0;
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.data[l] = levels[l];
    lv.height[l] = heights[l];
    lv.width[l] = widths[l];
    lv.stride[l] = (float)strides[l];
  }
  int threads = channels / 2;
  if (threads > 256) threads = 256;
  threads = ((threads + 31) / 32) * 32;
  const unsigned int blocks = (unsigned int)num_rois * out_size;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    roi_align_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        lv, (const float*)boxes, (const int*)level_ids, (__nv_bfloat16*)out,
        channels, out_size, sampling_ratio);
  else
    roi_align_kernel<float><<<blocks, threads, 0, s>>>(
        lv, (const float*)boxes, (const int*)level_ids, (float*)out,
        channels, out_size, sampling_ratio);
  return (int)cudaGetLastError();
}
