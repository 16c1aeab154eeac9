// Multilevel ROIAlignV2 (aligned=True, fixed sampling ratio s), forward
// and backward. Forward:
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
//
// Backward, the transpose of the same tap form: for every ROI r, output
// cell (ph, pw), sample of the bin and bilinear tap t at level position p
//     grad_level[lvl[r]][p, c] += (grad_out[r, ph, pw, c] / s^2) * w_t
// with the forward's sample table (sample_table below: the same
// coordinates, clamps and weights). grad_out [R, S, S, C] bf16 or f32; the
// gradients accumulate into one f32 [H_l, W_l, C] buffer a level (zeroed
// by the caller, who casts each once to the levels' type). It replaces
// the backward of the same function, which JAX derives by autodiff (of
// v4's hat-weight matmuls, or of v1's tap gathers as a scatter-add). Each
// contribution is the f32 product that autodiff of the tap form computes;
// only the order of the sums differs, because they are f32 atomicAdds: per
// element the result is within (contributions) x 2^-24 x sum|contribution|
// of any other order. Bound in principle by bytes (grad_out read once, 6.4
// MB at R = 512, 7 x 7, 256 bf16; the f32 accumulators, 6.5 MB, written
// once), in practice by the atomics: R x S^2 x s^2 x 4 taps x C adds that
// land in L2, many on the same addresses (overlapping ROIs on the 60 x 80
// level). Same blocks as the forward; zero-weight taps (samples outside
// [-1, size]) are skipped.

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

// The s * S * s sample positions of output row ph of ROI `roi` (k = sample
// row within the bin * S * s + sample column across all bins): their four
// tap offsets into the level and the taps' weights, 0 for a sample outside
// [-1, size]. The block fills the table in shared memory; the forward and
// the backward read the same one, so their taps are the same.
__device__ __forceinline__ void sample_table(
    const float* __restrict__ boxes, int roi, int ph, int h, int w,
    float stride, int out_size, int s, int (*off)[4], float (*wgt)[4]) {
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
}

// One block per (ROI, output row); each thread owns two adjacent channels.
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
  const T* __restrict__ f = static_cast<const T*>(lv.data[lvl]);
  sample_table(boxes, roi, ph, lv.height[lvl], lv.width[lvl],
               lv.stride[lvl], out_size, s, off, wgt);

  const int row_samples = out_size * s;
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

// The transpose: lv.data[l] is level l's f32 gradient buffer.
template <typename T>
__global__ void roi_align_backward_kernel(Levels lv,
                                          const float* __restrict__ boxes,
                                          const int* __restrict__ level_ids,
                                          const T* __restrict__ grad_out,
                                          int channels, int out_size, int s) {
  __shared__ int off[kMaxSamples][4];
  __shared__ float wgt[kMaxSamples][4];
  const int roi = blockIdx.x / out_size;
  const int ph = blockIdx.x - roi * out_size;
  const int lvl = level_ids[roi];
  float* __restrict__ g = static_cast<float*>(const_cast<void*>(lv.data[lvl]));
  sample_table(boxes, roi, ph, lv.height[lvl], lv.width[lvl],
               lv.stride[lvl], out_size, s, off, wgt);

  const int row_samples = out_size * s;
  const float ss = (float)(s * s);
  const T* row_grad =
      grad_out + ((long long)roi * out_size + ph) * out_size * channels;
  for (int c = 2 * threadIdx.x; c < channels; c += 2 * blockDim.x) {
    for (int pw = 0; pw < out_size; ++pw) {
      const float2 go = load2(row_grad + (long long)pw * channels + c);
      const float g0 = __fdiv_rn(go.x, ss);       // the mean's transpose
      const float g1 = __fdiv_rn(go.y, ss);
      for (int iy = 0; iy < s; ++iy) {
        for (int ix = 0; ix < s; ++ix) {
          const int k = iy * row_samples + pw * s + ix;
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            const float wt = wgt[k][tap];
            if (wt == 0.0f) continue;
            float* dst = g + (long long)off[k][tap] * channels + c;
            atomicAdd(dst, __fmul_rn(g0, wt));
            atomicAdd(dst + 1, __fmul_rn(g1, wt));
          }
        }
      }
    }
  }
}

Levels make_levels(const void* const* data, const int* heights,
                   const int* widths, const int* strides, int num_levels) {
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    lv.data[l] = data[l];
    lv.height[l] = heights[l];
    lv.width[l] = widths[l];
    lv.stride[l] = (float)strides[l];
  }
  return lv;
}

bool bad_geometry(int num_levels, int channels, int out_size,
                  int sampling_ratio) {
  return num_levels < 1 || num_levels > kMaxLevels || channels % 2 != 0 ||
         out_size < 1 || sampling_ratio < 1 ||
         out_size * sampling_ratio * sampling_ratio > kMaxSamples;
}

int threads_for(int channels) {
  int threads = channels / 2;
  if (threads > 256) threads = 256;
  return ((threads + 31) / 32) * 32;
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
  if (bad_geometry(num_levels, channels, out_size, sampling_ratio))
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0 || channels == 0) return 0;
  const Levels lv = make_levels(levels, heights, widths, strides, num_levels);
  const int threads = threads_for(channels);
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

// grads, heights, widths, strides: host arrays of num_levels entries; each
// grads[l] is a zeroed f32 [H_l, W_l, C] device buffer.
extern "C" int roi_align_backward_launch(
    void* const* grads, const int* heights, const int* widths,
    const int* strides, int num_levels, const void* boxes,
    const void* level_ids, const void* grad_out, int num_rois, int channels,
    int out_size, int sampling_ratio, int is_bf16, void* stream) {
  if (bad_geometry(num_levels, channels, out_size, sampling_ratio))
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0 || channels == 0) return 0;
  const Levels lv = make_levels(grads, heights, widths, strides, num_levels);
  const int threads = threads_for(channels);
  const unsigned int blocks = (unsigned int)num_rois * out_size;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    roi_align_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        lv, (const float*)boxes, (const int*)level_ids,
        (const __nv_bfloat16*)grad_out, channels, out_size, sampling_ratio);
  else
    roi_align_backward_kernel<float><<<blocks, threads, 0, st>>>(
        lv, (const float*)boxes, (const int*)level_ids,
        (const float*)grad_out, channels, out_size, sampling_ratio);
  return (int)cudaGetLastError();
}
