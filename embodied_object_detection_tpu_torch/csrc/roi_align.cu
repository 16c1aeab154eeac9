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
// What bounds it on Hopper, forward: bytes (the levels, 3.2 MB of bf16 at
// 480x640, read once; the output, 6.4 MB at R = 256, 7 x 7, written once).
// Its S*s x S*s samples read 16 S^2 s^2 taps a channel, but neighbouring
// samples share taps: a ROI touches at most min(2 S s, E + 2)^2 level
// positions (E its extent in level pixels), a median of ~130 against 784
// taps on the path. So a block takes one ROI and one 128-byte channel
// slab (64 bf16 or 32 f32 channels), computes the ROI's sample table once
// per axis, and stages its tap grid, the distinct tap rows x distinct tap
// columns, in shared memory with 16-byte cp.async copies:
// each position is read from L2 once per (ROI, slab) instead of once per
// tap. The distinct taps of an axis are found from a bitmap of the level's
// rows (columns) and ranked by a warp's scan of its popcounts; the
// samples are monotone along an axis, so the ranks of an output row's taps
// are a range of at most 2 s. When the (ROI, slab) blocks do not fill one
// wave of the card (the mask pooler's R = 100), each also takes only a
// part of the output rows, and stages only the tap rows of that part. A
// grid larger than kGridPositions (a ROI over more than ~15 level pixels
// a side, or a whole level) is taken in bands of output rows, each band's
// tap-row range staged in turn, planned greedily by one thread. Outputs
// are then computed from shared memory in the tap form's order (4 taps in
// order, the s x s samples in order, times 1/s^2), each thread owning one
// 16-byte vector of channels: the same bits as the one-pass kernel this
// replaces. The arithmetic (a widening, a multiply and an add a tap and
// channel, unfused for those bits) is then the larger cost.
//
// Backward, the transpose of the same tap form: for every ROI r, output
// cell (ph, pw), sample of the bin and bilinear tap t at level position p
//     grad_level[lvl[r]][p, c] += (grad_out[r, ph, pw, c] / s^2) * w_t
// with the forward's sample arithmetic (sample_table below: the same
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
// level). One block per (ROI, output row), two channels a thread;
// zero-weight taps (samples outside [-1, size]) are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 256;   // s * S * s positions of one output row
constexpr int kThreads = 224;      // forward: 7 warps
constexpr int kMaxAxis = 128;      // forward: tap candidates an axis, 2 S s
constexpr int kSlabBytes = 128;    // forward: channels a block
constexpr int kChunks = kSlabBytes / 16;
constexpr int kGridPositions = 288;   // staged positions: 36 KB
constexpr int kBlocksPerSM = 5;    // forward: by its shared memory
constexpr int kMinBlocksPerSM = 8;  // forward: when its rows are split
constexpr int kMaxSide = 1024;     // forward: level height and width

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

// A ROI's origin and bin sizes in level pixels.
struct Bins {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ Bins roi_bins(const float* __restrict__ boxes,
                                         int roi, float stride,
                                         int out_size) {
  const float* b = boxes + 4LL * roi;
  Bins r;
  r.x1 = __fdiv_rn(b[0], stride);
  r.y1 = __fdiv_rn(b[1], stride);
  r.bin_w = __fdiv_rn(__fsub_rn(__fdiv_rn(b[2], stride), r.x1),
                      (float)out_size);
  r.bin_h = __fdiv_rn(__fsub_rn(__fdiv_rn(b[3], stride), r.y1),
                      (float)out_size);
  return r;
}

// Sample i of an axis (all bins): start + (i + 0.5) / s * bin - 0.5.
__device__ __forceinline__ float sample_coord(float start, float bin, int i,
                                              int s) {
  const float g = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)s);
  return __fsub_rn(__fadd_rn(start, __fmul_rn(g, bin)), 0.5f);
}

// The s * S * s sample positions of output row ph of ROI `roi` (k = sample
// row within the bin * S * s + sample column across all bins): their four
// tap offsets into the level and the taps' weights, 0 for a sample outside
// [-1, size]. The backward's block fills the table in shared memory; the
// forward computes the same axes (sample_coord, sample_axis) and weights.
__device__ __forceinline__ void sample_table(
    const float* __restrict__ boxes, int roi, int ph, int h, int w,
    float stride, int out_size, int s, int (*off)[4], float (*wgt)[4]) {
  const Bins bn = roi_bins(boxes, roi, stride, out_size);
  const int row_samples = out_size * s;          // x samples of the row
  const int samples = s * row_samples;
  for (int k = threadIdx.x; k < samples; k += blockDim.x) {
    const int iy = k / row_samples;              // sample row within the bin
    const int px = k - iy * row_samples;         // sample column, all bins
    const Axis ay = sample_axis(sample_coord(bn.y1, bn.bin_h, ph * s + iy, s),
                                h);
    const Axis ax = sample_axis(sample_coord(bn.x1, bn.bin_w, px, s), w);
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

// ---------------------------------------------------------------- forward

// A 16-byte vector of the features' type, widened to f32 and back.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the high half of the f32 of the same value
  __device__ static void widen(const uint4& u, float* f) {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      f[2 * q] = __uint_as_float(w[q] << 16);
      f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  __device__ static unsigned int pack(float lo, float hi) {
    return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi))
            << 16);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One sample of an axis: the slots of its two taps among the axis's
// sorted distinct taps, and their weights times the in-range flag
// (multiplying by a flag of 1 is exact, by 0 gives +0: the weights'
// products are sample_table's bits).
struct __align__(16) Sample {
  int s0, s1;
  float lo, hi;
};

__device__ __forceinline__ int rank_below(const unsigned int* bits,
                                          const int* below, int x) {
  return below[x / 32] + __popc(bits[x / 32] & ((1u << (x % 32)) - 1u));
}

// One block per (ROI, 128-byte channel slab, part of the output rows);
// the staged tap grid in dynamic shared memory, grid_cap positions of
// kChunks 16-byte vectors. Thread t owns vector t % kChunks of the slab
// and every kLanes-th position or output from t / kChunks. kS is the
// sampling ratio when it is fixed at compile time (0: the argument s).
// stats, when not null (zeroed by the caller), gets [ROI]: the largest
// grid a band staged, the positions all bands staged, and the bands
// beyond one a part.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
roi_align_kernel(Levels lv, const float* __restrict__ boxes,
                 const int* __restrict__ level_ids, T* __restrict__ out,
                 int channels, int out_size, int s_arg, int parts,
                 int grid_cap, int* __restrict__ stats) {
  extern __shared__ uint4 grid[];
  __shared__ Sample samples[2][kMaxAxis / 2];        // x, y
  __shared__ int lists[2][kMaxAxis];                 // distinct taps
  __shared__ unsigned int bits[2][kMaxSide / 32];    // tap bitmaps
  __shared__ int below[2][kMaxSide / 32 + 1];        // distinct below a word
  __shared__ int row_lo[kMaxAxis / 2], row_hi[kMaxAxis / 2];
  __shared__ int band_end[kMaxAxis / 2], band_lo[kMaxAxis / 2];
  __shared__ int band_rows[kMaxAxis / 2];
  __shared__ int num_bands;

  constexpr int kVec = Vec<T>::kN;
  constexpr int kSlab = kSlabBytes / (int)sizeof(T);
  constexpr int kLanes = kThreads / kChunks;
  const int tid = threadIdx.x;
  if (tid < 2 * kMaxSide / 32) bits[tid / 32][tid % 32] = 0u;
  const int s = kS > 0 ? kS : s_arg;
  const int slabs = (channels + kSlab - 1) / kSlab;
  const int roi = blockIdx.x / (slabs * parts);
  const int rest = blockIdx.x - roi * slabs * parts;
  const int slab = rest / parts;
  const int part = rest - slab * parts;
  const int c0 = slab * kSlab;
  const int rb = part * out_size / parts;      // this part's output rows
  const int re = (part + 1) * out_size / parts;
  const int nvec = min(kSlab, channels - c0) / kVec;
  const int lvl = level_ids[roi];
  const T* __restrict__ f = nullptr;
  int h = 1, w = 1;
  float stride = 1.0f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l == lvl) {
      f = static_cast<const T*>(lv.data[l]);
      h = lv.height[l];
      w = lv.width[l];
      stride = lv.stride[l];
    }
  const int n = out_size * s;                  // samples an axis

  // the sample table, once per axis (threads [0, n): the x samples, then
  // the y samples of this part's rows); its taps marked in the axis's
  // bitmap
  const Bins bn = roi_bins(boxes, roi, stride, out_size);
  const int axis = tid < n ? 0 : 1;
  const int i = axis == 0 ? tid : tid - n + rb * s;
  const bool sampler = tid < n + (re - rb) * s;
  Axis a;
  __syncthreads();
  if (sampler) {
    a = axis == 0 ? sample_axis(sample_coord(bn.x1, bn.bin_w, i, s), w)
                  : sample_axis(sample_coord(bn.y1, bn.bin_h, i, s), h);
    const float okf = a.ok ? 1.0f : 0.0f;
    samples[axis][i].lo = __fmul_rn(a.lo, okf);
    samples[axis][i].hi = __fmul_rn(a.hi, okf);
    atomicOr(&bits[axis][a.i0 / 32], 1u << (a.i0 % 32));
    atomicOr(&bits[axis][a.i1 / 32], 1u << (a.i1 % 32));
  }
  __syncthreads();
  if (tid < 64) {                              // warp 0: x, warp 1: y
    const int ax = tid / 32, lane = tid % 32;
    const int c = __popc(bits[ax][lane]);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    below[ax][lane] = incl - c;
    if (lane == 31) below[ax][32] = incl;
  }
  __syncthreads();
  // each tap's slot: its rank among the axis's distinct taps
  if (sampler) {
    const int r0 = rank_below(bits[axis], below[axis], a.i0);
    const int r1 = rank_below(bits[axis], below[axis], a.i1);
    samples[axis][i].s0 = r0;
    samples[axis][i].s1 = r1;
    lists[axis][r0] = a.i0;
    lists[axis][r1] = a.i1;
  }
  __syncthreads();
  const int nx = below[0][32];
  const int ny = below[1][32];
  const Sample* xs = samples[0];
  const Sample* ys = samples[1];

  // bands of output rows: the slots are sorted and the samples monotone,
  // so a band's tap rows are the slot range of its samples, at most 2 s
  // for one output row; one thread extends each band while its rows x nx
  // fit
  int bands = 1;
  if (ny * nx > grid_cap) {
    for (int r = rb + tid; r < re; r += blockDim.x) {
      int lo = ys[r * s].s0, hi = ys[r * s].s1;
      for (int k = r * s + 1; k < (r + 1) * s; ++k) {
        lo = min(lo, ys[k].s0);
        hi = max(hi, ys[k].s1);
      }
      row_lo[r] = lo;
      row_hi[r] = hi;
    }
    __syncthreads();
    if (tid == 0) {
      const int max_rows = grid_cap / nx;      // >= 2 s: one row fits
      int nb = 0, lo = row_lo[rb], hi = row_hi[rb];
      for (int r = rb + 1; r < re; ++r) {
        const int l = min(lo, row_lo[r]);
        const int u = max(hi, row_hi[r]);
        if (u - l + 1 > max_rows) {
          band_end[nb] = r;
          band_lo[nb] = lo;
          band_rows[nb++] = hi - lo + 1;
          lo = row_lo[r];
          hi = row_hi[r];
        } else {
          lo = l;
          hi = u;
        }
      }
      band_end[nb] = re;
      band_lo[nb] = lo;
      band_rows[nb++] = hi - lo + 1;
      num_bands = nb;
    }
    __syncthreads();
    bands = num_bands;
  }

  const int q = tid % kChunks;                 // this thread's vector
  const int lane = tid / kChunks;
  const bool active = q < nvec;
  const int* xlist = lists[0];
  const int* ylist = lists[1];
  const float inv = 1.0f / (float)(s * s);
  int r0 = rb, staged = 0, largest = 0;
  for (int band = 0; band < bands; ++band) {
    const int r1 = bands == 1 ? re : band_end[band];
    const int y0 = bands == 1 ? 0 : band_lo[band];
    const int rows = bands == 1 ? ny : band_rows[band];
    // stage the band's grid: its tap rows x the distinct tap columns
    staged += rows * nx;
    largest = max(largest, rows * nx);
    if (active) {
      int yi = lane / nx, xi = lane - (lane / nx) * nx;
      for (int p = lane; p < rows * nx; p += kLanes) {
        cp_async16(grid + p * kChunks + q,
                   f + ((long long)ylist[y0 + yi] * w + xlist[xi]) *
                           channels + c0 + q * kVec);
        xi += kLanes;
        while (xi >= nx) {
          xi -= nx;
          ++yi;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    if (active) {
      int pw = lane % out_size, ph = r0 + lane / out_size;
      while (ph < r1) {
        float acc[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
        for (int iy = 0; iy < s; ++iy) {
          const Sample sy = ys[ph * s + iy];
          const int row0 = (sy.s0 - y0) * nx;
          const int row1 = (sy.s1 - y0) * nx;
          for (int ix = 0; ix < s; ++ix) {
            const Sample sx = xs[pw * s + ix];
            const float wt[4] = {__fmul_rn(sy.lo, sx.lo),
                                 __fmul_rn(sy.lo, sx.hi),
                                 __fmul_rn(sy.hi, sx.lo),
                                 __fmul_rn(sy.hi, sx.hi)};
            const int pos[4] = {row0 + sx.s0, row0 + sx.s1, row1 + sx.s0,
                                row1 + sx.s1};
            float val[kVec];
#pragma unroll
            for (int e = 0; e < kVec; ++e) val[e] = 0.0f;
#pragma unroll
            for (int tap = 0; tap < 4; ++tap) {
              float tv[kVec];
              Vec<T>::widen(grid[pos[tap] * kChunks + q], tv);
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                val[e] = __fadd_rn(val[e], __fmul_rn(tv[e], wt[tap]));
            }
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[e] = __fadd_rn(acc[e], val[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = __fmul_rn(acc[e], inv);
        *reinterpret_cast<uint4*>(
            out + (((long long)roi * out_size + ph) * out_size + pw) *
                      channels + c0 + q * kVec) = Vec<T>::narrow(acc);
        pw += kLanes;
        while (pw >= out_size) {
          pw -= out_size;
          ++ph;
        }
      }
    }
    __syncthreads();           // the next band restages the grid
    r0 = r1;
  }
  if (stats != nullptr && c0 == 0 && tid == 0) {
    atomicMax(stats + 3 * roi, largest);
    atomicAdd(stats + 3 * roi + 1, staged);
    atomicAdd(stats + 3 * roi + 2, bands - 1);
  }
}

// --------------------------------------------------------------- backward

// The transpose: lv.data[l] is level l's f32 gradient buffer. One block
// per (ROI, output row); each thread owns two adjacent channels.
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

template <typename T>
int launch_forward(const Levels& lv, const float* boxes, const int* level_ids,
                   T* out, int num_rois, int channels, int out_size, int s,
                   int* stats, cudaStream_t stream) {
  // a band of one output row (<= 2 s distinct rows x <= 2 S s columns)
  // must always fit
  int cap = 4 * out_size * s * s;
  if (cap < kGridPositions) cap = kGridPositions;
  const int bytes = cap * kSlabBytes;
  // the grid and the static tables exceed the default 48 KB: opt in, once
  // for each size (before any graph capture: the first call is eager)
  static int allowed = 0;
  if (bytes > allowed) {
    const void* kernels[2] = {(const void*)roi_align_kernel<T, 2>,
                              (const void*)roi_align_kernel<T, 0>};
    for (const void* fn : kernels) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
    }
    allowed = bytes;
  }
  // split the output rows into parts when the (ROI, slab) blocks do not
  // fill one wave of the card (kBlocksPerSM on every SM): then make at
  // least kMinBlocksPerSM blocks an SM
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int kSlab = kSlabBytes / (int)sizeof(T);
  const long long per_part =
      (long long)num_rois * ((channels + kSlab - 1) / kSlab);
  int parts = 1;
  if (per_part < (long long)kBlocksPerSM * sms)
    parts = (int)(((long long)kMinBlocksPerSM * sms + per_part - 1) /
                  per_part);
  if (parts > out_size) parts = out_size;
  const unsigned int blocks = (unsigned int)(per_part * parts);
  if (s == 2)
    roi_align_kernel<T, 2><<<blocks, kThreads, bytes, stream>>>(
        lv, boxes, level_ids, out, channels, out_size, s, parts, cap, stats);
  else
    roi_align_kernel<T, 0><<<blocks, kThreads, bytes, stream>>>(
        lv, boxes, level_ids, out, channels, out_size, s, parts, cap, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// levels, heights, widths, strides: host arrays of num_levels entries;
// stats: null, or a zeroed int32 [num_rois, 3] device buffer (each ROI's
// largest staged grid, the positions all its bands staged, and its bands
// beyond one a block).
extern "C" int roi_align_launch(const void* const* levels, const int* heights,
                                const int* widths, const int* strides,
                                int num_levels, const void* boxes,
                                const void* level_ids, void* out,
                                int num_rois, int channels, int out_size,
                                int sampling_ratio, int is_bf16,
                                void* stats, void* stream) {
  if (bad_geometry(num_levels, channels, out_size, sampling_ratio) ||
      channels % 8 != 0 || 2 * out_size * sampling_ratio > kMaxAxis)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < num_levels; ++l)
    if (heights[l] > kMaxSide || widths[l] > kMaxSide)
      return (int)cudaErrorInvalidValue;
  if (num_rois == 0 || channels == 0) return 0;
  const Levels lv = make_levels(levels, heights, widths, strides, num_levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_forward<__nv_bfloat16>(
        lv, (const float*)boxes, (const int*)level_ids, (__nv_bfloat16*)out,
        num_rois, channels, out_size, sampling_ratio, (int*)stats, s);
  return launch_forward<float>(lv, (const float*)boxes,
                               (const int*)level_ids, (float*)out, num_rois,
                               channels, out_size, sampling_ratio,
                               (int*)stats, s);
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
