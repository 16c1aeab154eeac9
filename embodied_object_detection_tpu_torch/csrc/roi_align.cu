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
// contribution is the f32 product that autodiff of the tap form computes,
// (grad / s^2) * (w_y * w_x) with __fdiv_rn/__fmul_rn; only the order of
// the sums differs: per element the result is within (contributions) x
// 2^-24 x sum|contribution| of any other order.
//
// What bounds it on Hopper, backward: bytes (grad_out read once, 6.4 MB at
// R = 512, 7 x 7, 256 bf16; the f32 accumulators, 6.5 MB, written once).
// A kernel that adds every tap's contribution to device memory is bound
// instead by ~7 x 10^7 scalar f32 atomics a call in L2, up to ~300 on one
// address. But a ROI's 784 taps land on a median of ~128 distinct
// positions, the same staged grid the forward finds. So a block takes one
// ROI and one slab of 128 channels, stages grad_out's slab once with
// 16-byte loads, divided by s^2, in shared memory, and finds the ROI's
// distinct tap rows and columns as the forward does (sample_table). A grid
// position (Y, X) receives exactly the taps of the y-samples with a tap on
// slot Y times those of the x-samples with a tap on slot X, so each axis's
// 2 n (sample, tap) entries are sorted by slot (a count, a warp's scan,
// each entry's rank among its slot's). Then each thread owns one position
// and two float4s of channels at a time and sums its contributions in
// registers in a fixed order: no atomics in shared memory, no zeroing, no
// bands (the grid is an index space, not a buffer, so no budget applies).
// Each position a ROI touches with a nonzero weight is then flushed once,
// one float4 atomicAdd (sm_90, a vector RED in L2) per 4 channels: ~5 x
// 10^6 vector atomics a call instead of ~7 x 10^7 scalar ones. What
// remains is the block's own work: its set-up (the slab's loads, the
// table, the entry sort: ~7 barriers), paid once per 128 channels, and
// ~10 instructions of control per contribution, paid once per 8 channels.
// Zero-weight taps (samples outside [-1, size]) are skipped, as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 256;   // s * S * s samples of one output row
constexpr int kThreads = 224;      // forward: 7 warps
constexpr int kMaxAxis = 128;      // tap candidates an axis, 2 S s
constexpr int kSlabBytes = 128;    // forward: channels a block
constexpr int kChunks = kSlabBytes / 16;
constexpr int kGridPositions = 288;   // staged positions: 36 KB
constexpr int kBlocksPerSM = 5;    // forward: by its shared memory
constexpr int kMinBlocksPerSM = 8;  // forward: when its rows are split
constexpr int kMaxSide = 1024;     // level height and width
constexpr int kBwdThreads = 256;   // backward: 8 warps
constexpr int kBwdSlab = 128;      // backward: f32 channels a block
constexpr int kBwdVecs = kBwdSlab / 4;              // its float4s
constexpr int kBwdOwners = kBwdVecs / 2;   // threads a position: 2 float4s
constexpr int kBwdLanes = kBwdThreads / kBwdOwners;  // positions at a time
constexpr int kMaxGradBytes = 200 * 1024;   // backward: grad_out's slab

struct Levels {
  const void* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float stride[kMaxLevels];
};

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

// One sample of an axis: the slots of its two taps among the axis's
// sorted distinct taps, and their weights times the in-range flag
// (multiplying by a flag of 1 is exact, by 0 gives +0, so a tap's weight
// w_y * w_x is the tap form's (w_y * w_x) * flag).
struct __align__(16) Sample {
  int s0, s1;
  float lo, hi;
};

// A block's sample table in shared memory: both axes' samples, the
// distinct taps of each axis in order (lists[axis][slot] is the level row
// or column) and below[axis][32] their count.
struct Table {
  Sample samples[2][kMaxAxis / 2];             // x, y
  int lists[2][kMaxAxis];
  unsigned int bits[2][kMaxSide / 32];         // tap bitmaps
  int below[2][kMaxSide / 32 + 1];             // distinct below a word
};

__device__ __forceinline__ int rank_below(const unsigned int* bits,
                                          const int* below, int x) {
  return below[x / 32] + __popc(bits[x / 32] & ((1u << (x % 32)) - 1u));
}

// Fill `tb` for the n samples of each axis of a ROI's bins (the y axis:
// the samples of output rows [rb, re) only), all threads of the block:
// threads [0, n) take the x samples, the next (re - rb) s the y samples;
// each marks its taps in the axis's bitmap of the level's rows (columns),
// a warp's scan of the popcounts ranks them, and each sample's taps get
// their slots. Four barriers; ends on one.
__device__ __forceinline__ void sample_table(Table& tb, const Bins& bn, int h,
                                             int w, int n, int rb, int re,
                                             int s) {
  const int tid = threadIdx.x;
  if (tid < 2 * kMaxSide / 32) tb.bits[tid / 32][tid % 32] = 0u;
  const int axis = tid < n ? 0 : 1;
  const int i = axis == 0 ? tid : tid - n + rb * s;
  const bool sampler = tid < n + (re - rb) * s;
  Axis a;
  __syncthreads();
  if (sampler) {
    a = axis == 0 ? sample_axis(sample_coord(bn.x1, bn.bin_w, i, s), w)
                  : sample_axis(sample_coord(bn.y1, bn.bin_h, i, s), h);
    const float okf = a.ok ? 1.0f : 0.0f;
    tb.samples[axis][i].lo = __fmul_rn(a.lo, okf);
    tb.samples[axis][i].hi = __fmul_rn(a.hi, okf);
    atomicOr(&tb.bits[axis][a.i0 / 32], 1u << (a.i0 % 32));
    atomicOr(&tb.bits[axis][a.i1 / 32], 1u << (a.i1 % 32));
  }
  __syncthreads();
  if (tid < 64) {                              // warp 0: x, warp 1: y
    const int ax = tid / 32, lane = tid % 32;
    const int c = __popc(tb.bits[ax][lane]);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    tb.below[ax][lane] = incl - c;
    if (lane == 31) tb.below[ax][32] = incl;
  }
  __syncthreads();
  // each tap's slot: its rank among the axis's distinct taps
  if (sampler) {
    const int r0 = rank_below(tb.bits[axis], tb.below[axis], a.i0);
    const int r1 = rank_below(tb.bits[axis], tb.below[axis], a.i1);
    tb.samples[axis][i].s0 = r0;
    tb.samples[axis][i].s1 = r1;
    tb.lists[axis][r0] = a.i0;
    tb.lists[axis][r1] = a.i1;
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
  __shared__ Table tb;
  __shared__ int row_lo[kMaxAxis / 2], row_hi[kMaxAxis / 2];
  __shared__ int band_end[kMaxAxis / 2], band_lo[kMaxAxis / 2];
  __shared__ int band_rows[kMaxAxis / 2];
  __shared__ int num_bands;

  constexpr int kVec = Vec<T>::kN;
  constexpr int kSlab = kSlabBytes / (int)sizeof(T);
  constexpr int kLanes = kThreads / kChunks;
  const int tid = threadIdx.x;
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

  // the sample table, once per axis (the y axis: this part's rows)
  sample_table(tb, roi_bins(boxes, roi, stride, out_size), h, w, n, rb, re,
               s);
  const int nx = tb.below[0][32];
  const int ny = tb.below[1][32];
  const Sample* xs = tb.samples[0];
  const Sample* ys = tb.samples[1];

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
  const int* xlist = tb.lists[0];
  const int* ylist = tb.lists[1];
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

// One (sample, tap) of an axis as seen from the tap's slot: the output
// cell (row or column) of the sample and the tap's weight.
struct Entry {
  int cell;
  float w;
};

// The transpose: lv.data[l] is level l's f32 gradient buffer. One block
// per (ROI, 128-channel slab); thread t owns float4s q = t % kBwdOwners and
// q + kBwdOwners of the slab (so 16 threads load 256 contiguous bytes) and
// every kBwdLanes-th grid position from t / kBwdOwners.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
roi_align_backward_kernel(Levels lv, const float* __restrict__ boxes,
                          const int* __restrict__ level_ids,
                          const T* __restrict__ grad_out, int channels,
                          int out_size, int s) {
  extern __shared__ float4 staged[];           // [S * S][kBwdVecs]
  __shared__ Table tb;
  __shared__ int first[2][kMaxAxis + 1];       // per slot: count, then start
  __shared__ Entry entries[2][kMaxAxis];       // sorted by slot
  constexpr int kVec = Vec<T>::kN;
  constexpr int kInVecs = kBwdSlab / kVec;     // grad_out vectors a cell
  const int tid = threadIdx.x;
  const int slabs = (channels + kBwdSlab - 1) / kBwdSlab;
  const int roi = blockIdx.x / slabs;
  const int c0 = (blockIdx.x - roi * slabs) * kBwdSlab;
  const int span = min(kBwdSlab, channels - c0);
  const int lvl = level_ids[roi];
  float* g = nullptr;
  int h = 1, w = 1;
  float stride = 1.0f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l == lvl) {
      g = static_cast<float*>(const_cast<void*>(lv.data[l]));
      h = lv.height[l];
      w = lv.width[l];
      stride = lv.stride[l];
    }
  for (int e = tid; e < 2 * (kMaxAxis + 1); e += blockDim.x)
    (&first[0][0])[e] = 0;
  // the slab of grad_out, read once with 16-byte loads and divided by s^2
  // (the mean's transpose) once an element; by a power of two the
  // division is the multiplication by its exact inverse, the same number
  const int cells = out_size * out_size;
  const float ss = (float)(s * s);
  const bool pow2 = (s & (s - 1)) == 0;
  const float inv = 1.0f / ss;
#pragma unroll 4
  for (int e = tid; e < cells * kInVecs; e += blockDim.x) {
    const int cell = e / kInVecs;
    const int v = e - cell * kInVecs;
    if (v * kVec < span) {
      float f[kVec];
      Vec<T>::widen(__ldg(reinterpret_cast<const uint4*>(
                        grad_out + ((long long)roi * cells + cell) * channels +
                        c0 + v * kVec)),
                    f);
      float* dst = reinterpret_cast<float*>(staged + cell * kBwdVecs) +
                   v * kVec;
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        dst[q] = pow2 ? __fmul_rn(f[q], inv) : __fdiv_rn(f[q], ss);
    }
  }
  const int n = out_size * s;
  sample_table(tb, roi_bins(boxes, roi, stride, out_size), h, w, n, 0,
               out_size, s);

  // each axis's 2 n (sample, tap) entries, sorted by slot: a count per
  // slot, a warp's exclusive scan of the counts, then each entry's rank
  // among its slot's entries (in entry order, so the order is fixed)
  const int per_axis = 2 * n;
  const bool entry = tid < 2 * per_axis;
  const int axis = tid < per_axis ? 0 : 1;
  const int e = tid - axis * per_axis;
  int slot = 0;
  if (entry) {
    const Sample sm = tb.samples[axis][e >> 1];
    slot = (e & 1) ? sm.s1 : sm.s0;
    atomicAdd(&first[axis][slot], 1);
  }
  __syncthreads();
  if (tid < 64) {                              // warp 0: x, warp 1: y
    const int ax = tid / 32, lane = tid % 32;
    constexpr int kPer = kMaxAxis / 32;
    int v[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = first[ax][kPer * lane + j];
      sum += v[j];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    int start = incl - sum;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      first[ax][kPer * lane + j] = start;
      start += v[j];
    }
    if (lane == 31) first[ax][kMaxAxis] = incl;
  }
  __syncthreads();
  if (entry) {
    int before = 0;
    for (int f = 0; f < e; ++f) {
      const Sample o = tb.samples[axis][f >> 1];
      before += ((f & 1) ? o.s1 : o.s0) == slot;
    }
    const Sample sm = tb.samples[axis][e >> 1];
    entries[axis][first[axis][slot] + before] =
        Entry{(e >> 1) / s, (e & 1) ? sm.hi : sm.lo};
  }
  __syncthreads();

  // position (Y, X) of the grid takes the taps of Y's y-entries times X's
  // x-entries, each (grad / s^2) * (w_y * w_x), summed in registers; a
  // position touched with a nonzero weight is flushed once
  const int q = tid % kBwdOwners;
  if (4 * q >= span) return;                  // no barrier follows
  const bool second = 4 * (q + kBwdOwners) < span;
  const int nx = tb.below[0][32];
  const int ny = tb.below[1][32];
  for (int p = tid / kBwdOwners; p < nx * ny; p += kBwdLanes) {
    const int py = p / nx;
    const int px = p - py * nx;
    float4 acc[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                     make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
    bool touched = false;
    for (int a = first[1][py]; a < first[1][py + 1]; ++a) {
      const Entry ey = entries[1][a];
      const float4* row = staged + ey.cell * out_size * kBwdVecs + q;
      for (int b = first[0][px]; b < first[0][px + 1]; ++b) {
        const Entry ex = entries[0][b];
        const float wt = __fmul_rn(ey.w, ex.w);
        if (wt == 0.0f) continue;
        touched = true;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float4 gv = row[ex.cell * kBwdVecs + h2 * kBwdOwners];
          acc[h2].x = __fadd_rn(acc[h2].x, __fmul_rn(gv.x, wt));
          acc[h2].y = __fadd_rn(acc[h2].y, __fmul_rn(gv.y, wt));
          acc[h2].z = __fadd_rn(acc[h2].z, __fmul_rn(gv.z, wt));
          acc[h2].w = __fadd_rn(acc[h2].w, __fmul_rn(gv.w, wt));
        }
      }
    }
    if (touched) {
      float4* dst = reinterpret_cast<float4*>(
          g + ((long long)tb.lists[1][py] * w + tb.lists[0][px]) * channels +
          c0) + q;
      atomicAdd(dst, acc[0]);
      if (second) atomicAdd(dst + kBwdOwners, acc[1]);
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

// what both kernels take: up to kMaxLevels levels of sides <= kMaxSide,
// 16-byte vectors of channels, at most kMaxAxis / 2 samples an axis
bool bad_geometry(int num_levels, const int* heights, const int* widths,
                  int channels, int out_size, int sampling_ratio) {
  if (num_levels < 1 || num_levels > kMaxLevels || channels % 8 != 0 ||
      out_size < 1 || sampling_ratio < 1 ||
      out_size * sampling_ratio * sampling_ratio > kMaxSamples ||
      2 * out_size * sampling_ratio > kMaxAxis)
    return true;
  for (int l = 0; l < num_levels; ++l)
    if (heights[l] > kMaxSide || widths[l] > kMaxSide) return true;
  return false;
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

template <typename T>
int launch_backward(const Levels& lv, const float* boxes,
                    const int* level_ids, const T* grad_out, int num_rois,
                    int channels, int out_size, int s, cudaStream_t stream) {
  // the staged slab of grad_out: S^2 x 256 bytes; opt in above the
  // default, once for each size (before any graph capture)
  const int bytes = out_size * out_size * kBwdSlab * (int)sizeof(float);
  static int allowed = 0;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)roi_align_backward_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const unsigned int blocks =
      (unsigned int)num_rois * ((channels + kBwdSlab - 1) / kBwdSlab);
  roi_align_backward_kernel<T><<<blocks, kBwdThreads, bytes, stream>>>(
      lv, boxes, level_ids, grad_out, channels, out_size, s);
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
  if (bad_geometry(num_levels, heights, widths, channels, out_size,
                   sampling_ratio))
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
// grads[l] is a zeroed f32 [H_l, W_l, C] device buffer, 16-byte aligned.
extern "C" int roi_align_backward_launch(
    void* const* grads, const int* heights, const int* widths,
    const int* strides, int num_levels, const void* boxes,
    const void* level_ids, const void* grad_out, int num_rois, int channels,
    int out_size, int sampling_ratio, int is_bf16, void* stream) {
  if (bad_geometry(num_levels, heights, widths, channels, out_size,
                   sampling_ratio) ||
      out_size * out_size * kBwdSlab * (int)sizeof(float) > kMaxGradBytes)
    return (int)cudaErrorInvalidValue;
  if (num_rois == 0 || channels == 0) return 0;
  const Levels lv = make_levels(grads, heights, widths, strides, num_levels);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_backward<__nv_bfloat16>(
        lv, (const float*)boxes, (const int*)level_ids,
        (const __nv_bfloat16*)grad_out, num_rois, channels, out_size,
        sampling_ratio, st);
  return launch_backward<float>(lv, (const float*)boxes,
                                (const int*)level_ids,
                                (const float*)grad_out, num_rois, channels,
                                out_size, sampling_ratio, st);
}
