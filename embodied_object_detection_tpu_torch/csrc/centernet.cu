// The CenterNet proposal head on one packed canvas (kernels 10, 10b and 10c
// of the port):
//   10   centernet_pack:   the FPN levels [H_l, W_l, C] -> one channels-last
//                          canvas [Hc, Wc, C] in the tower's type, each level
//                          at its origin, zeros everywhere else;
//   10b  group_norm_relu:  GroupNorm over each level's own positions of a
//                          canvas, then the affine map, the cast to the
//                          tower's type and the ReLU, zeros at every pad
//                          position (one launch);
//   10c  centernet_decode: the heatmap and regression outputs, packed or per
//                          level -> every position's sort key and its row
//                          of box, score and threshold flag, in per-level
//                          flat order.
//
// These replace no TPU kernel: the JAX package runs the tower level by
// level and leaves the decode to XLA, which fuses each level's ops into a
// few programs. On the card the same per-level code is ~540 launches a
// frame, each a few microseconds of work, so the host's dispatch sets the
// stage's time. Packing the levels into one canvas (one zero row or column
// between levels, so a 3x3 convolution with padding 1 reads the same zeros
// at every level border as it does per level) makes each tower layer one
// convolution a band of the canvas (two at 480 x 640) plus one GroupNorm
// launch, and the decode one launch before one sort.
//
// What bounds them on Hopper: bytes, and at these sizes launch latency. At
// 480 x 640 the canvas is 91 x 80 positions x 256 channels, 3.7 MB in bf16:
// the pack reads the levels (3.3 MB in bf16) and writes the canvas once;
// the GroupNorm reads the tower convolution's output once into shared
// memory, sums it twice there and writes the canvas once; the decode reads
// 5 f32 channels of 6 400 positions and writes 32 bytes each (an 8-byte
// key and a 24-byte row).
//
// The design:
//   - pack: one thread a (canvas position, 8 channels), 16-byte loads and
//     stores where the channels allow (else one channel), the position's
//     level found by testing at most 8 rectangles;
//   - GroupNorm: one block a (group, level), which stages the group's
//     values in shared memory in `models/layers.py:GroupNorm`'s [channel]
//     [position] order and sums them in the order PyTorch's own reduction
//     sums that layer's `mean` on the card (`torch_order_sum` below): the
//     mean, then the mean of the squared deviations, rstd = rsqrtf(var +
//     eps), each product and sum rounded alone (no FMA), so the statistics
//     equal the per-level layer's bit for bit; then (x - mean) * rstd, bias
//     + xn * weight rounded once (an FMA, as PyTorch's `addcmul` computes
//     it on the card), rounded to the tower's type, ReLU, written where the
//     level sits on the canvas in the tower's type or (for the last layer,
//     which feeds the f32 heads) widened to f32. So a tower layer's bf16
//     roundings fall as they fall level by level. Any other order of the
//     sums leaves ~20 of a layer's 1.9 M bf16 values rounded the other way,
//     which the next layers and the NMS spread: the benchmark's frame-0
//     score gap to its per-level reference then reads 3-10x the gap of
//     this order on the same seeds, on an H100 (PERF.md, section 6).
//     Fixed order, so a run is repeatable. The block reads its level where
//     the level's band convolution wrote it (`ops/centernet.py` says why
//     the convolutions run a band at a time). One more row of blocks
//     writes the zeros at the pad positions;
//   - decode: one thread a candidate; sigmoid as 1 / (1 + expf(-x)),
//     sqrtf, and every product and sum with the _rn intrinsics (never
//     contracted into an FMA), PyTorch's own f32 expressions on the card,
//     so the boxes, scores and flags equal the per-level PyTorch decode's
//     bit for bit. The key (level << 32) | (0x7FFFFFFF - bits(sigmoid))
//     sorts, ascending and stably, into each level's descending scores with
//     ties in index order: the order of one stable descending sort a level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kNormThreads = 512;  // PyTorch's reduction block at most

struct Rects {  // the levels' rectangles on the canvas
  int y0[kMaxLevels], x0[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
  int n;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements, loaded and stored as 16-byte vectors (or fewer bytes)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

// the level whose rectangle holds canvas position (y, x), -1 for a pad
__device__ __forceinline__ int level_of(const Rects& r, int y, int x) {
  int found = -1;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l < r.n && y >= r.y0[l] && y < r.y0[l] + r.h[l] && x >= r.x0[l] &&
        x < r.x0[l] + r.w[l])
      found = l;
  return found;
}

struct Sources {
  const void* ptr[kMaxLevels];
};

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(Sources src, Rects r, Tout* __restrict__ out, int height,
                int width, int channels) {
  const int vecs = channels / V;
  const long long total = (long long)height * width * vecs;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int pos = (int)(i / vecs), c = (int)(i % vecs) * V;
    const int y = pos / width, x = pos % width;
    const int l = level_of(r, y, x);
    Pack<Tout, V> o;
    if (l < 0) {
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = from_f<Tout>(0.0f);
    } else {
      const Tin* p = static_cast<const Tin*>(src.ptr[l]) +
                     ((long long)(y - r.y0[l]) * r.w[l] + (x - r.x0[l])) *
                         channels + c;
      const Pack<Tin, V> v = *reinterpret_cast<const Pack<Tin, V>*>(p);
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = from_f<Tout>(to_f(v.v[k]));
    }
    *reinterpret_cast<Pack<Tout, V>*>(out + (long long)pos * channels + c) =
        o;
  }
}

// PyTorch's order of summation for `mean` over the last axis of a
// contiguous f32 [G, N] tensor on the card (ATen/native/cuda/Reduce.cuh:
// setReduceConfig, ReduceOp::thread_reduce, block_x_reduce,
// block_y_reduce, MeanOps), which `models/layers.py:GroupNorm` runs for each
// level. Its ReduceConfig for G outputs of N inputs: a block of bw x bh
// threads (bw along the row); rows of N >= 128 read 4-element vectors (the
// elements before the row's first 16-byte boundary summed first, the
// tail last); a thread keeps 4 accumulators, adds them in order, the row's
// threads are summed by warp shuffles, and where each thread would sum 16
// or more values (at most 256) the bh warps share one output and are
// summed by a tree in shared memory; mean = sum * (G / (G * N)). Splits
// over several blocks (N >= 131072 here) are not followed: such a level
// is summed as if they were not.
struct ReducePlan {
  int bw;        // threads along the row
  int warps;     // rows of threads sharing one output (1: each its own)
  int vec;       // 4-element vectors (N >= 128)
  int shift;     // elements before the row's first 16-byte boundary
  float factor;  // MeanOps' projection, G / (G * N)
};

__device__ __forceinline__ int last_pow2(int n) {
  n |= n >> 1;
  n |= n >> 2;
  n |= n >> 4;
  n |= n >> 8;
  n |= n >> 16;
  return max(1, n - (n >> 1));
}

// the plan for row `row` of a [groups, n] reduction
__device__ ReducePlan plan_for(int n, int groups, int row) {
  ReducePlan p;
  p.vec = n >= 128;
  const int dim0 = p.vec ? n / 4 : n;
  const int dim0_pow2 = dim0 < 512 ? last_pow2(dim0) : 512;
  const int dim1_pow2 = groups < 512 ? last_pow2(groups) : 512;
  int bw = min(dim0_pow2, 32);
  const int bh = min(dim1_pow2, 512 / bw);
  bw = min(dim0_pow2, 512 / bh);
  const int per_thread = (n + bw - 1) / bw;
  p.bw = bw;
  p.warps = per_thread >= min(bh * 16, 256) ? bh : 1;
  p.shift = p.vec ? (int)(((long long)row * n) % 4) : 0;
  p.factor = (float)groups / (float)((long long)groups * n);
  return p;
}

// sum of elem(i), i < n, in the plan's order; every thread of the
// kNormThreads block gets it. red: kNormThreads + 1 floats of shared
// memory.
template <class Elem>
__device__ float torch_order_sum(const ReducePlan& p, int n, Elem elem,
                                 float* red) {
  const int tid = threadIdx.x;
  const int x = tid % p.bw, y = tid / p.bw;
  float v = 0.0f;
  if (y < p.warps) {
    const bool tail = p.warps == 1 || y == 0;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    const int stride = p.bw * p.warps;
    if (p.vec) {
      int end = n, sh = 0;
      if (p.shift > 0) {
        if (x >= p.shift && x < 4 && tail) a0 = 0.0f + elem(x - p.shift);
        sh = 4 - p.shift;
        end = n - sh;
      }
      for (int idx = x + p.bw * y; idx * 4 + 3 < end; idx += stride) {
        const int i = sh + 4 * idx;
        a0 += elem(i);
        a1 += elem(i + 1);
        a2 += elem(i + 2);
        a3 += elem(i + 3);
      }
      const int t = end - end % 4 + x;
      if (tail && t < end) a0 += elem(sh + t);
    } else {
      int idx = x + p.bw * y;
      for (; idx + 3 * stride < n; idx += 4 * stride) {
        a0 += elem(idx);
        a1 += elem(idx + stride);
        a2 += elem(idx + 2 * stride);
        a3 += elem(idx + 3 * stride);
      }
      if (idx < n) {
        a0 += elem(idx);
        if ((idx += stride) < n) {
          a1 += elem(idx);
          if ((idx += stride) < n) a2 += elem(idx);
        }
      }
    }
    v = ((a0 + a1) + a2) + a3;
  }
  // block_x_reduce: shuffles down, the offset halving from bw / 2
  for (int off = p.bw >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // red is reused between calls
  if (p.warps > 1) {  // block_y_reduce
    red[tid] = v;
    for (int off = p.warps >> 1; off > 0; off >>= 1) {
      __syncthreads();
      if (y < off) {
        v += red[x + (y + off) * p.bw];
        red[x + y * p.bw] = v;
      }
    }
  }
  if (tid == 0) red[kNormThreads] = v;
  __syncthreads();
  return red[kNormThreads];
}

struct LevelSources {  // each level's first element; rows `width` apart
  const void* ptr[kMaxLevels];
};

// blocks (g, l < levels): level l's group g, staged in shared memory in
// [channel][position] order when `staged`: mean and rstd in `GroupNorm`'s
// arithmetic, then (x - mean) * rstd, bias + xn * weight rounded once
// (PyTorch's `addcmul` on the card is an FMA), rounded to the tower's type
// T, ReLU, written to the canvas [height, width, C] in T or (Tout = float)
// widened to f32 for the heads; blocks (g, levels): zeros at group g's
// channels of every pad position
template <typename T, typename Tout, int V>
__global__ void __launch_bounds__(kNormThreads)
    group_norm_relu_kernel(LevelSources src, Rects r, int height, int width,
                           int channels, int cpg, float eps, int staged,
                           const float* __restrict__ weight,
                           const float* __restrict__ bias,
                           Tout* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char staging[];
  __shared__ float red[kNormThreads + 1];
  const int g = blockIdx.x, l = blockIdx.y, c0 = g * cpg;
  if (l == r.n) {
    Pack<Tout, V> zero;
#pragma unroll
    for (int k = 0; k < V; ++k) zero.v[k] = from_f<Tout>(0.0f);
    for (int pos = threadIdx.x; pos < height * width; pos += kNormThreads)
      if (level_of(r, pos / width, pos % width) < 0)
        for (int c = 0; c < cpg; c += V)
          *reinterpret_cast<Pack<Tout, V>*>(
              out + (long long)pos * channels + c0 + c) = zero;
    return;
  }
  const int lw = r.w[l], np = r.h[l] * lw, n = np * cpg;
  const T* base = static_cast<const T*>(src.ptr[l]) + c0;
  T* s = reinterpret_cast<T*>(staging);
  if (staged) {
    for (int p = threadIdx.x; p < np; p += kNormThreads) {
      const T* q = base + ((long long)(p / lw) * width + p % lw) * channels;
      for (int c = 0; c < cpg; c += V) {
        const Pack<T, V> v = *reinterpret_cast<const Pack<T, V>*>(q + c);
#pragma unroll
        for (int k = 0; k < V; ++k) s[(c + k) * np + p] = v.v[k];
      }
    }
    __syncthreads();
  }
  auto load = [&](int c, int p) -> float {
    if (staged) return to_f(s[c * np + p]);
    return to_f(base[((long long)(p / lw) * width + p % lw) * channels + c]);
  };
  // the group's i-th value in [channel][position] order
  auto value = [&](int i) -> float {
    return staged ? to_f(s[i]) : load(i / np, i % np);
  };
  const ReducePlan plan = plan_for(n, gridDim.x, g);
  const float mean = __fmul_rn(torch_order_sum(plan, n, value, red),
                               plan.factor);
  const float var = __fmul_rn(torch_order_sum(plan, n,
                                              [&](int i) {
                                                const float d =
                                                    __fsub_rn(value(i), mean);
                                                return __fmul_rn(d, d);
                                              },
                                              red),
                              plan.factor);
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const int vecs = cpg / V;
  for (int i = threadIdx.x; i < np * vecs; i += kNormThreads) {
    const int p = i / vecs, c = (i % vecs) * V;
    Pack<Tout, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xn = __fmul_rn(__fsub_rn(load(c + k, p), mean), rstd);
      const float t = to_f(from_f<T>(
          __fmaf_rn(xn, __ldg(weight + c0 + c + k), __ldg(bias + c0 + c + k))));
      o.v[k] = from_f<Tout>(t > 0.0f ? t : 0.0f);
    }
    const long long pos = (long long)(r.y0[l] + p / lw) * width + r.x0[l] +
                          p % lw;
    *reinterpret_cast<Pack<Tout, V>*>(out + pos * channels + c0 + c) = o;
  }
}

struct DecodeLevels {
  const float* hm[kMaxLevels];
  const float* reg[kMaxLevels];
  int w[kMaxLevels];
  int hm_row[kMaxLevels], hm_pos[kMaxLevels];
  int reg_row[kMaxLevels], reg_pos[kMaxLevels], reg_ch[kMaxLevels];
  int start[kMaxLevels + 1];  // flat offsets of the levels' candidates
  int stride[kMaxLevels];
  int n;
};

// the key of a score s on level l: (l << 32) | (0x7FFFFFFF - bits(s))
__global__ void __launch_bounds__(kThreads)
    decode_kernel(DecodeLevels lv, const float* __restrict__ scales,
                  float thresh, long long* __restrict__ key,
                  float2* __restrict__ rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lv.start[lv.n]) return;
  int l = 0;
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k)
    if (k < lv.n && i >= lv.start[k]) l = k;
  const int j = i - lv.start[l], w = lv.w[l];
  const int y = j / w, x = j % w;
  const float h = __ldg(lv.hm[l] + (long long)y * lv.hm_row[l] +
                        (long long)x * lv.hm_pos[l]);
  // torch.sigmoid's f32 expression on the card
  const float s = 1.0f / (1.0f + expf(-h));
  const float* rp = lv.reg[l] + (long long)y * lv.reg_row[l] +
                    (long long)x * lv.reg_pos[l];
  const float stride = (float)lv.stride[l];
  float r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v = __ldg(rp + (long long)c * lv.reg_ch[l]);
    if (scales != nullptr) {  // the level's Scale, then the ReLU
      v = __fmul_rn(v, __ldg(scales + l));
      v = v < 0.0f ? 0.0f : v;
    }
    r[c] = __fmul_rn(v, stride);
  }
  // level_grids: index * stride + stride // 2
  const float gx = __fadd_rn(__fmul_rn((float)x, stride),
                             (float)(lv.stride[l] / 2));
  const float gy = __fadd_rn(__fmul_rn((float)y, stride),
                             (float)(lv.stride[l] / 2));
  const float x1 = __fsub_rn(gx, r[0]);
  const float y1 = __fsub_rn(gy, r[1]);
  const float x2 = fmaxf(__fadd_rn(gx, r[2]), __fadd_rn(x1, 0.01f));
  const float y2 = fmaxf(__fadd_rn(gy, r[3]), __fadd_rn(y1, 0.01f));
  const bool ok = s > thresh;
  key[i] = ((long long)l << 32) | (long long)(0x7FFFFFFF - __float_as_int(s));
  float2* row = rows + 3LL * i;  // x1 y1 x2 y2 score flag
  row[0] = make_float2(x1, y1);
  row[1] = make_float2(x2, y2);
  row[2] = make_float2(__fsqrt_rn(s), ok ? 1.0f : 0.0f);
}

bool make_rects(const int* y0s, const int* x0s, const int* hs, const int* ws,
                int num_levels, int height, int width, Rects* r) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  r->n = num_levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < num_levels;
    r->y0[l] = on ? y0s[l] : 0;
    r->x0[l] = on ? x0s[l] : 0;
    r->h[l] = on ? hs[l] : 0;
    r->w[l] = on ? ws[l] : 0;
    if (on && (r->h[l] < 1 || r->w[l] < 1 || r->y0[l] < 0 || r->x0[l] < 0 ||
               r->y0[l] + r->h[l] > height || r->x0[l] + r->w[l] > width))
      return false;
  }
  return true;
}

int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535);
}

template <typename Tin, typename Tout>
int launch_pack(const Sources& src, const Rects& r, void* out, int height,
                int width, int channels, cudaStream_t s) {
  if (channels % 8 == 0) {
    pack_kernel<Tin, Tout, 8><<<grid_for((long long)height * width *
                                         (channels / 8)),
                                kThreads, 0, s>>>(
        src, r, (Tout*)out, height, width, channels);
  } else {
    pack_kernel<Tin, Tout, 1><<<grid_for((long long)height * width *
                                         channels),
                                kThreads, 0, s>>>(
        src, r, (Tout*)out, height, width, channels);
  }
  return (int)cudaGetLastError();
}

constexpr int kMaxStaged = 200 * 1024;  // shared memory a GroupNorm block

template <typename T, typename Tout, int V>
int launch_norm(const LevelSources& src, const Rects& r, int height,
                int width, int channels, int groups, float eps,
                const float* weight, const float* bias, void* out,
                cudaStream_t s) {
  const int cpg = channels / groups;
  long long most = 0;
  for (int l = 0; l < r.n; ++l)
    most = std::max(most, (long long)r.h[l] * r.w[l] * cpg *
                              (long long)sizeof(T));
  const int staged = most <= kMaxStaged;
  const int bytes = staged ? (int)most : 0;
  static int allowed = 48 * 1024;
  if (bytes > allowed) {
    const int err = (int)cudaFuncSetAttribute(
        group_norm_relu_kernel<T, Tout, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStaged);
    if (err) return err;
    allowed = kMaxStaged;
  }
  group_norm_relu_kernel<T, Tout, V>
      <<<dim3(groups, r.n + 1), kNormThreads, bytes, s>>>(
          src, r, height, width, channels, cpg, eps, staged, weight, bias,
          (Tout*)out);
  return (int)cudaGetLastError();
}

template <typename T, typename Tout>
int launch_norm_v(const LevelSources& src, const Rects& r, int height,
                  int width, int channels, int groups, float eps,
                  const float* weight, const float* bias, void* out,
                  cudaStream_t s) {
  if ((channels / groups) % 8 == 0)
    return launch_norm<T, Tout, 8>(src, r, height, width, channels, groups,
                                   eps, weight, bias, out, s);
  return launch_norm<T, Tout, 1>(src, r, height, width, channels, groups,
                                 eps, weight, bias, out, s);
}

}  // namespace

// levels, y0s, x0s, heights, widths: host arrays of num_levels entries; each
// levels[l] a contiguous [H_l, W_l, C] device array (bf16 when in_bf16,
// else f32), 16-byte aligned when C % 8 == 0; out the [height, width, C]
// canvas (bf16 when out_bf16, else f32), written whole.
extern "C" int centernet_pack_launch(const void* const* levels,
                                     const int* y0s, const int* x0s,
                                     const int* heights, const int* widths,
                                     int num_levels, int height, int width,
                                     int channels, int in_bf16, int out_bf16,
                                     void* out, void* stream) {
  Rects r;
  if (channels < 1 ||
      !make_rects(y0s, x0s, heights, widths, num_levels, height, width, &r))
    return (int)cudaErrorInvalidValue;
  Sources src;
  for (int l = 0; l < kMaxLevels; ++l)
    src.ptr[l] = l < num_levels ? levels[l] : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return out_bf16 ? launch_pack<__nv_bfloat16, __nv_bfloat16>(
                          src, r, out, height, width, channels, s)
                    : launch_pack<__nv_bfloat16, float>(src, r, out, height,
                                                        width, channels, s);
  return out_bf16 ? launch_pack<float, __nv_bfloat16>(src, r, out, height,
                                                      width, channels, s)
                  : launch_pack<float, float>(src, r, out, height, width,
                                              channels, s);
}

// levels: host array of num_levels device pointers, each at its level's
// first element of a tower convolution's output (bf16 when is_bf16, else
// f32), rows `width` positions of C channels apart, 16-byte aligned when
// C / groups % 8 == 0; y0s .. widths as for the pack (the levels' places on
// the canvas); weight, bias: f32 [C]; out: the [height, width, C] canvas
// in the input's type, or f32 when out_f32, written whole.
extern "C" int group_norm_relu_launch(const void* const* levels,
                                      const int* y0s, const int* x0s,
                                      const int* heights, const int* widths,
                                      int num_levels, int height, int width,
                                      int channels, int groups, float eps,
                                      const void* weight, const void* bias,
                                      void* out, int is_bf16,
                                      int out_f32, void* stream) {
  Rects r;
  if (groups < 1 || groups > 512 || channels < groups || channels % groups ||
      !make_rects(y0s, x0s, heights, widths, num_levels, height, width, &r))
    return (int)cudaErrorInvalidValue;
  LevelSources src;
  for (int l = 0; l < kMaxLevels; ++l)
    src.ptr[l] = l < num_levels ? levels[l] : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  const float* wt = (const float*)weight;
  const float* bs = (const float*)bias;
  if (is_bf16)
    return out_f32
               ? launch_norm_v<__nv_bfloat16, float>(src, r, height, width,
                                                     channels, groups, eps,
                                                     wt, bs, out, s)
               : launch_norm_v<__nv_bfloat16, __nv_bfloat16>(
                     src, r, height, width, channels, groups, eps, wt, bs,
                     out, s);
  return launch_norm_v<float, float>(src, r, height, width, channels, groups,
                                     eps, wt, bs, out, s);
}

// hms, regs: host arrays of num_levels f32 device pointers; hm_strides
// (row, position) and reg_strides (row, position, channel) in elements, 2 and
// 3 a level; heights, widths, strides a level; scales: f32 [num_levels] on
// the card, or null where the regressions are already scaled and rectified;
// key: int64 [N]; rows: f32 [N, 6] (8-byte
// aligned), each x1, y1, x2, y2, score, flag (1.0 or 0.0); N the levels'
// positions, written in per-level flat order.
extern "C" int centernet_decode_launch(
    const void* const* hms, const void* const* regs, const int* heights,
    const int* widths, const int* hm_strides, const int* reg_strides,
    const int* strides, int num_levels, const void* scales, float thresh,
    void* key, void* rows, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  DecodeLevels lv;
  lv.n = num_levels;
  long long total = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool on = l < num_levels;
    lv.hm[l] = on ? (const float*)hms[l] : nullptr;
    lv.reg[l] = on ? (const float*)regs[l] : nullptr;
    lv.w[l] = on ? widths[l] : 1;
    lv.hm_row[l] = on ? hm_strides[2 * l] : 0;
    lv.hm_pos[l] = on ? hm_strides[2 * l + 1] : 0;
    lv.reg_row[l] = on ? reg_strides[3 * l] : 0;
    lv.reg_pos[l] = on ? reg_strides[3 * l + 1] : 0;
    lv.reg_ch[l] = on ? reg_strides[3 * l + 2] : 0;
    lv.stride[l] = on ? strides[l] : 1;
    lv.start[l] = (int)total;
    if (on) {
      if (heights[l] < 1 || widths[l] < 1) return (int)cudaErrorInvalidValue;
      total += (long long)heights[l] * widths[l];
    }
  }
  lv.start[kMaxLevels] = (int)total;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  decode_kernel<<<(int)((total + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      lv, (const float*)scales, thresh, (long long*)key, (float2*)rows);
  return (int)cudaGetLastError();
}
