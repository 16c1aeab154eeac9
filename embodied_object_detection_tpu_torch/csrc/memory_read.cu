// Memory read: gather map cells into the egocentric frame, mean-pooled.
//     table[r]    = bf16(features[r] / (obs[r] > 1 ? obs[r] : 1))
//     out[y, x]   = mean over the pool x pool window of f32(table[proj[...]])
// features [B * cells, D] f32, obs [B * cells] f32, proj [B, H, W] int32
// with ids in [0, cells) (the host guard enforces it), out
// [B, H/pool, W/pool, D] f32. Frame b reads rows b * cells + id of the
// flattened table, as the JAX package's memory_read_batched offsets its
// ids; B = 1 is the eval frame's read.
//
// Replaces ops/memory_ops.py:memory_read and memory_read_batched (plain-jnp
// gathers + means that XLA lowered on the TPU). Two kernels, in the JAX
// package's order (ops/memory_ops.py normalises once and rounds to bf16,
// then gathers and takes the mean):
//   1. the pre-pass writes the bf16 table once, one row element at a time
//      (__fdiv_rn, __float2bfloat16_rn rounding), into a [B * cells, D]
//      bf16 scratch that the wrapper allocates: 8.4 MB for the eval frame,
//      33.5 MB at B = 4, so it stays in the 50 MB L2 for the gather;
//   2. the gather: a block takes kCellTile output cells, stages their
//      pool * pool row ids in shared memory, and each thread owns 8
//      channels of one cell, read as one 16-byte vector of bf16 per tap
//      (64 threads cover a 512-channel row). `pool` is a template
//      parameter, so a cell's taps are unrolled and all in flight at once.
//      The taps are widened and accumulated in f32 in tap order t = 0..15,
//      then divided by pool^2: the arithmetic of the one-pass kernel this
//      replaces, so the output is the same bits. The output is written
//      with evict-first stores (__stcs), so its 39 MB stream does not push
//      the table out of L2.
// A frame of the batch runs the same instructions on the same values as a
// single read, so the batched read is bit-exact to B single reads.
//
// What bounds it on Hopper: bytes. Device memory must see the f32 table
// once (16.8 MB a frame), proj (1.2 MB) and the output (39.3 MB); the
// pre-pass adds the bf16 table's write and its re-reads from L2. The
// one-pass design divided and rounded every element of every tap (16x
// the table's elements) and re-read 2 KB f32 rows 16 times from L1/L2
// (629 MB a frame); here each row is divided once and the re-reads are
// 1 KB bf16 rows.
//
// Backward (kernel 2b): the transpose of the read in `features`, as JAX's
// autodiff forms it through ops/memory_ops.py:memory_read(_batched):
//     grad_features[r] = f32(bf16(sum over the (window, tap) pairs that
//                        gathered row r of bf16(grad_out[window] / p^2)))
//                        / (obs[r] > 1 ? obs[r] : 1)
// (the mean's cotangent g / p^2 rounded to bf16 where the gather widened
// bf16 to f32, scatter-added into the bf16 table's cotangent, widened back
// and divided as the normalisation's transpose). grad_out [B, H/p, W/p, D]
// f32, grad_features [B * cells, D] f32, zeroed by the wrapper. JAX adds
// the contributions in bf16 one by one; atomics cannot keep an order, so
// the kernel adds them in f32 and rounds once, and is held to that
// arithmetic's own bound of the exact sum s, one bf16 rounding of an f32
// sum: (2^-8 |s| + n 2^-24 sum |c|) / denominator, to first order
// (ops/memory_ops.py:memory_read_grad_exact; JAX's bf16 sum keeps only the
// looser n 2^-8 sum |c| / denominator). Two kernels:
//   1. the scatter: a warp per output window stages its p^2 row ids and
//      merges equal ones (a tap's id counted with its multiplicity, exact
//      in f32: a bf16 value times at most 64), then adds each distinct
//      row once with one float4 atomicAdd (sm_90, a vector RED in L2) per
//      4 channels: a window of a real scene maps to one or two cells, and
//      random ids to 16;
//   2. the finish, in place: the bf16 rounding and the division.
// What bounds it: bytes (grad_out read once, the table written once) and,
// on random ids, the atomics: 307 200 taps x 512 channels a frame, ~39 M
// float4 REDs where no window repeats a cell.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPool = 8;
constexpr int kCellTile = 16;      // output cells a gather block
constexpr int kThreads = 256;
constexpr int kGroup = 16;         // tap loads in flight at once

// two f32 rounded to bf16 (__float2bfloat16_rn), low half first
__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// a bf16 is the high half of the f32 of the same value
__device__ __forceinline__ float2 unpack_bf16(unsigned int v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// table[r, 8v .. 8v + 8) from features[r, ...]: one 16-byte store a thread
__global__ void memory_read_prepass(const float* __restrict__ features,
                                 const float* __restrict__ obs,
                                 uint4* __restrict__ table, long long rows,
                                 int vec) {
  const long long n = rows * vec;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float o = __ldg(obs + i / vec);
    const float d = o > 1.0f ? o : 1.0f;
    const float4* src = reinterpret_cast<const float4*>(features) + 2 * i;
    const float4 a = __ldcs(src);           // read once: do not keep in L2
    const float4 b = __ldcs(src + 1);
    table[i] = make_uint4(pack_bf16(__fdiv_rn(a.x, d), __fdiv_rn(a.y, d)),
                          pack_bf16(__fdiv_rn(a.z, d), __fdiv_rn(a.w, d)),
                          pack_bf16(__fdiv_rn(b.x, d), __fdiv_rn(b.y, d)),
                          pack_bf16(__fdiv_rn(b.z, d), __fdiv_rn(b.w, d)));
  }
}

template <int kPool>
__global__ void __launch_bounds__(kThreads)
memory_read_gather(const uint4* __restrict__ table,
                   const int* __restrict__ proj, float* __restrict__ out,
                   int vec, int height, int width, int cells,
                   long long out_cells) {
  constexpr int kTaps = kPool * kPool;
  __shared__ long long rows[kCellTile][kTaps];
  const int out_w = width / kPool;
  const int frame_cells = (height / kPool) * out_w;
  const long long first = (long long)blockIdx.x * kCellTile;
  for (int i = threadIdx.x; i < kCellTile * kTaps; i += blockDim.x) {
    const int j = i / kTaps;
    const int t = i - j * kTaps;
    const long long cell = first + j;
    long long row = 0;
    if (cell < out_cells) {
      const int b = (int)(cell / frame_cells);
      const int local = (int)(cell - (long long)b * frame_cells);
      const int oy = local / out_w;
      const int ox = local - oy * out_w;
      const int dy = t / kPool;
      const int dx = t - dy * kPool;
      row = (long long)b * cells +
            __ldg(proj + (long long)b * height * width +
                  (long long)(oy * kPool + dy) * width + ox * kPool + dx);
    }
    rows[j][t] = row * vec;
  }
  __syncthreads();

  const long long left = out_cells - first;
  const int here = left < kCellTile ? (int)left : kCellTile;
  const float n = (float)kTaps;
  for (int i = threadIdx.x; i < here * vec; i += blockDim.x) {
    const int j = i / vec;
    const int c = i - j * vec;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t0 = 0; t0 < kTaps; t0 += kGroup) {
      uint4 v[kGroup];
#pragma unroll
      for (int t = 0; t < kGroup; ++t)
        if (t0 + t < kTaps) v[t] = __ldg(table + rows[j][t0 + t] + c);
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        if (t0 + t >= kTaps) continue;
        const unsigned int w[4] = {v[t].x, v[t].y, v[t].z, v[t].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = unpack_bf16(w[q]);
          acc[2 * q] = __fadd_rn(acc[2 * q], f.x);
          acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1], f.y);
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(out) + 2 * ((first + j) * vec + c);
    __stcs(dst, make_float4(__fdiv_rn(acc[0], n), __fdiv_rn(acc[1], n),
                            __fdiv_rn(acc[2], n), __fdiv_rn(acc[3], n)));
    __stcs(dst + 1, make_float4(__fdiv_rn(acc[4], n), __fdiv_rn(acc[5], n),
                                __fdiv_rn(acc[6], n), __fdiv_rn(acc[7], n)));
  }
}

template <int kPool>
void launch_gather(const uint4* table, const int* proj, float* out, int vec,
                   int height, int width, int cells, long long out_cells,
                   cudaStream_t stream) {
  const unsigned int blocks =
      (unsigned int)((out_cells + kCellTile - 1) / kCellTile);
  memory_read_gather<kPool><<<blocks, kThreads, 0, stream>>>(
      table, proj, out, vec, height, width, cells, out_cells);
}

constexpr int kMaxTaps = kMaxPool * kMaxPool;
constexpr int kBwdWarps = 8;       // windows a scatter block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kBwdWarps * 32)
memory_read_scatter(const float4* __restrict__ grad_out,
                    const int* __restrict__ proj, float4* __restrict__ acc,
                    int vec4, int height, int width, int pool, int cells,
                    long long windows) {
  __shared__ long long rows[kBwdWarps][kMaxTaps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long win = blockIdx.x * (long long)kBwdWarps + warp;
  if (win >= windows) return;        // whole warps leave together
  const int taps = pool * pool;
  const int out_w = width / pool;
  const int frame_windows = (height / pool) * out_w;
  const int b = (int)(win / frame_windows);
  const int local = (int)(win - (long long)b * frame_windows);
  const int oy = local / out_w, ox = local - (local / out_w) * out_w;
  for (int t = lane; t < taps; t += 32) {
    const int dy = t / pool, dx = t - (t / pool) * pool;
    rows[warp][t] = (long long)b * cells +
                    __ldg(proj + (long long)b * height * width +
                          (long long)(oy * pool + dy) * width + ox * pool +
                          dx);
  }
  __syncwarp();
  const float n = (float)taps;
  const float4* g = grad_out + win * vec4;
  for (int t = 0; t < taps; ++t) {
    const long long row = rows[warp][t];
    // the first tap of its row carries the row's multiplicity
    bool earlier = false;
    int mult = 0;
    for (int u0 = 0; u0 < taps; u0 += 32) {
      const int u = u0 + lane;
      const bool same = u < taps && rows[warp][u] == row;
      earlier |= __any_sync(0xffffffffu, same && u < t);
      mult += __popc(__ballot_sync(0xffffffffu, same));
    }
    if (earlier) continue;
    const float f = (float)mult;
    for (int c = lane; c < vec4; c += 32) {
      const float4 v = __ldg(g + c);
      atomicAdd(acc + row * vec4 + c,
                make_float4(bf16_round(__fdiv_rn(v.x, n)) * f,
                            bf16_round(__fdiv_rn(v.y, n)) * f,
                            bf16_round(__fdiv_rn(v.z, n)) * f,
                            bf16_round(__fdiv_rn(v.w, n)) * f));
    }
  }
}

__global__ void memory_read_finish(float4* __restrict__ acc,
                                   const float* __restrict__ obs,
                                   long long rows, int vec4) {
  const long long n = rows * vec4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float o = __ldg(obs + i / vec4);
    const float d = o > 1.0f ? o : 1.0f;
    const float4 v = acc[i];
    acc[i] = make_float4(__fdiv_rn(bf16_round(v.x), d),
                         __fdiv_rn(bf16_round(v.y), d),
                         __fdiv_rn(bf16_round(v.z), d),
                         __fdiv_rn(bf16_round(v.w), d));
  }
}

}  // namespace

// grad_features: a zeroed f32 [batch * cells, dim] buffer, 16-byte
// aligned, that holds the gradient when the two kernels are done.
extern "C" int memory_read_backward_launch(const void* grad_out,
                                           const void* obs, const void* proj,
                                           void* grad_features, int dim,
                                           int height, int width, int pool,
                                           int batch, int cells,
                                           void* stream) {
  if (pool <= 0 || pool > kMaxPool || dim % 4 != 0 || height % pool != 0 ||
      width % pool != 0 || batch < 0 || cells < 0)
    return (int)cudaErrorInvalidValue;
  const long long windows =
      (long long)batch * (height / pool) * (width / pool);
  const long long rows = (long long)batch * cells;
  if (dim == 0 || rows == 0) return 0;
  if ((windows + kBwdWarps - 1) / kBwdWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec4 = dim / 4;
  if (windows > 0)
    memory_read_scatter<<<(unsigned int)((windows + kBwdWarps - 1) /
                                         kBwdWarps),
                          kBwdWarps * 32, 0, s>>>(
        (const float4*)grad_out, (const int*)proj, (float4*)grad_features,
        vec4, height, width, pool, cells, windows);
  long long blocks = (rows * vec4 + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  memory_read_finish<<<(unsigned int)blocks, kThreads, 0, s>>>(
      (float4*)grad_features, (const float*)obs, rows, vec4);
  return (int)cudaGetLastError();
}

// table: a [batch * cells, dim] bf16 scratch the caller allocates.
extern "C" int memory_read_launch(const void* features, const void* obs,
                                  const void* proj, void* table, void* out,
                                  int dim, int height, int width, int pool,
                                  int batch, int cells, void* stream) {
  if (pool <= 0 || pool > kMaxPool || dim % 8 != 0 || height % pool != 0 ||
      width % pool != 0 || batch < 0 || cells < 0)
    return (int)cudaErrorInvalidValue;
  const long long out_cells =
      (long long)batch * (height / pool) * (width / pool);
  if (out_cells == 0 || dim == 0) return 0;
  if ((out_cells + kCellTile - 1) / kCellTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = dim / 8;
  const long long rows = (long long)batch * cells;
  if (rows > 0) {
    long long blocks = (rows * vec + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    memory_read_prepass<<<(unsigned int)blocks, kThreads, 0, s>>>(
        (const float*)features, (const float*)obs, (uint4*)table, rows, vec);
  }
  const uint4* t = (const uint4*)table;
  const int* p = (const int*)proj;
  float* o = (float*)out;
  switch (pool) {
    case 1: launch_gather<1>(t, p, o, vec, height, width, cells, out_cells, s); break;
    case 2: launch_gather<2>(t, p, o, vec, height, width, cells, out_cells, s); break;
    case 3: launch_gather<3>(t, p, o, vec, height, width, cells, out_cells, s); break;
    case 4: launch_gather<4>(t, p, o, vec, height, width, cells, out_cells, s); break;
    case 5: launch_gather<5>(t, p, o, vec, height, width, cells, out_cells, s); break;
    case 6: launch_gather<6>(t, p, o, vec, height, width, cells, out_cells, s); break;
    case 7: launch_gather<7>(t, p, o, vec, height, width, cells, out_cells, s); break;
    default: launch_gather<8>(t, p, o, vec, height, width, cells, out_cells, s); break;
  }
  return (int)cudaGetLastError();
}
