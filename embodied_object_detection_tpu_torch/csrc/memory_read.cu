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

}  // namespace

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
