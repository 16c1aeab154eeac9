// Segment-sum of weight rows into map cells:
//     out[c, k] = sum over rows r with idx[r] == c of w[r, k]
// Rows whose idx lies outside [0, num_cells) are dropped.
//
// Replaces the TPU kernel ops/pallas_scatter.py:scatter_sum_pallas (and the
// jax.ops.segment_sum of ops/memory_ops.py:246 on the JAX default path):
// the memory write's core contraction, [S, N+1] weights-plus-count rows
// into [cells, N+1] on every frame (S = 480 * 80 selection slots,
// N + 1 = 101, cells = 8192).
//
// What bounds it on Hopper: bytes. The inputs are read once (S*K*4 + S*4
// bytes, ~15.7 MB at the flagship shape) and the output written once
// (cells*K*4, ~3.3 MB); the adds are negligible. The TPU kernel's one-hot
// MXU formulation was a workaround for a serialised scatter and is not
// carried over: Hopper resolves float atomics in L2.
//
// The design, a warp per group of kRows = 16 consecutive rows:
//   - the warp reads the group's ids with one coalesced load (lane i, row
//     i) and ballots the rows whose id is in range; the weights of the
//     other rows (the selection's empty slots) are never read;
//   - lane g owns the 4-lane group g of a row (columns 4g .. 4g+3; 26
//     groups at K = 101, a second sweep past 128 columns), and loads it
//     for kBatch live rows at once, as four 4-byte loads of the same
//     sectors (a 404-byte row admits no wider load);
//   - the loads are what takes the time (a scratch build that loads and
//     sums but never flushes was only a little faster), and a warp's
//     chain of dependent batches is its latency, so groups are short: 16
//     rows a warp ran faster than 32 on random and coherent ids (more
//     warps in flight), 8 no faster, and 16 keeps a one-cell worst case
//     to half the flushes of 8;
//   - runs of consecutive live rows with the same id are summed in
//     registers in row order; each run is flushed once, with one float4
//     atomicAdd (sm_90, a vector reduction in L2) per lane whose four sums
//     are not all zero, into an accumulator whose rows are padded to a
//     multiple of 4 columns so that every flush is 16-byte aligned.
// No per-element division: a row's offset is one 64-bit multiply. Adding
// a zero (+0.0 or -0.0) to a +0.0-initialised sum changes nothing, so
// skipping all-zero flushes is exact. Accumulation is f32; a register sum
// is a sum of fewer terms in a fixed order, and the atomics land in any
// order, so each entry stays within rows in the cell * 2^-24 * sum|w| of
// the exact sum and integer-valued lanes (the count lane) stay exact below
// 2^24. The caller zero-fills `out`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;       // rows a warp: one id a lane
constexpr int kBatch = 4;       // live rows whose loads are in flight at once
constexpr int kWarps = 4;       // warps a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load_group(const float* __restrict__ row,
                                             int col, int lanes) {
  float4 v;
  v.x = col < lanes ? __ldg(row + col) : 0.0f;
  v.y = col + 1 < lanes ? __ldg(row + col + 1) : 0.0f;
  v.z = col + 2 < lanes ? __ldg(row + col + 2) : 0.0f;
  v.w = col + 3 < lanes ? __ldg(row + col + 3) : 0.0f;
  return v;
}

__device__ __forceinline__ void flush(float* __restrict__ out, int cell,
                                      int padded, int col, bool owns,
                                      float4 acc) {
  if (cell < 0 || !owns) return;
  if (acc.x == 0.0f && acc.y == 0.0f && acc.z == 0.0f && acc.w == 0.0f)
    return;
  atomicAdd(reinterpret_cast<float4*>(out + (long long)cell * padded + col),
            acc);
}

__global__ void segment_sum_kernel(const float* __restrict__ w,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, long long rows,
                                   int lanes, int padded, int num_cells) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      (blockIdx.x * (long long)kWarps + (threadIdx.x >> 5)) * kRows;
  if (r0 >= rows) return;                      // warp-uniform
  const long long left = rows - r0;
  const int n = left < kRows ? (int)left : kRows;
  const int cell = lane < n ? __ldg(idx + r0 + lane) : -1;
  const unsigned live = __ballot_sync(kFull, cell >= 0 && cell < num_cells);
  if (live == 0u) return;                      // warp-uniform
  const float* base = w + r0 * lanes;

  for (int c0 = 0; c0 < lanes; c0 += 4 * 32) {
    const int col = c0 + 4 * lane;
    const bool owns = col < lanes;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int run = -1;                              // the cell of the open run
    unsigned todo = live;
    while (todo) {                             // warp-uniform
      int row[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        row[u] = todo ? __ffs(todo) - 1 : -1;
        todo &= todo - 1u;
      }
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = (row[u] >= 0 && owns)
                   ? load_group(base + (long long)row[u] * lanes, col, lanes)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (row[u] < 0) break;                 // warp-uniform
        const int c = __shfl_sync(kFull, cell, row[u]);
        if (c != run) {
          flush(out, run, padded, col, owns, acc);
          acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          run = c;
        }
        acc.x += v[u].x;
        acc.y += v[u].y;
        acc.z += v[u].z;
        acc.w += v[u].w;
      }
    }
    flush(out, run, padded, col, owns, acc);
  }
}

}  // namespace

// out: [num_cells, padded] f32, zero-filled, 16-byte aligned, padded a
// multiple of 4 and >= lanes
extern "C" int segment_sum_launch(const void* w, const void* idx, void* out,
                                  long long rows, int lanes, int padded,
                                  int num_cells, void* stream) {
  if (padded % 4 != 0 || padded < lanes || ((uintptr_t)out & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || lanes == 0 || num_cells == 0) return 0;
  const long long warps = (rows + kRows - 1) / kRows;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  segment_sum_kernel<<<(unsigned int)blocks, 32 * kWarps, 0,
                       (cudaStream_t)stream>>>(
      (const float*)w, (const int*)idx, (float*)out, rows, lanes, padded,
      num_cells);
  return (int)cudaGetLastError();
}
