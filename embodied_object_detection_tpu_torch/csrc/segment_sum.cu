// Segment-sum of weight rows into map cells:
//     out[c, k] = sum over rows r with idx[r] == c of w[r, k]
// Rows whose idx lies outside [0, num_cells) are dropped.
//
// Replaces the TPU kernel ops/pallas_scatter.py:scatter_sum_pallas (and the
// jax.ops.segment_sum of ops/memory_ops.py:246 on the JAX default path):
// the memory write's core contraction, [S, N+1] weights-plus-count rows
// into [cells, N+1] on every frame (S = 480 * 80 selected pixels,
// N + 1 = 101, cells = 8192).
//
// What bounds it on Hopper: bytes. The inputs are read once (S*K*4 + S*4
// bytes, ~15.7 MB at the flagship shape) and the output written once
// (cells*K*4, ~3.3 MB); the adds are negligible. The TPU kernel's one-hot
// MXU formulation was a workaround for a serialised scatter and is not
// carried over: Hopper resolves float atomics in L2. One thread per
// (row, lane), consecutive threads on consecutive lanes of a row, so the
// reads of w are coalesced and a warp's atomics land on one cell row. Zero
// weights (most lanes: a pixel is covered by few of the 100 masks) skip
// the atomic; adding +0.0 or -0.0 to a +0.0-initialised sum changes
// nothing, so skipping them is exact. Accumulation is f32 (the JAX default
// path's precision, not the Pallas kernel's bf16 inputs); the order of the
// atomics varies from run to run, so weight lanes carry a rounding bound
// and integer-valued lanes (the count lane) stay exact below 2^24.
// The caller zero-fills `out`.

#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ w,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out,
                                   long long rows, int lanes, int num_cells) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= rows * lanes) return;
  const long long row = i / lanes;
  const int lane = (int)(i - row * lanes);
  const int cell = __ldg(idx + row);
  const float v = __ldg(w + i);
  if (cell < 0 || cell >= num_cells || v == 0.0f) return;
  atomicAdd(out + (long long)cell * lanes + lane, v);
}

}  // namespace

extern "C" int segment_sum_launch(const void* w, const void* idx, void* out,
                                  long long rows, int lanes, int num_cells,
                                  void* stream) {
  const long long total = rows * lanes;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  segment_sum_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)w, (const int*)idx, (float*)out, rows, lanes, num_cells);
  return (int)cudaGetLastError();
}
