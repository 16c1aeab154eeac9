// Memory read: gather map cells into the egocentric frame, mean-pooled.
//     mem[c]      = bf16(features[c] / (obs[c] > 1 ? obs[c] : 1))
//     out[y, x]   = mean over the pool x pool window of f32(mem[proj[...]])
// features [cells, D] f32, obs [cells] f32, proj [H, W] int32 with ids in
// [0, cells) (the host guard enforces it), out [H/pool, W/pool, D] f32.
//
// Replaces ops/memory_ops.py:memory_read (a plain-jnp gather + mean that
// XLA lowered on the TPU). Its plain PyTorch form materialises the bf16
// table and a [H*W/16, 16, D] bf16 gather (~315 MB at 480x640, D = 512)
// only to average it. Here the normalise and the bf16 round are fused into
// the gather: each tap reads the f32 row, divides, rounds with
// __float2bfloat16_rn (where JAX rounds), widens and accumulates in f32,
// so neither the bf16 table nor the transient is ever written.
//
// What bounds it on Hopper: bytes. Device memory sees the f32 table once
// (16.8 MB, which stays resident in the 50 MB L2 for the 16 re-reads of
// every row), proj (1.2 MB) and the output (39.3 MB): ~57 MB. One block
// per output cell; its pool*pool ids and denominators are staged in
// shared memory, and each thread owns 4 consecutive channels read as one
// float4, so a warp reads 512 contiguous bytes of a row per tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void memory_read_kernel(const float* __restrict__ features,
                                   const float* __restrict__ obs,
                                   const int* __restrict__ proj,
                                   float* __restrict__ out, int dim,
                                   int width, int pool) {
  __shared__ int ids[kMaxTaps];
  __shared__ float denom[kMaxTaps];
  const int out_w = width / pool;
  const int cell = blockIdx.x;
  const int oy = cell / out_w;
  const int ox = cell - oy * out_w;
  const int taps = pool * pool;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    const int dy = t / pool;
    const int dx = t - dy * pool;
    const int id = __ldg(proj + (long long)(oy * pool + dy) * width +
                         ox * pool + dx);
    const float o = __ldg(obs + id);
    ids[t] = id;
    denom[t] = o > 1.0f ? o : 1.0f;
  }
  __syncthreads();

  const int vec = dim / 4;
  const float n = (float)taps;
  float4* out4 = reinterpret_cast<float4*>(out + (long long)cell * dim);
  for (int c = threadIdx.x; c < vec; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < taps; ++t) {
      const float4 v = __ldg(
          reinterpret_cast<const float4*>(features + (long long)ids[t] * dim) +
          c);
      const float d = denom[t];
      acc.x += round_bf16(v.x / d);
      acc.y += round_bf16(v.y / d);
      acc.z += round_bf16(v.z / d);
      acc.w += round_bf16(v.w / d);
    }
    out4[c] = make_float4(acc.x / n, acc.y / n, acc.z / n, acc.w / n);
  }
}

}  // namespace

extern "C" int memory_read_launch(const void* features, const void* obs,
                                  const void* proj, void* out, int dim,
                                  int height, int width, int pool,
                                  void* stream) {
  if (pool <= 0 || pool * pool > kMaxTaps || dim % 4 != 0 ||
      height % pool != 0 || width % pool != 0)
    return (int)cudaErrorInvalidValue;
  const int out_cells = (height / pool) * (width / pool);
  if (out_cells == 0 || dim == 0) return 0;
  int threads = dim / 4;
  if (threads > 256) threads = 256;
  threads = ((threads + 31) / 32) * 32;
  memory_read_kernel<<<out_cells, threads, 0, (cudaStream_t)stream>>>(
      (const float*)features, (const float*)obs, (const int*)proj,
      (float*)out, dim, width, pool);
  return (int)cudaGetLastError();
}
