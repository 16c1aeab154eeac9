// Memory read: gather map cells into the egocentric frame, mean-pooled.
//     mem[c]      = bf16(features[c] / (obs[c] > 1 ? obs[c] : 1))
//     out[y, x]   = mean over the pool x pool window of f32(mem[proj[...]])
// features [B * cells, D] f32, obs [B * cells] f32, proj [B, H, W] int32
// with ids in [0, cells) (the host guard enforces it), out
// [B, H/pool, W/pool, D] f32. Frame b reads rows b * cells + id of the
// flattened table, as the JAX package's memory_read_batched offsets its
// ids; B = 1 is the eval frame's read.
//
// Replaces ops/memory_ops.py:memory_read and memory_read_batched (plain-jnp
// gathers + means that XLA lowered on the TPU). A frame of the batch runs
// the same instructions on the same values as a single read, so the
// batched read is bit-exact to B single reads. Its plain PyTorch form materialises the bf16
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
                                   int height, int width, int pool,
                                   int cells) {
  __shared__ long long ids[kMaxTaps];
  __shared__ float denom[kMaxTaps];
  const int out_w = width / pool;
  const int frame_cells = (height / pool) * out_w;
  const long long cell = blockIdx.x;                 // over all B frames
  const int b = (int)(cell / frame_cells);
  const int local = (int)(cell - (long long)b * frame_cells);
  const int oy = local / out_w;
  const int ox = local - oy * out_w;
  const int taps = pool * pool;
  const int* frame_proj = proj + (long long)b * height * width;
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    const int dy = t / pool;
    const int dx = t - dy * pool;
    const long long id = (long long)b * cells +
                         __ldg(frame_proj + (long long)(oy * pool + dy) *
                               width + ox * pool + dx);
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
          reinterpret_cast<const float4*>(features + ids[t] * dim) +
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
                                  int height, int width, int pool, int batch,
                                  int cells, void* stream) {
  if (pool <= 0 || pool * pool > kMaxTaps || dim % 4 != 0 ||
      height % pool != 0 || width % pool != 0 || batch < 0)
    return (int)cudaErrorInvalidValue;
  const long long out_cells =
      (long long)batch * (height / pool) * (width / pool);
  if (out_cells == 0 || dim == 0) return 0;
  if (out_cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int threads = dim / 4;
  if (threads > 256) threads = 256;
  threads = ((threads + 31) / 32) * 32;
  memory_read_kernel<<<(unsigned int)out_cells, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)features, (const float*)obs, (const int*)proj,
      (float*)out, dim, height, width, pool, cells);
  return (int)cudaGetLastError();
}
