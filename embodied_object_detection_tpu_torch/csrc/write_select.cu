// The exact memory write's pixel selection (row scan and compaction):
//     observed[y, x] = any_n(masks[y, x, n] && valid[n])
//     rank           = the pixel's index in the row-major compacted set of
//                      observed pixels
//     selected       = the pixels with rank % s == 0
// For image row y, with row_start = the observed pixels of the rows above
// and t0 = (-row_start) mod s, slot j of the row holds the row's observed
// pixel of local rank t0 + s * j, if the row has that many. Outputs, J =
// ceil(W / s) slots a row:
//     seg_idx[y * J + j]      = proj[y, x] of the slot's pixel, -1 if empty
//     aug[y * J + j, n < N]   = (masks[y, x, n] && valid[n]) / c, where c
//                               counts the pixel's covering valid masks
//     aug[y * J + j, N]       = 1 for a filled slot; empty slots are zeros
// masks [H, W, N] bool (pixel-major), valid [N] bool, proj [H, W] int32.
// The rows feed the segment-sum kernel (segment_sum.cu) as they are.
//
// Replaces the exact path of ops/memory_ops.py:memory_write (:188-223): a
// per-row cumsum, an exclusive cumsum over the row counts and one-hot
// matmuls that XLA lowered on the TPU (on the card, about 15 PyTorch ops
// a frame: two cumsums, a searchsorted and a [H, J, N] gather). Every sum
// there has at most one nonzero term and m / c is one division, so the
// kernel is bit-exact to the plain version and to JAX.
//
// What bounds it on Hopper: bytes. The masks are read once in full by the
// first pass (H * W * N bytes, 30.7 MB at 480 x 640 x 100), then only the
// selected pixels' rows again; aug is written once (15.5 MB at J = 80,
// N = 100). Two launches, because the row start is a scan across rows:
//   1. one block per row: each thread decides the observed flag of a
//      pixel (32-bit word loads of its mask bytes when N % 4 == 0) into a
//      [H, W] byte map, and the block counts its row;
//   2. one block per row: the block sums the counts of the rows above
//      (at most H ints), scans its row's flags (a contiguous run of
//      columns a thread, then a block scan of the runs), records the
//      column of each filled slot in shared memory, and writes seg_idx
//      and the [J, N + 1] aug rows with consecutive threads on
//      consecutive floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kWords>
__global__ void observed_kernel(const unsigned char* __restrict__ masks,
                                const unsigned char* __restrict__ valid,
                                unsigned char* __restrict__ observed,
                                int* __restrict__ row_count, int width,
                                int n) {
  extern __shared__ unsigned char valid_s[];
  for (int k = threadIdx.x; k < n; k += blockDim.x) valid_s[k] = valid[k];
  __syncthreads();
  const int y = blockIdx.x;
  int total = 0;
  for (int base = 0; base < width; base += blockDim.x) {
    const int x = base + threadIdx.x;
    int flag = 0;
    if (x < width) {
      const unsigned char* px = masks + ((long long)y * width + x) * n;
      if (kWords) {
        const uint32_t* pw = reinterpret_cast<const uint32_t*>(px);
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(valid_s);
        for (int k = 0; k < n / 4; ++k) {
          if (__ldg(pw + k) & vw[k]) {
            flag = 1;
            break;
          }
        }
      } else {
        for (int k = 0; k < n; ++k) {
          if (__ldg(px + k) && valid_s[k]) {
            flag = 1;
            break;
          }
        }
      }
      observed[(long long)y * width + x] = (unsigned char)flag;
    }
    total += __syncthreads_count(flag);
  }
  if (threadIdx.x == 0) row_count[y] = total;
}

__device__ int block_sum(int v, int* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__global__ void select_kernel(const unsigned char* __restrict__ masks,
                              const unsigned char* __restrict__ valid,
                              const int* __restrict__ proj,
                              const unsigned char* __restrict__ observed,
                              const int* __restrict__ row_count,
                              int* __restrict__ seg_idx,
                              float* __restrict__ aug, int width, int n,
                              int s, int slots) {
  extern __shared__ int shared[];
  int* slot_col = shared;                       // [slots]
  int* slot_cnt = shared + slots;               // [slots]
  unsigned char* valid_s =
      reinterpret_cast<unsigned char*>(shared + 2 * slots);   // [n]
  __shared__ int scan[kThreads];
  __shared__ int scratch[kThreads / 32];
  const int y = blockIdx.x;
  const int tid = threadIdx.x;

  for (int k = tid; k < n; k += blockDim.x) valid_s[k] = valid[k];
  for (int j = tid; j < slots; j += blockDim.x) slot_col[j] = -1;

  // the observed pixels of the rows above: the row start
  int above = 0;
  for (int q = tid; q < y; q += blockDim.x) above += row_count[q];
  const int row_start = block_sum(above, scratch);
  const int t0 = ((-row_start) % s + s) % s;

  // each thread owns a contiguous run of columns; a block scan of the
  // runs' counts gives each run its first rank
  const int run = (width + blockDim.x - 1) / blockDim.x;
  const int x0 = min(tid * run, width);
  const int x1 = min(x0 + run, width);
  const unsigned char* row_obs = observed + (long long)y * width;
  int mine = 0;
  for (int x = x0; x < x1; ++x) mine += row_obs[x];
  scan[tid] = mine;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const int add = tid >= off ? scan[tid - off] : 0;
    __syncthreads();
    scan[tid] += add;
    __syncthreads();
  }
  int rank = scan[tid] - mine;                  // exclusive
  for (int x = x0; x < x1; ++x) {
    if (row_obs[x]) {
      const int k = rank - t0;
      if (k >= 0 && k % s == 0 && k / s < slots) slot_col[k / s] = x;
      ++rank;
    }
  }
  __syncthreads();

  // per slot: the covering count and the cell id
  const unsigned char* row_masks = masks + (long long)y * width * n;
  for (int j = tid; j < slots; j += blockDim.x) {
    const int x = slot_col[j];
    int c = 0;
    int id = -1;
    if (x >= 0) {
      const unsigned char* px = row_masks + (long long)x * n;
      for (int k = 0; k < n; ++k) c += (px[k] && valid_s[k]) ? 1 : 0;
      id = proj[(long long)y * width + x];
    }
    slot_cnt[j] = c;
    seg_idx[(long long)y * slots + j] = id;
  }
  __syncthreads();

  // the row's [slots, n + 1] weights, consecutive threads on consecutive
  // floats
  const int lanes = n + 1;
  float* row_aug = aug + (long long)y * slots * lanes;
  for (int e = tid; e < slots * lanes; e += blockDim.x) {
    const int j = e / lanes;
    const int lane = e - j * lanes;
    const int x = slot_col[j];
    float v = 0.0f;
    if (x >= 0) {
      if (lane == n) {
        v = 1.0f;
      } else if (row_masks[(long long)x * n + lane] && valid_s[lane]) {
        v = __fdiv_rn(1.0f, (float)slot_cnt[j]);
      }
    }
    row_aug[e] = v;
  }
}

}  // namespace

// observed [H, W] uint8 and row_count [H] int32 are scratch buffers.
extern "C" int write_select_launch(const void* masks, const void* valid,
                                   const void* proj, void* observed,
                                   void* row_count, void* seg_idx, void* aug,
                                   int height, int width, int n,
                                   int subsample, void* stream) {
  if (height < 0 || width < 0 || n < 0 || subsample < 1 || n > 16384)
    return (int)cudaErrorInvalidValue;
  if (height == 0 || width == 0) return 0;
  const int slots = (width + subsample - 1) / subsample;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t valid_bytes = ((size_t)n + 3) / 4 * 4;
  const bool words = n % 4 == 0 && ((uintptr_t)masks % 4) == 0;
  if (words)
    observed_kernel<true><<<height, kThreads, valid_bytes, st>>>(
        (const unsigned char*)masks, (const unsigned char*)valid,
        (unsigned char*)observed, (int*)row_count, width, n);
  else
    observed_kernel<false><<<height, kThreads, valid_bytes, st>>>(
        (const unsigned char*)masks, (const unsigned char*)valid,
        (unsigned char*)observed, (int*)row_count, width, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t shared = 2 * (size_t)slots * sizeof(int) + valid_bytes;
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  select_kernel<<<height, kThreads, shared, st>>>(
      (const unsigned char*)masks, (const unsigned char*)valid,
      (const int*)proj, (const unsigned char*)observed,
      (const int*)row_count, (int*)seg_idx, (float*)aug, width, n,
      subsample, slots);
  return (int)cudaGetLastError();
}
