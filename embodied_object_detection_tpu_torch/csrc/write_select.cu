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
// What bounds it on Hopper: bytes. On the frame's path the flags and
// counts come from the mask paste (csrc/mask_paste.cu writes observed[y,
// x] and one count per (row, 32-column tile) as it stores the masks, so
// the 30.7 MB of masks at 480 x 640 x 100 are not read again to find
// them), and this kernel reads only the flags (0.3 MB), the counts, the
// selected pixels' mask rows (~3.8 MB) and ids, and writes aug once (15.5
// MB at J = 80, N = 100). The counts are per (row, column tile) so that
// nobody zeroes them: the paste writes each one, and the select pass sums
// a row's K of them (K = 1 when pass 1 below made them).
//   select pass, one block per row: the block sums the counts of the rows
//     above (y K contiguous ints, 16-byte loads), ballots its row's flags
//     into 32-bit words, one warp scans their popcounts, and each observed
//     pixel's rank picks its slot; the selected pixels' mask rows are
//     staged in shared memory with all their loads in flight at once (a
//     block that loads them one slot after another waits out one L2
//     latency per load), a warp per slot counts the pixel's covering valid
//     masks with ballots over N, and the block writes seg_idx and the
//     [J, N + 1] aug rows with consecutive threads on consecutive floats.
//   pass 1, for callers with only the masks (the two-pass entry): one
//     block per row decides each pixel's flag (32-bit word loads of its
//     mask bytes when N % 4 == 0) into the [H, W] map and counts its row
//     (K = 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 16384;     // staged mask rows of selected pixels

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
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// counts: [H, count_cols] ints whose row y sums to row y's observed pixels
__global__ void __launch_bounds__(kThreads)
select_kernel(const unsigned char* __restrict__ masks,
              const unsigned char* __restrict__ valid,
              const int* __restrict__ proj,
              const unsigned char* __restrict__ observed,
              const int* __restrict__ counts, int* __restrict__ seg_idx,
              float* __restrict__ aug, int width, int n, int s, int slots,
              int count_cols) {
  extern __shared__ int shared[];
  const int words = (width + 31) / 32;
  int* slot_col = shared;                       // [slots]
  int* slot_id = slot_col + slots;              // [slots]
  unsigned int* flags =
      reinterpret_cast<unsigned int*>(slot_id + slots);      // [words]
  int* rank0 = reinterpret_cast<int*>(flags + words);        // [words]
  unsigned char* valid_s =
      reinterpret_cast<unsigned char*>(rank0 + words);       // [n_pad]
  __shared__ int scratch[kWarps];
  __shared__ __align__(16) unsigned char rows_s[kRowBytes];  // mask rows
  const int y = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_pad = (n + 3) / 4 * 4;            // a staged row's bytes
  const bool row_words = n % 4 == 0 && ((uintptr_t)masks & 3) == 0;

  for (int k = tid; k < n_pad; k += kThreads)
    valid_s[k] = k < n ? valid[k] : 0;
  for (int j = tid; j < slots; j += kThreads) slot_col[j] = -1;

  // the observed pixels of the rows above: the row start (the loads of
  // a thread are independent: unrolled, they are in flight together)
  const long long above_n = (long long)y * count_cols;
  int above = 0;
  if (((uintptr_t)counts & 15) == 0) {
    const int4* c4 = reinterpret_cast<const int4*>(counts);
#pragma unroll 4
    for (long long q = tid; q < above_n / 4; q += kThreads) {
      const int4 v = __ldg(c4 + q);
      above += v.x + v.y + v.z + v.w;
    }
    for (long long q = above_n / 4 * 4 + tid; q < above_n; q += kThreads)
      above += __ldg(counts + q);
  } else {
#pragma unroll 4
    for (long long q = tid; q < above_n; q += kThreads)
      above += __ldg(counts + q);
  }
  const int row_start = block_sum(above, scratch);
  const int t0 = ((-row_start) % s + s) % s;

  // the row's flags as 32-bit words, then each word's first rank
  const unsigned char* row_obs = observed + (long long)y * width;
#pragma unroll 4
  for (int base = 0; base < width; base += kThreads) {
    const int x = base + tid;
    const unsigned int bits =
        __ballot_sync(0xffffffffu, x < width && row_obs[x] != 0);
    if (lane == 0 && x < width) flags[x / 32] = bits;
  }
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int c = w0 + lane < words ? __popc(flags[w0 + lane]) : 0;
      int incl = c;
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      if (w0 + lane < words) rank0[w0 + lane] = run + incl - c;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  // the slot of each observed pixel whose rank is t0 + s j
  for (int x = tid; x < width; x += kThreads) {
    const unsigned int bits = flags[x / 32];
    if ((bits >> (x % 32)) & 1u) {
      const int k = rank0[x / 32] +
                    __popc(bits & ((1u << (x % 32)) - 1u)) - t0;
      if (k >= 0 && k % s == 0 && k / s < slots) slot_col[k / s] = x;
    }
  }
  __syncthreads();

  // the slots' cell ids and the selected pixels' mask rows, staged
  // kRowBytes at a time (all the row's slots at once at N = 100): every
  // load of the chunk in flight together, then the slots' rows from
  // shared memory
  for (int j = tid; j < slots; j += kThreads) {
    const int x = slot_col[j];
    slot_id[j] = x >= 0 ? __ldg(proj + (long long)y * width + x) : -1;
  }
  const unsigned char* row_masks = masks + (long long)y * width * n;
  const int lanes = n + 1;
  float* row_aug = aug + (long long)y * slots * lanes;
  const int per_chunk = n_pad > 0 ? kRowBytes / n_pad : slots;
  for (int j0 = 0; j0 < slots; j0 += per_chunk) {
    const int js = min(per_chunk, slots - j0);
    if (row_words) {
      const int wpr = n / 4;                    // words a row
#pragma unroll 4
      for (int e = tid; e < js * wpr; e += kThreads) {
        const int j = e / wpr;
        const int x = slot_col[j0 + j];
        if (x >= 0)
          reinterpret_cast<uint32_t*>(rows_s)[e] = __ldg(
              reinterpret_cast<const uint32_t*>(row_masks +
                                                (long long)x * n) +
              e - j * wpr);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < js * n; e += kThreads) {
        const int j = e / n;
        const int x = slot_col[j0 + j];
        if (x >= 0)
          rows_s[j * n_pad + e - j * n] =
              __ldg(row_masks + (long long)x * n + e - j * n);
      }
    }
    __syncthreads();
    // a warp a slot: its covering count from ballots over the N masks,
    // 1 / c once, then its row of n + 1 weights, 32 consecutive floats a
    // store, and its cell id
    for (int j = warp; j < js; j += kWarps) {
      const int x = slot_col[j0 + j];
      const unsigned char* px = rows_s + j * n_pad;
      int c = 0;
      if (x >= 0)
        for (int k0 = 0; k0 < n; k0 += 32) {
          const int k = k0 + lane;
          c += __popc(__ballot_sync(0xffffffffu,
                                    k < n && px[k] != 0 && valid_s[k] != 0));
        }
      const float inv = x >= 0 && c > 0 ? __fdiv_rn(1.0f, (float)c) : 0.0f;
      float* dst = row_aug + (long long)(j0 + j) * lanes;
      for (int ln = lane; ln < lanes; ln += 32) {
        float v = 0.0f;
        if (x >= 0)
          v = ln == n ? 1.0f : (px[ln] && valid_s[ln] ? inv : 0.0f);
        dst[ln] = v;
      }
      if (lane == 0) seg_idx[(long long)y * slots + j0 + j] = slot_id[j0 + j];
    }
    __syncthreads();            // the next chunk restages rows_s
  }
}

}  // namespace

// observed [H, W] bytes (0/1) and counts [H, count_cols] int32: the flags
// and counts when flags_given (the mask paste's), else scratch that pass 1
// fills (count_cols must then be 1).
extern "C" int write_select_launch(const void* masks, const void* valid,
                                   const void* proj, void* observed,
                                   void* counts, void* seg_idx, void* aug,
                                   int height, int width, int n,
                                   int subsample, int count_cols,
                                   int flags_given, void* stream) {
  if (height < 0 || width < 0 || n < 0 || subsample < 1 || n > 16384 ||
      count_cols < 1 || (!flags_given && count_cols != 1))
    return (int)cudaErrorInvalidValue;
  if (height == 0 || width == 0) return 0;
  const int slots = (width + subsample - 1) / subsample;
  const int words = (width + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t valid_bytes = ((size_t)n + 3) / 4 * 4;
  const size_t shared = (2 * (size_t)slots + 2 * (size_t)words) * sizeof(int) +
                        valid_bytes;
  if (shared + kRowBytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (!flags_given) {
    const bool word_loads = n % 4 == 0 && ((uintptr_t)masks % 4) == 0;
    if (word_loads)
      observed_kernel<true><<<height, kThreads, valid_bytes, st>>>(
          (const unsigned char*)masks, (const unsigned char*)valid,
          (unsigned char*)observed, (int*)counts, width, n);
    else
      observed_kernel<false><<<height, kThreads, valid_bytes, st>>>(
          (const unsigned char*)masks, (const unsigned char*)valid,
          (unsigned char*)observed, (int*)counts, width, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  select_kernel<<<height, kThreads, shared, st>>>(
      (const unsigned char*)masks, (const unsigned char*)valid,
      (const int*)proj, (const unsigned char*)observed,
      (const int*)counts, (int*)seg_idx, (float*)aug, width, n, subsample,
      slots, count_cols);
  return (int)cudaGetLastError();
}
