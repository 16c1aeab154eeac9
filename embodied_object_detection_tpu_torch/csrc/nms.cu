// Greedy NMS over score-sorted boxes as a bitmask and a one-block sweep:
//     keep[j] = valid[j] and no kept i < j with class[i] == class[j],
//               valid[i] and IoU(i, j) > thresh
// boxes [N, 4] f32 xyxy, classes [N] int32 and valid [N] bool, all already
// in descending-score order; keep [N] bool. `disabled` (ml_nms with a
// threshold <= 0) sets no suppression bit, so keep == valid.
//
// Replaces ops/nms.py:_greedy_keep and the [N, N] IoU mask of
// ops/nms.py:_nms_core (behind nms_padded, class_aware_nms and
// multiclass_nms). The JAX package computes the greedy keep set as the
// fixpoint of Jacobi iterations over the dense mask, one device-wide
// convergence test per iteration; on the card each test is a host sync.
// Here the keep set is decided on the device with no host involvement.
//
// Kernel 1, the mask: one 64-thread block per 64 x 64 tile (rows i, cols j)
// of the upper triangle, the tile's column boxes, areas, classes and valid
// flags staged in shared memory; thread i writes one 64-bit word whose bit k
// says that row i suppresses column 64 * tile + k. Tiles below the diagonal
// write zero words. The IoU is the exact sequence of structures.pairwise_iou
// (max/min, clamp, product, area_i + area_j - inter, the union > 0 guard and
// the clamp(min=1e-12) divisor) written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn so that nvcc cannot contract any of it into an FMA: `iou > t`
// is decided per pair, and one ulp moves a pair across the threshold.
//
// Kernel 2, the sweep, one block: the removed set is ceil(N/64) words in
// shared memory. Row block b (64 rows) is decided by one thread from the
// block's removed word, its valid bits and its 64 diagonal words
// (suppression inside the block), in a branch-free chain; then every kept
// row's mask words right of the diagonal are OR-ed into the removed set,
// spread over the block's threads (word x kept-row slices, shared-memory
// atomicOr). The diagonal words of block b+1 load
// during that OR. The result is the unique greedy solution that the
// fixpoint converges to, so the keep sets are equal, not close.
//
// What bounds it on Hopper: neither bytes nor operations. The mask is
// N^2/2 IoUs (~30 MFLOP at N = 2048, well under a microsecond of f32 rate)
// and 512 KB of words; the sweep is serial over the N/64 row blocks, each a
// chain of a shared-memory decision loop, an L2 read of the kept rows' words
// and three block barriers. It is bound by that chain's latency, which the
// row-block decision (64 rows per step instead of one) and the prefetched
// diagonal shorten.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSweepThreads = 1024;

__device__ __forceinline__ float box_area(float x0, float y0, float x1,
                                          float y1) {
  return __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.0f),
                   fmaxf(__fsub_rn(y1, y0), 0.0f));
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const int* __restrict__ classes,
                                const unsigned char* __restrict__ valid,
                                int n, int words, float thresh, int disabled,
                                unsigned long long* __restrict__ mask) {
  __shared__ float cbox[kTile][4];
  __shared__ float carea[kTile];
  __shared__ int ccls[kTile];
  __shared__ int cvalid[kTile];
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  const int t = threadIdx.x;
  const int i = row_tile * kTile + t;
  if (col_tile < row_tile) {
    if (i < n) mask[(long long)i * words + col_tile] = 0ull;
    return;
  }
  const int j = col_tile * kTile + t;
  if (j < n) {
    const float* b = boxes + 4LL * j;
    cbox[t][0] = b[0];
    cbox[t][1] = b[1];
    cbox[t][2] = b[2];
    cbox[t][3] = b[3];
    carea[t] = box_area(b[0], b[1], b[2], b[3]);
    ccls[t] = classes[j];
    cvalid[t] = valid[j];
  }
  __syncthreads();
  if (i >= n) return;
  unsigned long long bits = 0ull;
  if (!disabled && valid[i]) {
    const float* a = boxes + 4LL * i;
    const float ax0 = a[0], ay0 = a[1], ax1 = a[2], ay1 = a[3];
    const float area_i = box_area(ax0, ay0, ax1, ay1);
    const int cls = classes[i];
    const int cols = min(kTile, n - col_tile * kTile);
    const int start = col_tile == row_tile ? t + 1 : 0;
    for (int k = start; k < cols; ++k) {
      if (!cvalid[k] || ccls[k] != cls) continue;
      const float w = fmaxf(__fsub_rn(fminf(ax1, cbox[k][2]),
                                      fmaxf(ax0, cbox[k][0])), 0.0f);
      const float h = fmaxf(__fsub_rn(fminf(ay1, cbox[k][3]),
                                      fmaxf(ay0, cbox[k][1])), 0.0f);
      const float inter = __fmul_rn(w, h);
      const float uni = __fsub_rn(__fadd_rn(area_i, carea[k]), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f))
                                   : 0.0f;
      if (iou > thresh) bits |= 1ull << k;
    }
  }
  mask[(long long)i * words + col_tile] = bits;
}

// valid flags of rows row0 .. row0+63 as a 64-bit word; threads 0..63 call
__device__ __forceinline__ void load_valid_bits(
    const unsigned char* __restrict__ valid, int row0, int n,
    unsigned int* half) {
  const int t = threadIdx.x;
  const unsigned int bits =
      __ballot_sync(0xffffffffu, row0 + t < n && valid[row0 + t]);
  if ((t & 31) == 0) half[t >> 5] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const unsigned char* __restrict__ valid,
                                 int n, int words, bool* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];   // [words]
  __shared__ unsigned long long diag[2][kTile];
  __shared__ unsigned int vhalf[2][2];
  __shared__ unsigned long long kept_bits;
  const int t = threadIdx.x;
  for (int w = t; w < words; w += blockDim.x) removed[w] = 0ull;
  if (t < kTile) {
    diag[0][t] = t < n ? mask[(long long)t * words] : 0ull;
    load_valid_bits(valid, 0, n, vhalf[0]);
  }
  __syncthreads();
  for (int b = 0; b < words; ++b) {
    const int buf = b & 1;
    const int row0 = b * kTile;
    const int rows = min(kTile, n - row0);
    if (t == 0) {
      // rows in order: kept iff valid and not removed by a kept row above;
      // branch-free, so the diagonal words load ahead of the chain
      const unsigned long long vb =
          ((unsigned long long)vhalf[buf][1] << 32) | vhalf[buf][0];
      unsigned long long cur = removed[b];
      unsigned long long kb = 0ull;
#pragma unroll 16
      for (int r = 0; r < kTile; ++r) {
        const unsigned long long d = diag[buf][r];
        const unsigned long long k = ((vb & ~cur) >> r) & 1ull;
        kb |= k << r;
        cur |= d & (0ull - k);
      }
      kept_bits = kb;
    }
    __syncthreads();
    const unsigned long long kb = kept_bits;
    if (t < rows) keep[row0 + t] = (kb >> t) & 1ull;
    // prefetch the next row block's diagonal words and valid flags
    if (b + 1 < words && t < kTile) {
      const int r = row0 + kTile + t;
      diag[buf ^ 1][t] = r < n ? mask[(long long)r * words + b + 1] : 0ull;
      load_valid_bits(valid, row0 + kTile, n, vhalf[buf ^ 1]);
    }
    // OR the kept rows' words right of the diagonal into the removed set:
    // thread -> (word b+1 + t % later, rows r == t / later mod parts)
    const int later = words - b - 1;
    if (kb != 0ull && later > 0) {
      const int parts = max(1, (int)blockDim.x / later);
      if (t < parts * later) {
        const int w = b + 1 + t % later;
        unsigned long long acc = 0ull;
        for (int r = t / later; r < rows; r += parts)
          if ((kb >> r) & 1ull)
            acc |= __ldg(mask + (long long)(row0 + r) * words + w);
        if (acc) atomicOr(&removed[w], acc);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int nms_launch(const void* boxes, const void* classes,
                          const void* valid, void* mask, void* keep, int n,
                          float thresh, int disabled, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  const size_t removed_bytes = (size_t)words * sizeof(unsigned long long);
  if (removed_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3(words, words), kTile, 0, s>>>(
      (const float*)boxes, (const int*)classes, (const unsigned char*)valid,
      n, words, thresh, disabled, (unsigned long long*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<1, kSweepThreads, removed_bytes, s>>>(
      (const unsigned long long*)mask, (const unsigned char*)valid, n, words,
      (bool*)keep);
  return (int)cudaGetLastError();
}
