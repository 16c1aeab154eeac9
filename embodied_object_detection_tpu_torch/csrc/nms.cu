// Greedy NMS over score-sorted boxes:
//     keep[j] = valid[j] and no kept i < j with class[i] == class[j],
//               valid[i] and IoU(i, j) > thresh
// boxes [N, 4] f32 xyxy, classes [N] int32 and valid [N] bool, all already
// in descending-score order; keep [N] bool. `disabled` (ml_nms with a
// threshold <= 0) builds no mask and runs no sweep: keep == valid.
//
// Replaces ops/nms.py:_greedy_keep and the [N, N] IoU mask of
// ops/nms.py:_nms_core (behind nms_padded, class_aware_nms and
// multiclass_nms). The JAX package computes the greedy keep set as the
// fixpoint of Jacobi iterations over the dense mask, one device-wide
// convergence test per iteration; on the card each test is a host sync.
// Here the keep set is decided on the device with no host involvement.
//
// Greedy NMS gated by class is the union, over classes, of each class's
// greedy keep set on its own score-ordered candidates, so the work splits
// by class. Three kernels:
//
// 1. The partition, one block: a stable counting sort of the valid
//    candidates by class (kBins class bins from the smallest valid class;
//    each warp counts its contiguous slice with __match_any_sync, a scan
//    over bins and warps gives every (warp, bin) its offset, the warps
//    scatter by rank), invalid candidates last. Within a class the score
//    order is kept. Each class is one segment of consecutive positions.
//    Valid classes spanning more than kBins values make one segment in
//    score order, and the per-pair class test below keeps that exact.
// 2. The mask, one block per 64 x 64 tile of the partitioned upper
//    triangle. A tile whose first column's segment lies after its last
//    row's segment holds no same-class pair and returns at once, as does
//    every tile below the diagonal: nothing is written there, and the sweep
//    reads no such word. Four threads a row each loop over a quarter of the
//    columns of the row's own segment in the tile (a contiguous range);
//    the row's 64-bit word, whose bit k says it suppresses column 64 *
//    tile + k, is OR-ed over the four by __shfl_xor_sync. A tile right of
//    the diagonal also marks its rows with a nonzero word in the row
//    block's later-rows word. The IoU is the exact sequence of
//    structures.pairwise_iou (max/min, clamp, product, area_i + area_j -
//    inter, the union > 0 guard and the clamp(min=1e-12) divisor) written
//    with __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn so that nvcc cannot
//    contract any of it into an FMA: `iou > t` is decided per pair, and one
//    ulp moves a pair across the threshold. (A pair that does not intersect
//    skips the division: 0 / x is +0 for the positive x there.)
// 3. The sweep, one block a segment, all segments at once; one warp
//    decides. A segment of at most 32 words (2048 rows): lane l owns word
//    b0 + l of the removed set, in a register. The block's four warps first
//    copy into shared memory with cp.async, all in flight at once, each
//    row's diagonal word and candidate index, and the later words of the
//    segment's flagged rows (a nonzero later word; the first kFlagged).
//    Then for each 64-row block (rows outside the segment masked off)
//    every lane of warp 0 makes the decision from the block's removed word
//    (one __shfl_sync from its owner) and the rows' diagonal words
//    (__shfl_sync; no barrier in the chain): over only the rows that
//    suppress something inside the block when there are at most
//    kSparseRows of them, else over all 64 in a chain by 32-bit halves.
//    Each lane then ORs its word of the kept flagged rows into the removed
//    set. A larger segment is swept the same way by one warp holding
//    kLaneWords words a lane, every word read from L2 when needed. The
//    result is the unique greedy solution that the fixpoint converges to,
//    so the keep sets are equal, not close.
//
// What bounds it on Hopper: neither bytes nor operations. The mask is the
// same-class pairs' IoUs (~2 MFLOP at 2048 candidates of 20 classes) and
// at most N^2/8 bytes of words; the sweep of a segment is serial over its
// row blocks. One warp exposes the latency of every instruction and of
// every global round trip, so the design cuts both: the copies into
// shared memory are issued together and waited for once, and a block's
// decision touches only the rows that suppress inside it and the kept
// rows that suppress later. What is left is that chain, the single-block partition,
// and three launches; the class partition runs the segments in parallel
// on as many SMs.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kBins = 256;                 // class bins of the partition
constexpr int kPartThreads = 1024;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kScanWarps = (kBins + 1 + 31) / 32;   // warps over the bins
constexpr int kCachedChunks = 4;           // a lane's candidates in registers
constexpr int kStagedRows = 2048;          // a scatter staged in shared memory
constexpr int kLaneWords = 8;              // removed-set words a lane holds
constexpr int kMaxRows = 32 * kLaneWords * kTile;   // 16384 candidates
constexpr int kMaskThreads = 4 * kTile;    // four threads a mask row
constexpr int kSparseRows = 16;
constexpr int kInvalidSeg = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float x0, float y0, float x1,
                                          float y1) {
  return __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.0f),
                   fmaxf(__fsub_rn(y1, y0), 0.0f));
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// a lane's candidate of one 32-candidate chunk of its warp's slice
struct Cand {
  int cls;
  bool valid, in_slice;
};

__device__ __forceinline__ Cand load_cand(const int* __restrict__ classes,
                                          const unsigned char* __restrict__ valid,
                                          int i, int end) {
  Cand c = {0, false, i < end};
  if (c.in_slice) {
    c.valid = valid[i] != 0;
    c.cls = classes[i];
  }
  return c;
}

// its class bin: kBins for an invalid one, -1 - lane past the slice (a
// key of its own, so __match_any_sync groups it with nothing)
__device__ __forceinline__ int bin_of(const Cand& c, int lo, bool binned) {
  if (!c.in_slice) return -1 - (int)(threadIdx.x & 31);
  if (!c.valid) return kBins;
  return binned ? c.cls - lo : 0;
}

// one block. Each warp takes a contiguous slice of the candidates, 32 at a
// time; a lane keeps its first kCachedChunks candidates in registers
// between the three passes (range, counts, scatter) and loads the others
// again in each. With at most kStagedRows candidates the scatter goes to
// shared memory and the order is written out in one coalesced pass (with
// many classes the ranks scatter, and a store a candidate from one block
// is slow).
__global__ void __launch_bounds__(kPartThreads) nms_partition_kernel(
    const int* __restrict__ classes, const unsigned char* __restrict__ valid,
    int n, int* __restrict__ perm, int* __restrict__ pos_seg,
    int* __restrict__ seg_bounds, int* __restrict__ num_segs,
    unsigned long long* __restrict__ later_rows, int words,
    bool* __restrict__ keep) {
  // counts, then each (warp, bin) offset: below 2^16, as n is
  __shared__ unsigned short cnt[kPartWarps][kBins + 1];
  __shared__ int staged_perm[kStagedRows];
  __shared__ int staged_seg[kStagedRows];
  __shared__ int seg_of_bin[kBins + 1];
  __shared__ int red_lo[kPartWarps], red_hi[kPartWarps];
  __shared__ int scan_total[kScanWarps], scan_segs[kScanWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n + kPartWarps - 1) / kPartWarps;
  const int begin = warp * per;
  const int end = min(n, begin + per);

  // the class range of the valid candidates
  Cand cached[kCachedChunks];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int c = 0; c < kCachedChunks; ++c) {
    cached[c] = load_cand(classes, valid, begin + 32 * c + lane, end);
    if (cached[c].valid) {
      lo = min(lo, cached[c].cls);
      hi = max(hi, cached[c].cls);
    }
  }
  for (int base = begin + 32 * kCachedChunks; base < end; base += 32) {
    const Cand c = load_cand(classes, valid, base + lane, end);
    if (c.valid) {
      lo = min(lo, c.cls);
      hi = max(hi, c.cls);
    }
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  for (int e = t; e < kPartWarps * (kBins + 1); e += kPartThreads)
    (&cnt[0][0])[e] = 0;
  for (int e = t; e < words; e += kPartThreads) later_rows[e] = 0ull;
  __syncthreads();
  lo = warp_min(red_lo[lane]);
  hi = warp_max(red_hi[lane]);
  const bool binned = lo <= hi && (long long)hi - lo < kBins;

  // each warp counts its slice, 32 candidates at a time
  auto count = [&](const Cand& c) {
    const int bin = bin_of(c, lo, binned);
    const unsigned grp = __match_any_sync(kFull, bin);
    if (bin >= 0 && lane == 31 - __clz(grp)) cnt[warp][bin] += __popc(grp);
    __syncwarp();
  };
#pragma unroll
  for (int c = 0; c < kCachedChunks; ++c)
    if (begin + 32 * c < end) count(cached[c]);
  for (int base = begin + 32 * kCachedChunks; base < end; base += 32)
    count(load_cand(classes, valid, base + lane, end));
  __syncthreads();
  // bins in order, then warps in order: the exclusive offsets, and each
  // non-empty class bin's segment index (warp-uniform branches only)
  int total = 0, segs = 0, inc_total = 0, inc_segs = 0;
  int counts[kPartWarps];
  if (warp < kScanWarps) {
#pragma unroll
    for (int w = 0; w < kPartWarps; ++w) {
      counts[w] = t <= kBins ? cnt[w][t] : 0;
      total += counts[w];
    }
    segs = t < kBins && total > 0;
    inc_total = total;
    inc_segs = segs;
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFull, inc_total, o);
      const int b = __shfl_up_sync(kFull, inc_segs, o);
      if (lane >= o) {
        inc_total += a;
        inc_segs += b;
      }
    }
    if (lane == 31) {
      scan_total[warp] = inc_total;
      scan_segs[warp] = inc_segs;
    }
  }
  __syncthreads();
  if (t <= kBins) {
    int start = inc_total - total, seg = inc_segs - segs;
    for (int w = 0; w < warp; ++w) {
      start += scan_total[w];
      seg += scan_segs[w];
    }
#pragma unroll
    for (int w = 0; w < kPartWarps; ++w) {
      cnt[w][t] = start;
      start += counts[w];
    }
    start -= total;
    if (segs) {
      seg_of_bin[t] = seg;
      seg_bounds[seg] = start;
    }
    if (t == kBins) {         // the invalid bin: past the last segment
      seg_of_bin[t] = kInvalidSeg;
      seg_bounds[seg] = start;
      *num_segs = seg;
    }
  }
  __syncthreads();

  // the stable scatter: rank = the (warp, bin) offset + earlier lanes
  const bool staged = n <= kStagedRows;
  auto scatter = [&](const Cand& c, int i) {
    const int bin = bin_of(c, lo, binned);
    const unsigned grp = __match_any_sync(kFull, bin);
    const int rank = bin >= 0
        ? cnt[warp][bin] + __popc(grp & ((1u << lane) - 1u)) : 0;
    __syncwarp();
    if (bin >= 0 && lane == 31 - __clz(grp)) cnt[warp][bin] += __popc(grp);
    __syncwarp();
    if (bin >= 0) {
      if (staged) {
        staged_perm[rank] = i;
        staged_seg[rank] = seg_of_bin[bin];
      } else {
        perm[rank] = i;
        pos_seg[rank] = seg_of_bin[bin];
      }
      keep[i] = false;
    }
  };
#pragma unroll
  for (int c = 0; c < kCachedChunks; ++c)
    if (begin + 32 * c < end) scatter(cached[c], begin + 32 * c + lane);
  for (int base = begin + 32 * kCachedChunks; base < end; base += 32)
    scatter(load_cand(classes, valid, base + lane, end), base + lane);
  if (staged) {
    __syncthreads();
    for (int p = t; p < n; p += kPartThreads) {
      perm[p] = staged_perm[p];
      pos_seg[p] = staged_seg[p];
    }
  }
}

// one 256-thread block per tile: four threads a row, 16 columns each
__global__ void __launch_bounds__(kMaskThreads) nms_mask_kernel(
    const float* __restrict__ boxes, const int* __restrict__ classes,
    const int* __restrict__ perm, const int* __restrict__ pos_seg,
    const int* __restrict__ seg_bounds, int n, int words, float thresh,
    unsigned long long* __restrict__ mask,
    unsigned long long* __restrict__ later_rows) {
  __shared__ float cbox[kTile][4];
  __shared__ float carea[kTile];
  __shared__ int ccls[kTile];
  __shared__ unsigned long long tile_rows;
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;             // below the diagonal
  const int col0 = col_tile * kTile;
  const int first_seg = pos_seg[col0];
  if (first_seg == kInvalidSeg ||
      first_seg > pos_seg[min(n, row_tile * kTile + kTile) - 1])
    return;                                    // no same-class pair
  const int t = threadIdx.x;
  if (t < kTile && col0 + t < n) {
    const int j = perm[col0 + t];
    const float* b = boxes + 4LL * j;
    cbox[t][0] = b[0];
    cbox[t][1] = b[1];
    cbox[t][2] = b[2];
    cbox[t][3] = b[3];
    carea[t] = box_area(b[0], b[1], b[2], b[3]);
    ccls[t] = classes[j];
  }
  if (t == 0) tile_rows = 0ull;
  __syncthreads();
  const int row = t >> 2;
  const int quarter = t & 3;
  const int i = row_tile * kTile + row;
  unsigned long long bits = 0ull;
  const int seg = i < n ? pos_seg[i] : kInvalidSeg;
  if (seg != kInvalidSeg) {
    const int o = perm[i];
    const float* a = boxes + 4LL * o;
    const float ax0 = a[0], ay0 = a[1], ax1 = a[2], ay1 = a[3];
    const float area_i = box_area(ax0, ay0, ax1, ay1);
    const int cls = classes[o];
    // this thread's quarter of the row's own segment in the tile
    const int k0 = max(max(i + 1, col0) - col0, quarter * 16);
    const int k1 = min(min(seg_bounds[seg + 1], col0 + kTile) - col0,
                       quarter * 16 + 16);
    for (int k = k0; k < k1; ++k) {
      if (ccls[k] != cls) continue;            // only in one unbinned segment
      const float w = fmaxf(__fsub_rn(fminf(ax1, cbox[k][2]),
                                      fmaxf(ax0, cbox[k][0])), 0.0f);
      const float h = fmaxf(__fsub_rn(fminf(ay1, cbox[k][3]),
                                      fmaxf(ay0, cbox[k][1])), 0.0f);
      const float inter = __fmul_rn(w, h);
      const float uni = __fsub_rn(__fadd_rn(area_i, carea[k]), inter);
      // 0 / x is +0 for the positive x here: the division is skipped
      const float iou = inter != 0.0f && uni > 0.0f
          ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
      if (iou > thresh) bits |= 1ull << k;
    }
  }
  bits |= __shfl_xor_sync(kFull, bits, 1);
  bits |= __shfl_xor_sync(kFull, bits, 2);
  if (quarter == 0 && i < n) {
    mask[(long long)i * words + col_tile] = bits;
    if (bits != 0ull && col_tile > row_tile)
      atomicOr(&tile_rows, 1ull << row);
  }
  __syncthreads();
  if (t == 0 && tile_rows != 0ull) atomicOr(later_rows + row_tile, tile_rows);
}

constexpr int kFlagged = 384;    // flagged rows' words staged a segment
constexpr int kSmallRows = 32 * kTile;   // rows of a segment of 32 words
constexpr int kSweepThreads = 128;       // stage with four warps, sweep one

// what a segment of at most 32 words is decided from (dynamic shared
// memory, 123 KB)
struct SweepShared {
  unsigned long long diag[kSmallRows];           // each row's diagonal word
  unsigned long long flag_words[kFlagged][32];   // [flagged row][lane word]
  int perm[kSmallRows];                          // each row's candidate
  int flag_row[kFlagged];
  int flag_bit[kFlagged];                        // its row within its block
  int flagged;
};

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, bool fill) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // src-size 0 fills the destination with zeros and reads nothing
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(fill ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(fill ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ unsigned long long block_rows(int seg_lo,
                                                         int seg_hi,
                                                         int row0) {
  const int lo = max(seg_lo, row0) - row0;
  const int hi = min(seg_hi, row0 + kTile) - row0;
  return (hi - lo == kTile ? ~0ull : ((1ull << (hi - lo)) - 1ull)) << lo;
}

// the block's keep decision from its removed word and the diagonal words
// of rows lane and lane + 32 (0 outside the segment)
__device__ __forceinline__ unsigned long long decide(unsigned long long cur,
                                                     unsigned long long vb,
                                                     unsigned long long d_lo,
                                                     unsigned long long d_hi) {
  const unsigned long long nz =
      (unsigned long long)__ballot_sync(kFull, d_lo != 0ull) |
      ((unsigned long long)__ballot_sync(kFull, d_hi != 0ull) << 32);
  // rows in order: kept iff not removed by then; a kept row removes its
  // diagonal word's rows (all later than it)
  if (__popcll(nz) <= kSparseRows) {
    for (unsigned long long m = nz; m != 0ull; m &= m - 1ull) {
      const int r = __ffsll((long long)m) - 1;
      const unsigned long long d =
          __shfl_sync(kFull, r < 32 ? d_lo : d_hi, r & 31);
      if (!((cur >> r) & 1ull)) cur |= d;
    }
  } else {
    // by 32-bit halves: rows 0-31 set bits in both, rows 32-63 only in
    // the upper half
    unsigned int lo = (unsigned int)cur, hi = (unsigned int)(cur >> 32);
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const unsigned long long d = __shfl_sync(kFull, d_lo, r);
      if (!((lo >> r) & 1u)) {
        lo |= (unsigned int)d;
        hi |= (unsigned int)(d >> 32);
      }
    }
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const unsigned int d =
          (unsigned int)(__shfl_sync(kFull, d_hi, r) >> 32);
      if (!((hi >> r) & 1u)) hi |= d;
    }
    cur = ((unsigned long long)hi << 32) | lo;
  }
  return vb & ~cur;
}

// OR word w of rows row0 + r (r in `rows`) into acc, four loads in flight
__device__ __forceinline__ unsigned long long or_rows(
    const unsigned long long* __restrict__ mask, int words, int row0, int w,
    bool mine, unsigned long long rows) {
  unsigned long long acc = 0ull;
  while (rows != 0ull) {
    int r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r[q] = rows != 0ull ? __ffsll((long long)rows) - 1 : -1;
      rows &= rows - 1ull;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (mine && r[q] >= 0)
        acc |= mask[(long long)(row0 + r[q]) * words + w];
  }
  return acc;
}

// a segment spanning at most 32 words: lane l of warp 0 owns word b0 + l.
// First the whole block copies into shared memory, with cp.async and all
// copies in flight at once, every row's diagonal word and candidate index
// and the later words of the segment's flagged rows (those with a nonzero
// later word, the first kFlagged of them; lane l of warp 0 holds its own
// block's flags, and a scan over the lanes gives each block its slots).
// Then warp 0 decides the blocks from shared memory alone, save flagged
// rows past kFlagged, read from L2.
__device__ __forceinline__ void sweep_small(
    const unsigned long long* __restrict__ mask,
    const unsigned long long* __restrict__ later_rows,
    const int* __restrict__ perm, int words, int seg_lo, int seg_hi,
    bool* __restrict__ keep, SweepShared& sh) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b0 = seg_lo / kTile;
  const int b1 = (seg_hi - 1) / kTile;
  const int base = kTile * b0;
  const int w = b0 + lane;                     // this lane's word
#pragma unroll 4
  for (int r = seg_lo + t; r < seg_hi; r += kSweepThreads) {
    cp_async(&sh.diag[r - base], mask + (long long)r * words + r / kTile, 8,
             true);
    cp_async(&sh.perm[r - base], perm + r, 4, true);
  }
  unsigned long long my_later = 0ull;
  int my_slot = 0;
  if (t < 32) {
    my_later = w < b1
        ? later_rows[w] & block_rows(seg_lo, seg_hi, kTile * w) : 0ull;
    const int my_count = __popcll(my_later);
    my_slot = my_count;                        // inclusive scan, then less
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, my_slot, o);
      if (lane >= o) my_slot += x;
    }
    if (lane == 31) sh.flagged = min(my_slot, kFlagged);
    my_slot -= my_count;
    int slot = my_slot;
    for (unsigned long long m = my_later; m != 0ull && slot < kFlagged;
         m &= m - 1ull, ++slot) {
      const int bit = __ffsll((long long)m) - 1;
      sh.flag_row[slot] = kTile * w + bit;
      sh.flag_bit[slot] = bit;
    }
  }
  __syncthreads();
  const int flagged = sh.flagged;
  for (int f = t >> 5; f < flagged; f += kSweepThreads / 32) {
    const int row = sh.flag_row[f];
    const bool later = w > row / kTile && w <= b1;
    cp_async(&sh.flag_words[f][lane],
             mask + (later ? (long long)row * words + w : 0), 8, later);
  }
  cp_async_wait_all();
  __syncthreads();
  if (t >= 32) return;

  unsigned long long removed = 0ull;
  for (int b = b0; b <= b1; ++b) {
    const int rel = b - b0;
    const int row0 = kTile * b;
    const unsigned long long vb = block_rows(seg_lo, seg_hi, row0);
    const unsigned long long d_lo =
        (vb >> lane) & 1ull ? sh.diag[row0 + lane - base] : 0ull;
    const unsigned long long d_hi =
        (vb >> (lane + 32)) & 1ull ? sh.diag[row0 + lane + 32 - base] : 0ull;
    const unsigned long long kb =
        decide(__shfl_sync(kFull, removed, rel), vb, d_lo, d_hi);
    if ((kb >> lane) & 1ull) keep[sh.perm[row0 + lane - base]] = true;
    if ((kb >> (lane + 32)) & 1ull)
      keep[sh.perm[row0 + lane + 32 - base]] = true;
    // OR the later words of the kept flagged rows into the removed set
    const unsigned long long flags = __shfl_sync(kFull, my_later, rel);
    if ((kb & flags) != 0ull) {
      const int first = __shfl_sync(kFull, my_slot, rel);
      const int count = __popcll(flags);
      const int staged = max(0, min(count, kFlagged - first));
      unsigned long long acc = 0ull;
#pragma unroll 4
      for (int f = first; f < first + staged; ++f)
        if ((kb >> sh.flag_bit[f]) & 1ull) acc |= sh.flag_words[f][lane];
      removed |= acc;
      if (staged < count) {         // the flagged rows past the staged ones
        unsigned long long past = flags;
        for (int k = 0; k < staged; ++k) past &= past - 1ull;
        removed |= or_rows(mask, words, row0, w, w > b && w <= b1, kb & past);
      }
    }
  }
}

// a larger segment: lane l owns words b0 + l + 32 j, and every word is
// read from L2 when it is needed
__device__ __forceinline__ void sweep_large(
    const unsigned long long* __restrict__ mask,
    const unsigned long long* __restrict__ later_rows,
    const int* __restrict__ perm, int words, int seg_lo, int seg_hi,
    bool* __restrict__ keep) {
  const int lane = threadIdx.x & 31;
  const int b0 = seg_lo / kTile;
  const int b1 = (seg_hi - 1) / kTile;
  unsigned long long removed[kLaneWords];
#pragma unroll
  for (int j = 0; j < kLaneWords; ++j) removed[j] = 0ull;
  for (int b = b0; b <= b1; ++b) {
    const int rel = b - b0;
    const int row0 = kTile * b;
    const unsigned long long vb = block_rows(seg_lo, seg_hi, row0);
    const int r = row0 + lane;
    const unsigned long long d_lo =
        (vb >> lane) & 1ull ? mask[(long long)r * words + b] : 0ull;
    const unsigned long long d_hi =
        (vb >> (lane + 32)) & 1ull ? mask[(long long)(r + 32) * words + b]
                                   : 0ull;
    unsigned long long own = 0ull;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j)
      if (j == rel / 32) own = removed[j];
    const unsigned long long kb =
        decide(__shfl_sync(kFull, own, rel & 31), vb, d_lo, d_hi);
    if ((kb >> lane) & 1ull) keep[perm[r]] = true;
    if ((kb >> (lane + 32)) & 1ull) keep[perm[r + 32]] = true;
    const unsigned long long rows = b < b1 ? kb & later_rows[b] : 0ull;
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j) {
      const int w = b0 + lane + 32 * j;
      removed[j] |= or_rows(mask, words, row0, w, w > b && w <= b1, rows);
    }
  }
}

// one block a segment (the grid is at least the segment count)
__global__ void __launch_bounds__(kSweepThreads) nms_sweep_kernel(
    const unsigned long long* __restrict__ mask,
    const unsigned long long* __restrict__ later_rows,
    const int* __restrict__ perm, const int* __restrict__ seg_bounds,
    const int* __restrict__ num_segs, int words, bool* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  SweepShared& sh = *reinterpret_cast<SweepShared*>(sweep_smem);
  // the count and the bounds load together (bounds past the count unused)
  const int segs = *num_segs;
  const int seg_lo = seg_bounds[blockIdx.x];
  const int seg_hi = seg_bounds[blockIdx.x + 1];
  if ((int)blockIdx.x >= segs) return;
  if ((seg_hi - 1) / kTile - seg_lo / kTile < 32)
    sweep_small(mask, later_rows, perm, words, seg_lo, seg_hi, keep, sh);
  else if (threadIdx.x < 32)
    sweep_large(mask, later_rows, perm, words, seg_lo, seg_hi, keep);
}

__global__ void nms_bypass_kernel(const unsigned char* __restrict__ valid,
                                  int n, bool* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keep[i] = valid[i] != 0;
}

}  // namespace

// mask: int64 [n + 1, words], of which only the same-class tiles' words
// are written and read, and row n the later-rows flags of each row block;
// scratch: int32 [2 n + kBins + 3] (the partition order, each position's
// segment, the segment bounds, the segment count). Neither is touched
// when `disabled`.
extern "C" int nms_launch(const void* boxes, const void* classes,
                          const void* valid, void* mask, void* scratch,
                          void* keep, int n, float thresh, int disabled,
                          void* stream) {
  if (n < 0 || n > kMaxRows) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (disabled) {
    nms_bypass_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        (const unsigned char*)valid, n, (bool*)keep);
    return (int)cudaGetLastError();
  }
  const int words = (n + kTile - 1) / kTile;
  unsigned long long* mask_words = (unsigned long long*)mask;
  unsigned long long* later_rows = mask_words + (long long)n * words;
  int* perm = (int*)scratch;
  int* pos_seg = perm + n;
  int* seg_bounds = pos_seg + n;
  int* num_segs = seg_bounds + kBins + 2;
  nms_partition_kernel<<<1, kPartThreads, 0, s>>>(
      (const int*)classes, (const unsigned char*)valid, n, perm, pos_seg,
      seg_bounds, num_segs, later_rows, words, (bool*)keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_mask_kernel<<<dim3(words, words), kMaskThreads, 0, s>>>(
      (const float*)boxes, (const int*)classes, perm, pos_seg, seg_bounds, n,
      words, thresh, mask_words, later_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the opt-in above 48 KB of shared memory, once a process (the port
  // drives one card)
  static bool sweep_smem_set = false;
  if (!sweep_smem_set) {
    err = cudaFuncSetAttribute(nms_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(SweepShared));
    if (err != cudaSuccess) return (int)err;
    sweep_smem_set = true;
  }
  nms_sweep_kernel<<<n < kBins ? n : kBins, kSweepThreads,
                     sizeof(SweepShared), s>>>(
      mask_words, later_rows, perm, seg_bounds, num_segs, words, (bool*)keep);
  return (int)cudaGetLastError();
}
