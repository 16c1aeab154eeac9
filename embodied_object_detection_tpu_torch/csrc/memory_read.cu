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
// f32, grad_features [B * cells, D] f32, written whole. JAX adds the
// contributions in bf16 one by one. The kernel adds each row's in f32 in
// window order and rounds once: bit for bit the window-order sum
// (ops/memory_ops.py:memory_read_grad_window_order), and so within that
// arithmetic's bound of the exact sum s, one bf16 rounding of an f32 sum:
// (2^-8 |s| + n 2^-24 sum |c|) / denominator, to first order
// (memory_read_grad_exact; JAX's bf16 sum keeps only the looser
// n 2^-8 sum |c| / denominator). A gather by row, with no atomics on the
// data (int counters only), in five kernels:
//   1. table: c = bf16(grad_out / p^2) written once into a bf16 scratch
//      [B * windows, D], the values every later read takes, at half the
//      bytes of grad_out (19.7 MB a frame, which stays in the 50 MB L2);
//   2. count: a warp's lanes take the taps of two 4x4 windows, and
//      __match_any_sync merges each window's equal row ids (the lowest
//      lane of a row holds its multiplicity: a bf16 value times at most 64
//      is exact in f32); one int RED on each distinct row's counter;
//   3. an exclusive scan of the B * cells counters into the rows' bucket
//      offsets: 1024 a block, the last block to finish scanning the
//      blocks' totals;
//   4. keys: the same merge puts each distinct row's key, window << 7 |
//      multiplicity, into the row's bucket at a slot it takes by counting
//      the row's counter down;
//   5. rows: a warp a (row, 256 channels) loads the row's keys (up to 8 a
//      lane), sorts them with a bitonic network in registers (the atomics
//      gave the slots in any order; the keys' order is the windows'), and
//      adds c[window] x multiplicity in that order in f32 registers
//      (__fmul_rn, __fadd_rn, from 0), a lane over 8 channels in 16-byte
//      loads, 4 entries' loads in flight; then it rounds to bf16 once,
//      divides (__fdiv_rn) and stores its channels once. A row with no
//      entry stores 0. A row of more than 256 entries (a cell under more
//      than a 75th of a 480x640 frame's windows) takes its windows in
//      order from a bitmap in shared memory, 8192 windows a sweep, and
//      recounts each one's multiplicity from proj. Rows go in frame
//      order, and frame b's rows read only frame b's table, so at B = 4
//      each frame's table is re-read from L2.
// What bounds it on Hopper: bytes. Device memory must see grad_out once
// (39.3 MB a frame), proj once (1.2 MB) and the gradient written once
// (16.8 MB); the table's write and its re-reads (one 1 KB row an entry:
// 315 MB on random ids, where a window touches ~16 rows; 19.7 MB on
// coherent ids) are L2 traffic, and the rows' reads of them set the pace
// on random ids.

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

constexpr int kBwdWarps = 8;         // warps a row block
constexpr int kMultBits = 7;         // key = window << 7 | multiplicity (<= 64)
constexpr unsigned kMultMask = (1u << kMultBits) - 1;
constexpr unsigned kNoKey = 0xffffffffu;
constexpr int kSweepWords = 256;     // a large row's bitmap: 8192 windows
constexpr int kScanThreads = 1024;
constexpr int kRowChannels = 8;      // a lane's channels of a row
constexpr int kInFlight = 4;         // entries whose loads are in flight
constexpr int kRowBlocks = 4;        // row blocks an SM: 64 registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct BwdShape {
  int vec4;                          // D / 4
  int height, width, pool, taps, out_w, frame_windows, cells;
};

// the global row that tap t of window w gathered
__device__ __forceinline__ int tap_row(const int* __restrict__ proj,
                                       const BwdShape& s, int w, int t) {
  const int b = w / s.frame_windows;
  const int local = w - b * s.frame_windows;
  const int oy = local / s.out_w, ox = local - oy * s.out_w;
  const int dy = t / s.pool, dx = t - dy * s.pool;
  return b * s.cells +
         __ldg(proj + (long long)b * s.height * s.width +
               (long long)(oy * s.pool + dy) * s.width + ox * s.pool + dx);
}

// 1. the table: c = bf16(grad_out / p^2), 4 channels a thread a step;
// a power of two divides exactly as its reciprocal multiplies
__global__ void read_bwd_table(const float4* __restrict__ grad_out,
                               uint2* __restrict__ table, long long n,
                               int taps) {
  const float div = (float)taps, inv = 1.0f / div;
  const bool pow2 = (taps & (taps - 1)) == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldcs(grad_out + i);   // read once: do not keep in L2
    const float a[4] = {v.x, v.y, v.z, v.w};
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = pow2 ? __fmul_rn(a[k], inv) : __fdiv_rn(a[k], div);
    table[i] = make_uint2(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]));
  }
}

// exclusive scan of v over the block; *total is the block's sum
__device__ __forceinline__ int block_exclusive(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int u = sums[lane];
    int ui = u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, ui, o);
      if (lane >= o) ui += t;
    }
    sums[lane] = ui - u;
    if (lane == 31) sums[32] = ui;
  }
  __syncthreads();
  const int out = sums[warp] + incl - v;
  *total = sums[32];
  __syncthreads();                   // sums may be reused
  return out;
}

// 3. the buckets' offsets: offset(i) = local[i] + prefix[i / 1024] for
// i <= rows (counts[rows] is 0, so offset(rows) is the entries' total). A
// block scans 1024 counters and writes its total into prefix; the last
// block to finish turns the totals into exclusive prefixes.
__global__ void __launch_bounds__(kScanThreads)
read_bwd_scan(const int* __restrict__ counts, int* __restrict__ local,
              int* __restrict__ prefix, unsigned int* __restrict__ ticket,
              int n) {
  __shared__ int sums[33];
  __shared__ bool last;
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  const int v = i < n ? __ldg(counts + i) : 0;
  int total;
  const int excl = block_exclusive(v, sums, &total);
  if (i < n) local[i] = excl;
  if (threadIdx.x == 0) {
    prefix[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int b0 = 0; b0 < (int)gridDim.x; b0 += kScanThreads) {
    const int j = b0 + threadIdx.x;
    const int t = j < (int)gridDim.x ? __ldcg(prefix + j) : 0;
    int chunk;
    const int e = block_exclusive(t, sums, &chunk);
    if (j < (int)gridDim.x) prefix[j] = carry + e;
    carry += chunk;
  }
}

__device__ __forceinline__ int bucket_offset(const int* __restrict__ local,
                                             const int* __restrict__ prefix,
                                             int i) {
  return __ldg(local + i) + __ldg(prefix + i / kScanThreads);
}

// 2 and 4. a window's distinct rows: the lanes of a warp take the taps of
// 32 / p^2 windows (p^2 <= 32; __match_any_sync finds a tap's equals in
// its window, the lowest lane of each row holds the row's multiplicity),
// or one window's taps in steps of 32 (p^2 > 32: each tap's equals
// counted by reloading the window's taps). The count pass adds one to
// each distinct row's counter; the keys pass puts its key, window << 7 |
// multiplicity, into the row's bucket at a slot it takes by counting the
// counter down.
template <bool kKeys>
__device__ __forceinline__ void window_entry(int* __restrict__ counts,
                                             const int* __restrict__ local,
                                             const int* __restrict__ prefix,
                                             unsigned* __restrict__ keys,
                                             int w, int row, int mult) {
  int* counter = counts + row;
  if (!kKeys) {
    atomicAdd(counter, 1);
    return;
  }
  const int slot = atomicSub(counter, 1) - 1;
  keys[bucket_offset(local, prefix, row) + slot] =
      ((unsigned)w << kMultBits) | (unsigned)mult;
}

template <bool kKeys>
__global__ void read_bwd_windows(const int* __restrict__ proj,
                                 int* __restrict__ counts,
                                 const int* __restrict__ local,
                                 const int* __restrict__ prefix,
                                 unsigned* __restrict__ keys,
                                 const BwdShape s, int windows) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (s.taps <= 32) {
    const int per = 32 / s.taps;
    const int sub = lane / s.taps, t = lane - sub * s.taps;
    const int w = warp * per + sub;
    const bool live = sub < per && w < windows;
    const int row = live ? tap_row(proj, s, w, t) : -1;
    // the window in the high word: equal rows of two windows stay apart
    const unsigned same = __match_any_sync(
        kFull, ((unsigned long long)(live ? sub : 32) << 32) | (unsigned)row);
    if (live && lane == __ffs(same) - 1)
      window_entry<kKeys>(counts, local, prefix, keys, w, row, __popc(same));
    return;
  }
  if (warp >= windows) return;       // whole warps leave together
  for (int t = lane; t < s.taps; t += 32) {
    const int row = tap_row(proj, s, warp, t);
    int mult = 0;
    bool first = true;
    for (int u = 0; u < s.taps; ++u) {
      const bool eq = tap_row(proj, s, warp, u) == row;
      mult += eq;
      first = first && !(eq && u < t);
    }
    if (first)
      window_entry<kKeys>(counts, local, prefix, keys, warp, row, mult);
  }
}

// 5. the rows. A lane's vectors of a row: kVec bf16 a vector (uint4: 8,
// uint2: 4), J of them a pass, vector v0 + j * 32 + lane.
template <int kVec> struct BfVec;
template <> struct BfVec<8> { using T = uint4; };
template <> struct BfVec<4> { using T = uint2; };

__device__ __forceinline__ void widen(const uint4& v, float* f) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 p = unpack_bf16(w[q]);
    f[2 * q] = p.x;
    f[2 * q + 1] = p.y;
  }
}

__device__ __forceinline__ void widen(const uint2& v, float* f) {
  const float2 a = unpack_bf16(v.x), b = unpack_bf16(v.y);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// acc += c[window] x multiplicity for the batch's m keys, held one a lane
// by lanes 0 .. m - 1 in window order, added in that order
template <int kVec>
__device__ __forceinline__ void add_batch(
    float (&acc)[kRowChannels], unsigned key, int m,
    const typename BfVec<kVec>::T* __restrict__ table, int row_vecs,
    int v0, int lane) {
  using T = typename BfVec<kVec>::T;
  constexpr int J = kRowChannels / kVec;
  for (int e0 = 0; e0 < m; e0 += kInFlight) {
    unsigned k[kInFlight];
    T v[kInFlight][J];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      k[u] = __shfl_sync(kFull, key, (e0 + u) & 31);
      const long long base = (long long)(k[u] >> kMultBits) * row_vecs;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int vi = v0 + j * 32 + lane;
        v[u][j] = e0 + u < m && vi < row_vecs ? __ldg(table + base + vi) : T{};
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (e0 + u >= m) break;
      const float f = (float)(k[u] & kMultMask);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float c[kVec];
        widen(v[u][j], c);
#pragma unroll
        for (int q = 0; q < kVec; ++q)
          acc[j * kVec + q] = __fadd_rn(acc[j * kVec + q], __fmul_rn(c[q], f));
      }
    }
  }
}

// the pass's channels of the row: rounded to bf16 once, then divided
template <int kVec>
__device__ __forceinline__ void store_row(const float (&acc)[kRowChannels],
                                          float* __restrict__ dst,
                                          int row_vecs, int v0, float d,
                                          int lane) {
  constexpr int J = kRowChannels / kVec;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int vi = v0 + j * 32 + lane;
    if (vi >= row_vecs) continue;
    float4* out = reinterpret_cast<float4*>(dst) + vi * (kVec / 4);
#pragma unroll
    for (int h = 0; h < kVec / 4; ++h) {
      const float* a = acc + j * kVec + 4 * h;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = bf16_round(a[i]);
        if (d != 1.0f) v[i] = __fdiv_rn(v[i], d);   // x / 1 is x
      }
      out[h] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ascending bitonic sort of the warp's 32 K keys, element k * 32 + lane in
// key[k]: the strides under 32 exchange by shuffles, the others in a lane
template <int K>
__device__ __forceinline__ void warp_sort(unsigned (&key)[K], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * K; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool up = ((k * 32 + lane) & size) == 0;
        if (stride >= 32) {
          const int partner = k ^ (stride >> 5);
          if (partner > k && (key[k] > key[partner]) == up) {
            const unsigned t = key[k];
            key[k] = key[partner];
            key[partner] = t;
          }
        } else {
          const unsigned other = __shfl_xor_sync(kFull, key[k], stride);
          const bool lower = (lane & stride) == 0;
          key[k] = lower == up ? min(key[k], other) : max(key[k], other);
        }
      }
    }
  }
}

// a row of at most 32 K entries: its keys sorted in registers
template <int K, int kVec>
__device__ __forceinline__ void row_sorted(
    const typename BfVec<kVec>::T* __restrict__ table,
    const unsigned* __restrict__ keys, int begin, int n,
    float* __restrict__ dst, int row_vecs, int v0, float d, int lane) {
  unsigned key[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = k * 32 + lane;
    key[k] = e < n ? __ldg(keys + begin + e) : kNoKey;
  }
  if (n > 1) warp_sort<K>(key, lane);
  float acc[kRowChannels];
#pragma unroll
  for (int i = 0; i < kRowChannels; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m = min(32, n - 32 * k);
    if (m > 0) add_batch<kVec>(acc, key[k], m, table, row_vecs, v0, lane);
  }
  store_row<kVec>(acc, dst, row_vecs, v0, d, lane);
}

// a row of more entries than the registers sort: its frame's windows
// swept in order through a bitmap of the bucket, 32 at a time, each one's
// multiplicity recounted from proj
template <int kVec>
__device__ void row_swept(const typename BfVec<kVec>::T* __restrict__ table,
                          const unsigned* __restrict__ keys,
                          const int* __restrict__ proj, const BwdShape& s,
                          unsigned* bitmap, unsigned* order, int r,
                          int begin, int n, float* __restrict__ dst,
                          int row_vecs, int v0, float d, int lane) {
  constexpr int kSpan = kSweepWords * 32;
  const int first = (r / s.cells) * s.frame_windows;
  const int last = first + s.frame_windows;
  {
    float acc[kRowChannels];
#pragma unroll
    for (int i = 0; i < kRowChannels; ++i) acc[i] = 0.f;
    for (int w0 = first; w0 < last; w0 += kSpan) {
      for (int i = lane; i < kSweepWords; i += 32) bitmap[i] = 0u;
      __syncwarp();
      for (int e = lane; e < n; e += 32) {
        const int w = (int)(__ldg(keys + begin + e) >> kMultBits) - w0;
        if (w >= 0 && w < kSpan) atomicOr(bitmap + (w >> 5), 1u << (w & 31));
      }
      __syncwarp();
      for (int q0 = 0; q0 < kSweepWords; q0 += 32) {
        const unsigned word = bitmap[q0 + lane];
        const int pc = __popc(word);
        int incl = pc;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        const int base = incl - pc;
        for (int b0 = 0; b0 < total; b0 += 32) {
          if (base < b0 + 32 && base + pc > b0) {
            unsigned bits = word;
            for (int rank = base; bits; ++rank) {
              const int bit = __ffs(bits) - 1;
              bits &= bits - 1;
              if (rank >= b0 && rank < b0 + 32)
                order[rank - b0] = (unsigned)(w0 + ((q0 + lane) << 5) + bit);
            }
          }
          __syncwarp();
          const int m = min(32, total - b0);
          unsigned key = kNoKey;
          if (lane < m) {
            const int w = (int)order[lane];
            unsigned mult = 0;
            for (int t = 0; t < s.taps; ++t) mult += tap_row(proj, s, w, t) == r;
            key = ((unsigned)w << kMultBits) | mult;
          }
          __syncwarp();
          add_batch<kVec>(acc, key, m, table, row_vecs, v0, lane);
        }
      }
      __syncwarp();                  // the bitmap is cleared next sweep
    }
    store_row<kVec>(acc, dst, row_vecs, v0, d, lane);
  }
}

// a row's slices of 32 lanes x kRowChannels channels
__host__ __device__ __forceinline__ int row_slices(int vec4) {
  return (vec4 * 4 + 32 * kRowChannels - 1) / (32 * kRowChannels);
}

template <int kVec>
__global__ void __launch_bounds__(kBwdWarps * 32, kRowBlocks)
read_bwd_rows(const void* __restrict__ table_bytes,
              const unsigned* __restrict__ keys,
              const int* __restrict__ local, const int* __restrict__ prefix,
              const float* __restrict__ obs, const int* __restrict__ proj,
              float* __restrict__ grad, const BwdShape s, int rows) {
  __shared__ unsigned bitmap[kBwdWarps][kSweepWords];
  __shared__ unsigned order[kBwdWarps][32];
  using T = typename BfVec<kVec>::T;
  const T* table = reinterpret_cast<const T*>(table_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a warp a (row, slice of 32 x kRowChannels channels)
  const int row_vecs = s.vec4 * 4 / kVec;
  const int slices = row_slices(s.vec4);
  const long long item = blockIdx.x * (long long)kBwdWarps + warp;
  if (item >= (long long)rows * slices) return;   // whole warps leave
  const int r = (int)(item / slices);
  const int v0 = (int)(item - (long long)r * slices) * 32 *
                 (kRowChannels / kVec);
  const int begin = bucket_offset(local, prefix, r);
  const int n = bucket_offset(local, prefix, r + 1) - begin;
  const float o = __ldg(obs + r);
  const float d = o > 1.0f ? o : 1.0f;
  float* dst = grad + (long long)r * s.vec4 * 4;
  if (n <= 32)
    row_sorted<1, kVec>(table, keys, begin, n, dst, row_vecs, v0, d, lane);
  else if (n <= 64)
    row_sorted<2, kVec>(table, keys, begin, n, dst, row_vecs, v0, d, lane);
  else if (n <= 128)
    row_sorted<4, kVec>(table, keys, begin, n, dst, row_vecs, v0, d, lane);
  else if (n <= 256)
    row_sorted<8, kVec>(table, keys, begin, n, dst, row_vecs, v0, d, lane);
  else
    row_swept<kVec>(table, keys, proj, s, bitmap[warp], order[warp], r,
                    begin, n, dst, row_vecs, v0, d, lane);
}

constexpr long long kAlign = 256;

long long aligned(long long bytes) {
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

// The scratch, one device buffer of at least this many bytes, each part
// from a 256-byte boundary (ops/memory_ops.py sizes it the same way): the
// bf16 table [windows, dim]; the keys uint32 [windows * p^2]; the
// counters int32 [rows + 2] (the rows', a 0 and the scan's ticket); the
// offsets within a scan block int32 [rows + 1]; the scan blocks' prefixes
// int32 [(rows + 1) / 1024, rounded up].
long long scratch_bytes(int dim, int height, int width, int pool, int batch,
                        int cells) {
  const long long windows =
      (long long)batch * (height / pool) * (width / pool);
  const long long entries = windows * pool * pool;
  const long long rows = (long long)batch * cells;
  return aligned(windows * dim * 2) + aligned(entries * 4) +
         aligned((rows + 2) * 4) +
         aligned((rows + 1) * 4) +
         aligned((rows + kScanThreads) / kScanThreads * 4);
}

}  // namespace

// grad_features: f32 [batch * cells, dim], 16-byte aligned, written whole;
// scratch: a device buffer of scratch_bytes bytes or more.
extern "C" int memory_read_backward_launch(const void* grad_out,
                                           const void* obs, const void* proj,
                                           void* grad_features, void* scratch,
                                           long long scratch_size, int dim,
                                           int height, int width, int pool,
                                           int batch, int cells,
                                           void* stream) {
  if (pool <= 0 || pool > kMaxPool || dim % 4 != 0 || height % pool != 0 ||
      width % pool != 0 || batch < 0 || cells < 0 || height < 0 ||
      width < 0)
    return (int)cudaErrorInvalidValue;
  const long long windows =
      (long long)batch * (height / pool) * (width / pool);
  const long long entries = windows * pool * pool;
  const long long rows = (long long)batch * cells;
  if (dim == 0 || rows == 0) return 0;
  // keys hold a window in 24 bits; offsets are int32
  if (windows >= (1LL << 24) || entries > 0x7fffffffLL ||
      rows >= 0x7fffffffLL ||
      (long long)height * width * batch > 0x7fffffffLL ||
      scratch_size < scratch_bytes(dim, height, width, pool, batch, cells))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* p = (char*)scratch;
  uint2* table = (uint2*)p;
  p += aligned(windows * dim * 2);
  unsigned* keys = (unsigned*)p;
  p += aligned(entries * 4);
  int* counts = (int*)p;
  p += aligned((rows + 2) * 4);
  int* local = (int*)p;
  p += aligned((rows + 1) * 4);
  int* prefix = (int*)p;
  const BwdShape s{dim / 4, height, width, pool, pool * pool, width / pool,
                   (height / pool) * (width / pool), cells};
  cudaError_t err = cudaMemsetAsync(counts, 0, (rows + 2) * 4, st);
  if (err != cudaSuccess) return (int)err;
  // a warp takes 32 / p^2 windows, or one
  const long long window_warps =
      pool * pool <= 32 ? (windows + 32 / (pool * pool) - 1) /
                              (32 / (pool * pool))
                        : windows;
  const unsigned int window_blocks =
      (unsigned int)((window_warps + kThreads / 32 - 1) / (kThreads / 32));
  if (windows > 0) {
    const long long quads = windows * (dim / 4);
    long long blocks = (quads + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    read_bwd_table<<<(unsigned int)blocks, kThreads, 0, st>>>(
        (const float4*)grad_out, table, quads, pool * pool);
    read_bwd_windows<false><<<window_blocks, kThreads, 0, st>>>(
        (const int*)proj, counts, local, prefix, keys, s, (int)windows);
  }
  read_bwd_scan<<<(unsigned int)((rows + kScanThreads) / kScanThreads),
                  kScanThreads, 0, st>>>(counts, local, prefix,
                                         (unsigned int*)(counts + rows + 1),
                                         (int)rows + 1);
  if (windows > 0)
    read_bwd_windows<true><<<window_blocks, kThreads, 0, st>>>(
        (const int*)proj, counts, local, prefix, keys, s, (int)windows);
  const long long row_warps = rows * row_slices(dim / 4);
  if ((row_warps + kBwdWarps - 1) / kBwdWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned int row_blocks =
      (unsigned int)((row_warps + kBwdWarps - 1) / kBwdWarps);
  if (dim % 8 == 0)
    read_bwd_rows<8><<<row_blocks, kBwdWarps * 32, 0, st>>>(
        table, keys, local, prefix, (const float*)obs, (const int*)proj,
        (float*)grad_features, s, (int)rows);
  else
    read_bwd_rows<4><<<row_blocks, kBwdWarps * 32, 0, st>>>(
        table, keys, local, prefix, (const float*)obs, (const int*)proj,
        (float*)grad_features, s, (int)rows);
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
