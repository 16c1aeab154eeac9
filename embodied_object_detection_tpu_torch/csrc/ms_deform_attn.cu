// Multi-scale deformable attention (the MSDeformAttn core op), forward and
// backward. Forward:
//     out[q, m*D + d] = sum over points p of sum over levels l of
//                       attn[q, m, l, p] * sample_l(loc[q, m, l, p])[m, d]
// where sample_l is the bilinear, zero-padded (grid_sample,
// align_corners=False) sample of level l's [H_l, W_l] rows of
// value[S, M, D] at x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5. value
// [S, M, D] f32 (S = sum H_l W_l, the levels flattened one after another),
// loc [Q, M, L, P, 2] f32 (x, y) normalised per level, attn [Q, M, L, P]
// f32, out [Q, M * D] f32.
//
// Replaces ops/ms_deform_attn.py:ms_deform_attn of the JAX package (a
// gather per tap, its backward by autodiff), itself the reference's
// vendored CUDA extension (ms_deform_im2col_cuda.cuh) and the only one the
// Deformable-DETR family calls: 6 encoder layers (Q = S) and 6 decoder
// layers (Q = 100 queries) a frame.
//
// The arithmetic is the plain version's (ops/ms_deform_attn.py:
// ms_deform_attn_plain) in its order, with __fmul_rn/__fadd_rn/__fsub_rn so
// that no FMA contraction moves a coordinate across a pixel border: the
// corners' hat weights (1 - fy)(1 - fx), (1 - fy) fx, fy (1 - fx), fy fx,
// each corner's validity (0 <= yi < H_l, 0 <= xi < W_l) folded into its
// weight, the four taps summed in that order, each sample times its
// attention weight, summed over the levels a point, then over the points
// in order p = 0, 1, ..., P - 1. So the output is the plain version's, bit
// for bit.
//
// What bounds it on Hopper: the gathers, and how many of them are in
// flight. The inputs are read once in principle (at the encoder's shape,
// 480x640: value 6.5 MB, locations 6.5 MB, weights 3.3 MB, the output
// 6.5 MB), but every (query, head) reads the corners of each of its
// L x P samples that lie inside their level: up to 418 MB a call at
// L = P = 4, D = 32 (264 MB on uniform locations in [-0.1, 1.1]), served
// from L2, since the value table fits in its 50 MB. A corner is one
// head's row, D = 32 contiguous f32, 128 bytes. The layout keeps many of
// them in flight:
//   - a warp per (query, head); a lane per (point, 4 channels): lane =
//     pp * G + j, where G, a power of two, is at least the ceil(D / 4)
//     channel quads (up to 32), and 32 / G points go in one pass. At
//     D = 32, P = 4 that is 4 points x 8 quads: each corner row is one
//     128-byte request by 8 lanes, and one instruction asks for 4 points'
//     rows;
//   - the forward's lane loads its point's locations (float2) and weights
//     for a pair of levels, computes their corners, and copies all 8
//     corner quads into its own shared-memory slots with cp.async before
//     it waits and does the arithmetic: the loads in flight hold no
//     registers, so 8 blocks of 4 warps fit an SM, 16 KB of slots each.
//     An odd L takes its levels one at a time (a second instantiation:
//     guarding a pair's second level instead cost the 4-level forward 5 %);
//   - the P point partials are added in order by shuffles from the lane
//     groups into the first, which stores the quad;
//   - D % 4 != 0 leaves the rows without 16-byte alignment: the same
//     kernels then copy, load and store each quad's channels one by one,
//     and the last quad holds D % 4 of them. More quads than 32 loop;
//   - a block is 4 consecutive queries of one head, whose samples share
//     rows where the queries are neighbouring pixels; when the pairs are
//     too few to fill the card twice at 4 warps a block (the decoder's 100
//     queries: 2 warps, 400 blocks), the launcher takes smaller blocks.
//
// Backward, the same lane map, for the gradient of a loss through out:
//   grad_value[row, m, d] += (g[q, m*D + d] * a) * w_k at each valid
//                            corner k of each sample: one float4
//                            atomicAdd (sm_90, a vector RED in L2) a
//                            (sample, corner, quad) into a zeroed
//                            [S, M, D] buffer, since many queries sample
//                            the same rows in no fixed order
//   grad_attn[q, m, l, p]  = sum_d g * sample
//   grad_loc[q, m, l, p]   = a * sum_d g * d(sample)/d(fx, fy) * (W_l, H_l)
// where only valid corners contribute and floor() has zero gradient, as
// in JAX's autodiff (which, unlike the reference's CUDA, also takes the
// row-0 corner's term of a sample on the -1 row). Each (q, m, l, p) is
// owned by one lane group: each lane sums its quad's channels, then xor
// shuffles sum over the group's G lanes, deterministic and without
// atomics. The backward takes one level at a time (4 corner quads a lane
// in registers): its sums and grad_out quad make every level held at once
// cost occupancy, which its loads need more. A gather-form transpose (the
// (sample, corner) entries sorted by (row, head), a warp summing each
// row's in registers) was estimated slower at these shapes: its sort and
// a second gather as large as the first, of grad_out, cost more than the
// float4 REDs (16.5 M a call on uniform locations at the encoder's
// shape).
//
// Built with -DEODT_COUNT (kernels/build.py, counting=True), the same
// kernels also count what they issue: the bytes of the corner quads each
// lane copies (forward) or loads (backward), and the REDs it issues into
// grad_value, summed a warp and added to two device counters that
// ms_deform_attn_tally reads and zeroes. The timed build counts nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPoints = 8;
constexpr int kMaxWarps = 4;         // warps a block, one (query, head) each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdGroup = 2;         // levels whose corners load together

#ifdef EODT_COUNT
__device__ unsigned long long g_tally[2];   // corner bytes, REDs

// A lane's counts, added to g_tally once a warp (all 32 lanes call flush)
struct Tally {
  unsigned long long n[2] = {0, 0};
  __device__ void add(int i, unsigned long long v) { n[i] += v; }
  __device__ void flush() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unsigned long long v = n[i];
      for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if ((threadIdx.x & 31) == 0 && v) atomicAdd(&g_tally[i], v);
    }
  }
};
#else
struct Tally {
  __device__ void add(int, unsigned long long) {}
  __device__ void flush() {}
};
#endif

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];             // first row of the level in value
  int n;
};

// The four corners of one sample, top-left, top-right, bottom-left,
// bottom-right: the flat row of each (-1 when outside its level) and its
// hat weight with the validity folded in; fx, fy are the fractional parts.
struct Corners {
  int row[4];
  float wgt[4];
  float fx, fy;
};

__device__ __forceinline__ Corners corners(float loc_x, float loc_y, int h,
                                           int w, int start) {
  Corners c;
  const float x = __fsub_rn(__fmul_rn(loc_x, (float)w), 0.5f);
  const float y = __fsub_rn(__fmul_rn(loc_y, (float)h), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  c.fx = __fsub_rn(x, x0);
  c.fy = __fsub_rn(y, y0);
  const float gx = __fsub_rn(1.f, c.fx), gy = __fsub_rn(1.f, c.fy);
  const float hat[4] = {__fmul_rn(gy, gx), __fmul_rn(gy, c.fx),
                        __fmul_rn(c.fy, gx), __fmul_rn(c.fy, c.fx)};
  // validity in float: x0, y0 are integral, so these are the integer
  // tests, and a coordinate too large for an int never converts
  const bool okx[2] = {x0 >= 0.f && x0 < (float)w,
                       x0 + 1.f >= 0.f && x0 + 1.f < (float)w};
  const bool oky[2] = {y0 >= 0.f && y0 < (float)h,
                       y0 + 1.f >= 0.f && y0 + 1.f < (float)h};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const bool ok = oky[dy] && okx[dx];
    c.row[k] = ok ? start + ((int)y0 + dy) * w + (int)x0 + dx : -1;
    c.wgt[k] = ok ? hat[k] : 0.f;
  }
  return c;
}

// One lane's place in its warp: G = 1 << g_log2 lanes a point, pc points a
// pass, this lane's point slot pp and quad slot sub.
struct LaneMap {
  int g_log2, g, pc, pp, sub;
  __device__ explicit LaneMap(int g_log2_)
      : g_log2(g_log2_), g(1 << g_log2_), pc(32 >> g_log2_),
        pp((threadIdx.x & 31) >> g_log2_),
        sub((threadIdx.x & 31) & ((1 << g_log2_) - 1)) {}
};

// n (1 to 4) channels at p, as a float4 load when kVec (16-byte aligned
// rows, n = 4), else one by one with the rest 0
template <bool kVec>
__device__ __forceinline__ void load_quad(const float* p, int n,
                                          float (&v)[4]) {
  if (kVec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < n ? __ldg(p + c) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_quad(float* p, int n,
                                           const float (&v)[4]) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) p[c] = v[c];
  }
}

template <bool kVec>
__device__ __forceinline__ void red_quad(float* p, int n,
                                         const float (&v)[4]) {
  if (kVec) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n) atomicAdd(p + c, v[c]);
  }
}

// n (1 to 4) channels at p into a shared-memory slot, asynchronously
// (cp.async: the data lands in shared memory without holding registers);
// one 16-byte copy when kVec, else one 4-byte copy a channel
template <bool kVec>
__device__ __forceinline__ void stage_quad(float4* slot, const float* p,
                                           int n) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
  if (kVec) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(p)
                 : "memory");
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < n)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         dst + 4 * c),
                     "l"(p + c)
                     : "memory");
  }
}

// The location (x, y) and attention weight of sample k of a pair
template <bool kVec>
__device__ __forceinline__ float2 load_loc(const float* pl, int k) {
  if (kVec) return __ldg(reinterpret_cast<const float2*>(pl) + k);
  return make_float2(__ldg(pl + 2 * k), __ldg(pl + 2 * k + 1));
}

// The pair of this warp: blocks of `warps` consecutive queries of one head
__device__ __forceinline__ bool warp_pair(int num_queries, int heads,
                                          long long* pair, int* m) {
  const int warps = blockDim.x >> 5;
  *m = blockIdx.x % heads;
  const int q = (blockIdx.x / heads) * warps + (threadIdx.x >> 5);
  *pair = (long long)q * heads + *m;
  return q < num_queries;
}

// LG levels a group (L % LG == 0): their corners' loads go out together
template <int LG, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32, 8)
    ms_deform_attn_fwd(const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       float* __restrict__ out, const Levels lv,
                       int num_queries, int heads, int dim, int points,
                       int g_log2) {
  long long pair;
  int m;
  if (!warp_pair(num_queries, heads, &pair, &m)) return;  // whole warps
  const LaneMap lm(g_log2);
  const int quads = (dim + 3) >> 2;
  const int samples = lv.n * points;
  const float* pl = loc + pair * samples * 2;
  const float* pa = attn + pair * samples;
  const float* vm = value + (size_t)m * dim;
  const size_t row_stride = (size_t)heads * dim;
  // the warp's staging slots: LG x 4 corners x 32 lanes, a float4 each
  extern __shared__ float4 stage[];
  float4* slots =
      stage + (threadIdx.x >> 5) * (LG * 4 * 32) + (threadIdx.x & 31);
  Tally tally;
  for (int q0 = 0; q0 < quads; q0 += lm.g) {
    const int j = q0 + lm.sub;                     // this lane's quad
    const int nc = j < quads ? min(4, dim - 4 * j) : 0;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < points; p0 += lm.pc) {
      const int p = p0 + lm.pp;
      const bool point = p < points;
      const bool live = point && nc > 0;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int l0 = 0; l0 < lv.n; l0 += LG) {
        Corners c[LG];
        float a[LG];
#pragma unroll
        for (int i = 0; i < LG; ++i) {
          const int l = l0 + i;
          float2 xy = make_float2(0.f, 0.f);
          a[i] = 0.f;
          if (point) {
            xy = load_loc<kVec>(pl, l * points + p);
            a[i] = __ldg(pa + l * points + p);
          }
          c[i] = corners(xy.x, xy.y, lv.h[l], lv.w[l], lv.start[l]);
        }
        // every corner's quad into the lane's own slots, then one wait
#pragma unroll
        for (int i = 0; i < LG; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (live && c[i].row[k] >= 0) {
              stage_quad<kVec>(slots + (i * 4 + k) * 32,
                               vm + c[i].row[k] * row_stride + 4 * j, nc);
              tally.add(0, 4 * nc);
            }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < LG; ++i) {
          float v[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 t = slots[(i * 4 + k) * 32];
            v[k][0] = t.x; v[k][1] = t.y; v[k][2] = t.z; v[k][3] = t.w;
          }
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float tap = c[i].row[k] >= 0
                                    ? __fmul_rn(v[k][ch], c[i].wgt[k])
                                    : 0.f;
              s = k ? __fadd_rn(s, tap) : tap;
            }
            acc[ch] = __fadd_rn(acc[ch], __fmul_rn(s, a[i]));
          }
        }
      }
      // this pass's points, into the first lane group in order
      for (int k = 0; k < lm.pc && p0 + k < points; ++k) {
        const int src = (k << lm.g_log2) + lm.sub;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const float part = __shfl_sync(kFull, acc[ch], src);
          o[ch] = (p0 == 0 && k == 0) ? part : __fadd_rn(o[ch], part);
        }
      }
    }
    if (lm.pp == 0 && nc > 0)
      store_quad<kVec>(out + pair * dim + 4 * j, nc, o);
  }
  tally.flush();
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ms_deform_attn_bwd(const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad_value,
                       float* __restrict__ grad_loc,
                       float* __restrict__ grad_attn, const Levels lv,
                       int num_queries, int heads, int dim, int points,
                       int g_log2) {
  long long pair;
  int m;
  if (!warp_pair(num_queries, heads, &pair, &m)) return;  // whole warps
  const LaneMap lm(g_log2);
  const int quads = (dim + 3) >> 2;
  const int samples = lv.n * points;
  const float* pl = loc + pair * samples * 2;
  const float* pa = attn + pair * samples;
  const float* g_row = grad_out + pair * dim;
  const size_t col = (size_t)m * dim;
  const size_t row_stride = (size_t)heads * dim;
  Tally tally;
  for (int p0 = 0; p0 < points; p0 += lm.pc) {
    const int p = p0 + lm.pp;
    const bool point = p < points;
    for (int l = 0; l < lv.n; ++l) {
      float2 xy = make_float2(0.f, 0.f);
      float a = 0.f;
      if (point) {
        xy = load_loc<kVec>(pl, l * points + p);
        a = __ldg(pa + l * points + p);
      }
      const Corners c = corners(xy.x, xy.y, lv.h[l], lv.w[l], lv.start[l]);
      const float gx = 1.f - c.fx, gy = 1.f - c.fy;
      float sum_a = 0.f, sum_x = 0.f, sum_y = 0.f;
      for (int q0 = 0; q0 < quads; q0 += lm.g) {
        const int j = q0 + lm.sub;
        const int nc = j < quads ? min(4, dim - 4 * j) : 0;
        const bool live = point && nc > 0;
        float g[4] = {0.f, 0.f, 0.f, 0.f};
        float v[4][4];
        if (live) load_quad<kVec>(g_row + 4 * j, nc, g);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (live && c.row[k] >= 0) {
            load_quad<kVec>(value + c.row[k] * row_stride + col + 4 * j, nc,
                            v[k]);
            tally.add(0, 4 * nc);
          } else {
#pragma unroll
            for (int ch = 0; ch < 4; ++ch) v[k][ch] = 0.f;
          }
        }
        float ga[4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          float s = __fmul_rn(v[0][ch], c.wgt[0]);
#pragma unroll
          for (int k = 1; k < 4; ++k)
            s = __fadd_rn(s, __fmul_rn(v[k][ch], c.wgt[k]));
          sum_a += g[ch] * s;
          sum_x += g[ch] * (gy * (v[1][ch] - v[0][ch]) +
                            c.fy * (v[3][ch] - v[2][ch]));
          sum_y += g[ch] * (gx * (v[2][ch] - v[0][ch]) +
                            c.fx * (v[3][ch] - v[1][ch]));
          ga[ch] = __fmul_rn(g[ch], a);
        }
        if (!live) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.row[k] < 0) continue;
          const float contrib[4] = {
              __fmul_rn(ga[0], c.wgt[k]), __fmul_rn(ga[1], c.wgt[k]),
              __fmul_rn(ga[2], c.wgt[k]), __fmul_rn(ga[3], c.wgt[k])};
          red_quad<kVec>(grad_value + c.row[k] * row_stride + col + 4 * j,
                         nc, contrib);
          tally.add(1, kVec ? 1 : nc);
        }
      }
      // (l, p) summed over its lane group's quads; its first lane writes it
      for (int off = lm.g >> 1; off; off >>= 1) {
        sum_a += __shfl_xor_sync(kFull, sum_a, off);
        sum_x += __shfl_xor_sync(kFull, sum_x, off);
        sum_y += __shfl_xor_sync(kFull, sum_y, off);
      }
      if (point && lm.sub == 0) {
        const long long o = pair * samples + l * points + p;
        grad_attn[o] = sum_a;
        grad_loc[2 * o] = a * sum_x * (float)lv.w[l];
        grad_loc[2 * o + 1] = a * sum_y * (float)lv.h[l];
      }
    }
  }
  tally.flush();
}

bool make_levels(const int* heights, const int* widths, int num_levels,
                 Levels* lv) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  int start = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1) return false;
    lv->h[l] = heights[l];
    lv->w[l] = widths[l];
    lv->start[l] = start;
    start += heights[l] * widths[l];
  }
  lv->n = num_levels;
  return true;
}

// The launch shape of both kernels.
struct Plan {
  dim3 grid, block;
  int g_log2;                        // lanes a point: 1 << g_log2
  int group;                         // the forward's levels a group
  bool vec;                          // float4 quads, float2 locations
  size_t smem;                       // the forward's staging slots
};

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// The current device's SM count, read once a device
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};           // 0: not read yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached[device]) {
    *sms = cached[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) cached[device] = *sms;
  return err;
}

cudaError_t make_plan(int num_queries, int heads, int dim, int levels,
                      bool vec, Plan* plan) {
  const int quads = (dim + 3) / 4;
  plan->g_log2 = 0;
  while ((1 << plan->g_log2) < quads && plan->g_log2 < 5) ++plan->g_log2;
  plan->group = levels % kFwdGroup == 0 ? kFwdGroup : 1;
  plan->vec = vec && dim % 4 == 0;
  // 4 warps a block, fewer when the blocks would not fill the card twice
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  int warps = kMaxWarps;
  while (warps > 1 &&
         (long long)heads * ((num_queries + warps - 1) / warps) < 2LL * sms)
    warps >>= 1;
  const long long blocks =
      (long long)heads * ((num_queries + warps - 1) / warps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  plan->grid = dim3((unsigned)blocks);
  plan->block = dim3(warps * 32);
  plan->smem = (size_t)warps * plan->group * 4 * 32 * sizeof(float4);
  return cudaSuccess;
}

}  // namespace

// heights, widths: host arrays of num_levels entries. All tensors f32,
// contiguous, on the card; out [Q, M * D].
extern "C" int ms_deform_attn_launch(const void* value, const int* heights,
                                     const int* widths, int num_levels,
                                     const void* loc, const void* attn,
                                     void* out, int num_queries, int heads,
                                     int dim, int points, void* stream) {
  Levels lv;
  if (!make_levels(heights, widths, num_levels, &lv) || points < 1 ||
      points > kMaxPoints || heads < 1 || dim < 1 || num_queries < 0)
    return (int)cudaErrorInvalidValue;
  if (num_queries == 0) return 0;
  Plan plan;
  const bool vec = aligned(value, 16) && aligned(out, 16) && aligned(loc, 8);
  cudaError_t err =
      make_plan(num_queries, heads, dim, num_levels, vec, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define EODT_FWD(LG, VEC)                                                  \
  ms_deform_attn_fwd<LG, VEC><<<plan.grid, plan.block, plan.smem, s>>>(    \
      (const float*)value, (const float*)loc, (const float*)attn,          \
      (float*)out, lv, num_queries, heads, dim, points, plan.g_log2)
  if (plan.group == 2) {
    if (plan.vec) EODT_FWD(2, true); else EODT_FWD(2, false);
  } else {
    if (plan.vec) EODT_FWD(1, true); else EODT_FWD(1, false);
  }
#undef EODT_FWD
  return (int)cudaGetLastError();
}

// grad_value: a zeroed f32 [S, M, D] buffer; grad_loc [Q, M, L, P, 2] and
// grad_attn [Q, M, L, P] are written whole.
extern "C" int ms_deform_attn_backward_launch(
    const void* value, const int* heights, const int* widths, int num_levels,
    const void* loc, const void* attn, const void* grad_out, void* grad_value,
    void* grad_loc, void* grad_attn, int num_queries, int heads, int dim,
    int points, void* stream) {
  Levels lv;
  if (!make_levels(heights, widths, num_levels, &lv) || points < 1 ||
      points > kMaxPoints || heads < 1 || dim < 1 || num_queries < 0)
    return (int)cudaErrorInvalidValue;
  if (num_queries == 0) return 0;
  Plan plan;
  const bool vec = aligned(value, 16) && aligned(grad_out, 16) &&
                   aligned(grad_value, 16) && aligned(loc, 8);
  cudaError_t err =
      make_plan(num_queries, heads, dim, num_levels, vec, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
#define EODT_BWD(VEC)                                                      \
  ms_deform_attn_bwd<VEC><<<plan.grid, plan.block, 0, s>>>(                \
      (const float*)value, (const float*)loc, (const float*)attn,          \
      (const float*)grad_out, (float*)grad_value, (float*)grad_loc,        \
      (float*)grad_attn, lv, num_queries, heads, dim, points, plan.g_log2)
  if (plan.vec) EODT_BWD(true); else EODT_BWD(false);
#undef EODT_BWD
  return (int)cudaGetLastError();
}

#ifdef EODT_COUNT
// counts: a host array of 2, given the corner bytes gathered and the REDs
// issued since the last call, which zeroes them. Waits for the card.
extern "C" int ms_deform_attn_tally(unsigned long long* counts) {
  static const unsigned long long zero[2] = {0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(counts, g_tally, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_tally, zero, sizeof(zero));
  return (int)err;
}
#endif
