#!/usr/bin/env python3
"""Count what the memory read's and the ROIAlign forward's one-pass designs
ask of the card's caches, on the card, at the main path's shapes.

    python3 scripts/count_reads.py          # from the repository root

A counting build: two CUDA kernels with the launch geometry and the load
loops of the one-pass designs (memory read: one block per output cell,
a float4 of the f32 table per thread and tap, divided and rounded per
element; ROIAlign forward: one block per (ROI, output row), a bf16 pair
per thread and tap), which add up the bytes their loads request and the
divisions they issue instead of computing the result. The ROIAlign
counter also marks every level position a ROI's taps touch, so it reports
the distinct positions, and the distinct rows x distinct columns a staged
grid would hold. It is compiled with nvcc into a temporary directory that
is removed afterwards. The inputs are chip_smoke.py's (same seeds).
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>

// memory read, one block per output cell, threads own 4 channels
__global__ void count_read(const int* proj, int dim, int height, int width,
                           int pool, unsigned long long* totals,
                           unsigned int* seen) {
  const int out_w = width / pool;
  const int oy = blockIdx.x / out_w, ox = blockIdx.x % out_w;
  unsigned long long bytes = 0, divs = 0;
  for (int c = threadIdx.x; c < dim / 4; c += blockDim.x)
    for (int t = 0; t < pool * pool; ++t) { bytes += 16; divs += 4; }
  if (threadIdx.x < pool * pool) {
    const int id = proj[(oy * pool + threadIdx.x / pool) * width +
                        ox * pool + threadIdx.x % pool];
    atomicOr(seen + id / 32, 1u << (id % 32));
  }
  atomicAdd(totals + 0, bytes);
  atomicAdd(totals + 1, divs);
}

// ROIAlign forward, one block per ROI: the sample arithmetic of
// csrc/roi_align.cu; bytes as one block per (ROI, row) with a bf16 pair a
// thread and tap requests them; distinct positions, rows and columns
__global__ void count_roi(const float* boxes, const int* lvl,
                          const int* heights, const int* widths,
                          const float* strides, int channels, int out_size,
                          int s, unsigned long long* totals, int* per_roi) {
  __shared__ unsigned int pos[160 * 160 / 32];
  __shared__ unsigned int rows[8], cols[8];
  const int roi = blockIdx.x, l = lvl[roi];
  const int h = heights[l], w = widths[l];
  const float st = strides[l];
  for (int i = threadIdx.x; i < (h * w + 31) / 32; i += blockDim.x) pos[i] = 0;
  if (threadIdx.x < 8) rows[threadIdx.x] = cols[threadIdx.x] = 0;
  __syncthreads();
  const float* b = boxes + 4 * roi;
  const float x1 = __fdiv_rn(b[0], st), y1 = __fdiv_rn(b[1], st);
  const float bw = __fdiv_rn(__fsub_rn(__fdiv_rn(b[2], st), x1), (float)out_size);
  const float bh = __fdiv_rn(__fsub_rn(__fdiv_rn(b[3], st), y1), (float)out_size);
  const int n = out_size * s;
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) {
    const int py = k / n, px = k % n;
    float sy = __fsub_rn(__fadd_rn(y1, __fmul_rn(__fdiv_rn(__fadd_rn((float)py, 0.5f), (float)s), bh)), 0.5f);
    float sx = __fsub_rn(__fadd_rn(x1, __fmul_rn(__fdiv_rn(__fadd_rn((float)px, 0.5f), (float)s), bw)), 0.5f);
    sy = fminf(fmaxf(sy, 0.0f), (float)h - 1.0f);
    sx = fminf(fmaxf(sx, 0.0f), (float)w - 1.0f);
    const int y0 = (int)floorf(sy), x0 = (int)floorf(sx);
    const int ys[2] = {y0, min(y0 + 1, h - 1)}, xs[2] = {x0, min(x0 + 1, w - 1)};
    for (int a = 0; a < 2; ++a) {
      atomicOr(rows + ys[a] / 32, 1u << (ys[a] % 32));
      atomicOr(cols + xs[a] / 32, 1u << (xs[a] % 32));
      for (int c = 0; c < 2; ++c) {
        const int p = ys[a] * w + xs[c];
        atomicOr(pos + p / 32, 1u << (p % 32));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int distinct = 0, nr = 0, nc = 0;
    for (int i = 0; i < (h * w + 31) / 32; ++i) distinct += __popc(pos[i]);
    for (int i = 0; i < 8; ++i) { nr += __popc(rows[i]); nc += __popc(cols[i]); }
    per_roi[3 * roi] = distinct;
    per_roi[3 * roi + 1] = nr;
    per_roi[3 * roi + 2] = nc;
    // one block per output row, channels / 2 threads, each loading a bf16
    // pair per tap: 4 taps x s^2 samples x out_size columns a row
    atomicAdd(totals + 0, (unsigned long long)out_size * out_size * s * s *
                          4 * (channels / 2) * 4);
    atomicAdd(totals + 1, (unsigned long long)distinct * channels * 2);
  }
}

extern "C" int run_read(const void* proj, int dim, int height, int width,
                        int pool, void* totals, void* seen) {
  count_read<<<(height / pool) * (width / pool), 128>>>(
      (const int*)proj, dim, height, width, pool,
      (unsigned long long*)totals, (unsigned int*)seen);
  return (int)cudaGetLastError();
}

extern "C" int run_roi(const void* boxes, const void* lvl, const void* heights,
                       const void* widths, const void* strides, int rois,
                       int channels, int out_size, int s, void* totals,
                       void* per_roi) {
  count_roi<<<rois, 128>>>((const float*)boxes, (const int*)lvl,
                           (const int*)heights, (const int*)widths,
                           (const float*)strides, channels, out_size, s,
                           (unsigned long long*)totals, (int*)per_roi);
  return (int)cudaGetLastError();
}
"""


def build(tmp: Path):
    from embodied_object_detection_tpu_torch.kernels.build import nvcc
    src, lib = tmp / "count_reads.cu", tmp / "count_reads.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("count_reads: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    P = ctypes.c_void_p
    card = cs.smi("name,power.limit")
    print(card)
    result = {"card": card}
    with tempfile.TemporaryDirectory(prefix="count_reads_") as tmp:
        lib = build(Path(tmp))
        lib.run_read.argtypes = (P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, P, P)
        lib.run_roi.argtypes = (P, P, P, P, P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, P, P)
        rng = np.random.RandomState(123)
        feats, obs, proj = cs.memory_read_inputs(rng)
        for b in (1, 4):
            totals = torch.zeros(2, dtype=torch.int64, device="cuda")
            seen = torch.zeros(b * 8192 // 32, dtype=torch.int32,
                               device="cuda")
            for i in range(b):
                p = proj if i == 0 else torch.from_numpy(rng.randint(
                    0, 8192, (480, 640)).astype(np.int32)).cuda()
                assert lib.run_read(p.data_ptr(), 512, 480, 640, 4,
                                    totals.data_ptr(),
                                    seen[i * 256:].data_ptr()) == 0
            torch.cuda.synchronize()
            rows = int(sum(bin(x & 0xffffffff).count("1")
                           for x in seen.tolist()))
            out = b * 120 * 160 * 512 * 4
            req, divs = totals.tolist()
            result[f"memory_read B={b}"] = {
                "load_bytes_requested": req, "divisions": divs,
                "distinct_rows": rows, "f32_table_bytes": b * 8192 * 512 * 4,
                "output_bytes": out,
                "bytes_once": rows * 512 * 4 + out + b * 480 * 640 * 4}
        heights = torch.tensor([60, 30, 15], dtype=torch.int32, device="cuda")
        widths = torch.tensor([80, 40, 20], dtype=torch.int32, device="cuda")
        strides = torch.tensor([8.0, 16.0, 32.0], device="cuda")
        for r, size in ((256, 7), (100, 14), (512, 7)):
            _, boxes = cs.roi_inputs(rng, r, torch.bfloat16)
            lvl = cs.roi_levels(boxes)
            totals = torch.zeros(2, dtype=torch.int64, device="cuda")
            per = torch.zeros((r, 3), dtype=torch.int32, device="cuda")
            assert lib.run_roi(boxes.data_ptr(), lvl.data_ptr(),
                               heights.data_ptr(), widths.data_ptr(),
                               strides.data_ptr(), r, 256, size, 2,
                               totals.data_ptr(), per.data_ptr()) == 0
            torch.cuda.synchronize()
            per = per.cpu().numpy()
            grid = per[:, 1] * per[:, 2]
            req, distinct_bytes = totals.tolist()
            result[f"roi_align R={r} {size}x{size}"] = {
                "tap_bytes_requested": req,
                "distinct_position_bytes": distinct_bytes,
                "taps_per_roi": size * size * 4 * 4,
                "distinct_positions_min_median_max": [
                    int(per[:, 0].min()), float(np.median(per[:, 0])),
                    int(per[:, 0].max())],
                "rows_x_cols_min_median_max": [
                    int(grid.min()), float(np.median(grid)),
                    int(grid.max())]}
    for k, v in result.items():
        print(f"{k}: {v}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
