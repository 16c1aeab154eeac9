#!/usr/bin/env python3
"""Measure how fast the card's L2 adds f32 reductions into a buffer that
stays in L2: the rows kernel 9b adds into grad_x at chip_smoke.py's phase
13 level 60 x 80 x 256 (modulated; one row of Cin f32 a valid corner of
each (pixel, tap), 1 KB), issued three ways by a small CUDA program built
here with nvcc:

- float4 REDs: a warp a row, atomicAdd on a float4 a lane (9b's form);
- scalar REDs: a warp a row, atomicAdd on a float a lane, 32 contiguous
  floats a warp instruction (9b's form before its redesign);
- bulk reductions: a warp a row, the row staged in shared memory and added
  by one TMA cp.reduce.async.bulk ... add.f32.

    python3 scripts/red_rate.py

Each form is timed with CUDA events over 20 launches after a warm-up, and
its sums are checked once against the row counts. Prints one JSON line:
rows, bytes a launch, microseconds a launch and TB/s of reduced data for
each form, and the card's name and power limit.
"""

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

SOURCE = r'''
#include <cuda_runtime.h>

// rows[e] names the row of out (cin f32, cin % 4 == 0) that entry e adds
// 1.0 to in every channel; a warp an entry, grid-strided
__global__ void red_float4(float* out, const int* rows, int n, int cin) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * blockDim.x / 32;
  for (int e = (blockIdx.x * blockDim.x + threadIdx.x) / 32; e < n;
       e += warps) {
    float4* row = reinterpret_cast<float4*>(out + (long long)rows[e] * cin);
    for (int q = lane; q < cin / 4; q += 32)
      atomicAdd(row + q, make_float4(1.f, 1.f, 1.f, 1.f));
  }
}

__global__ void red_scalar(float* out, const int* rows, int n, int cin) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * blockDim.x / 32;
  for (int e = (blockIdx.x * blockDim.x + threadIdx.x) / 32; e < n;
       e += warps) {
    float* row = out + (long long)rows[e] * cin;
    for (int c = lane; c < cin; c += 32) atomicAdd(row + c, 1.f);
  }
}

// two row buffers a warp in shared memory: a buffer is refilled once the
// bulk reduction issued from it two rows before has read it
constexpr int kMaxCin = 512;
__global__ void red_bulk(float* out, const int* rows, int n, int cin) {
  __shared__ __align__(128) float buf[8][2][kMaxCin];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = gridDim.x * blockDim.x / 32;
  int step = 0;
  for (int e = (blockIdx.x * blockDim.x + threadIdx.x) / 32; e < n;
       e += warps, ++step) {
    float* b = buf[warp][step & 1];
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncwarp();
    for (int c = lane; c < cin; c += 32) b[c] = 1.f;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      float* dst = out + (long long)rows[e] * cin;
      const unsigned src = (unsigned)__cvta_generic_to_shared(b);
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
          " [%0], [%1], %2;" :: "l"(dst), "r"(src), "r"(cin * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

extern "C" int red_rows(void* out, const void* rows, int n, int cin,
                        int form, void* stream) {
  if (cin % 4 != 0 || cin > kMaxCin) return (int)cudaErrorInvalidValue;
  const int blocks = 132 * 8, threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0)
    red_float4<<<blocks, threads, 0, s>>>((float*)out, (const int*)rows, n, cin);
  else if (form == 1)
    red_scalar<<<blocks, threads, 0, s>>>((float*)out, (const int*)rows, n, cin);
  else
    red_bulk<<<blocks, threads, 0, s>>>((float*)out, (const int*)rows, n, cin);
  return (int)cudaGetLastError();
}
'''

FORMS = ("float4_red", "scalar_red", "bulk_reduce")


def build_library():
    """The program's shared library under build/, named by a hash of the
    source and the flags."""
    from embodied_object_detection_tpu_torch.kernels import build
    digest = hashlib.sha256((SOURCE + " ".join(build.NVCC_FLAGS)).encode())
    out = build.BUILD_DIR / f"red_rate-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(SOURCE)
        done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if done.returncode:
            raise RuntimeError(f"red_rate: nvcc failed:\n{done.stdout}"
                               f"{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.red_rows.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    return lib


def corner_rows(smoke, torch):
    """The grad_x row of every valid corner at phase 13's largest level,
    modulated, in the order 9b issues them ((pixel, tap), then corner)."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    block = smoke.dcn_blocks()[True]
    x, _ = smoke.dcn_level_inputs(np.random.RandomState(13))[0]
    off, _ = smoke.dcn_offsets(block, x)
    h, w, cin = x.shape
    y0, x0, _, _ = dc._sample_corners(off, 3, 3, block.stride,
                                      block.padding, block.dilation)
    rows = []
    for dy, dx in dc.CORNERS:
        yy, xx = y0.long() + dy, x0.long() + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        rows.append(torch.where(ok, yy * w + xx, -1).reshape(-1))
    rows = torch.stack(rows, -1).reshape(-1)
    return rows[rows >= 0].int().contiguous(), h * w, cin


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("red_rate: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    lib = build_library()
    rows, pixels, cin = corner_rows(smoke, torch)
    n = rows.numel()
    want = torch.bincount(rows.long(), minlength=pixels).float()[:, None] \
        .expand(pixels, cin)
    out = torch.zeros(pixels, cin, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"rows": n, "row_bytes": cin * 4, "bytes": n * cin * 4}
    for form, name in enumerate(FORMS):
        out.zero_()
        if lib.red_rows(out.data_ptr(), rows.data_ptr(), n, cin, form,
                        stream):
            raise RuntimeError(f"red_rate: {name} failed to launch")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"red_rate: {name} summed wrongly")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            lib.red_rows(out.data_ptr(), rows.data_ptr(), n, cin, form,
                         stream)
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) * 1e3 / 20
        result[f"{name}_us"] = us
        result[f"{name}_tb_s"] = n * cin * 4 / us / 1e6
    result["card"] = smoke.smi("name,power.limit")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
