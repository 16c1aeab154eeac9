"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<source>.cu` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
`build/` at the repository root, named by a hash of the source and the
flags so that an edited source is never served from a stale library.
Nothing here runs at import time: `load` builds on first use, and
`build` compiles several sources at once with one nvcc process each.
A source may also have a counting build (`counting=True`: compiled with
COUNT_FLAGS), whose kernels also count what they issue; it is a library of
its own, used only to measure, never on a wrapper's path.

The entry point of every library takes device pointers (and, for the
ROIAlign's per-level arguments, pointers to small host arrays), ints,
floats and the CUDA stream as `void*`, launches on that stream, and
returns `cudaGetLastError()`; the Python wrapper raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
COUNT_FLAGS = ("-DEODT_COUNT",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernel name -> (C symbol, argtypes); every pointer and the stream is void*.
# A kernel's source is csrc/<name>.cu unless SOURCES names another.
ENTRY_POINTS = {
    # (w, idx, out, rows, lanes, padded out lanes, num_cells, stream)
    "segment_sum": ("segment_sum_launch",
                    (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P)),
    # (features, obs_count, proj, bf16 table scratch, out, dim, height,
    #  width, pool, batch, cells, stream)
    "memory_read": ("memory_read_launch",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    # (boxes, classes, valid, mask scratch, int32 scratch, keep, n,
    #  threshold, disabled, stream)
    "nms": ("nms_launch", (_P, _P, _P, _P, _P, _P, _I, _F, _I, _P)),
    # (host arrays: level pointers, heights, widths, strides; num_levels,
    #  boxes, level_ids, out, num_rois, channels, out_size, sampling_ratio,
    #  is_bf16, stats (null or int32 [num_rois, 3]), stream)
    "roi_align": ("roi_align_launch",
                  (_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                   _P)),
    # (masks, boxes, out, n, m, height, width, x_stride, threshold,
    #  pixel_major, valid, observed, tile counts (the last three null, or
    #  the exact write's flags), stream)
    "mask_paste": ("mask_paste_launch",
                   (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P)),
    # (masks, valid, proj, observed, counts, seg_idx, aug, height, width,
    #  n, subsample, count_cols, flags_given (else observed and counts are
    #  scratch for the first pass), stream)
    "write_select": ("write_select_launch",
                     (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P)),
    # (host arrays: f32 level gradients, heights, widths, strides;
    #  num_levels, boxes, level_ids, grad_out, num_rois, channels,
    #  out_size, sampling_ratio, is_bf16, stream)
    "roi_align_backward": ("roi_align_backward_launch",
                           (_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P)),
    # (value, host arrays: heights, widths; num_levels, locations,
    #  attention weights, out, queries, heads, channels, points, stream)
    "ms_deform_attn": ("ms_deform_attn_launch",
                       (_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P)),
    # (value, host arrays: heights, widths; num_levels, locations,
    #  attention weights, grad_out, grad_value (zeroed), grad_loc,
    #  grad_attn, queries, heads, channels, points, stream)
    "ms_deform_attn_backward": ("ms_deform_attn_backward_launch",
                                (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _P)),
    # (grad_out, obs_count, proj, grad_features (zeroed f32 [B * cells,
    #  D], finished in place), dim, height, width, pool, batch, cells,
    #  stream)
    "memory_read_backward": ("memory_read_backward_launch",
                             (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    # (x, offset, mask (null for DCNv1), columns, height, width, in
    #  channels, out height, out width, kernel h, kernel w, stride,
    #  padding, dilation, stream)
    "deform_im2col": ("deform_im2col_launch",
                      (_P, _P, _P, _P) + (_I,) * 10 + (_P,)),
    # (x, offset, mask, grad_columns, grad_x (zeroed), grad_offset,
    #  grad_mask (null without a mask), the same ten ints, stream)
    "deform_im2col_backward": ("deform_im2col_backward_launch",
                               (_P,) * 7 + (_I,) * 10 + (_P,)),
}
# the ROIAlign backward shares the forward's sample table, the deformable
# attention's backward its corner arithmetic, the read's transpose its
# source, the deformable convolution's kernels one source
SOURCES = {"roi_align_backward": "roi_align",
           "ms_deform_attn_backward": "ms_deform_attn",
           "memory_read_backward": "memory_read",
           "deform_im2col": "deform_conv",
           "deform_im2col_backward": "deform_conv"}


def source(name: str) -> str:
    """The `csrc/<source>.cu` that holds kernel `name`."""
    return SOURCES.get(name, name)


def on_card(t: torch.Tensor) -> bool:
    """True when a wrapper must launch its kernel for `t`, False when it
    takes the plain PyTorch version (a CPU tensor). Any other device has
    neither, and raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _flags(counting: bool) -> Tuple[str, ...]:
    return NVCC_FLAGS + COUNT_FLAGS if counting else NVCC_FLAGS


def library_path(name: str, counting: bool = False) -> Path:
    """The library of kernel `name`'s source (its counting build when
    `counting`)."""
    src = source(name)
    text = (CSRC / f"{src}.cu").read_bytes()
    digest = hashlib.sha256(
        text + " ".join(_flags(counting)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src}{'-count' if counting else ''}-{digest}.so"


def build(names: Iterable[str] = tuple(ENTRY_POINTS),
          counting: Iterable[str] = ()) -> Dict[str, Tuple[float, str]]:
    """Compile the source of every named kernel whose library is missing,
    and the counting build of every kernel in `counting`, all nvcc
    processes started together. Returns {source (with " (counting)" for a
    counting build): (seconds, compiler log)} for the libraries it
    compiled; raises if any compile failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    running = {}
    jobs = [(n, False) for n in map(source, names)] + \
        [(n, True) for n in map(source, counting)]
    for name, count in dict.fromkeys(jobs):
        out = library_path(name, count)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *_flags(count), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        key = f"{name} (counting)" if count else name
        running[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        report[name] = (time.perf_counter() - start, log)
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


@functools.cache
def library(name: str, counting: bool = False) -> ctypes.CDLL:
    """The library of kernel `name` (its counting build when `counting`),
    built on first use."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available: the {name} kernel runs only on the card")
    if torch.cuda.get_device_capability() != (9, 0):
        raise RuntimeError(
            f"the {name} kernel is built for sm_90a (Hopper); this card is "
            f"sm_{''.join(map(str, torch.cuda.get_device_capability()))}")
    if counting:
        build((), counting=(name,))
    else:
        build((name,))
    return ctypes.CDLL(str(library_path(name, counting)))


@functools.cache
def load(name: str):
    """The ctypes entry point of kernel `name`, built on first use."""
    symbol, argtypes = ENTRY_POINTS[name]
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
