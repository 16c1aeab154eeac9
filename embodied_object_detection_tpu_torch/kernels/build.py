"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
`build/` at the repository root, named by a hash of the source and the
flags so that an edited source is never served from a stale library.
Nothing here runs at import time: `load` builds on first use, and
`build` compiles several sources at once with one nvcc process each.

The entry point of every library takes device pointers and the CUDA
stream as `void*`, launches on that stream, and returns
`cudaGetLastError()`; the Python wrapper raises when it is not 0.
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

_P = ctypes.c_void_p
_I = ctypes.c_int
# source name -> (C symbol, argtypes); every pointer and the stream is void*
ENTRY_POINTS = {
    # (w, idx, out, rows, lanes, num_cells, stream)
    "segment_sum": ("segment_sum_launch",
                    (_P, _P, _P, ctypes.c_longlong, _I, _I, _P)),
    # (features, obs_count, proj, out, dim, height, width, pool, stream)
    "memory_read": ("memory_read_launch",
                    (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
}


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


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(ENTRY_POINTS)
          ) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Returns {name: (seconds, compiler log)}
    for the sources it compiled; raises if any compile failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
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
def load(name: str):
    """The ctypes entry point of kernel `name`, built on first use."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available: the {name} kernel runs only on the card")
    if torch.cuda.get_device_capability() != (9, 0):
        raise RuntimeError(
            f"the {name} kernel is built for sm_90a (Hopper); this card is "
            f"sm_{''.join(map(str, torch.cuda.get_device_capability()))}")
    build((name,))
    symbol, argtypes = ENTRY_POINTS[name]
    fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
