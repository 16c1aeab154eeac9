"""Build and ctypes-bind the host evaluator core, `eval_core.cc`.

Compiled with the system g++ on first use (never at import), into the
repository's `build/` beside the CUDA kernels' libraries (see
`kernels/build.py`), never into the package directory. The library's name
carries a hash of the source, so a stale or foreign binary is never
loaded; flags are portable (-O3, no -march=native). Plain C ABI and
ctypes, no pybind11. Set EODT_NO_NATIVE=1 to force the numpy evaluator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "eval_core.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"_eval_core_{digest}.so"


class EvalCore:
    """numpy-friendly wrappers over the C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.iou_xywh.argtypes = [_f64, ctypes.c_int64, _f64, ctypes.c_int64,
                                 _f64]
        lib.greedy_match.argtypes = [_f64, ctypes.c_int64, ctypes.c_int64,
                                     _u8, _f64, ctypes.c_int64,
                                     _i64, _i64, _u8]
        lib.precision_at_recall.argtypes = [_f64, _f64, ctypes.c_int64,
                                            ctypes.c_double, _f64,
                                            ctypes.c_int64, _f64]
        lib.evaluate_category.argtypes = [
            _f64, _f64, _i64, _i64, _f64, _f64, _i64, ctypes.c_int64,
            _f64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, _f64, _i64, _u8, _i64]
        lib.evaluate_category.restype = ctypes.c_int64

    def iou_xywh(self, dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
        dets = np.ascontiguousarray(dets, np.float64).reshape(-1, 4)
        gts = np.ascontiguousarray(gts, np.float64).reshape(-1, 4)
        out = np.zeros((len(dets), len(gts)), np.float64)
        if len(dets) and len(gts):
            self._lib.iou_xywh(dets, len(dets), gts, len(gts), out)
        return out

    def greedy_match(self, ious: np.ndarray, g_ignore: np.ndarray,
                     thrs: np.ndarray):
        """COCOeval.evaluateImg's greedy matching of one (image, category)
        at every threshold: ious [D, G] with detections score-sorted and
        gts non-ignored first -> (dt_m [T, D] matched gt index + 1, gt_m
        [T, G] matched detection index + 1, dt_ig [T, D] bool)."""
        ious = np.ascontiguousarray(ious, np.float64)
        nd, ng = ious.shape
        g_ignore = np.ascontiguousarray(g_ignore, np.uint8).reshape(-1)
        thrs = np.ascontiguousarray(thrs, np.float64).reshape(-1)
        nt = len(thrs)
        dt_m = np.zeros((nt, nd), np.int64)
        gt_m = np.zeros((nt, ng), np.int64)
        dt_ig = np.zeros((nt, nd), np.uint8)
        self._lib.greedy_match(ious, nd, ng, g_ignore, thrs, nt,
                               dt_m, gt_m, dt_ig)
        return dt_m, gt_m, dt_ig.astype(bool)

    def evaluate_category(self, g_boxes, g_areas, g_ids, g_off, d_boxes,
                          d_scores, d_off, thrs, area_rng, max_dets: int):
        """One category's COCOeval.evaluateImg sweep over every image in
        one call: concatenated per-image xywh boxes with global annotation
        ids and prefix offsets in; (scores [N], dt_m [T, N], dt_ig [T, N],
        n_gt) out, N the max_dets-capped detections in image order, each
        image's sorted by descending score. dt_m holds the matched gt's
        annotation id (0 = unmatched, aliasing annotation id 0 as
        pycocotools does)."""
        g_boxes = np.ascontiguousarray(g_boxes, np.float64).reshape(-1, 4)
        g_areas = np.ascontiguousarray(g_areas, np.float64).reshape(-1)
        g_ids = np.ascontiguousarray(g_ids, np.int64).reshape(-1)
        g_off = np.ascontiguousarray(g_off, np.int64)
        d_boxes = np.ascontiguousarray(d_boxes, np.float64).reshape(-1, 4)
        d_scores = np.ascontiguousarray(d_scores, np.float64).reshape(-1)
        d_off = np.ascontiguousarray(d_off, np.int64)
        thrs = np.ascontiguousarray(thrs, np.float64).reshape(-1)
        n_imgs = len(g_off) - 1
        nt = len(thrs)
        nd_cap = int(np.minimum(np.diff(d_off), max_dets).sum())
        scores = np.zeros(nd_cap, np.float64)
        dt_m = np.zeros((nt, nd_cap), np.int64)
        dt_ig = np.zeros((nt, nd_cap), np.uint8)
        n_gt = np.zeros(1, np.int64)
        written = self._lib.evaluate_category(
            g_boxes, g_areas, g_ids, g_off, d_boxes, d_scores, d_off,
            n_imgs, thrs, nt, float(area_rng[0]), float(area_rng[1]),
            int(max_dets), nd_cap, scores, dt_m, dt_ig, n_gt)
        if written != nd_cap:
            raise RuntimeError(f"eval core wrote {written} of {nd_cap} "
                               "detections")
        return scores, dt_m, dt_ig.astype(bool), int(n_gt[0])

    def precision_at_recall(self, tp: np.ndarray, fp: np.ndarray,
                            n_gt: float, rec_thrs: np.ndarray) -> np.ndarray:
        tp = np.ascontiguousarray(tp, np.float64).reshape(-1)
        fp = np.ascontiguousarray(fp, np.float64).reshape(-1)
        rec_thrs = np.ascontiguousarray(rec_thrs, np.float64).reshape(-1)
        out = np.zeros(len(rec_thrs), np.float64)
        self._lib.precision_at_recall(tp, fp, len(tp), float(n_gt),
                                      rec_thrs, len(rec_thrs), out)
        return out


def _build(so: Path) -> bool:
    """Compile to a process-unique name, then rename into place, so that
    concurrent processes never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


_CACHE: dict = {}


def load_eval_core() -> Optional[EvalCore]:
    """Build (if needed) and bind the core, once a process. None when
    disabled or when the toolchain or the build is unavailable."""
    if os.environ.get("EODT_NO_NATIVE"):
        return None
    if "core" not in _CACHE:
        core = None
        so = library_path()
        try:
            if so.exists() or _build(so):
                core = EvalCore(ctypes.CDLL(str(so)))
        except OSError:
            core = None
        _CACHE["core"] = core
    return _CACHE["core"]
