#!/usr/bin/env python3
"""Drive the torch port on one CUDA card, end to end, and check it.

Run from the repository root:

    python3 chip_smoke.py                  # needs one card
    python3 chip_smoke.py --profile DIR    # also profile one eval chunk and
                                           # one training step into DIR

Phases (each prints its own lines; any failure exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions
  2. build every kernel from csrc/, one nvcc per source, all at once
  3. the segment-sum kernel against its plain version at the memory
     write's shapes, with out-of-range ids, on random ids, coherent ids
     (16 x 16-pixel squares share a cell, so runs of rows and the rows of
     neighbouring image rows share cells) and a one-cell worst case
  4. the memory-read kernel against its plain version at the read's
     shapes, on random and coherent ids
  4a. the NMS kernels against the plain fixpoint: proposal NMS (1024
     candidates, class-agnostic, t = 0.9, and t = 0 with the ml_nms
     bypass) and the multiclass NMS (2048 candidates of 20 classes,
     t = 0.5), with tied scores, duplicated boxes and a suppression chain
     deeper than 64; then the class partition's cases: classes of 0, 1,
     63, 64, 65 and 130 members (segments starting mid-word) at t = 0.5,
     0.9 and 0, the chain among other classes, every candidate in one
     class, and class ids beyond the partition's bins; keep sets must be
     equal
  4b. the ROIAlign kernel against the plain tap form (v1, f32) and the
     plain separable form (v4, bf16) at the box pooler's (R = 256, 7 x 7)
     and the mask pooler's (R = 100, 14 x 14) shapes over p3-p5, then
     ROIs under one level pixel, a whole level, and ROIs whose staged tap
     grid is taken in bands; the staged grid sizes (min, median, max) and
     the banded ROIs, as the kernel reports them
  4c. the mask-paste kernel against its plain version at 100 masks into
     480 x 640, flips at the 0.5 threshold counted and bounded; then 1 and
     130 masks, thresholds 0 and -1, boxes wholly outside the image and
     one covering it, pixel-major and mask-major (x_stride 8)
  4d. the exact write's selection: the mask paste with its observed-flag
     epilogue and the selection on its flags (the frame's path) against
     the plain paste, its flags and the plain selection, on 100 masks at
     0.5 with an empty and a full image row and invalid detections, 99
     masks (N % 4 != 0), 130 masks (two passes) and threshold 0: masks
     within the paste's flip bound, and flags, counts, ids and rows equal
     in every element; then the two-pass selection (masks only) against
     its plain version on pasted masks with an empty and a full row
  4e. the batched memory-read kernel (B = 4) against four single reads:
     equal in every element
  4f. the ROIAlign backward kernel (R = 512, 7 x 7 x 256, then ROIs under
     one level pixel, a whole level, beyond the image and wide ahead of 64
     random ROIs) in f32 within contributions x 2^-24 x sum|contribution|
     per element of the exact (f64) sum of the plain tap form's f32
     contributions, which any summation order keeps (at R = 512 also of
     torch autograd of the plain tap form on the CPU), and in bf16 within
     2^-8 |ref| + (1 + 2^-8) contributions x 2^-24 x sum|contribution| of
     the exact sum of the bf16 gradient's contributions and within
     (contributions + 1) x 2^-8 x sum|contribution| of the card's plain
     v1 autograd in bf16; the vector atomics its flush issues (each
     distinct position a ROI touches, once per 4 channels) beside the
     scalar atomics of a kernel that adds every tap
  5. the eval path: the default config (480x640, ResNet-50, 8192 x 512
     memory, 300 detections, write top-100, bf16) with seeded weights,
     one chunk of frames through `make_episode_runner` with the memory
     carried; the warm-up chunk runs under the sync debug mode "warn" and
     lists any synchronising call, the counted chunk under "error" (the
     frame must not synchronise with the host); kernel launch counts are
     zeroed just before the counted run and read just after it, and each
     kernel must have launched its expected count per frame
  5b. the episode modes at the same config: the longterm protocol, the
     pipelined runner, the batched runner (B = 2 streams, one starting
     from a carried memory) and the semantic_gt baseline on a class
     table; each once under the sync debug mode "warn" and once under
     "error" with its launches counted (semantic_gt: no write kernel, the
     table unchanged bit for bit)
  6. the card against the plain CPU path on a small config; 6b the same
     under the longterm protocol over 3 frames
  10. the evaluation engine (`engine.eval.evaluate_dataset`) at the
     default config over 8 in-memory chunks of 20 synthetic frames (2
     scenes x 4 chunks, a 110 x 57-cell map, every 5th frame scored):
     32 images, overall and quartile AP (random weights), the data /
     compute / eval seconds a chunk and frames/s, which evaluator ran
     (the native C++ core or numpy), each kernel's launches a frame
     (counts zeroed just before the run, read just after; equal to phase
     5's), and the host syncs of the run under the sync debug mode "warn"
     (the chunk end and the scored detections' copy, none in a frame);
     then the runner alone over the engine's timed chunks, their inputs
     on the card, beside the engine's compute a frame
  10b. the same protocol at the 64x96 f32 miniature (2 scenes x 2
     chunks x 10 frames) on the card and on the CPU, for the image-only
     preset "pretrained" and for "implicit_object_memory" under the exact
     and the strided write, with the mask logits shifted by +2 on both
     (so that few pasted pixels sit at 0.5) and each CPU chunk started
     from the card's memory: equal images and quartiles; each scored
     image's detections unless a mask-paste flip (within 1e-5 of 0.5, or
     between the two devices' inputs) precedes it in its chunk (a
     chunk's first frame within phase 6's tolerances, a later one within
     the frame tests' episode tolerance, rtol 1e-3); the memories of each
     chunk without a flip within 1e-3 of each cell's norm; overall AP
     within 0.1 points where every image was held; images that read a
     memory their scene wrote among those held; and `semmap_classes` of
     the last chunk's first memory equal on both devices but for
     near-tied logits
  7. each kernel's device time beside its plain version, the PyTorch
     library call where one exists (the memory reads: one
     F.embedding_bag(mean) on a table prepared beforehand), and its bound;
     the segment-sum and the memory read also on coherent ids;
     the ROIAlign forward also at the training shape (R = 512, 7 x 7); the
     mask paste with its flag epilogue (the JSON entry) and without it,
     the selection on the paste's flags (the JSON entry) and the two-pass
     selection on masks alone
  8. the training path: the default config with seeded weights, 3 AdamW
     steps at B = 4 frames (2 chunks x 2 frames) of synthetic batches
     through `engine.train.train`; every loss finite, ms per step, peak
     device memory, each kernel's launches a step (counts zeroed just
     before the run, read just after), then one more step under the sync
     debug mode "warn" listing any synchronising call
  9. one training step at the 64x96 f32 miniature on the card against
     the same step on the CPU: losses, gradients and updated parameters

With --profile, phases 5, 8 and 10 also print each port kernel's device
time a call in the profiled chunk, step and engine run (10: the engine
over its first 2 chunks), the mask paste + write selection a frame, and
the device's busy time a frame.

It then prints one JSON line of kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a card, or without the rest of
the repository beside it, it exits non-zero before printing a result.
"""

import argparse
import collections
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
T_FRAMES = 4
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# launches of each kernel in one frame of the eval path: proposal, final
# and write NMS; three cascade stages and the mask pooler
LAUNCHES_PER_FRAME = {"segment_sum": 1, "memory_read": 1, "nms": 3,
                      "roi_align": 4, "mask_paste": 1, "write_select": 1}
TRAIN_FRAMES = 4        # B: ims_per_batch 2 x 2 frames a chunk
TRAIN_STEPS = 3
# launches of each kernel in one training step: one batched read, then per
# frame the proposal NMS and three cascade stages' pooling and its backward
LAUNCHES_PER_STEP = {"memory_read_batched": 1, "nms": TRAIN_FRAMES,
                     "roi_align": 3 * TRAIN_FRAMES,
                     "roi_align_backward": 3 * TRAIN_FRAMES}
STRIDES = (8, 16, 32)
LEVEL_SHAPES = ((60, 80), (30, 40), (15, 20))     # p3-p5 at 480x640
COHERENT_BLOCK = 16     # pixels a side of the squares that share a cell
# launches a frame with an external GT memory: no write, so no write NMS,
# mask pooler, paste, selection or segment-sum
LAUNCHES_PER_FRAME_EXTERNAL = {"segment_sum": 0, "memory_read": 1, "nms": 2,
                               "roi_align": 3, "mask_paste": 0,
                               "write_select": 0}


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call: `reps` calls captured in a CUDA graph
    (no host launch overhead in the timing), replayed `replays` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def event_ms(fn, reps: int = 20) -> float:
    """Time of one fn() call from CUDA events around `reps` eager calls,
    host waits included: for a plain version that synchronises with the
    host and so cannot be captured in a graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_counters():
    """Kernel name -> the wrapper whose `launches` counts its launches."""
    from embodied_object_detection_tpu_torch.ops import (
        mask_paste, memory_ops, nms, roi_align, segment_sum)
    return {"segment_sum": segment_sum.segment_sum,
            "memory_read": memory_ops.memory_read,
            "nms": nms.nms_keep,
            "roi_align": roi_align.roi_align_cuda,
            "roi_align_backward": roi_align.roi_align_backward_cuda,
            "mask_paste": mask_paste.paste_masks,
            "memory_read_batched": memory_ops.memory_read_batched,
            "write_select": memory_ops.write_select}


def zero_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(n: int, text: str) -> None:
    print(f"[phase {n}] {text}", flush=True)


# ------------------------------------------------------------------ phases

def build_kernels():
    from embodied_object_detection_tpu_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    for name, (secs, log) in report.items():
        print(f"  built {name} in {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    phase(2, f"kernels ready in {time.perf_counter() - t0:.1f} s "
             f"({len(report)} of "
             f"{len(set(map(build.source, build.ENTRY_POINTS)))} sources "
             f"compiled, {len(build.ENTRY_POINTS)} entry points)")


def coherent_proj(rng, h=480, w=640, cells=8192, block=COHERENT_BLOCK):
    """Cell ids where each block x block square of pixels shares a cell
    (the blocks' cells drawn without repeats), as a real projection's
    neighbouring pixels share their floor cell."""
    by, bx = -(-h // block), -(-w // block)
    cell = rng.permutation(cells)[:by * bx].reshape(by, bx)
    return np.ascontiguousarray(np.repeat(np.repeat(cell, block, 0), block,
                                          1)[:h, :w]).astype(np.int32)


def segment_sum_inputs(rng, ids="random"):
    """Weights-plus-count rows like the memory write's: each selected pixel
    is covered by 1-3 of the 100 masks (weight 1/c each) and carries a
    count of 1; unselected slots carry id -1. `ids`: "random" cells,
    "coherent" (slot j of image row y is pixel (y, 8j) of a
    `coherent_proj`, so runs of slots and the slots of neighbouring image
    rows share cells) or "one_cell"."""
    rows, n, cells = 480 * 80, 100, 8192
    w = np.zeros((rows, n + 1), np.float32)
    cover = rng.randint(1, 4, rows)
    lanes = np.argsort(rng.rand(rows, n), axis=1)[:, :3]   # distinct masks
    for c in (1, 2, 3):
        r = np.flatnonzero(cover == c)
        w[r[:, None], lanes[r, :c]] = 1.0 / c
    w[:, n] = 1.0
    if ids == "one_cell":
        idx = np.full(rows, 5, np.int32)
    elif ids == "coherent":
        idx = coherent_proj(rng)[:, ::8].reshape(-1).copy()
    else:
        idx = rng.randint(0, cells, rows).astype(np.int32)
    idx[rng.rand(rows) < 0.1] = -1
    idx[rng.rand(rows) < 0.02] = cells + 7
    return (torch.from_numpy(w).cuda(), torch.from_numpy(idx).cuda(), cells)


def check_segment_sum(rng):
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss
    worst = 0.0
    for ids in ("random", "coherent", "one_cell"):
        w, idx, cells = segment_sum_inputs(rng, ids)
        got = ss.segment_sum(w, idx, cells)
        want = ss.segment_sum_plain(w, idx, cells)
        torch.cuda.synchronize()
        keep = (idx >= 0) & (idx < cells)
        rows_in_cell = torch.bincount(idx[keep].long(), minlength=cells)
        abs_sum = ss.segment_sum_plain(w.abs(), idx, cells)
        bound = rows_in_cell[:, None] * 2.0 ** -24 * abs_sum + 1e-7
        err = (got - want).abs()
        if got.shape != want.shape or not bool((err <= bound).all()):
            raise AssertionError(f"segment_sum disagrees: max err "
                                 f"{float(err.max())} ({ids} ids)")
        if not torch.equal(got[:, -1], rows_in_cell.float()):
            raise AssertionError(f"segment_sum count lane is not exact "
                                 f"({ids} ids)")
        worst = max(worst, float(err.max()))
        runs = int((idx[1:] != idx[:-1]).sum()) + 1
        print(f"  {ids} ids ({runs} runs of equal ids in {idx.numel()} "
              f"rows): max |kernel - plain| = {float(err.max()):.3e}, "
              f"count lane exact")
    phase(3, "segment_sum agrees with its plain version on random, coherent "
             "and one-cell ids (tolerance: rows in the cell * 2^-24 * "
             "sum|w| per entry; count lane exact)")
    return worst


def memory_read_inputs(rng):
    feats = torch.from_numpy(
        (rng.randn(8192, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(
        rng.choice([0.0, 1.0, 2.0, 5.0], 8192).astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    return feats, obs, proj


def check_memory_read(rng):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats, obs, proj = memory_read_inputs(rng)
    errs = []
    for p in (proj, torch.from_numpy(coherent_proj(rng)).cuda()):
        got = memory_ops.memory_read(feats, obs, p)
        want = memory_ops.memory_read_plain(feats, obs, p)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    phase(4, f"memory_read agrees with its plain version on random and "
             f"coherent ids: max err {errs[0]:.3e} and {errs[1]:.3e} "
             f"(tolerance rtol 1e-6, atol 1e-6)")
    return max(errs)


NMS_CASES = (
    # (name, candidates, classes, threshold, ml_nms bypass, chain shift);
    # a 100-px box shifted by `shift` overlaps its chain neighbour above
    # the threshold and the one after that below it
    ("proposal NMS, t = 0.9", 1024, 1, 0.9, True, 4.0),
    ("proposal NMS, t = 0 (ml_nms bypass)", 1024, 1, 0.0, True, 4.0),
    ("training proposal NMS, t = 0.9", 2000, 1, 0.9, True, 4.0),
    ("multiclass NMS, 20 classes, t = 0.5", 2048, 20, 0.5, False, 25.0),
)
MULTICLASS_CASE = NMS_CASES[3][0]     # the kernels line's NMS entry
CLASS_SIZES = (0, 1, 63, 64, 65, 130)
# the class partition's cases, from a generator of their own so that the
# cases above draw the same inputs as before them; `classes` is a count of
# classes drawn at random, member counts per class (no chain), or "wide"
# (class ids -5, 0 and 1000: more than the partition's 256 bins)
PARTITION_CASES = (
    ("classes of 0/1/63/64/65/130 members, t = 0.5", 323, CLASS_SIZES, 0.5,
     False, 25.0),
    ("classes of 0/1/63/64/65/130 members, t = 0.9", 323, CLASS_SIZES, 0.9,
     False, 25.0),
    ("classes of 0/1/63/64/65/130 members, t = 0 (no bypass)", 323,
     CLASS_SIZES, 0.0, False, 25.0),
    ("the chain among 4 classes, t = 0.5", 1024, 4, 0.5, False, 25.0),
    ("one class of 2048, t = 0.5", 2048, 1, 0.5, False, 25.0),
    ("class ids beyond 256 bins, t = 0.5", 2048, "wide", 0.5, False, 25.0),
    ("one class of 5000 (more than 32 words), t = 0.5", 5000, 1, 0.5, False,
     25.0),
    ("3 classes over 3000 candidates, t = 0.5", 3000, 3, 0.5, False, 25.0),
)
CHAIN = 150


def nms_inputs(rng, n, classes, shift):
    """Score-sorted candidates like the frame's (random boxes over the
    image; a third of the scores rounded to sixteenths, so many tie
    exactly; a tenth of the boxes duplicated; 5 % invalid), led by a
    suppression chain of CHAIN boxes of class 0 with descending scores
    unless `classes` gives member counts, sorted as `_nms_core` sorts
    them."""
    from embodied_object_detection_tpu_torch.ops import nms
    xy = rng.uniform(-20, 600, (n, 2)) * np.array([1.0, 0.75])
    boxes = np.concatenate([xy, xy + rng.uniform(8, 200, (n, 2))], 1)
    scores = rng.rand(n)
    scores[::3] = np.round(scores[::3] * 16) / 16
    dup = rng.choice(n - 1, n // 10, replace=False)
    boxes[dup] = boxes[dup + 1]
    if isinstance(classes, tuple):
        cls = np.concatenate([np.full(k, c) for c, k in enumerate(classes)])
        rng.shuffle(cls)
    else:
        cls = (rng.choice([-5, 1000], n) if classes == "wide"
               else rng.randint(0, classes, n))
    valid = rng.rand(n) > 0.05
    if not isinstance(classes, tuple):
        c = np.arange(CHAIN)
        boxes[:CHAIN] = np.stack([10 + c * shift, np.full(CHAIN, 100.0),
                                  110 + c * shift, np.full(CHAIN, 180.0)], 1)
        scores[:CHAIN] = 2.0 - c / CHAIN
        cls[:CHAIN], valid[:CHAIN] = 0, True
    b = torch.from_numpy(boxes.astype(np.float32)).cuda()
    sc = torch.from_numpy(scores.astype(np.float32)).cuda()
    cl = torch.from_numpy(cls.astype(np.int32)).cuda()
    v = torch.from_numpy(valid).cuda()
    _, order = nms.sort_desc(torch.where(v, sc, sc.new_full((), nms.NEG_INF)))
    return b[order].contiguous(), cl[order].contiguous(), v[order].contiguous()


def check_nms(rng):
    from embodied_object_detection_tpu_torch.ops import nms
    part_rng = np.random.RandomState(4)
    for cases, r in ((NMS_CASES, rng), (PARTITION_CASES, part_rng)):
        for name, n, classes, t, ml, shift in cases:
            b, c, v = nms_inputs(r, n, classes, shift)
            disabled = ml and not t > 0
            got = nms.nms_keep(b, c, v, t, disabled)
            want = nms.nms_keep_plain(b, c, v, t, disabled)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            if differ:
                raise AssertionError(f"nms {name}: {differ} keep flags differ "
                                     "from the plain fixpoint")
            chained = not isinstance(classes, tuple)
            if chained:
                chain = got[:CHAIN].cpu().numpy()
                expect = v[:CHAIN].cpu().numpy() if disabled \
                    else np.arange(CHAIN) % 2 == 0
                if not (chain == expect).all():
                    raise AssertionError(f"nms {name}: the {CHAIN}-deep chain "
                                         "is not resolved greedily")
            print(f"  {name}: N = {n}, {int(v.sum())} valid, "
                  f"{int(got.sum())} kept, keep set equal to the plain "
                  f"fixpoint" + (f", the {CHAIN}-deep chain greedy"
                                 if chained else ""))
    phase("4a", "nms keep sets equal the plain fixpoint in every case "
                "(ties, duplicated boxes, chain deeper than 64; 2000 "
                "candidates at training; classes of 0-130 members, one "
                "class, class ids beyond the bins, 3000 and 5000 "
                "candidates)")
    return 0.0


def roi_inputs(rng, r, dtype):
    """p3-p5 [H, W, 256] levels of `dtype` and [r, 4] boxes whose sides
    span all three levels' assignment and cross the image border."""
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              .cuda().to(dtype) for h, w in LEVEL_SHAPES]
    side = np.exp(rng.uniform(np.log(16), np.log(900), r))
    aspect = np.exp(rng.uniform(-0.7, 0.7, r))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    cx, cy = rng.uniform(-40, 680, r), rng.uniform(-40, 520, r)
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    return levels, torch.from_numpy(boxes.astype(np.float32)).cuda()


def roi_levels(boxes):
    from embodied_object_detection_tpu_torch.ops import roi_align
    return (roi_align.assign_levels(boxes, 3, 5) - 3).contiguous()


# (name, boxes in image pixels, whether their grids exceed the budget) of
# phase 4b's edge cases: a whole level has 300 positions, the wide box 392
# (7 x 7) and 784 (14 x 14), the budget is 288
ROI_EDGE_CASES = (
    ("under one level pixel", [[100.3, 60.2, 104.1, 63.9],
                               [300.0, 200.0, 300.4, 200.3],
                               [636.0, 476.0, 639.5, 479.9]], False),
    ("a whole level (p5)", [[0.0, 0.0, 640.0, 480.0]], True),
    ("beyond the image (p5)", [[-300.0, -200.0, 940.0, 680.0]], False),
    ("wide on p3 (480 x 100)", [[40.0, 160.0, 520.0, 260.0]], True),
)


def staged_grids(stats):
    """(min, median, max) of each ROI's largest staged grid and the count
    of ROIs taken in bands, from the kernel's stats."""
    st = stats.cpu().numpy()
    grid = st[:, 0]
    return (int(grid.min()), float(np.median(grid)), int(grid.max()),
            int((st[:, 2] > 0).sum()))


def check_roi_case(levels, boxes, size):
    """The kernel in f32 against the plain tap form on the CPU, in bf16
    against it and the plain v4; returns (f32 error, bf16 errors, stats)."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    lvl = roi_levels(boxes)
    r = boxes.shape[0]
    # the tap form is held on the CPU: there `/ output_size` is a true
    # division, as in the kernel and the JAX package, while PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal,
    # which moves bin_w, and so the sample coordinates, by an ulp
    cpu = ([f.cpu() for f in levels], boxes.cpu(), lvl.cpu())
    stats = torch.zeros((r, 3), dtype=torch.int32, device="cuda")
    got = ra.roi_align_cuda(levels, boxes, lvl, STRIDES, size, 2,
                            stats=stats).cpu()
    want = ra._roi_align_taps(cpu[0], cpu[1], STRIDES, size, 2, cpu[2])
    err32 = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    levels16 = [f.to(torch.bfloat16) for f in levels]
    got16 = ra.roi_align_cuda(levels16, boxes, lvl, STRIDES, size, 2)
    v1 = ra._roi_align_taps([f.cpu() for f in levels16], cpu[1],
                            STRIDES, size, 2, cpu[2])
    v4 = ra._roi_align_matmul(levels16, boxes, STRIDES, size, 2, lvl)
    torch.cuda.synchronize()
    fmax = max(float(f.float().abs().max()) for f in levels16)
    err_v1 = (got16.float().cpu() - v1).abs()
    if not bool((err_v1 <= 2.0 ** -8 * v1.abs() + 1e-6).all()):
        raise AssertionError(f"roi_align bf16 differs from v1 by "
                             f"{float(err_v1.max())}")
    err_v4 = float((got16.float() - v4.float()).abs().max())
    tol_v4 = 2.0 ** -7 * fmax
    if not err_v4 <= tol_v4:
        raise AssertionError(f"roi_align bf16 differs from v4 by "
                             f"{err_v4} > {tol_v4}")
    return err32, float(err_v1.max()), err_v4, err_v4 / fmax, tol_v4, stats


def check_roi_align(rng):
    worst = 0.0
    for r, size in ((256, 7), (100, 14)):
        levels, boxes = roi_inputs(rng, r, torch.float32)
        lvl = roi_levels(boxes)
        hits = torch.bincount(lvl.long(), minlength=3).tolist()
        b = boxes.cpu().numpy()
        outside = int(((b[:, 0] < 0) | (b[:, 1] < 0) | (b[:, 2] > 640) |
                       (b[:, 3] > 480)).sum())
        if min(hits) == 0 or outside == 0:
            raise AssertionError(f"roi_align inputs reach levels {hits} and "
                                 f"cross the border {outside} times")
        err32, err_v1, err_v4, rel_v4, tol_v4, stats = check_roi_case(
            levels, boxes, size)
        worst = max(worst, err32)
        lo, med, hi, banded = staged_grids(stats)
        print(f"  R = {r}, {size}x{size}: rois per level {hits}, {outside} "
              f"cross the border; f32 vs v1 (CPU) max err {err32:.3e} "
              f"(tolerance rtol/atol 1e-5); bf16 vs v1 (CPU) max err "
              f"{err_v1:.3e} (one bf16 output rounding, <= 2^-8 |v1|); bf16 "
              f"vs v4 max err {err_v4:.3e} = {rel_v4:.2e} max|f| (tolerance "
              f"2^-7 max|f| = {tol_v4:.3e}); staged grid positions min "
              f"{lo}, median {med:g}, max {hi}; {banded} of {r} ROIs in "
              f"bands")
    # the edge cases, from a generator of their own, each ahead of 256
    # random ROIs: with that many the kernel takes all of a ROI's output
    # rows in one block (it splits them only when its blocks are too few
    # to fill the card, as for the mask pooler's R = 100)
    edge_rng = np.random.RandomState(7)
    levels, others = roi_inputs(edge_rng, 256, torch.float32)
    for name, edge, must_band in ROI_EDGE_CASES:
        k = len(edge)
        boxes = torch.cat([torch.tensor(edge, dtype=torch.float32).cuda(),
                           others])
        for size in (7, 14):
            err32, err_v1, err_v4, _, _, stats = check_roi_case(
                levels, boxes, size)
            worst = max(worst, err32)
            lo, _, hi, banded = staged_grids(stats[:k])
            print(f"  {name}, {size}x{size}: levels "
                  f"{(roi_levels(boxes[:k]) + 3).tolist()}, staged grid "
                  f"positions {lo}-{hi}, {banded} of {k} in bands; f32 vs "
                  f"v1 max err {err32:.3e}, bf16 vs v1 {err_v1:.3e}, vs v4 "
                  f"{err_v4:.3e} (with 256 random ROIs)")
            if name.startswith("under") and hi > 4:
                raise AssertionError(f"a ROI under one level pixel staged "
                                     f"{hi} positions")
            if must_band and banded == 0:
                raise AssertionError(f"roi_align {name}: not taken in bands")
    phase("4b", "roi_align agrees with the plain tap form (on the CPU, "
                "f32, rtol/atol 1e-5) and with the plain v4 (bf16, 2^-7 "
                "max|features|: v4 rounds its weights, its intermediate and "
                "its output to bf16, the kernel its output, each at most "
                "2^-9 of the pooled magnitude), random ROIs and ROIs under "
                "one level pixel, over a whole level, beyond the image and "
                "wide (the whole level and the wide ROI in bands)")
    return worst


def paste_inputs(rng, n=100, m=28, edges=False):
    """n random masks and boxes over 480 x 640; with `edges`, the first
    box covers the image and the next three lie wholly outside it."""
    probs = rng.rand(n, m, m).astype(np.float32)
    x0 = rng.uniform(-60, 600, n)
    y0 = rng.uniform(-60, 440, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 400, n),
                      y0 + rng.uniform(4, 300, n)], 1).astype(np.float32)
    if edges:
        boxes[:4] = [[-3, -1, 645, 482], [650, 10, 700, 90],
                     [20, -90, 80, -5], [-70, 490, -10, 560]][:n]
    return torch.from_numpy(probs).cuda(), torch.from_numpy(boxes).cuda()


# (masks, threshold, pixel_major, x_stride) of phase 4c's edge cases
PASTE_CASES = ((1, 0.5, True, 1), (130, 0.5, True, 1), (100, 0.0, True, 1),
               (130, -1.0, True, 1), (100, -1.0, False, 8),
               (130, 0.0, False, 8), (1, -1.0, False, 1))


def check_paste(masks, boxes, threshold, pixel_major, x_stride):
    """The kernel against the plain version: values within atol 1e-6, and
    at a threshold at most one flip in 10^4 pixels, each within 1e-5 of
    it. Returns (max value error, flips, pixels)."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    kw = dict(x_stride=x_stride, pixel_major=pixel_major)
    vals = mp.paste_masks(masks, boxes, 480, 640, -1.0, **kw)
    want_vals = mp.paste_masks_plain(masks, boxes, 480, 640, -1.0, **kw)
    torch.cuda.synchronize()
    err = float((vals - want_vals).abs().max())
    torch.testing.assert_close(vals, want_vals, rtol=0, atol=1e-6)
    if threshold < 0:
        return err, 0, vals.numel()
    got = mp.paste_masks(masks, boxes, 480, 640, threshold, **kw)
    want = mp.paste_masks_plain(masks, boxes, 480, 640, threshold, **kw)
    torch.cuda.synchronize()
    flipped = got != want
    flips = int(flipped.sum())
    near = bool(((want_vals[flipped] - threshold).abs() < 1e-5).all())
    if flips > max(1, got.numel() // 10000) or not near:
        raise AssertionError(f"mask paste: {flips} flips at {threshold} "
                             f"(near it: {near})")
    return err, flips, got.numel()


def check_mask_paste(rng):
    masks, boxes = paste_inputs(rng)
    worst = 0.0
    for pixel_major, x_stride in ((True, 1), (False, 8)):
        err, flips, pixels = check_paste(masks, boxes, 0.5, pixel_major,
                                         x_stride)
        worst = max(worst, err)
        print(f"  pixel_major={pixel_major}, x_stride={x_stride}: values max "
              f"err {err:.3e} (atol 1e-6); {flips} of {pixels} pixels "
              f"flipped at 0.5, all within 1e-5 of it")
    # the edge cases, from a generator of their own
    edge_rng = np.random.RandomState(5)
    for n, threshold, pixel_major, x_stride in PASTE_CASES:
        masks, boxes = paste_inputs(edge_rng, n, edges=True)
        err, flips, pixels = check_paste(masks, boxes, threshold,
                                         pixel_major, x_stride)
        worst = max(worst, err)
        print(f"  N = {n}, threshold {threshold}, pixel_major={pixel_major}, "
              f"x_stride={x_stride}, a covering box and boxes outside: "
              f"values max err {err:.3e}; {flips} of {pixels} flipped")
    phase("4c", "mask_paste agrees with its plain version (values within "
                "atol 1e-6; at most one flip in 10^4 pixels, and only where "
                "|plain - threshold| < 1e-5), 1-130 masks, thresholds 0.5, "
                "0 and -1, both layouts")
    return worst


def select_inputs(rng):
    """The two-pass selection's inputs: 100 masks pasted into 480 x 640
    (pixel-major, by the paste kernel), with one image row no mask covers
    and one every mask covers; a fifth of the detections invalid; random
    cell ids."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    probs, boxes = paste_inputs(rng)
    masks = mp.paste_masks(probs, boxes, 480, 640, 0.5, pixel_major=True)
    masks[100] = False
    masks[101] = True
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    return masks.contiguous(), valid, proj


# (masks, threshold) of phase 4d's fused cases: the frame's, N % 4 != 0,
# two passes of the paste's 128 masks, and every value >= 0
SELECT_CASES = ((100, 0.5), (99, 0.5), (130, 0.5), (100, 0.0))
FULL_ROWS = (114, 126)          # rows mask 0 (all ones) covers
EMPTY_ROWS = (300, 312)         # rows no valid mask reaches


def fused_select_inputs(rng, n):
    """The exact write's paste inputs: n random masks and boxes, mask 0
    all ones over a band of full image rows, a fifth of the detections
    invalid and every detection whose box comes near EMPTY_ROWS too;
    random cell ids."""
    probs, boxes = paste_inputs(rng, n)
    probs[0] = 1.0
    boxes[0] = torch.tensor([-3.0, 110.0, 645.0, 130.0], device="cuda")
    b = boxes.cpu().numpy()
    near = (b[:, 1] < EMPTY_ROWS[1] + 20) & (b[:, 3] > EMPTY_ROWS[0] - 20)
    valid = (rng.rand(n) > 0.2) & ~near
    valid[0] = True
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    return probs, boxes, torch.from_numpy(valid).cuda(), proj


def check_fused_select(probs, boxes, valid, proj, threshold):
    """The paste with its flag epilogue, then the selection on its flags,
    against the plain paste, its flags and the plain selection. Returns
    (flips, filled slots)."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    from embodied_object_detection_tpu_torch.ops import memory_ops
    h, w = 480, 640
    masks, observed, counts = mp.paste_masks_observed(probs, boxes, valid, h,
                                                      w, threshold)
    seg, aug = memory_ops.write_select(masks, valid, proj, 8, observed,
                                       counts)
    plain = mp.paste_masks_plain(probs, boxes, h, w, threshold,
                                 pixel_major=True)
    torch.cuda.synchronize()
    flipped = masks != plain
    flips = int(flipped.sum())
    if flips:
        vals = mp.paste_masks_plain(probs, boxes, h, w, -1.0,
                                    pixel_major=True)
        near = bool(((vals[flipped] - threshold).abs() < 1e-5).all())
        if flips > max(1, plain.numel() // 10000) or not near:
            raise AssertionError(f"fused paste: {flips} flips (near the "
                                 f"threshold: {near})")
    # the flags, counts, ids and rows of the kernel's masks, and when no
    # value flipped, of the plain paste's: equal in every element
    for ref in (masks,) if flips else (masks, plain):
        want_obs = (ref & valid).any(dim=-1)
        tiles = counts.shape[1]
        pad = tiles * mp.TILE_COLS - w
        want_counts = torch.nn.functional.pad(want_obs.int(), (0, pad)) \
            .reshape(h, tiles, mp.TILE_COLS).sum(-1, dtype=torch.int32)
        seg_p, aug_p = memory_ops.write_select_plain(ref, valid, proj, 8)
        if not (torch.equal(observed, want_obs) and
                torch.equal(counts, want_counts) and
                torch.equal(seg, seg_p) and torch.equal(aug, aug_p)):
            raise AssertionError(
                f"fused select at threshold {threshold}, N = {len(valid)}: "
                f"{int((observed != want_obs).sum())} flags, "
                f"{int((counts != want_counts).sum())} counts, "
                f"{int((seg != seg_p).sum())} ids, "
                f"{int((aug != aug_p).sum())} weights differ")
    if threshold > 0:
        rows = observed[FULL_ROWS[0]:FULL_ROWS[1]]
        if not (bool(rows.all()) and
                not bool(observed[EMPTY_ROWS[0]:EMPTY_ROWS[1]].any())):
            raise AssertionError("fused select: the full rows are not full "
                                 "or the empty rows not empty")
    return flips, int((seg >= 0).sum())


def check_write_select(rng):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    fused_rng = np.random.RandomState(11)
    for n, threshold in SELECT_CASES:
        probs, boxes, valid, proj = fused_select_inputs(fused_rng, n)
        flips, filled = check_fused_select(probs, boxes, valid, proj,
                                           threshold)
        print(f"  fused paste + select, N = {n}, threshold {threshold}: "
              f"{flips} pasted values flip against the plain paste; flags, "
              f"counts, ids and rows equal to the plain chain; {filled} "
              f"slots filled" + (f"; rows {FULL_ROWS[0]}-{FULL_ROWS[1] - 1} "
                                 f"full, rows {EMPTY_ROWS[0]}-"
                                 f"{EMPTY_ROWS[1] - 1} empty"
                                 if threshold > 0 else ""))
    masks, valid, proj = select_inputs(rng)
    seg, aug = memory_ops.write_select(masks, valid, proj, 8)
    seg_p, aug_p = memory_ops.write_select_plain(masks, valid, proj, 8)
    torch.cuda.synchronize()
    if not (torch.equal(seg, seg_p) and torch.equal(aug, aug_p)):
        raise AssertionError(
            f"write_select differs from its plain version: "
            f"{int((seg != seg_p).sum())} ids, "
            f"{int((aug != aug_p).sum())} weights")
    filled = int((seg >= 0).sum())
    print(f"  two-pass selection on masks alone: {filled} of {seg.numel()} "
          f"slots filled; row 100 empty, row 101 full; ids and "
          f"[{aug.shape[0]}, {aug.shape[1]}] rows equal to the plain version")
    phase("4d", "the mask paste's flags and the selection on them equal the "
                "plain chain in every element (masks within the paste's "
                "flip bound), 99-130 masks, thresholds 0.5 and 0, full and "
                "empty rows; the two-pass selection equals its plain "
                "version")
    return 0.0


def check_memory_read_batched(rng, b=TRAIN_FRAMES):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats = torch.from_numpy(
        (rng.randn(b, 8192, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (b, 8192))
                           .astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (b, 480, 640)).astype(np.int32)).cuda()
    got = memory_ops.memory_read_batched(feats, obs, proj)
    singles = torch.stack([memory_ops.memory_read(feats[i], obs[i], proj[i])
                           for i in range(b)])
    plain = memory_ops.memory_read_batched_plain(feats, obs, proj)
    torch.cuda.synchronize()
    if not torch.equal(got, singles):
        raise AssertionError(f"memory_read_batched differs from {b} single "
                             f"reads in {int((got != singles).sum())} values")
    err = float((got - plain).abs().max())
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
    phase("4e", f"memory_read_batched (B = {b}) equals {b} memory_read "
                f"calls in every element; max err against its plain "
                f"version {err:.3e} (rtol/atol 1e-6)")
    return err


def flat_levels(grads):
    return torch.cat([g.float().cpu().reshape(-1, g.shape[-1])
                      for g in grads])


def backward_atomics(levels, boxes, lvl, c, size=7):
    """(scalar, vector): the atomic adds a kernel that adds every nonzero
    tap's contribution issues (taps x C), and those the staged-grid
    kernel's flush issues (each distinct position a ROI touches with a
    nonzero weight, once per 4 channels), from the plain tap form."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    rows, wgt = ra.roi_align_taps([f.shape[:2] for f in levels], boxes.cpu(),
                                  STRIDES, size, 2, lvl.cpu())
    total = sum(f.shape[0] * f.shape[1] for f in levels)
    r = boxes.shape[0]
    key = rows.reshape(r, -1) + total * torch.arange(r)[:, None]
    live = wgt.reshape(r, -1) != 0
    return (int(live.sum()) * c,
            int(torch.unique(key[live]).numel()) * (c // 4))


def exact_contributions(levels, boxes, lvl, grad, size):
    """(count [P], exact [P, C], magnitude [P, C]) over the flattened
    levels: the nonzero tap contributions (grad / s^2) * w of the plain
    tap form on each position, each the f32 product the kernel forms, and
    their sum and the sum of their magnitudes taken exactly (f64). Summed
    in any order in f32, n contributions stay within (n - 1) 2^-24
    sum|c| of the exact sum, so within the n 2^-24 sum|c| bound; two f32
    orders may differ from each other by up to twice that."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    rows, wgt = ra.roi_align_taps([f.shape[:2] for f in levels], boxes.cpu(),
                                  STRIDES, size, 2, lvl.cpu())
    total = sum(f.shape[0] * f.shape[1] for f in levels)
    c = grad.shape[-1]
    g = grad.float().cpu() / 4.0        # s^2 = 4: exact, as __fdiv_rn
    count = torch.zeros(total).index_add_(0, rows.reshape(-1),
                                          (wgt.reshape(-1) != 0).float())
    exact = torch.zeros((total, c), dtype=torch.float64)
    mag = torch.zeros((total, c), dtype=torch.float64)
    for i in range(0, boxes.shape[0], 32):
        prod = (g[i:i + 32, :, None, :, None, None, :] *
                wgt[i:i + 32, ..., None]).reshape(-1, c).double()
        idx = rows[i:i + 32].reshape(-1)
        exact.index_add_(0, idx, prod)
        mag.index_add_(0, idx, prod.abs())
    return count, exact, mag


def check_backward_case(levels, boxes, grad, strict_plain):
    """The backward kernel in f32 and bf16 against the exact sums of the
    plain tap form's contributions, and against torch autograd of the
    plain tap form (in f32 on the CPU, in bf16 on the card); returns (f32
    error from the exact sum, its share of the bound, the share of the
    bound of its difference from the CPU's f32 autograd, the bf16
    shares, the most contributions on one position). With
    `strict_plain`, the f32 autograd is also held within the bound."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    lvl = roi_levels(boxes)
    shapes = [f.shape[:2] for f in levels]
    size = grad.shape[1]
    count, exact, mag = exact_contributions(levels, boxes, lvl, grad, size)
    bound = count[:, None].double() * 2.0 ** -24 * mag
    got = flat_levels(ra.roi_align_backward_cuda(grad, shapes, boxes, lvl,
                                                 STRIDES, 2, torch.float32))
    err = (got.double() - exact).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"roi_align backward f32: max err "
                             f"{float(err.max())} from the exact sum beyond "
                             f"n 2^-24 sum|c|")
    # the plain tap form on the CPU, whose divisions are the kernel's
    leaves = [f.cpu().requires_grad_(True) for f in levels]
    plain = flat_levels(torch.autograd.grad(
        ra._roi_align_taps(leaves, boxes.cpu(), STRIDES, size, 2, lvl.cpu()),
        leaves, grad.cpu()))
    err_plain = (got - plain).abs().double()
    if strict_plain and not bool((err_plain <= bound).all()):
        raise AssertionError(f"roi_align backward f32: max err "
                             f"{float(err_plain.max())} from the plain v1 "
                             f"autograd beyond n 2^-24 sum|c|")

    levels16 = [f.to(torch.bfloat16).requires_grad_(True) for f in levels]
    g16 = grad.to(torch.bfloat16)
    got16 = flat_levels(ra.roi_align_backward_cuda(
        g16, shapes, boxes, lvl, STRIDES, 2, torch.bfloat16)).double()
    want16 = flat_levels(torch.autograd.grad(
        ra._roi_align_taps(levels16, boxes, STRIDES, size, 2, lvl), levels16,
        g16.float())).double()
    torch.cuda.synchronize()
    # the exact sum of the bf16-rounded gradient's f32 contributions: the
    # kernel sums the same f32 products and rounds once to bf16
    _, exact16, mag16 = exact_contributions(levels, boxes, lvl, g16, size)
    err_ref = (got16 - exact16).abs()
    tight = 2.0 ** -8 * exact16.abs() + \
        (1 + 2.0 ** -8) * count[:, None].double() * 2.0 ** -24 * mag16
    if not bool((err_ref <= tight).all()):
        raise AssertionError(f"roi_align backward bf16: max err "
                             f"{float(err_ref.max())} from the exact sum "
                             f"beyond 2^-8 |ref| + n 2^-24 sum|c|")
    err16 = (got16 - want16).abs()
    tol16 = (count[:, None].double() + 1) * 2.0 ** -8 * mag16
    if not bool((err16 <= tol16).all()):
        raise AssertionError(f"roi_align backward bf16: max err "
                             f"{float(err16.max())} beyond (n + 1) 2^-8 "
                             f"sum|c|")

    def share(e, b):
        return float((e / b.clamp(min=1e-30)).max())

    return (float(err.max()), share(err, bound), share(err_plain, bound),
            share(err_ref, tight), share(err16, tol16), int(count.max()))


def check_roi_align_backward(rng, r=512):
    levels, boxes = roi_inputs(rng, r, torch.float32)
    grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32)
                            ).cuda()
    worst, s32, s_plain, s_ref, s16, most = check_backward_case(
        levels, boxes, grad, strict_plain=True)
    scalar, vector = backward_atomics(levels, boxes, roi_levels(boxes), 256)
    print(f"  R = {r}, 7x7x256: up to {most} contributions on one position; "
          f"f32 vs the exact sum max err {worst:.3e}, max err / bound "
          f"{s32:.3f}; vs the plain v1 autograd (CPU) {s_plain:.3f}; bf16 "
          f"vs the exact sum of the bf16 gradient's contributions max err "
          f"/ bound {s_ref:.3f}; bf16 vs the card's plain v1 autograd max "
          f"err / bound {s16:.3f}; the flush's float4 "
          f"atomics {vector} (the staged grid's distinct positions x C/4) "
          f"against {scalar:.3e} scalar atomics of a kernel adding every "
          f"tap")
    # the edge cases, from a generator of their own, each ahead of 64
    # random ROIs
    edge_rng = np.random.RandomState(9)
    levels, others = roi_inputs(edge_rng, 64, torch.float32)
    for name, edge, _ in ROI_EDGE_CASES:
        boxes = torch.cat([torch.tensor(edge, dtype=torch.float32).cuda(),
                           others])
        grad = torch.from_numpy(edge_rng.randn(len(boxes), 7, 7, 256)
                                .astype(np.float32)).cuda()
        err, s32, s_plain, s_ref, s16, most = check_backward_case(
            levels, boxes, grad, strict_plain=False)
        worst = max(worst, err)
        k = len(edge)
        _, vector = backward_atomics(levels, boxes[:k], roi_levels(boxes[:k]),
                                     256)
        print(f"  {name}: levels {(roi_levels(boxes[:k]) + 3).tolist()}, "
              f"{vector // 64} distinct positions flushed; f32 max err / "
              f"bound {s32:.3f} from the exact sum ({s_plain:.3f} from the "
              f"plain v1 autograd's own f32 order), bf16 {s_ref:.3f} and "
              f"{s16:.3f} (with 64 random ROIs; up to {most} contributions "
              f"on one position)")
    phase("4f", "roi_align backward within contributions x 2^-24 x "
                "sum|contribution| of the exact sum of the plain v1's f32 "
                "contributions (f32; at R = 512 also of the CPU's plain v1 "
                "autograd); in bf16 within 2^-8 |ref| + (1 + 2^-8) "
                "contributions x 2^-24 x sum|contribution| of the exact sum "
                "of the bf16-rounded gradient's contributions (one final "
                "rounding), and within (contributions + 1) x 2^-8 x "
                "sum|contribution| of the card's plain v1 in bf16 (which "
                "rounds every partial sum); R = 512 and ROIs under one level "
                "pixel, a whole level, beyond the image and wide")
    return worst


def sync_sites(fn) -> collections.Counter:
    """Run fn() under the sync debug mode "warn" and count the call stacks
    (the innermost frames of this repository, and the frame that called
    into torch) of every synchronising CUDA call it makes."""
    import traceback
    sites = collections.Counter()

    inside = []     # only count what fn() does, not the mode switches

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside or "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-2]
        ours = [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in frames
                if str(REPO) in f.filename][-4:]
        sites[" <- ".join(reversed(ours)) +
              f" -> {Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside.append(True)
            fn()
        finally:
            inside.clear()
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def run_main_path(profile_dir):
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.ops import memory_ops
    from embodied_object_detection_tpu_torch.structures import MemoryState

    cfg = DetectorConfig()
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=0, device="cuda")
    print(f"  built the default-config model in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters())} parameters)")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (T_FRAMES, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, cells, (T_FRAMES, h, w)).astype(np.int32)
    resets = np.array([True] + [False] * (T_FRAMES - 1))
    frames = frame_inputs(images, projs, resets, cells, "cuda")
    zs = torch.from_numpy(rng.randn(cfg.roi.zs_weight_dim,
                                    cfg.roi.num_classes + 1)
                          .astype(np.float32)).cuda()
    init = MemoryState.zeros(cells, dim, "cuda")
    run = make_episode_runner(model, cfg)

    out, counted_s, launches = counted_run(
        "default", lambda: run(frames, zs, init), LAUNCHES_PER_FRAME,
        T_FRAMES)
    chunk_s = [counted_s]
    for _ in range(3):
        t0 = time.perf_counter()
        run(frames, zs, out.memory)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    per_frame = [s / T_FRAMES * 1e3 for s in chunk_s]
    print("  per-frame ms over chunks of %d frames: %s" % (
        T_FRAMES, ", ".join(f"{x:.2f}" for x in per_frame)))

    t0 = time.perf_counter()
    model.backbone_raw(frames.image)
    torch.cuda.synchronize()
    print(f"  batched trunk alone: "
          f"{(time.perf_counter() - t0) / T_FRAMES * 1e3:.2f} ms/frame")

    check_episode("default", out, (T_FRAMES,), cfg)
    det = out.detections
    any_det = out.any_detection.tolist()
    n_det = det.valid.sum(dim=1).tolist()
    print(f"  detections per frame: {n_det}; frames that wrote: {any_det}")
    if not any_det[0]:
        raise AssertionError("frame 0 wrote nothing to the memory")
    first = out.first_memory
    ego1 = memory_ops.memory_read_plain(first.features, first.obs_count,
                                        frames.proj_indices[1])
    if not float(ego1.abs().max()) > 0:
        raise AssertionError("frame 1 read an all-zero memory")
    print(f"  memory after the chunk: {int((out.memory.obs_count > 0).sum())}"
          f" cells observed, max |feature| "
          f"{float(out.memory.features.abs().max()):.3f}; frame 1 read "
          f"max |ego| {float(ego1.abs().max()):.3f}")

    if profile_dir:
        profile_run(lambda: run(frames, zs, init), Path(profile_dir),
                    "chunk", T_FRAMES, "frame")
    phase(5, f"eval path ran {T_FRAMES} frames at 480x640 with no host "
             f"sync: {min(per_frame):.2f} ms/frame (best chunk), launches a "
             f"frame {LAUNCHES_PER_FRAME}, frame 0 wrote, frame 1 read it")
    return launches, per_frame


def counted_run(name, fn, per_frame, frames):
    """Run fn() once under the sync debug mode "warn" (any synchronising
    call fails), then once under "error" with the launch counts zeroed
    just before and read just after; each kernel must have launched its
    count a frame. Returns the counted run's result, its seconds and its
    launches."""
    t0 = time.perf_counter()
    syncs = sync_sites(fn)
    print(f"  {name}: warm-up run {time.perf_counter() - t0:.2f} s, "
          f"{sum(syncs.values())} synchronising calls (sync debug mode "
          f"'warn')")
    if syncs:
        for site, n in syncs.items():
            print(f"    {n} x {site}")
        raise AssertionError(f"{name}: the frames synchronise with the host")
    zero_counters()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    expected = {k: per_frame.get(k, 0) * frames for k in launches}
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expected}")
    print(f"  {name}: {frames} frames, no host sync (sync debug mode "
          f"'error'), launches {launches}, {secs / frames * 1e3:.2f} "
          f"ms/frame")
    return out, secs, launches


def check_episode(name, out, lead, cfg):
    """An episode's shapes ([*lead, detections, ...] and the memory's, one
    a stream) and finite values."""
    det = out.detections
    n = cfg.roi.detections_per_image
    shapes = {"boxes": lead + (n, 4), "scores": lead + (n,),
              "features": lead[:-1] + (cfg.memory.max_cells,
                                       cfg.memory.memory_dim)}
    got = {"boxes": tuple(det.boxes.shape),
           "scores": tuple(det.scores.shape),
           "features": tuple(out.memory.features.shape)}
    if got != shapes:
        raise AssertionError(f"{name}: shapes {got} != {shapes}")
    for part, t in (("boxes", det.boxes), ("scores", det.scores),
                    ("memory", out.memory.features),
                    ("obs", out.memory.obs_count)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite {part}")


def run_episode_modes():
    """Phase 5b: the longterm protocol, an external GT memory, the batched
    and the pipelined runners at the default config (480x640, bf16), each
    under the sync debug mode "error" with its launches counted."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.engine.eval import (
        external_memory_state)
    from embodied_object_detection_tpu_torch.models.detector import (
        EmbodiedDetector, build_detector, frame_inputs,
        make_batched_episode_runner, make_episode_runner,
        make_pipelined_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    base = DetectorConfig()
    cfg = base.replace(memory=dataclasses.replace(base.memory,
                                                  test_type="longterm"))
    model = build_detector(cfg, seed=0, device="cuda")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(5)
    b, t_max = 2, T_FRAMES
    images = rng.randint(0, 255, (b, t_max, h, w, 3)).astype(np.float32)
    projs = np.stack([np.stack([coherent_proj(rng) for _ in range(t_max)])
                      for _ in range(b)])
    # stream 0 starts from a reset, stream 1 from the memory it is given;
    # frames 1 and 3 read the snapshot of frames 0 and 2
    resets = np.zeros((b, t_max), bool)
    resets[0, 0] = True
    starts = np.zeros((b, t_max), bool)
    starts[:, ::2] = True
    batch = frame_inputs(images, projs, resets, cells, "cuda",
                         episode_start=starts)
    frames = batch._replace(**{k: None if v is None else v[0]
                               for k, v in batch._asdict().items()})
    zs = torch.from_numpy(rng.randn(cfg.roi.zs_weight_dim,
                                    cfg.roi.num_classes + 1)
                          .astype(np.float32)).cuda()
    init = MemoryState.zeros(cells, dim, "cuda")

    run = make_episode_runner(model, cfg)
    single, _, _ = counted_run("longterm", lambda: run(frames, zs, init),
                            LAUNCHES_PER_FRAME, t_max)
    check_episode("longterm", single, (t_max,), cfg)
    if not bool(single.any_detection[0]):
        raise AssertionError("longterm: frame 0 wrote nothing")

    trunk_fn, scan_fn = make_pipelined_episode_runner(model, cfg)
    piped, _, _ = counted_run(
        "pipelined runner (longterm)",
        lambda: scan_fn(frames, zs, init, trunk_fn(frames.image)),
        LAUNCHES_PER_FRAME, t_max)
    check_episode("pipelined", piped, (t_max,), cfg)
    # frame 0 reads the same zeros in both runs (later frames read
    # memories whose float atomics summed in another order)
    v_s, v_p = single.detections.valid[0], piped.detections.valid[0]
    if int(v_s.sum()) != int(v_p.sum()):
        raise AssertionError("pipelined: frame 0's detections differ")
    torch.testing.assert_close(
        piped.detections.scores[0][v_p].sort().values,
        single.detections.scores[0][v_s].sort().values, rtol=1e-3,
        atol=1e-4)

    batched = make_batched_episode_runner(model, cfg)
    mems = MemoryState(*(torch.stack(x) for x in zip(init, single.memory)))
    out, _, _ = counted_run("batched runner (B = 2, longterm)",
                         lambda: batched(batch, zs, mems),
                         LAUNCHES_PER_FRAME, b * t_max)
    check_episode("batched", out, (b, t_max), cfg)

    sem_cfg = base.replace(memory=dataclasses.replace(
        base.memory, memory_type="semantic_gt"))
    sem = EmbodiedDetector(sem_cfg).to("cuda").eval()
    sem.load_state_dict(model.state_dict())
    table = rng.randn(cfg.roi.num_classes + 1, dim).astype(np.float32)
    table[0] = 0.0                      # the class table's zero row 0
    # the pixels' ids index the class table
    sem_frames = frames._replace(
        proj_indices=frames.proj_indices % table.shape[0])
    table = external_memory_state(table, sem_cfg, device="cuda")
    kept = MemoryState(*(x.clone() for x in table))
    ext, _, _ = counted_run("semantic_gt",
                         lambda: make_episode_runner(sem, sem_cfg)(
                             sem_frames, zs, table),
                         LAUNCHES_PER_FRAME_EXTERNAL, t_max)
    check_episode("semantic_gt", ext, (t_max,), sem_cfg)
    for state in (table, ext.memory, ext.first_memory):
        if not (torch.equal(state.features, kept.features) and
                torch.equal(state.obs_count, kept.obs_count)):
            raise AssertionError("semantic_gt: the table changed")
    phase("5b", f"episode modes at 480x640 with no host sync: longterm, "
                f"the pipelined runner, the batched runner (B = {b}) and "
                f"semantic_gt (the table unchanged, no write kernel "
                f"launched), launches a frame as counted")


def kernel_name(key):
    """A profiler key's kernel name, without its namespace or arguments."""
    m = re.search(r"(\w+(<[^()]*>)?)\(", key)
    return m.group(1) if m else key


def profile_run(fn, out_dir, tag, units, unit):
    """Profile one fn() call: op table and chrome trace under out_dir,
    host sync and copy calls, device busy time per `unit`."""
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=-1)
    (out_dir / f"{tag}_ops.txt").write_text(table)
    trace = out_dir / f"{tag}_trace.json"
    prof.export_chrome_trace(str(trace))
    print("\n".join(table.splitlines()[:30]))
    # the device time of each of the port's kernels in this run
    ours = ("segment_sum", "memory_read", "nms_", "roi_align", "mask_paste",
            "write_select")
    for e in sorted(averages, key=lambda e: -e.device_time_total):
        if e.device_time_total > 0 and any(k in e.key for k in ours):
            print(f"  in the {tag}: {kernel_name(e.key)} "
                  f"{e.device_time_total / e.count:.1f} us a call x {e.count}")
    write = [e for e in averages if e.device_time_total > 0 and
             any(k in e.key for k in ("mask_paste", "select_kernel",
                                      "observed_kernel"))]
    if write:
        print(f"  in the {tag}: mask paste + write selection "
              f"{sum(e.device_time_total for e in write) / units:.1f} us a "
              f"{unit} ({', '.join(kernel_name(e.key) for e in write)})")
    trace_events = json.loads(trace.read_text())["traceEvents"]
    waits = {name: sum(1 for e in trace_events if e.get("name") == name)
             for name in ("cudaStreamSynchronize", "cudaMemcpyAsync")}
    print(f"  host calls in the {tag}: {waits}")
    # device busy time = union of kernel / copy / set intervals
    events = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in trace_events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"))
    busy, cur = 0.0, list(events[0])
    for s, e in events[1:]:
        if s > cur[1]:
            busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    span = max(e for _, e in events) - events[0][0]
    print(f"  profiled {tag}: {len(events)} device ops, device busy "
          f"{busy / 1e3:.2f} ms of a {span / 1e3:.2f} ms span "
          f"({busy / 1e3 / units:.2f} ms/{unit} busy; idle share "
          f"{1 - busy / span:.3f} under the profiler)")


def miniature(cfg, frames):
    """The 64x96 f32 miniature of a config that phases 6, 6b and 10b run
    on the card and on the CPU."""
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_sequence_length=frames),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=64,
                                      post_nms_topk_test=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=16,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=8))


class PasteCall(NamedTuple):
    """One mask paste of the memory write, on the CPU."""
    masks: torch.Tensor
    boxes: torch.Tensor
    out: torch.Tensor      # the pasted bool masks
    valid: object          # the write rows' flags (exact write), else None
    layout: dict           # the keywords of `paste_masks_plain`


class PasteRecorder:
    """Records every mask paste the memory write makes, one a frame: the
    exact write's `paste_masks_observed` and the strided write's
    `paste_masks`."""

    def __enter__(self):
        from embodied_object_detection_tpu_torch.models import detector
        self.detector = detector
        self.saved = observed, strided = (detector.paste_masks_observed,
                                          detector.paste_masks)
        self.calls = []

        def spy_observed(masks, boxes, valid, *args):
            out = observed(masks, boxes, valid, *args)
            self.calls.append(PasteCall(masks.cpu(), boxes.cpu(),
                                        out[0].cpu(), valid.cpu(),
                                        dict(pixel_major=True)))
            return out

        def spy_strided(masks, boxes, *args, x_stride=1):
            out = strided(masks, boxes, *args, x_stride=x_stride)
            self.calls.append(PasteCall(masks.cpu(), boxes.cpu(), out.cpu(),
                                        None, dict(x_stride=x_stride)))
            return out
        detector.paste_masks_observed = spy_observed
        detector.paste_masks = spy_strided
        return self

    def __exit__(self, *exc):
        self.detector.paste_masks_observed, self.detector.paste_masks = \
            self.saved


def paste_flips(cpu: PasteCall, card: PasteCall, h: int, w: int):
    """The pixels one frame's write paste differs on between the CPU and
    the card, as (rounding, input) counts; any other difference raises.
    A rounding flip lies within 1e-5 of the 0.5 threshold in the plain
    paste of the CPU's masks and boxes (the two devices' sums differ in
    their last bits); at most one pixel in 10 000 may be one. An input
    flip lies between the devices' inputs: the plain paste of each
    device's own masks and boxes puts it on that device's side, and the
    inputs agree (boxes within 1e-2 px, the frame tests' box tolerance;
    mask probabilities within 1e-4), as at a box edge that crosses 0.5
    between two pixel centres."""
    from embodied_object_detection_tpu_torch.ops import mask_paste

    if (cpu.valid is None) != (card.valid is None) or (
            cpu.valid is not None and not torch.equal(cpu.valid,
                                                      card.valid)):
        raise AssertionError("the write rows differ between the card and "
                             "the CPU")
    flipped = cpu.out != card.out
    n = int(flipped.sum())
    if not n:
        return 0, 0
    vals = [mask_paste.paste_masks_plain(c.masks, c.boxes, h, w, -1.0,
                                         **c.layout) for c in (cpu, card)]
    rounding = flipped & ((vals[0] - 0.5).abs() < 1e-5)
    box_gap = float((cpu.boxes - card.boxes).abs().max())
    mask_gap = float((cpu.masks - card.masks).abs().max())
    inputs = flipped & ~rounding & ((vals[0] >= 0.5) == cpu.out) & \
        ((vals[1] >= 0.5) == card.out)
    if box_gap > 1e-2 or mask_gap > 1e-4:
        inputs = torch.zeros_like(inputs)
    n_round, n_input = int(rounding.sum()), int(inputs.sum())
    if n_round + n_input != n or n_round > max(1, cpu.out.numel() // 10000):
        gap = float((vals[0][flipped] - 0.5).abs().max())
        raise AssertionError(
            f"{n} pasted pixels differ between the card and the CPU "
            f"({n_round} within 1e-5 of 0.5, {n_input} between the inputs; "
            f"up to {gap:.2e} from 0.5; inputs apart by {box_gap:.2e} px "
            f"and {mask_gap:.2e})")
    return n_round, n_input


def check_against_cpu(test_type="default"):
    """Phase 6 (test_type "default", 2 frames) and 6b ("longterm", 3
    frames: frame 1 reads frame 0's snapshot, frame 2 starts an episode)."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models import detector
    from embodied_object_detection_tpu_torch.structures import MemoryState

    frames_n = 2 if test_type == "default" else 3
    cfg = DetectorConfig()
    cfg = miniature(cfg.replace(memory=dataclasses.replace(
        cfg.memory, test_type=test_type)), frames_n)
    resets = np.array([True] + [False] * (frames_n - 1))
    starts = np.array([True, False, True][:frames_n])
    rng = np.random.RandomState(1)
    h, w = cfg.input.height, cfg.input.width
    images = rng.randint(0, 255, (frames_n, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, 64, (frames_n, h, w)).astype(np.int32)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    # record every paste on both devices, to count threshold flips
    outs, pasted = {}, {}
    for dev in ("cpu", "cuda"):
        with PasteRecorder() as rec:
            model = detector.build_detector(cfg, seed=3, device=dev)
            frames = detector.frame_inputs(images, projs, resets, 64, dev,
                                           episode_start=starts)
            outs[dev] = detector.make_episode_runner(model, cfg)(
                frames, torch.from_numpy(zs).to(dev),
                MemoryState.zeros(64, 512, dev))
        pasted[dev] = rec.calls
    cpu, card = outs["cpu"], outs["cuda"]
    if not torch.equal(cpu.any_detection, card.any_detection.cpu()):
        raise AssertionError("the card and the CPU disagree on writes")
    for t in range(frames_n):
        v_c, v_g = cpu.detections.valid[t], card.detections.valid[t].cpu()
        if int(v_c.sum()) != int(v_g.sum()):
            raise AssertionError(f"frame {t}: detection counts differ")
        s_c = cpu.detections.scores[t][v_c].sort(descending=True).values
        s_g = card.detections.scores[t].cpu()[v_g].sort(
            descending=True).values
        torch.testing.assert_close(s_g, s_c, rtol=1e-4, atol=1e-5)
    if len(pasted["cuda"]) != frames_n or len(pasted["cpu"]) != frames_n:
        raise AssertionError("expected one paste a frame on each device")
    flips = sum(sum(paste_flips(c, g, h, w))
                for c, g in zip(pasted["cpu"], pasted["cuda"]))
    if flips == 0:
        torch.testing.assert_close(card.memory.features.cpu(),
                                   cpu.memory.features, rtol=1e-3, atol=1e-3)
        memory = "memory rtol/atol 1e-3"
    else:
        # a flipped pixel moves a selected pixel's feature to another cell
        # and shifts the every-8th selection after it: the memories are not
        # comparable at 1e-3, and the phase says so
        memory = (f"memory NOT compared: {flips} pasted pixels flipped at "
                  "0.5 (within the flip bound)")
        print(f"  {memory}")
    if not torch.equal(card.memory.obs_count.cpu(), cpu.memory.obs_count):
        raise AssertionError("observation counts differ")
    phase(6 if test_type == "default" else "6b",
          f"small config (64x96, f32, test_type {test_type!r}): the card "
          f"matches the plain CPU path over {frames_n} frames (scores rtol "
          f"1e-4, {flips} pasted pixels flipped, {memory}, "
          f"{int(cpu.detections.valid.sum())} detections)")


EVAL_SCENES, EVAL_CHUNKS, EVAL_FRAMES = 2, 4, 20
# the largest reference map, 110 x 57 cells (the JAX package's
# MemoryConfig.max_cells comment)
EVAL_MAP = (57, 110)


class Recorder:
    """Spies on the evaluation engine: each chunk's starting memory and the
    runner's output, and each scored image's detections, as
    `evaluate_dataset` makes them. With `starts`, chunk i starts from
    `starts[i]` in place of the memory the engine carries."""

    def __init__(self, starts=None):
        from embodied_object_detection_tpu_torch.engine import eval as ev
        self.ev, self.starts = ev, starts
        self.chunks = []
        self.dets = {}

    def __enter__(self):
        from embodied_object_detection_tpu_torch.structures import (
            MemoryState)
        ev, rec = self.ev, self
        self.saved = (ev.make_episode_runner, ev.COCOEvaluator)

        def runner(model, cfg):
            run = rec.saved[0](model, cfg)

            def recorded(frames, zs, memory):
                if rec.starts is not None:
                    memory = MemoryState(*(
                        x.to(memory.features.device)
                        for x in rec.starts[len(rec.chunks)]))
                out = run(frames, zs, memory)
                rec.chunks.append((memory, out))
                return out
            return recorded

        class Evaluator(ev.COCOEvaluator):
            def add_detections(self, image_id, boxes, scores, classes):
                rec.dets[image_id] = (np.asarray(boxes), np.asarray(scores),
                                      np.asarray(classes))
                super().add_detections(image_id, boxes, scores, classes)

        ev.make_episode_runner, ev.COCOEvaluator = runner, Evaluator
        return self

    def __exit__(self, *exc):
        self.ev.make_episode_runner, self.ev.COCOEvaluator = self.saved


def runner_alone(model, cfg, ds, zs):
    """ms a frame of the runner alone over the engine's timed chunks (after
    its 5 warm-up chunks), their inputs on the card beforehand, after one
    untimed chunk."""
    from embodied_object_detection_tpu_torch.engine.eval import (
        frames_to_device, host_frame_inputs)
    from embodied_object_detection_tpu_torch.models.detector import (
        make_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    timed = range(min(5, len(ds) - 1), len(ds))
    runner = make_episode_runner(model, cfg)
    inputs = [frames_to_device(host_frame_inputs(ds[i], cfg.memory.max_cells,
                                                 pin=True), "cuda")
              for i in [timed[0], *timed]]
    memory = MemoryState.zeros(cfg.memory.max_cells, cfg.memory.memory_dim,
                               "cuda")
    zs = torch.from_numpy(zs).cuda()
    ms = []
    for frames_in in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        memory = runner(frames_in, zs, memory).memory
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / EVAL_FRAMES * 1e3)
    return ms[1:]


def run_eval_engine(profile_dir):
    """Phase 10: `engine.eval.evaluate_dataset` at the default config over
    8 in-memory chunks of synthetic episodes (h5py is not needed): the
    timing split, the evaluator's path, launches a frame, host syncs; then
    the runner alone over the engine's timed chunks, already on the card,
    for the chunk's compute without the engine."""
    from embodied_object_detection_tpu_torch import native
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.data.synthetic import (
        SyntheticEpisodes)
    from embodied_object_detection_tpu_torch.demo.predictor import (
        load_zs_weight_npy)
    from embodied_object_detection_tpu_torch.engine.eval import (
        evaluate_dataset)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)

    cfg = DetectorConfig()
    model = build_detector(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    ds = SyntheticEpisodes(max_sequence_length=EVAL_FRAMES,
                           max_gt=cfg.input.max_gt_boxes,
                           num_scenes=EVAL_SCENES,
                           chunks_per_scene=EVAL_CHUNKS, frames=EVAL_FRAMES,
                           height=cfg.input.height, width=cfg.input.width,
                           map_h=EVAL_MAP[0], map_w=EVAL_MAP[1], seed=0)
    print(f"  {len(ds)} chunks of {EVAL_FRAMES} frames made from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s ({ds.num_cells} cells a scene)")
    zs = load_zs_weight_npy(str(REPO / "embodied_object_detection_tpu_torch"
                                / "data" / "metadata" / "mp3d_clip.npy"))
    core = native.load_eval_core()
    result = {}

    def run():
        result["res"] = evaluate_dataset(model, cfg, ds, zs, verbose=False,
                                         num_workers=2)

    alone_before = runner_alone(model, cfg, ds, zs)
    zero_counters()
    syncs = sync_sites(run)
    launches = read_counters()
    res = result["res"]
    frames = len(ds) * EVAL_FRAMES
    expected = {k: LAUNCHES_PER_FRAME.get(k, 0) * frames for k in launches}
    per_frame = {k: v / frames for k, v in launches.items() if v}
    print(f"  launches over the run ({frames} frames): {launches}; a frame "
          f"{per_frame}")
    if launches != expected:
        raise AssertionError(f"phase 10: launches {launches}, expected "
                             f"{expected} (phase 5's counts a frame)")
    print(f"  host syncs over the run (set-up and {len(ds)} loop "
          f"iterations, sync debug mode 'warn'): {sum(syncs.values())}")
    for site, n in syncs.items():
        print(f"    {n} x {site}")
    inside = [site for site in syncs if "detector.py" in site or
              "_ops.py" in site or "eval.py" not in site]
    if inside or sum(syncs.values()) > 2 * len(ds):
        raise AssertionError(f"phase 10: host syncs outside the chunk end "
                             f"and the detection copy: {inside or syncs}")
    if res.num_images != frames // cfg.input.score_every:
        raise AssertionError(f"phase 10: {res.num_images} images scored, "
                             f"expected {frames // cfg.input.score_every}")
    aps = [res.overall] + [q for q in res.quartiles if q]
    if any(math.isinf(v) for d in aps for v in d.values()):
        raise AssertionError(f"phase 10: infinite AP in {res.overall}")
    t = res.timing
    alone = alone_before + runner_alone(model, cfg, ds, zs)
    engine_ms = t["compute_s_per_chunk"] / EVAL_FRAMES * 1e3
    alone_ms = sum(alone) / len(alone)
    print(f"  the runner alone over the timed chunks, before and after the "
          f"engine: {', '.join(f'{x:.2f}' for x in alone)} ms/frame (mean "
          f"{alone_ms:.2f}); the engine's compute {engine_ms:.2f} ms/frame "
          f"(mean over the same chunks), {engine_ms / alone_ms - 1:+.1%}")
    if profile_dir:
        profile_run(lambda: evaluate_dataset(model, cfg, [ds[0], ds[1]], zs,
                                             verbose=False, num_workers=2),
                    Path(profile_dir), "engine", 2 * EVAL_FRAMES, "frame")
    print(f"  evaluator: {'native C++ core' if core else 'numpy'}")
    print(f"  AP overall {res.overall['AP']:.4f}, AP50 "
          f"{res.overall['AP50']:.4f}; quartiles "
          f"{[round(q.get('AP', float('nan')), 4) for q in res.quartiles]}"
          f" (random weights); {res.num_images} images")
    print(f"  timing: {json.dumps(t)}")
    phase(10, f"eval engine at 480x640 over {len(ds)} chunks of "
              f"{EVAL_FRAMES} frames ({res.num_images} images scored, "
              f"{'native' if core else 'numpy'} evaluator): data "
              f"{t['data_s_per_chunk'] * 1e3:.1f} ms, compute "
              f"{t['compute_s_per_chunk'] * 1e3:.1f} ms, eval "
              f"{t['eval_s_per_chunk'] * 1e3:.1f} ms a chunk, "
              f"{t['frames_per_s']:.2f} frames/s over the timed chunks; "
              f"the runner alone {alone_ms:.2f} ms/frame")


def cell_gap(got, want):
    """The largest distance between two memories' cell features, each over
    the norm of the cell's features in `want` (a running sum over frames
    and pixels, whose small elements are differences of large terms); 0
    where both cells are empty, inf where only `want`'s is."""
    diff = (got - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    gap = torch.where(norm > 0, diff / norm.clamp(min=1e-30),
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(gap.max())


# phase 10b's shift of the miniature's mask logits. The seeded predictor's
# logits lie near 0, so every pasted pixel sits near the 0.5 threshold and
# rounds to either side on the two devices; shifted by +2 (a probability
# of ~0.88 inside a box) only a box's edge crosses it
MASK_LOGIT_SHIFT = 2.0

# phase 10b's cases: (name, golden preset, exact write subsample)
ENGINE_CASES = (("pretrained", "pretrained", True),
                ("implicit exact", "implicit_object_memory", True),
                ("implicit strided", "implicit_object_memory", False))


def eval_engine_against_cpu():
    """Phase 10b: the protocol at the 64x96 f32 miniature on the card and
    on the CPU, from the same weights and chunks: an image-only golden
    preset, implicit_object_memory, and its strided write.

    The mask predictor's bias is shifted by MASK_LOGIT_SHIFT on both
    devices, so that the write's pastes rarely land on the 0.5 threshold,
    and each CPU chunk starts from the memory its card chunk started from
    (so every chunk's first frame reads the same memory on both). Within a
    chunk, a pasted pixel that still lands on either side (`paste_flips`:
    within 1e-5 of 0.5, or between the two devices' inputs) moves a
    feature, or the every-8th selection of the compacted observed pixels
    after it, to other cells: the frames after it read memories that part
    beyond phase 6's tolerances. So each scored image is held to them
    unless it comes after such a flip in its chunk (counted), each chunk
    with no flip holds its memories (after frame 0 and at its end, each
    cell's features within 1e-3 of its norm, counts equal), and the AP is
    held within 0.1 points where every image was held. A preset that
    reads the memory must hold images that read a memory its scene wrote.

    A chunk's first frame reads the same memory on both devices and is
    held to phase 6's tolerances (scores rtol 1e-4, atol 1e-5); a later
    frame reads memories the two devices wrote, summed in other orders,
    and the f32 drift grows with the frames (on an H100, scores ~1.5e-4
    apart after 5 frames with no flip), so it is held to the episode tolerance
    of tests/test_torch_frame.py (rtol 1e-3, atol 1e-4). Over a chunk
    the memories' small elements drift past phase 6's 1e-3 elementwise
    bound, hence the bound on each cell's norm: every written feature
    has norm 50 (the normalised CLIP feature times the temperature), so
    one feature moved by a flip shifts a cell that summed k features by
    at least 1/k of its norm. At the shift the written boxes cover the 64x96
    image, so the exact write's every-8th compacted pixel is the strided
    grid's: the compaction of a partial observed set is held by phases 4d
    and 6."""
    from embodied_object_detection_tpu_torch.config import parity_config
    from embodied_object_detection_tpu_torch.data.synthetic import (
        SyntheticEpisodes)
    from embodied_object_detection_tpu_torch.engine.eval import (
        evaluate_dataset)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.ops.memory_ops import (
        semmap_classes)

    frames, chunks_per_scene = 10, 2
    ds = SyntheticEpisodes(max_sequence_length=frames, num_scenes=2,
                           chunks_per_scene=chunks_per_scene, frames=frames,
                           height=64, width=96, map_h=8, map_w=8, seed=1)
    rng = np.random.RandomState(1)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    summary = []
    for name, preset, exact in ENGINE_CASES:
        cfg = miniature(parity_config(preset), frames)
        cfg = cfg.replace(memory=dataclasses.replace(
            cfg.memory, exact_write_subsample=exact))
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_detector(cfg, seed=3, device=dev)
            with torch.no_grad():
                model.roi_heads.mask_head.predictor.bias.add_(
                    MASK_LOGIT_SHIFT)
            starts = None if dev == "cuda" else \
                [m for m, _ in runs["cuda"][1].chunks]
            with Recorder(starts) as rec, PasteRecorder() as pastes:
                res = evaluate_dataset(model, cfg, ds, zs, verbose=False,
                                       num_workers=2)
            runs[dev] = (res, rec, pastes.calls)
        (card, rg, pg), (cpu, rc, pc) = runs["cuda"], runs["cpu"]
        if card.num_images != cpu.num_images or \
                sorted(rg.dets) != sorted(rc.dets) or \
                len(pc) != len(ds) * frames or len(pg) != len(pc):
            raise AssertionError(f"phase 10b {name}: images "
                                 f"{card.num_images} vs {cpu.num_images}, "
                                 f"pastes {len(pg)} vs {len(pc)}")
        if [bool(q) for q in card.quartiles] != \
                [bool(q) for q in cpu.quartiles]:
            raise AssertionError(f"phase 10b {name}: quartiles differ")
        # each chunk's first frame whose write paste differs
        parted, n_round, n_input = {}, 0, 0
        for f, (c, g) in enumerate(zip(pc, pg)):
            r, i = paste_flips(c, g, 64, 96)
            n_round, n_input = n_round + r, n_input + i
            if r + i:
                parted.setdefault(f // frames, f)
        reads = cfg.memory.reads_memory()
        held = written = after = late = 0
        drift = 0.0
        for im in sorted(rc.dets):
            chunk, t = divmod(im, frames // cfg.input.score_every)
            f = chunk * frames + t * cfg.input.score_every
            if reads and f > parted.get(chunk, f):
                after += 1
                continue
            (_, s_c, _), (_, s_g, _) = rc.dets[im], rg.dets[im]
            if len(s_c) != len(s_g):
                raise AssertionError(f"phase 10b {name}: image {im}: "
                                     f"{len(s_g)} detections on the card, "
                                     f"{len(s_c)} on the CPU")
            # a chunk's first frame reads the same memory on both devices;
            # a later one, memories the two wrote (summed in other orders)
            s_g, s_c = np.sort(s_g)[::-1], np.sort(s_c)[::-1]
            if reads and t > 0:
                np.testing.assert_allclose(s_g, s_c, rtol=1e-3, atol=1e-4)
                drift = max(drift, float(np.max(
                    np.abs(s_g - s_c) / np.maximum(np.abs(s_c), 1e-30),
                    initial=0.0)))
                late += 1
            else:
                np.testing.assert_allclose(s_g, s_c, rtol=1e-4, atol=1e-5)
            held += 1
            written += reads and f % (frames * chunks_per_scene) != 0
        # the write: the memories of each chunk with no flip
        worst_gap = 0.0
        for k, ((_, out_g), (_, out_c)) in enumerate(zip(rg.chunks,
                                                         rc.chunks)):
            if k % chunks_per_scene == 0 and not float(
                    out_g.memory.features.abs().max()) > 0:
                raise AssertionError(f"phase 10b {name}: chunk {k} wrote "
                                     "nothing to the memory")
            if k in parted:
                continue
            for m_g, m_c in ((out_g.first_memory, out_c.first_memory),
                             (out_g.memory, out_c.memory)):
                gap = cell_gap(m_g.features.cpu(), m_c.features)
                worst_gap = max(worst_gap, gap)
                if not gap <= 1e-3:
                    raise AssertionError(f"phase 10b {name}: chunk {k}: a "
                                         f"cell's features differ by {gap:.2e}"
                                         " of its norm")
                if not torch.equal(m_g.obs_count.cpu(), m_c.obs_count):
                    raise AssertionError(f"phase 10b {name}: chunk {k}: "
                                         "observation counts differ")
        if reads and not written:
            raise AssertionError(f"phase 10b {name}: no image that reads "
                                 "a memory its scene wrote was held")
        ap_g, ap_c = card.overall["AP"], cpu.overall["AP"]
        q_g, q_c = ([round(q.get("AP", float("nan")), 4) for q in r.quartiles]
                    for r in (card, cpu))
        print(f"  {name}: overall AP card {ap_g:.4f}, CPU {ap_c:.4f}; "
              f"quartile AP card {q_g}, CPU {q_c}; {held} images held "
              f"({held - late} at rtol 1e-4, {late} later in their chunk at "
              f"rtol 1e-3, largest score gap {drift:.2e}; {written} reading "
              f"a memory their scene wrote), {after} after a flip in their "
              f"chunk; flips: {n_round} "
              f"within 1e-5 of 0.5 and {n_input} between the inputs, first "
              f"in chunks {parted}; memories held in "
              f"{len(ds) - len(parted)} of {len(ds)} chunks (cells within "
              f"{worst_gap:.2e} of their norms)")
        if after == 0 and not abs(ap_g - ap_c) <= 0.1:
            raise AssertionError(f"phase 10b {name}: AP {ap_g} vs {ap_c}")
        summary.append(f"{name} {held}/{held + after} images and "
                       f"{len(ds) - len(parted)}/{len(ds)} memories held, "
                       f"AP {ap_g:.4f} vs {ap_c:.4f}")
        if name == "implicit exact":
            last_c, last_g = rc.chunks[-1][1], rg.chunks[-1][1]
    # the last chunk's first-frame memory of the implicit run: the CPU's
    # memory through semmap_classes on both devices, then the card's own
    mem = last_c.first_memory
    zs_t = torch.from_numpy(zs)
    sm_c = semmap_classes(mem.features, mem.obs_count, zs_t,
                          cfg.memory.obs_score_thresh)
    sm_g = semmap_classes(mem.features.cuda(), mem.obs_count.cuda(),
                          zs_t.cuda(), cfg.memory.obs_score_thresh).cpu()
    feats = mem.features / mem.features.norm(dim=-1, keepdim=True).clamp(
        min=1e-12)
    top2 = torch.topk(50.0 * feats @ zs_t[:, :-1], 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    empty = mem.features.abs().amax(dim=-1) == 0     # all logits 0
    differ = sm_c != sm_g
    if bool((differ & ~near).any()):
        raise AssertionError(f"phase 10b: semmap classes differ on "
                             f"{int((differ & ~near).sum())} cells whose "
                             "top two logits are not tied")
    own = last_g.first_memory
    sm_own = semmap_classes(own.features, own.obs_count, zs_t.cuda(),
                            cfg.memory.obs_score_thresh).cpu()
    print(f"  semmap of the last chunk's first memory ({len(sm_c)} cells, "
          f"{int((sm_c >= 0).sum())} classed): the card equals the CPU on "
          f"the CPU's memory but for {int(differ.sum())} cells "
          f"({int((near & ~empty).sum())} written cells with top-two "
          f"logits within 1e-5, {int(empty.sum())} empty ones); on "
          f"the card's own memory {int((sm_own != sm_c).sum())} cells "
          "differ")
    phase("10b", f"eval protocol at 64x96 f32 over {len(ds)} chunks of "
                 f"{frames} frames, card against CPU (mask logits +"
                 f"{MASK_LOGIT_SHIFT}, each CPU chunk from the card's "
                 f"memory): {'; '.join(summary)}; semmap equal but for "
                 "tied logits")


def run_train_path(profile_dir):
    """Phase 8: the default config's training step through the loop."""
    import shutil
    import tempfile
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch_fn)
    from embodied_object_detection_tpu_torch.engine.train import train
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        batch_to_device, make_train_step)

    base = DetectorConfig()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = base.replace(
        solver=dataclasses.replace(base.solver, ims_per_batch=2),
        input=dataclasses.replace(base.input, max_sequence_length=2),
        output_dir=out_dir)
    model = build_detector(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(8)
    zs = rng.randn(cfg.roi.zs_weight_dim,
                   cfg.roi.num_classes + 1).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    batch_fn = synthetic_batch_fn(cfg, TRAIN_FRAMES)
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        state = train(model, cfg, None, zs, max_iter=TRAIN_STEPS,
                      log_period=1, seed=0, verbose=True, batch_fn=batch_fn)
        torch.cuda.synchronize()
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
        lines = [json.loads(x) for x in
                 (Path(out_dir) / "metrics.json").read_text().splitlines()]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if len(lines) != TRAIN_STEPS:
        raise AssertionError(f"{len(lines)} metrics lines for {TRAIN_STEPS} "
                             "steps")
    # a line a step (log_period 1): its losses, and the step's wall time,
    # the wait for its batch plus the step up to the loop's one host read
    nonfinite = [f"step {rec['iteration']}: {k}" for rec in lines
                 for k, v in rec.items() if not math.isfinite(v)]
    if nonfinite:
        raise AssertionError(f"non-finite losses: {nonfinite}")
    step_ms = [(rec["data_time"] + rec["time"]) * 1e3 for rec in lines]
    print(f"  launches in the {TRAIN_STEPS}-step run: {launches}")
    for name, fn in kernel_counters().items():
        expected = LAUNCHES_PER_STEP.get(name, 0) * TRAIN_STEPS
        if launches[name] != expected:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{TRAIN_STEPS} steps, expected {expected}")
    print(f"  ms per step (host clock, batch wait + step to its loss "
          f"read, from metrics.json): "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; steps 2-3 mean "
          f"{np.mean(step_ms[1:]):.1f}")
    print(f"  peak device memory: {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")

    # one more step, under the sync debug mode "warn"
    _, step_fn = make_train_step(model, cfg, state.optimizer)
    batch = batch_to_device(batch_fn(TRAIN_STEPS, np.random.RandomState(9),
                                     1), "cuda")
    zs_d = torch.from_numpy(zs).cuda()
    syncs = sync_sites(lambda: step_fn(state, batch, zs_d))
    print(f"  synchronising calls in one step (sync debug mode 'warn'): "
          f"{sum(syncs.values())}")
    for site, n in syncs.items():
        print(f"    {n} x {site}")
    if profile_dir:
        profile_run(lambda: step_fn(state, batch, zs_d), Path(profile_dir),
                    "train_step", TRAIN_FRAMES, "frame")
    phase(8, f"training path: {TRAIN_STEPS} AdamW steps at B = "
             f"{TRAIN_FRAMES} (480x640, bf16), losses finite, "
             f"{np.mean(step_ms[1:]):.1f} ms/step (steps 2-3), peak "
             f"{peak / 2 ** 30:.2f} GiB, launches a step "
             f"{LAUNCHES_PER_STEP}, {sum(syncs.values())} synchronising "
             f"calls in a step")
    return launches, step_ms, peak


def check_train_against_cpu():
    """Phase 9: one training step at the 64x96 f32 miniature on the card
    and on the CPU, from the same seeded weights and batch, at a learning
    rate the update can be seen at (base_lr 1e-3, no warmup)."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_train_batch)
    from embodied_object_detection_tpu_torch.engine.solver import (
        ADAM_EPS, build_optimizer)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        batch_losses, batch_to_device)

    cfg = DetectorConfig()
    cfg = cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=4),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=4),
        solver=dataclasses.replace(cfg.solver, base_lr=1e-3,
                                   warmup_factor=1.0))
    batch = synthetic_train_batch(cfg, np.random.RandomState(2), 2, 1)
    zs = np.random.RandomState(4).randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_detector(cfg, seed=3, device=dev)
        opt = build_optimizer(model, cfg.solver)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        total, losses = batch_losses(model, cfg, batch_to_device(batch, dev),
                                     torch.from_numpy(zs).to(dev), 0)
        total.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        opt.step()
        res[dev] = ({k: float(v.detach()) for k, v in losses.items()}, grads,
                    {n: p.detach().cpu() - before[n]
                     for n, p in model.named_parameters()},
                    before, dict(zip(opt.names, opt.mults)), opt.lr(0))
    (l_c, g_c, d_c, p0, mult, lr0), (l_g, g_g, d_g, p0_g, _, _) = \
        res["cpu"], res["cuda"]
    for k in l_c:
        if not abs(l_g[k] - l_c[k]) <= 1e-4 * abs(l_c[k]) + 1e-6:
            raise AssertionError(f"phase 9 loss {k}: card {l_g[k]} vs CPU "
                                 f"{l_c[k]}")
    if set(g_c) != set(g_g):
        raise AssertionError("the card and the CPU differ on which "
                             "parameters get a gradient")
    if any(not torch.equal(p0[n], p0_g[n]) for n in p0):
        raise AssertionError("the card and the CPU start from different "
                             "parameters")
    grad_rel = max(float((g_g[n] - g_c[n]).abs().max()) /
                   max(float(g_c[n].abs().max()), 1e-30) for n in g_c)
    if grad_rel > 1e-3:
        raise AssertionError(f"phase 9 gradients differ by {grad_rel:.3e} "
                             "of a tensor's largest")
    # AdamW's first step is -lr mult (f(g) + wd p) with f(g) = g / (|g| +
    # eps) of the clipped gradient. Where the two devices' clipped
    # gradients a, b share a sign, f(a) - f(b) = eps (a - b) / ((|a| + eps)
    # (|b| + eps)), so the updates must agree to that plus f32 rounding
    # (rtol 1e-5 of the update, 2^-23 of the parameter); where a gradient
    # near 0 flips sign, f may differ by up to 2. Every element whose
    # gradient is far above eps on the card must move by at least half of
    # lr mult, so a step that does not update fails.
    clip = cfg.solver.clip_value
    worst, worst_round, flipped, moved, total_n = 0.0, 0.0, 0, 0, 0
    for n in d_c:
        a = g_g.get(n, torch.zeros_like(d_c[n])).clamp(-clip, clip)
        b = g_c.get(n, torch.zeros_like(d_c[n])).clamp(-clip, clip)
        same = torch.sign(a) == torch.sign(b)
        df = torch.where(same, ADAM_EPS * (a - b).abs() /
                         ((a.abs() + ADAM_EPS) * (b.abs() + ADAM_EPS)),
                         torch.full_like(a, 2.0))
        lrm = lr0 * mult.get(n, 0.0)
        rounding = 1e-5 * d_c[n].abs() + 2.0 ** -23 * p0[n].abs()
        bound = lrm * df + rounding
        diff = (d_g[n] - d_c[n]).abs()
        if not bool((diff <= bound).all()):
            raise AssertionError(f"phase 9 update of {n} differs by "
                                 f"{float(diff.max())} (card vs CPU)")
        worst = max(worst, float(torch.where(
            same, diff / bound.clamp(min=1e-30), 0.0).max()))
        # where the gradients agree to within the rounding terms
        worst_round = max(worst_round, float(torch.where(
            same & (lrm * df <= rounding), diff / bound.clamp(min=1e-30),
            0.0).max()))
        flipped += int((~same).sum())
        live = a.abs() > 100 * ADAM_EPS
        if n in mult and not bool(
                (d_g[n][live].abs() >= 0.5 * lrm).all()):
            raise AssertionError(f"phase 9: the card's step left {n} (almost) "
                                 f"unchanged where its gradient is not 0")
        moved += int(live.sum()) if n in mult else 0
        total_n += a.numel()
    if moved == 0:
        raise AssertionError("phase 9: no parameter has a gradient")
    phase(9, f"one training step at 64x96 f32 (B = 2, one padding row, lr "
             f"{lr0:g}): the card matches the CPU, losses within rtol 1e-4, "
             f"gradients within {grad_rel:.2e} of each tensor's largest "
             f"(tolerance 1e-3), updates p_new - p_old within {worst:.3f} of "
             f"lr mult eps|a-b|/((|a|+eps)(|b|+eps)) + 1e-5 |update| + "
             f"2^-23 |p| where the gradients share a sign (the first term "
             f"is f(a) - f(b) exactly, so near 1 where it dominates; "
             f"{worst_round:.3f} where the rounding terms do; {flipped} of "
             f"{total_n} elements flip sign, held within 2 lr mult), "
             f"{moved} elements moved by >= lr mult / 2 on the card")


def time_kernels(rng, launches, train_launches, errs):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss

    seg = None
    for ids in ("random", "coherent"):
        w, idx, cells = segment_sum_inputs(rng, ids)
        rows, lanes = w.shape
        keep = (idx >= 0) & (idx < cells)
        routed = torch.where(keep, idx.long(),
                             torch.full_like(idx, cells).long())
        ms = graph_ms(lambda: ss.segment_sum(w, idx, cells))
        plain_ms = graph_ms(lambda: ss.segment_sum_plain(w, idx, cells))
        lib_ms = graph_ms(lambda: torch.zeros((cells + 1, lanes),
                                              device="cuda").index_add_(
                                                  0, routed, w))
        # the rows with an id in range must be read, the others need not
        live = int(keep.sum())
        added = int(((w != 0) & keep[:, None]).sum())
        b_ms, b_by = bound_ms(live * lanes * 4 + rows * 4 +
                              cells * lanes * 4, added)
        print(f"  segment_sum, {ids} ids ({live} of {rows} rows in range): "
              f"{ms * 1e3:.2f} us kernel, {plain_ms * 1e3:.2f} us plain, "
              f"{lib_ms * 1e3:.2f} us index_add_, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
        if seg is None:       # the JSON entry: random ids
            seg = {"name": "segment_sum", "route": "cuda",
                   "source": "embodied_object_detection_tpu_torch/csrc/"
                             "segment_sum.cu",
                   "replaces": "embodied_object_detection_tpu/ops/"
                               "pallas_scatter.py:60",
                   "launches": launches["segment_sum"],
                   "max_abs_err": errs["segment_sum"],
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib_ms}

    read = None
    for ids in ("random", "coherent"):
        feats, obs, proj = memory_read_inputs(rng)
        if ids == "coherent":
            proj = torch.from_numpy(coherent_proj(rng)).cuda()
        ms = graph_ms(lambda: memory_ops.memory_read(feats, obs, proj))
        plain_ms = graph_ms(lambda: memory_ops.memory_read_plain(feats, obs,
                                                                 proj))
        lib_ms = read_yardstick(feats[None], obs[None], proj[None],
                                memory_ops.memory_read(feats, obs,
                                                       proj)[None],
                                f"memory_read ({ids} ids)")
        h, wd = proj.shape
        d = feats.shape[1]
        rows_read = int(torch.unique(proj).numel())
        out_elems = (h // 4) * (wd // 4) * d
        b_ms, b_by = bound_ms(rows_read * d * 4 + obs.numel() * 4 +
                              proj.numel() * 4 + out_elems * 4,
                              out_elems * (16 * 2 + 1))
        print(f"  memory_read, {ids} ids ({rows_read} cells read): "
              f"{ms * 1e3:.2f} us kernel, {plain_ms * 1e3:.2f} us plain, "
              f"{lib_ms * 1e3:.2f} us embedding_bag, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})")
        if read is None:      # the JSON entry: random ids
            read = {"name": "memory_read", "route": "cuda",
                    "source": "embodied_object_detection_tpu_torch/csrc/"
                              "memory_read.cu",
                    "replaces": "embodied_object_detection_tpu/ops/"
                                "memory_ops.py:43",
                    "launches": launches["memory_read"],
                    "max_abs_err": errs["memory_read"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms}
    kernels = [seg, read] + time_nms(rng, launches, errs) + \
        time_roi_align(rng, launches, errs) + \
        time_roi_align_backward(rng, train_launches, errs) + \
        time_mask_paste(rng, launches, errs) + \
        time_memory_read_batched(rng, train_launches, errs) + \
        time_write_select(rng, launches, errs)
    for k in kernels:
        print(f"  {k['name']}: {k['ms'] * 1e3:.1f} us kernel, "
              f"{k['plain_ms'] * 1e3:.1f} us plain, bound "
              f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}), library "
              f"{'-' if k['library_ms'] is None else '%.1f us' % (k['library_ms'] * 1e3)}")
    phase(7, "kernel device times from CUDA graphs of 20 calls x 10 "
             "replays, inputs L2-warm (the plain NMS, which checks its "
             "fixpoint on the host, and the plain ROIAlign backward, "
             "torch autograd, from CUDA events around 20 eager calls)")
    return kernels


def time_nms(rng, launches, errs):
    """Every NMS shape of the frame, the bypass and the partition's cases;
    the JSON entry is the multiclass one (2048 candidates, 20 classes),
    two of the three calls a frame."""
    from embodied_object_detection_tpu_torch.ops import nms
    entry = None
    part_rng = np.random.RandomState(6)
    for cases, r in ((NMS_CASES, rng), (PARTITION_CASES, part_rng)):
        for name, n, classes, t, ml, shift in cases:
            b, c, v = nms_inputs(r, n, classes, shift)
            disabled = ml and not t > 0
            ms = graph_ms(lambda: nms.nms_keep(b, c, v, t, disabled))
            plain_ms = event_ms(lambda: nms.nms_keep_plain(b, c, v, t,
                                                           disabled))
            # IoU operations of the pairs that need one (i < j, both valid,
            # one class); the sweep is serial and bound by its latency
            _, per_class = torch.unique(c[v], return_counts=True)
            pairs = 0 if disabled else sum(k * (k - 1) // 2
                                           for k in per_class.tolist())
            b_ms, b_by = bound_ms(n * (16 + 4 + 1) + n, 13 * pairs)
            print(f"  nms, {name}: {ms * 1e3:.1f} us kernel, "
                  f"{plain_ms * 1e3:.1f} us plain, bound {b_ms * 1e3:.3f} us "
                  f"({b_by}: {pairs} IoUs); the sweep is serial, bound by "
                  f"latency, not by bytes")
            if name == MULTICLASS_CASE:
                entry = {"name": "nms", "route": "cuda",
                         "source": "embodied_object_detection_tpu_torch/csrc/nms.cu",
                         "replaces": "embodied_object_detection_tpu/ops/nms.py:51",
                         "launches": launches["nms"],
                         "max_abs_err": errs["nms"], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}
    return [entry]


def time_roi_align(rng, launches, errs):
    """Both pooler shapes and the training pooler's in bf16; the JSON
    entry is the box pooler's (R = 256, 7 x 7), three of the four calls a
    frame."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    entry = None
    for r, size in ((256, 7), (100, 14), (512, 7)):
        levels, boxes = roi_inputs(rng, r, torch.bfloat16)
        lvl = roi_levels(boxes)
        ms = graph_ms(lambda: ra.roi_align_cuda(levels, boxes, lvl, STRIDES,
                                                size, 2))
        plain_ms = graph_ms(lambda: ra._roi_align_taps(levels, boxes, STRIDES,
                                                       size, 2, lvl))
        v4_ms = graph_ms(lambda: ra._roi_align_matmul(levels, boxes, STRIDES,
                                                      size, 2, lvl))
        c = levels[0].shape[-1]
        out_elems = r * size * size * c
        b_ms, b_by = bound_ms(
            sum(f.numel() * 2 for f in levels) + r * 20 + out_elems * 2,
            out_elems * (4 * 8 + 1))
        print(f"  roi_align, R = {r}, {size}x{size}, bf16: {ms * 1e3:.1f} us "
              f"kernel, {plain_ms * 1e3:.1f} us plain v1, "
              f"{v4_ms * 1e3:.1f} us plain v4, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
        if entry is None:
            entry = {"name": "roi_align", "route": "cuda",
                     "source": "embodied_object_detection_tpu_torch/csrc/roi_align.cu",
                     "replaces": "embodied_object_detection_tpu/ops/roi_align.py:229",
                     "launches": launches["roi_align"],
                     "max_abs_err": errs["roi_align"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
    return [entry]


def time_roi_align_backward(rng, launches, errs, r=512):
    """The training pooler's backward (R = 512, 7 x 7 x 256, bf16), three
    calls a frame; its plain version is torch autograd of the tap form."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    levels, boxes = roi_inputs(rng, r, torch.bfloat16)
    lvl = roi_levels(boxes)
    grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32)
                            ).cuda().to(torch.bfloat16)
    shapes = [f.shape[:2] for f in levels]
    ms = graph_ms(lambda: ra.roi_align_backward_cuda(
        grad, shapes, boxes, lvl, STRIDES, 2, torch.bfloat16))
    leaves = [f.requires_grad_(True) for f in levels]
    plain_ms = event_ms(lambda: torch.autograd.grad(
        ra._roi_align_taps(leaves, boxes, STRIDES, 7, 2, lvl), leaves,
        grad.float()))
    c = grad.shape[-1]
    scalar, vector = backward_atomics(levels, boxes, lvl, c)
    contributions = float(scalar)
    b_ms, b_by = bound_ms(grad.numel() * 2 + r * 20 +
                          sum(f.numel() * 2 for f in levels),
                          2 * contributions)
    print(f"  roi_align backward, R = {r}, 7x7, bf16: {ms * 1e3:.1f} us "
          f"kernel, {plain_ms * 1e3:.1f} us plain v1 autograd, "
          f"{contributions:.3e} contributions summed in registers and "
          f"flushed as {vector} float4 atomics, bound {b_ms * 1e3:.2f} us "
          f"({b_by})")
    return [{"name": "roi_align_backward", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/roi_align.cu",
             "replaces": "embodied_object_detection_tpu/ops/roi_align.py:229",
             "launches": launches["roi_align_backward"],
             "max_abs_err": errs["roi_align_backward"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None}]


def time_memory_read_batched(rng, launches, errs, b=TRAIN_FRAMES):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats = torch.from_numpy(
        (rng.randn(b, 8192, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (b, 8192))
                           .astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (b, 480, 640)).astype(np.int32)).cuda()
    ms = graph_ms(lambda: memory_ops.memory_read_batched(feats, obs, proj))
    plain_ms = graph_ms(lambda: memory_ops.memory_read_batched_plain(
        feats, obs, proj))
    lib_ms = read_yardstick(feats, obs, proj, memory_ops.memory_read_batched(
        feats, obs, proj), "memory_read_batched")
    d = feats.shape[-1]
    rows_read = sum(int(torch.unique(proj[i]).numel()) for i in range(b))
    out_elems = b * 120 * 160 * d
    b_ms, b_by = bound_ms(rows_read * d * 4 + obs.numel() * 4 +
                          proj.numel() * 4 + out_elems * 4,
                          out_elems * (16 * 2 + 1))
    return [{"name": "memory_read_batched", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/memory_read.cu",
             "replaces": "embodied_object_detection_tpu/ops/memory_ops.py:75",
             "launches": launches["memory_read_batched"],
             "max_abs_err": errs["memory_read_batched"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


def read_yardstick(feats, obs, proj, got, name, pool=4):
    """Time one F.embedding_bag(mode="mean") over bags of the pool x pool
    window ids into the normalised table widened to f32, both prepared
    beforehand (frame b's ids offset by b * cells); print its largest
    difference from the kernel's output `got`. Timed only: the port never
    calls it."""
    import torch.nn.functional as F
    from embodied_object_detection_tpu_torch.ops import memory_ops
    b, cells, d = feats.shape
    h, w = proj.shape[1:]
    table = memory_ops.normalize_memory(feats.reshape(-1, d),
                                        obs.reshape(-1)).to(
                                            torch.bfloat16).float()
    idx = proj.long() + (torch.arange(b, device="cuda") * cells)[:, None,
                                                                 None]
    idx = idx.reshape(b, h // pool, pool, w // pool, pool).permute(
        0, 1, 3, 2, 4).reshape(-1, pool * pool).contiguous()
    lib_ms = graph_ms(lambda: F.embedding_bag(idx, table, mode="mean"))
    diff = float((F.embedding_bag(idx, table, mode="mean").reshape(got.shape)
                  - got).abs().max())
    print(f"  {name}: the F.embedding_bag(mean) yardstick differs from the "
          f"kernel by at most {diff:.3e} ({lib_ms * 1e3:.1f} us)")
    return lib_ms


def time_write_select(rng, launches, errs):
    """The selection on the paste's flags (the frame's path; the JSON
    entry), and the two-pass selection on masks alone beside it. The bound
    counts what the select pass must move: the flags, the counts, the
    selected pixels' mask rows and cell ids, seg_idx and aug."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    from embodied_object_detection_tpu_torch.ops import memory_ops
    probs, boxes = paste_inputs(rng)
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    masks, observed, counts = mp.paste_masks_observed(probs, boxes, valid,
                                                      480, 640)
    ms = graph_ms(lambda: memory_ops.write_select(masks, valid, proj, 8,
                                                  observed, counts))
    two_pass_ms = graph_ms(lambda: memory_ops.write_select(masks, valid,
                                                           proj, 8))
    plain_ms = graph_ms(lambda: memory_ops.write_select_plain(
        masks, valid, proj, 8, observed, counts))
    h, w, n = masks.shape
    slots = h * (w // 8)
    seg, _ = memory_ops.write_select(masks, valid, proj, 8, observed, counts)
    filled = int((seg >= 0).sum())
    b_ms, b_by = bound_ms(observed.numel() + counts.numel() * 4 + n +
                          filled * (n + 4) + slots * 4 +
                          slots * (n + 1) * 4, filled * n)
    print(f"  write_select on the paste's flags: {ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}; {filled} pixels selected); the "
          f"two-pass selection on masks alone {two_pass_ms * 1e3:.1f} us")
    return [{"name": "write_select", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/write_select.cu",
             "replaces": "embodied_object_detection_tpu/ops/memory_ops.py:188",
             "launches": launches["write_select"],
             "max_abs_err": errs["write_select"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None}]


def time_mask_paste(rng, launches, errs):
    """The write's paste with its flag epilogue (100 masks into 480 x 640,
    pixel-major bool, the frame's path; the JSON entry), and the paste
    without it beside it; the yardstick is one F.grid_sample
    (align_corners=False, zero padding) and the compare, on a sampling
    grid built beforehand."""
    import torch.nn.functional as F
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    masks, boxes = paste_inputs(rng)
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    n, m, _ = masks.shape
    h, w = 480, 640
    ms = graph_ms(lambda: mp.paste_masks_observed(masks, boxes, valid, h, w))
    bare_ms = graph_ms(lambda: mp.paste_masks(masks, boxes, h, w, 0.5,
                                              pixel_major=True))
    plain_ms = graph_ms(lambda: plain_observed(masks, boxes, valid, h, w))
    xs = torch.arange(w, device="cuda", dtype=torch.float32) + 0.5
    ys = torch.arange(h, device="cuda", dtype=torch.float32) + 0.5
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-4)[:, None]
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-4)[:, None]
    gx = (xs[None] - boxes[:, 0, None]) / bw * 2.0 - 1.0
    gy = (ys[None] - boxes[:, 1, None]) / bh * 2.0 - 1.0
    grid = torch.stack([gx[:, None, :].expand(n, h, w),
                        gy[:, :, None].expand(n, h, w)], -1).contiguous()

    def library():
        return F.grid_sample(masks[:, None], grid, mode="bilinear",
                             padding_mode="zeros",
                             align_corners=False)[:, 0] >= 0.5

    lib_ms = graph_ms(library)
    lib_flips = int((library().permute(1, 2, 0) !=
                     mp.paste_masks_plain(masks, boxes, h, w, 0.5,
                                          pixel_major=True)).sum())
    tiles = -(-w // mp.TILE_COLS)
    b_ms, b_by = bound_ms(n * m * m * 4 + n * 16 + n + h * w * n + h * w +
                          h * tiles * 4, h * w * n * 10)
    print(f"  mask_paste with the flag epilogue {ms * 1e3:.1f} us, without "
          f"it {bare_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); "
          f"the grid_sample yardstick disagrees with the plain version on "
          f"{lib_flips} of {h * w * n} pixels")
    return [{"name": "mask_paste", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/mask_paste.cu",
             "replaces": "embodied_object_detection_tpu/ops/mask_paste.py:38",
             "launches": launches["mask_paste"],
             "max_abs_err": errs["mask_paste"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


def plain_observed(masks, boxes, valid, h, w):
    """The plain version of the exact write's paste on the card: the plain
    paste, then its flags and row counts."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    out = mp.paste_masks_plain(masks, boxes, h, w, 0.5, pixel_major=True)
    observed = (out & valid).any(dim=-1)
    return out, observed, observed.sum(dim=1, keepdim=True,
                                       dtype=torch.int32)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one eval chunk, the eval engine's "
                             "first 2 chunks and one training step into "
                             "DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import embodied_object_detection_tpu_torch  # noqa: F401  fails alone

    card = smi("name,power.limit")
    print(card)
    phase(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"{torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} card(s)")
    build_kernels()
    rng = np.random.RandomState(123)
    errs = {"segment_sum": check_segment_sum(rng),
            "memory_read": check_memory_read(rng),
            "nms": check_nms(rng),
            "roi_align": check_roi_align(rng),
            "mask_paste": check_mask_paste(rng),
            "write_select": check_write_select(rng),
            "memory_read_batched": check_memory_read_batched(rng),
            "roi_align_backward": check_roi_align_backward(rng)}
    launches, _ = run_main_path(args.profile)
    run_episode_modes()
    check_against_cpu()
    check_against_cpu("longterm")
    run_eval_engine(args.profile)
    eval_engine_against_cpu()
    train_launches, _, _ = run_train_path(args.profile)
    check_train_against_cpu()
    kernels = time_kernels(rng, launches, train_launches, errs)
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
