"""Synthetic training batches made from a seed, with numpy.

A batch has the shapes of `engine/train.py:chunks_to_train_batch`'s at
the config's widths: random RGB, per-pixel cell ids in [0, cells) drawn
uniformly (a worst case for the memory read's locality), random memory
sums and observation counts, up to `max_gt_boxes` random GT boxes with
classes, and trailing padding frames of weight 0 with all-zero inputs.
Training on it exercises every op of the step; the weights learn nothing
meaningful.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..config import DetectorConfig
from ..parallel.train_step import TrainBatch


def synthetic_train_batch(cfg: DetectorConfig, rng: np.random.RandomState,
                          frames: int,
                          valid_frames: Optional[int] = None) -> TrainBatch:
    """A numpy TrainBatch of `frames` rows, the first `valid_frames`
    (default all) real, each with 1..max_gt_boxes valid GT boxes of 16 px
    or more inside the image."""
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    g = cfg.input.max_gt_boxes
    n = frames if valid_frames is None else valid_frames
    fast = np.random.default_rng(rng.randint(2 ** 31))
    image = np.zeros((frames, h, w, 3), np.float32)
    image[:n] = fast.integers(0, 256, (n, h, w, 3)).astype(np.float32)
    proj = np.zeros((frames, h, w), np.int32)
    proj[:n] = fast.integers(0, cells, (n, h, w), dtype=np.int32)
    memf = np.zeros((frames, cells, d), np.float32)
    memf[:n] = (fast.random((n, cells, d), dtype=np.float32) - 0.5) * 8.0
    memo = np.zeros((frames, cells), np.float32)
    memo[:n] = fast.choice(np.array([0.0, 1.0, 2.0, 5.0], np.float32),
                           (n, cells))
    boxes = np.zeros((frames, g, 4), np.float32)
    classes = np.zeros((frames, g), np.int32)
    valid = np.zeros((frames, g), bool)
    for b in range(n):
        k = int(rng.randint(1, g + 1))
        bw = rng.uniform(16, w / 2, k)
        bh = rng.uniform(16, h / 2, k)
        x0 = rng.uniform(0, w - bw)
        y0 = rng.uniform(0, h - bh)
        boxes[b, :k] = np.stack([x0, y0, x0 + bw, y0 + bh], 1)
        classes[b, :k] = rng.randint(0, cfg.roi.num_classes, k)
        valid[b, :k] = True
    weight = np.zeros((frames,), np.float32)
    weight[:n] = 1.0
    return TrainBatch(image=image, proj_indices=proj, mem_features=memf,
                      mem_obs=memo, gt_boxes=boxes, gt_classes=classes,
                      gt_valid=valid, weight=weight)


def synthetic_batch_fn(cfg: DetectorConfig, frames: int,
                       valid_frames: Optional[int] = None) -> Callable:
    """A `batch_fn(it, rng, dp)` for `engine.train.train` that makes each
    iteration's batch from the loop's per-iteration stream."""
    def batch_fn(it: int, rng: np.random.RandomState, dp: int) -> TrainBatch:
        return synthetic_train_batch(cfg, rng, frames, valid_frames)
    return batch_fn
