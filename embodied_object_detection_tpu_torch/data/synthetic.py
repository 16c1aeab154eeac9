"""Synthetic data made from a seed, with numpy: training batches, and
episodes in the reference's on-disk format.

Episodes (the port's copy of the JAX package's `data/synthetic.py`
generator, the stand-in for the habitat-sim data pipeline, ref:
Detic/SMNet/build_data.py + build_memory_data.py): scenes of coloured
rectangles seen by a panning camera, each frame's pixels projected onto a
map_h x map_w grid of cells that follows the pan.
`generate_synthetic_dataset` writes them in the reference format, so
`EpisodeDataset` and the evaluation read them unmodified; the same seed
gives the same arrays as the JAX package's generator.
`SyntheticEpisodes` holds them in memory as a dataset, for machines
without h5py. `SyntheticRenderer` renders such a scene frame by frame for
the dataset builder (`data/build_data.py`).

  memory_data/<scene>_<k>.h5 : memory_features (zeros), proj_indices
      [T, H, W, 1], semmap_gt (zeros, class_space "lvis21")
  sensor_data/<scene>_<k>.h5 : rgb [T, H, W, 3], detection_data (stringified
      dicts with xywh gt_boxes), segmentation_data (zeros)
  JPEGImages/*.jpg           : per-frame JPEGs

A training batch has the shapes of `engine/train.py:chunks_to_train_batch`'s at
the config's widths: random RGB, per-pixel cell ids in [0, cells) drawn
uniformly (a worst case for the memory read's locality), random memory
sums and observation counts, up to `max_gt_boxes` random GT boxes with
classes, and trailing padding frames of weight 0 with all-zero inputs.
Training on it exercises every op of the step; the weights learn nothing
meaningful.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from ..config import DetectorConfig
from ..parallel.train_step import TrainBatch
from .episode_dataset import EpisodeChunk, assemble_chunk


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


def _render_frame(rng: np.random.RandomState, h: int, w: int,
                  objects: List[dict],
                  pan: float) -> Tuple[np.ndarray, list, list]:
    """Draw each scene object as a coloured rectangle shifted by the
    camera pan; returns the image and its visible objects' xywh boxes and
    classes."""
    img = np.full((h, w, 3), 60, np.uint8)
    img += (rng.rand(h, w, 3) * 20).astype(np.uint8)
    boxes, classes = [], []
    for obj in objects:
        x = int(obj["x"] - pan)
        y = int(obj["y"])
        bw, bh = obj["w"], obj["h"]
        x1, y1 = max(0, x), max(0, y)
        x2, y2 = min(w, x + bw), min(h, y + bh)
        if x2 - x1 < 8 or y2 - y1 < 8:
            continue
        img[y1:y2, x1:x2] = obj["color"]
        boxes.append([float(x1), float(y1), float(x2 - x1),
                      float(y2 - y1)])
        classes.append(int(obj["cls"]))
    return img, boxes, classes


class SyntheticRenderer:
    """The `data/build_data.py:Renderer` protocol without a simulator (the
    habitat-free stand-in for HabitatUtils, habitat_utils.py:14-284): a
    panoramic wall of coloured rectangles at a fixed depth, panned by the
    agent's heading and x. The same seed renders the same frames as the
    JAX package's renderer."""

    def __init__(self, height: int = 480, width: int = 640, seed: int = 0,
                 num_objects: int = 6, wall_depth: float = 3.0,
                 class_ids: Optional[List[int]] = None):
        self.h, self.w = height, width
        self.wall_depth = wall_depth
        self.rng = np.random.RandomState(seed)
        class_ids = class_ids or [0, 2, 3, 4, 5]
        self.objects = []
        for _ in range(num_objects):
            self.objects.append(dict(
                x=int(self.rng.rand() * width * 2),
                y=int(self.rng.rand() * (height - 120)),
                w=int(40 + self.rng.rand() * 120),
                h=int(40 + self.rng.rand() * 120),
                color=self.rng.randint(90, 255, 3,
                                       dtype=np.int64).astype(np.uint8),
                cls=int(class_ids[self.rng.randint(len(class_ids))])))
        self._pan = 0.0
        self._cached = None

    def set_agent_state(self, position, rotation_euler) -> None:
        # the heading (rotation_euler[1], radians) pans the panorama
        self._pan = float(rotation_euler[1]) * self.w / 1.5 + \
            float(position[0]) * 40.0
        self._cached = None

    def _frame(self):
        # rendered once a pose: rgb, semantic and boxes agree whatever the
        # order of the render_* calls, and the stream advances once a frame
        if self._cached is None:
            self._cached = _render_frame(self.rng, self.h, self.w,
                                         self.objects, self._pan)
        return self._cached

    def render_rgb(self) -> np.ndarray:
        return self._frame()[0]

    def render_depth(self) -> np.ndarray:
        return np.full((self.h, self.w), self.wall_depth, np.float32)

    def render_semantic(self) -> np.ndarray:
        _, boxes, classes = self._frame()
        seg = np.zeros((self.h, self.w), np.int32)
        for b, c in zip(boxes, classes):
            x, y, bw, bh = (int(v) for v in b)
            seg[y: y + bh, x: x + bw] = c + 1
        return seg

    def render_boxes(self) -> List[dict]:
        _, boxes, classes = self._frame()
        return [dict(box=[b[0], b[1], b[0] + b[2], b[1] + b[3]], id=c)
                for b, c in zip(boxes, classes)]


def synthetic_chunks(num_scenes: int = 1, chunks_per_scene: int = 2,
                     frames: int = 20, height: int = 480, width: int = 640,
                     map_h: int = 40, map_w: int = 40, seed: int = 0,
                     class_ids: Optional[List[int]] = None
                     ) -> Iterator[tuple]:
    """Yield each chunk as (sequence file name, rgb [T, H, W, 3] uint8,
    detection records (the reference's stringified dicts), frame file
    names, proj ids [T, H, W, 1] int64), scenes and chunks in order."""
    rng = np.random.RandomState(seed)
    class_ids = class_ids or [0, 2, 3, 4, 5]
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    my = np.clip((ys / height * (map_h - 1)).astype(np.int64), 0, map_h - 1)
    for s in range(num_scenes):
        scene = f"scene{s:04d}_lvl0"
        # static scene objects in an extended panorama
        objects = []
        for _ in range(6):
            objects.append(dict(
                x=int(rng.rand() * width * 2),
                y=int(rng.rand() * (height - 120)),
                w=int(40 + rng.rand() * 120), h=int(40 + rng.rand() * 120),
                color=rng.randint(90, 255, 3,
                                  dtype=np.int64).astype(np.uint8),
                cls=int(class_ids[rng.randint(len(class_ids))])))
        for k in range(chunks_per_scene):
            rgbs = np.zeros((frames, height, width, 3), np.uint8)
            records, names = [], []
            proj = np.zeros((frames, height, width, 1), np.int64)
            for i in range(frames):
                pan = (k * frames + i) * 8.0
                img, boxes, classes = _render_frame(rng, height, width,
                                                    objects, pan)
                rgbs[i] = img
                fname = f"{scene}_{k}_{i}.jpg"
                names.append(fname)
                # the reference writes str(dict) (build_data.py:275-286)
                records.append(str({"file_name": fname, "image": 0,
                                    "gt_boxes": boxes,
                                    "gt_classes": classes}))
                # pixel -> map cell, following the pan
                mx = ((xs + pan) / (width * 2) * (map_w - 1)).astype(np.int64)
                proj[i, ..., 0] = my * map_w + np.clip(mx, 0, map_w - 1)
            yield f"{scene}_{k}.h5", rgbs, records, names, proj


def generate_synthetic_dataset(root: str, num_scenes: int = 1,
                               chunks_per_scene: int = 2, frames: int = 20,
                               height: int = 480, width: int = 640,
                               map_h: int = 40, map_w: int = 40,
                               seed: int = 0,
                               class_ids: Optional[List[int]] = None) -> None:
    """Write `synthetic_chunks(...)` under `root` in the reference
    format."""
    import h5py
    from PIL import Image
    for sub in ("memory_data", "sensor_data", "JPEGImages"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    num_cells = map_h * map_w
    for seq, rgbs, records, names, proj in synthetic_chunks(
            num_scenes, chunks_per_scene, frames, height, width, map_h,
            map_w, seed, class_ids):
        for img, fname in zip(rgbs, names):
            Image.fromarray(img).save(
                os.path.join(root, "JPEGImages", fname), quality=90)
        with h5py.File(os.path.join(root, "sensor_data", seq), "w") as f:
            f.create_dataset("rgb", data=rgbs)
            f.create_dataset("detection_data",
                             data=np.array(records, dtype=object),
                             dtype=h5py.string_dtype())
            f.create_dataset("segmentation_data",
                             data=np.zeros((frames, height, width),
                                           np.int32))
        with h5py.File(os.path.join(root, "memory_data", seq), "w") as f:
            f.create_dataset("memory_features",
                             data=np.zeros((num_cells, 512), np.float32))
            f.create_dataset("proj_indices", data=proj)
            d = f.create_dataset("semmap_gt",
                                 data=np.zeros((num_cells,), np.int32))
            # lvis-20+1 id space (all void here)
            d.attrs["class_space"] = "lvis21"


class SyntheticEpisodes:
    """`synthetic_chunks(**kw)` as an in-memory episode dataset: item i
    is the `EpisodeChunk` that `EpisodeDataset` reads from the files
    `generate_synthetic_dataset(**kw)` writes, with the h5 `rgb` rows in
    place of the JPEGs (test_type default or episodic)."""

    def __init__(self, test_type: str = "default",
                 max_sequence_length: int = 20, max_gt: int = 64, **kw):
        if test_type not in ("default", "episodic"):
            raise ValueError(f"test_type={test_type!r}: the in-memory "
                             "episodes have no longterm doubling")
        self.test_type = test_type
        self.max_sequence_length = max_sequence_length
        self.max_gt = max_gt
        self.num_cells = kw.get("map_h", 40) * kw.get("map_w", 40)
        self.chunks = [(seq, rgbs, records,
                        proj[..., 0].astype(np.int32))
                       for seq, rgbs, records, _, proj in
                       synthetic_chunks(**kw)]

    def __len__(self) -> int:
        return len(self.chunks)

    @property
    def files(self) -> List[str]:
        """The chunks' file names, `<scene>_<k>.h5`, in order."""
        return [c[0] for c in self.chunks]

    def __getitem__(self, index: int) -> EpisodeChunk:
        seq, rgbs, records, proj = self.chunks[index]
        return assemble_chunk(
            seq, records[:self.max_sequence_length], rgbs.__getitem__, proj,
            rgbs.shape[1:3], test_type=self.test_type,
            max_sequence_length=self.max_sequence_length,
            max_gt=self.max_gt, num_cells=self.num_cells)
