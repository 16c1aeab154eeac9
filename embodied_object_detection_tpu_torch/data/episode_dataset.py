"""Episode dataset: the reader for the reference's on-disk format.

The port's own copy of the JAX package's `data/episode_dataset.py` (ref:
Detic/SMNet/loader.py:58-308, SMNetDetectionLoader), with its quirks:
  * memory_data/<seq>.h5: memory_features [cells, D], proj_indices
    [T, H, W, 1], semmap_gt
  * sensor_data/<seq>.h5: rgb [T, H, W, 3], detection_data -- *stringified
    python dicts* parsed with string splits + ast.literal_eval
    (loader.py:255-267), segmentation_data
  * JPEGImages/<file_name>.jpg -- the actual eval images, the h5 `rgb` row
    when one is missing
  * class filtering to the 15-id subset (loader.py:134)
  * memory-reset flags per test_type (loader.py:288-293)
  * longterm episode doubling (loader.py:108-117)

Output is fixed-shape numpy per chunk (padded GT). h5py and PIL are
imported by the functions that read files, so the package imports where
they are absent; `assemble_chunk` builds a chunk from records and arrays
already in memory (`data/synthetic.py:SyntheticEpisodes`).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# ref: loader.py:134 — classes included for detections
CLASS_IDS = [0, 2, 3, 4, 5, 6, 7, 9, 12, 13, 14, 15, 16, 17, 19]

# object_lvis -> SMNet class-id row remap for the map_gt baseline when the
# GT semmap (13 SMNet classes) indexes the CLIP table (loader.py:136, :245)
SMNET_CLASS_MAPPING = [0, 11, 17, 1, 14, 4, 13, 10, 16, 6, 0, 0, 18]

# ref: custom_rcnn.py:988-989 / loader.py:132 — the 20-class mp3d vocabulary
OBJECT_LVIS = ['bed', 'stool', 'towel', 'fireplace', 'picture', 'cabinet',
               'toilet', 'curtain', 'lighting', 'table', 'shelving', 'mirror',
               'sofa', 'cushion', 'bathtub', 'chair', 'chest_of_drawers',
               'sink', 'seating', 'tv_monitor']


def sort_episode_files(files: Sequence[str]) -> List[str]:
    """ref: loader.py:97-105 (custom_sort): sort by (scene prefix, chunk id)."""
    def key(string):
        parts = string.split("_")
        name = "_".join(parts[:-1]) + "_"
        num = int(parts[-1].split(".")[0])
        return (name, num)
    return sorted(files, key=key)


def parse_detection_record(record: bytes | str) -> Tuple[str, np.ndarray, np.ndarray]:
    """Parse one stringified detection dict.

    ref: loader.py:255-267 — the GT is stored as a python-dict string; the
    reference slices it with string splits, converts xywh->xyxy, and filters
    to CLASS_IDS. Reproduced bit-for-bit (including the [1:-1] quote strip).
    """
    s = record.decode() if isinstance(record, bytes) else str(record)
    s = s.replace("'", '"')
    file_name = s.split('"file_name": ')[1].split(', "image": ')[0]
    gt_box_s, gt_class_s = s.split('"gt_boxes": ')[1].split(', "gt_classes": ')
    gt_class = ast.literal_eval(gt_class_s[:-1])
    gt_box = ast.literal_eval(gt_box_s)
    gt_box = [[b[0], b[1], b[2] + b[0], b[3] + b[1]] for b in gt_box]
    keep = [i for i, c in enumerate(gt_class) if c in CLASS_IDS]
    boxes = np.array([gt_box[i] for i in keep], np.float32).reshape(-1, 4)
    classes = np.array([gt_class[i] for i in keep], np.int32)
    return file_name[1:-1], boxes, classes


@dataclass
class EpisodeChunk:
    """One <=20-frame episode chunk, fixed shapes. Its fields include
    those of `engine/train.py:ChunkRecord`, so the training loop takes it
    as it is."""
    sequence_name: str
    file_names: List[str]
    images: np.ndarray            # [T, H, W, 3] uint8 RGB
    proj_indices: np.ndarray      # [T, H, W] int32
    gt_boxes: np.ndarray          # [T, G, 4] float32 xyxy
    gt_classes: np.ndarray        # [T, G] int32
    gt_valid: np.ndarray          # [T, G] bool
    memory_reset: np.ndarray      # [T] bool
    episode_start: np.ndarray     # [T] bool
    num_cells: int                # memory cells for this scene
    frame_valid: np.ndarray       # [T] bool (padding when chunk < T frames)
    # training-time precomputed memory (None for eval; ref: loader.py:216-227)
    memory_features: "np.ndarray | None" = None   # [cells, D]
    observations: "np.ndarray | None" = None      # [cells]


def assemble_chunk(file: str, det_records: Sequence, rgb_row: Callable,
                   proj: np.ndarray, image_hw: Tuple[int, int],
                   test_type: str = "default",
                   max_sequence_length: int = 20, max_gt: int = 64,
                   num_cells: int = 0,
                   memory_features: Optional[np.ndarray] = None,
                   observations: Optional[np.ndarray] = None,
                   load_image: Optional[Callable] = None) -> EpisodeChunk:
    """One chunk from its detection records (one a frame), the frames'
    RGB rows (`rgb_row(i)`, read only when `load_image(file_name,
    fallback)` falls back to them, or always without `load_image`) and its
    [T, H, W] proj ids: GT parsed and padded to `max_gt`, frames padded to
    `max_sequence_length`, reset flags by `test_type` (loader.py:288-293).
    """
    t_max = max_sequence_length
    t = len(det_records)
    h, w = image_hw
    images = np.zeros((t_max, h, w, 3), np.uint8)
    proj_out = np.zeros((t_max, h, w), np.int32)
    boxes = np.zeros((t_max, max_gt, 4), np.float32)
    classes = np.zeros((t_max, max_gt), np.int32)
    gt_valid = np.zeros((t_max, max_gt), bool)
    resets = np.zeros(t_max, bool)
    starts = np.zeros(t_max, bool)
    frame_valid = np.zeros(t_max, bool)
    file_names = []

    seq_id = int(file.split("_")[-1].split(".")[0])
    for i in range(t):
        file_name, b, c = parse_detection_record(det_records[i])
        file_names.append(file_name)
        images[i] = rgb_row(i) if load_image is None else \
            load_image(file_name, lambda i=i: rgb_row(i))
        proj_out[i] = proj[i]
        g = min(len(b), max_gt)
        if g < len(b):
            # the reference keeps every annotation
            # (train_mp3d.py:235-238); silently dropping GT turns
            # detections on the dropped objects into false positives
            print(f"WARNING: {file} frame {i}: {len(b)} GT boxes "
                  f"exceed max_gt={max_gt}; {len(b) - g} "
                  "dropped — raise input.max_gt_boxes for parity")
        boxes[i, :g] = b[:g]
        classes[i, :g] = c[:g]
        gt_valid[i, :g] = True
        # ref: loader.py:288-293
        if test_type in ("default", "longterm"):
            resets[i] = (seq_id == 0 and i == 0)
        else:  # episodic
            resets[i] = (i == 0)
        starts[i] = (i == 0)
        frame_valid[i] = True

    return EpisodeChunk(sequence_name=file, file_names=file_names,
                        images=images, proj_indices=proj_out,
                        gt_boxes=boxes, gt_classes=classes,
                        gt_valid=gt_valid, memory_reset=resets,
                        episode_start=starts, num_cells=num_cells,
                        frame_valid=frame_valid,
                        memory_features=memory_features,
                        observations=observations)


class EpisodeDataset:
    """Iterates episode chunks in the reference order.

    data_path layout (ref: loader.py:64-66):
      <data_path>/memory_data/*.h5, <data_path>/sensor_data/*.h5,
      <data_path>/JPEGImages/*.jpg
    """

    def __init__(self, data_path: str, test_type: str = "default",
                 max_sequence_length: int = 20, max_gt: int = 64,
                 load_jpeg: bool = True, semmap_path: str = "",
                 clip_path: str = "", memory_type: str = "",
                 semmap_dialect: str = "auto"):
        if semmap_dialect not in ("auto", "smnet", "lvis"):
            raise ValueError(f"semmap_dialect={semmap_dialect!r} "
                             "(expected auto|smnet|lvis)")
        # class-id space of semmap_gt for map_gt (see MemoryConfig
        # .semmap_dialect); resolved per file in __getitem__
        self.semmap_dialect = semmap_dialect
        self.data_path = data_path
        self.memory_path = os.path.join(data_path, "memory_data")
        self.sensor_path = os.path.join(data_path, "sensor_data")
        self.image_root = os.path.join(data_path, "JPEGImages")
        self.test_type = test_type
        self.max_sequence_length = max_sequence_length
        self.max_gt = max_gt
        self.load_jpeg = load_jpeg
        # training-time precomputed memory snapshots (MODEL.SEMMAP_PATH;
        # ref: loader.py:216-227) — h5 files with `impicit_memory` [sic] +
        # `observations` produced by an eval pass with TEST_SAVE_SEMMAP
        self.semmap_path = semmap_path
        # GT-memory baselines (ref: loader.py:139-142, 233-246): for
        # semantic_gt / map_gt the "memory" is the CLIP class-embedding table
        # (zero row 0 prepended) and proj indices point at classes
        self.memory_type = memory_type
        self.clip_embeddings = None
        if clip_path:
            emb = np.load(clip_path).astype(np.float32)     # [C, D]
            self.clip_embeddings = np.concatenate(
                [np.zeros((1, emb.shape[1]), np.float32), emb], axis=0)

        files = sort_episode_files(
            [f for f in os.listdir(self.memory_path) if f.endswith(".h5")])
        if test_type == "longterm":
            # ref: loader.py:108-117 — replay each 50-chunk block twice; the
            # first chunk of each replayed block is replaced by the block's
            # last chunk so memory state carries over. Preserved quirks: the
            # reference sorts the doubled BLOCKS lexicographically (so with
            # >=100 chunks/scene "x_100" blocks precede "x_50" blocks) and
            # steps the replacement by a fixed 100 (off for a trailing
            # short block) — reproduced bit-for-bit, not corrected.
            blocks = [files[i:i + 50] for i in range(0, len(files), 50)]
            files = sorted(blocks * 2)
            files = [f for blk in files for f in blk]
            for j in range(50, len(files), 100):
                files[j] = files[j - 1]
        self.files = files

    def __len__(self) -> int:
        return len(self.files)

    def _load_image(self, file_name: str, fallback) -> np.ndarray:
        """fallback is a ZERO-ARG CALLABLE returning the h5 rgb row — only
        invoked when the JPEG is missing (or load_jpeg is off), so a
        dataset with complete JPEGImages/ never pays the [T,H,W,3] h5
        read+decompress in the eval hot loop."""
        if not self.load_jpeg:
            return np.asarray(fallback())
        path = os.path.join(self.image_root, file_name)
        if not os.path.exists(path):
            return np.asarray(fallback())
        from PIL import Image, ImageOps
        with open(path, "rb") as f:
            img = Image.open(f)
            # _apply_exif_orientation (loader.py:282-284): an EXIF-tagged
            # JPEG must be rotated to match the GT boxes' orientation
            img = ImageOps.exif_transpose(img)
            img = img.convert("RGB")
            return np.asarray(img)

    def ground_truth(self, index: int) -> EpisodeChunk:
        """Chunk `index` as scoring reads it: its GT and frame flags, with
        no frames, ids or memory; only the detection records are read."""
        import h5py
        file = self.files[index]
        with h5py.File(os.path.join(self.sensor_path, file), "r") as h5:
            records = h5["detection_data"]
            det_records = [records[i] for i in range(
                min(self.max_sequence_length, len(records)))]
        return assemble_chunk(
            file, det_records, lambda i: np.zeros((0, 0, 3), np.uint8),
            np.zeros((len(det_records), 0, 0), np.int32), (0, 0),
            test_type=self.test_type,
            max_sequence_length=self.max_sequence_length, max_gt=self.max_gt)

    def __getitem__(self, index: int) -> EpisodeChunk:
        import h5py
        file = self.files[index]
        t_max = self.max_sequence_length

        with h5py.File(os.path.join(self.memory_path, file), "r") as h5:
            # only the ROW COUNT of the (zero-filled) memory template is
            # needed (ARCHITECTURE.md: "the h5 is only a cell-count
            # template") — .shape reads no data, vs tens of MB per chunk.
            # EXCEPT explicit_map: its external memory IS these values
            # (loader.py:204 + :296-302 when no semmap snapshot exists)
            num_cells = int(h5["memory_features"].shape[0])
            proj = np.array(h5["proj_indices"])
            semmap_gt = semmap_space = None
            if "semmap_gt" in h5:
                semmap_gt = np.array(h5["semmap_gt"])
                # class-space marker written by build_memory/synthetic;
                # reference-built files carry none
                semmap_space = h5["semmap_gt"].attrs.get("class_space")
                if isinstance(semmap_space, bytes):
                    semmap_space = semmap_space.decode()
            mem_h5_values = (np.array(h5["memory_features"], np.float32)
                             if self.memory_type == "explicit_map" else None)
        if proj.ndim == 4:
            proj = proj[..., 0]

        mem_features = observations = None
        semmap_real = None
        if self.semmap_path:
            snap = os.path.join(self.semmap_path, file)
            if os.path.exists(snap):
                with h5py.File(snap, "r") as h5:
                    mem_features = np.array(h5["impicit_memory"], np.float32)
                    observations = np.array(h5["observations"], np.float32)
                    if "semmap" in h5:
                        # +1: empty space shifts -1 -> 0 (loader.py:221-223)
                        semmap_real = np.array(h5["semmap"]) + 1
                num_cells = int(mem_features.shape[0])
        if self.memory_type == "explicit_map" and mem_features is None:
            mem_features = mem_h5_values
            observations = np.ones((mem_features.shape[0],), np.float32)
            num_cells = int(mem_features.shape[0])

        with h5py.File(os.path.join(self.sensor_path, file), "r") as h5:
            rgb = h5["rgb"]  # lazy handle; rows read only as JPEG fallback
            det_records = [h5["detection_data"][i]
                           for i in range(min(t_max, len(h5["detection_data"])))]
            segmentation = np.array(h5["segmentation_data"]) \
                if (self.memory_type == "semantic_gt" and
                    "segmentation_data" in h5) else None

            # GT-memory remapping (ref: loader.py:233-246, 269-273). The
            # CLIP table applies to semantic_gt/map_gt ONLY — explicit_map's
            # memory is the h5/snapshot values with raw map-cell proj
            # (train_mp3d.py wires CLIP_PATH only for those two baselines)
            if self.clip_embeddings is not None and \
                    self.memory_type in ("semantic_gt", "map_gt"):
                mem_features = self.clip_embeddings
                observations = np.ones((mem_features.shape[0],), np.float32)
                num_cells = mem_features.shape[0]
                if self.memory_type == "semantic_gt":
                    if segmentation is None:
                        raise ValueError(
                            f"memory_type=semantic_gt needs segmentation_data "
                            f"in the sensor h5 for {file} — projecting raw "
                            "map-cell indices into the tiny CLIP table would "
                            "silently clamp to garbage")
                    # per-pixel class id becomes the "projection" into the
                    # table
                    proj = segmentation.astype(np.int64)
                elif self.memory_type == "map_gt":
                    if semmap_real is not None:
                        # generated-semmap route (loader.py:239-242): the
                        # eval-pass snapshot's class map (already +1) indexes
                        # the UNMAPPED table
                        proj = semmap_real[proj]
                    elif semmap_gt is not None:
                        # GT-semmap route (loader.py:243-246). Two dialects:
                        # reference-built grids carry SMNet 13-class ids and
                        # index a ROW-REMAPPED table; repo-built grids
                        # (build_memory/synthetic) carry lvis-20+1 ids that
                        # index the zero-prepended table DIRECTLY — applying
                        # the 13-row remap to those would gather-clamp to
                        # wrong class rows silently. Resolution order: the
                        # explicit semmap_dialect override, the builders'
                        # class_space h5 attr, then a max-id heuristic
                        # (ambiguous when a 21-class scene only contains
                        # low ids — hence the warning).
                        dialect = self.semmap_dialect
                        if dialect == "auto":
                            if semmap_space is not None:
                                dialect = ("lvis"
                                           if semmap_space == "lvis21"
                                           else "smnet")
                            elif int(np.max(semmap_gt)) < \
                                    len(SMNET_CLASS_MAPPING):
                                dialect = "smnet"
                                print(f"WARNING: {file}: semmap_gt has no "
                                      "class_space attr and max id < 13 — "
                                      "assuming reference SMNet 13-class "
                                      "ids; pin memory.semmap_dialect if "
                                      "this grid is lvis-20+1")
                            else:
                                dialect = "lvis"
                        if dialect == "smnet":
                            mem_features = mem_features[SMNET_CLASS_MAPPING]
                            observations = np.ones((mem_features.shape[0],),
                                                   np.float32)
                            num_cells = mem_features.shape[0]
                        proj = semmap_gt[proj]
                    else:
                        raise ValueError(
                            f"memory_type=map_gt needs semmap_gt in the "
                            f"memory h5 (or a semmap snapshot via "
                            f"semmap_path) for {file}")

            return assemble_chunk(
                file, det_records, lambda i: rgb[i], proj, rgb.shape[1:3],
                test_type=self.test_type, max_sequence_length=t_max,
                max_gt=self.max_gt, num_cells=num_cells,
                memory_features=mem_features, observations=observations,
                load_image=self._load_image)
