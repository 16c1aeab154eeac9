"""Host-side training augmentations and the multi-source dataset mapper.

Counterpart of the JAX package's `data/augment.py` (ref: Detic/detic/data/
transforms/custom_augmentation_impl.py:25-60 EfficientDetResizeCrop,
custom_transform.py:28-112 its transform, custom_dataset_mapper.py:23-130
CustomDatasetMapper): the resize-crop's parameters are drawn from a numpy
`RandomState`, the image is resized with PIL (imported where it is used)
and cropped, boxes move with the same parameters, and the mapper pads
every frame to fixed shapes for the trainer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from .catalog import read_rgb


@dataclass
class ResizeCropParams:
    scaled_h: int
    scaled_w: int
    offset_y: int
    offset_x: int
    img_scale: float
    target_size: Tuple[int, int]


def sample_efficientdet_resize_crop(img_hw: Tuple[int, int], size: int,
                                    scale: Tuple[float, float],
                                    rng: np.random.RandomState
                                    ) -> ResizeCropParams:
    """Sample the transform parameters (ref: custom_augmentation_impl.py:
    get_transform): random target scale in `scale`, aspect-preserving
    resize so the image fits the scaled target, random crop offset when
    the scaled image exceeds the target."""
    h, w = img_hw
    f = rng.uniform(*scale)
    tgt_h = tgt_w = f * size
    img_scale = min(tgt_h / h, tgt_w / w)
    scaled_h = int(h * img_scale)
    scaled_w = int(w * img_scale)
    offset_y = int(max(0.0, float(scaled_h - size)) * rng.uniform(0, 1))
    offset_x = int(max(0.0, float(scaled_w - size)) * rng.uniform(0, 1))
    return ResizeCropParams(scaled_h, scaled_w, offset_y, offset_x,
                            img_scale, (size, size))


def apply_resize_crop_image(img: np.ndarray, p: ResizeCropParams,
                            nearest: bool = False) -> np.ndarray:
    """ref: custom_transform.py apply_image (uint8/PIL branch)."""
    from PIL import Image
    pil = Image.fromarray(np.asarray(img, np.uint8))
    pil = pil.resize((p.scaled_w, p.scaled_h),
                     Image.NEAREST if nearest else Image.BILINEAR)
    ret = np.asarray(pil)
    right = min(p.scaled_w, p.offset_x + p.target_size[1])
    lower = min(p.scaled_h, p.offset_y + p.target_size[0])
    return ret[p.offset_y: lower, p.offset_x: right]


def apply_resize_crop_boxes(boxes_xyxy: np.ndarray, p: ResizeCropParams
                            ) -> np.ndarray:
    """ref: custom_transform.py apply_coords + detectron2 apply_box (clips
    to the transformed canvas)."""
    b = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4) * p.img_scale
    b[:, [0, 2]] -= p.offset_x
    b[:, [1, 3]] -= p.offset_y
    th = min(p.scaled_h - p.offset_y, p.target_size[0])
    tw = min(p.scaled_w - p.offset_x, p.target_size[1])
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, tw)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, th)
    return b.astype(np.float32)


def inverse_apply_resize_crop_boxes(boxes_xyxy: np.ndarray,
                                    p: ResizeCropParams) -> np.ndarray:
    """ref: custom_transform.py inverse_apply_coords/inverse_apply_box —
    maps detections back to the original resolution."""
    b = np.asarray(boxes_xyxy, np.float64).reshape(-1, 4).copy()
    b[:, [0, 2]] += p.offset_x
    b[:, [1, 3]] += p.offset_y
    return (b / p.img_scale).astype(np.float32)


class MultiSourceMapper:
    """Per-dataset augmentation and fixed-shape padding (ref:
    CustomDatasetMapper, custom_dataset_mapper.py:23-130): each source has
    its own EfficientDetResizeCrop scale and size (USE_DIFF_BS_SIZE);
    image-labelled tar sources load through `DiskTarDataset` and carry
    labels instead of boxes. Frames come out on (size, size) canvases with
    scaled boxes and validity. One `RandomState(seed)` draws, per record,
    the resize-crop, the flip and the caption, in that order."""

    def __init__(self, dataset_scales: Sequence[Tuple[float, float]],
                 dataset_sizes: Sequence[int],
                 dataset_ann: Sequence[str],
                 max_gt: int = 64, max_labels: int = 16,
                 tar_dataset=None, seed: int = 0):
        assert len(dataset_scales) == len(dataset_sizes) == len(dataset_ann)
        self.dataset_scales = list(dataset_scales)
        self.dataset_sizes = list(dataset_sizes)
        self.dataset_ann = list(dataset_ann)
        self.max_gt = max_gt
        self.max_labels = max_labels
        self.tar_dataset = tar_dataset
        self.rng = np.random.RandomState(seed)

    def __call__(self, record: dict, source: int) -> dict:
        size = self.dataset_sizes[source]
        if "image" in record:
            img = np.asarray(record["image"], np.uint8)
        elif "file_name" in record:
            img = read_rgb(record["file_name"])
        else:
            assert self.tar_dataset is not None, "tar source needs a dataset"
            # the reference mapper DISCARDS the tar label ('ori_image, _, _',
            # custom_dataset_mapper.py:93) — pos_category_ids come only from
            # the dataset record; the tar synset index is in a different
            # label space (tar-file order, not LVIS contiguous ids)
            pil, _, _ = self.tar_dataset[record["tar_index"]]
            img = np.asarray(pil)

        p = sample_efficientdet_resize_crop(
            img.shape[:2], size, self.dataset_scales[source], self.rng)
        out_img = apply_resize_crop_image(img, p)
        # RandomFlip: build_custom_augmentation appends a 50% horizontal
        # flip to EVERY train pipeline (custom_build_augmentation.py:43-44)
        flip = bool(self.rng.rand() < 0.5)
        if flip:
            out_img = out_img[:, ::-1]
        canvas = np.zeros((size, size, 3), np.uint8)
        canvas[: out_img.shape[0], : out_img.shape[1]] = out_img

        out = dict(image=canvas, dataset_source=source,
                   ann_type=self.dataset_ann[source], transform=p,
                   flipped=flip)
        if self.dataset_ann[source] == "box":
            boxes = apply_resize_crop_boxes(
                np.asarray(record.get("gt_boxes",
                                      np.zeros((0, 4), np.float32))), p)
            if flip and len(boxes):
                # mirror x within the resized-crop region (the flip applies
                # before canvas padding, like the d2 transform chain)
                ow = out_img.shape[1]
                boxes = np.stack([ow - boxes[:, 2], boxes[:, 1],
                                  ow - boxes[:, 0], boxes[:, 3]], axis=1)
            classes = np.asarray(record.get("gt_classes",
                                            np.zeros((0,), np.int64)))
            gt_boxes = np.zeros((self.max_gt, 4), np.float32)
            gt_classes = np.zeros((self.max_gt,), np.int32)
            gt_valid = np.zeros((self.max_gt,), bool)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes = boxes[keep], classes[keep]
            n = min(len(boxes), self.max_gt)
            gt_boxes[:n] = boxes[:n]
            gt_classes[:n] = classes[:n]
            gt_valid[:n] = True
            out.update(gt_boxes=gt_boxes, gt_classes=gt_classes,
                       gt_valid=gt_valid)
        else:  # image-labeled / caption source
            labels = list(record.get("pos_category_ids", []))[: self.max_labels]
            lab = np.zeros((self.max_labels,), np.int32)
            lab_valid = np.zeros((self.max_labels,), bool)
            lab[: len(labels)] = labels
            lab_valid[: len(labels)] = True
            out.update(labels=lab, labels_valid=lab_valid)
            if "caption" in self.dataset_ann[source]:
                # one caption sampled per image per step
                # (ref: custom_rcnn.py:226-229 torch.randint over captions)
                caps = record.get("captions", [])
                out["caption"] = (caps[self.rng.randint(len(caps))]
                                  if caps else "")
        return out
