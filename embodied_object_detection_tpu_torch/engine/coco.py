"""Vanilla single-frame training batches and evaluation over COCO-format
datasets.

Counterpart of the JAX package's `engine/coco.py` (ref: Detic/
train_net.py, the non-embodied Detic trainer: detectron2's loop over
LVIS / COCO with CustomRCNN, no memory; and detectron2's
inference_on_dataset for the evaluation). The single-frame model is the
embodied detector with `memory.memory_type` "image_only": the frame reads
no memory, and its write is skipped.

  * `items_to_train_batch`, `coco_train_batches`: box-supervised batches
    (numpy `TrainBatch`es for `parallel/train_step.py`), one source a
    batch
  * `caption_items_to_batch`, `multi_source_train_batches`: Detic's
    co-training matrix, one ann_type a batch (box, image labels, caption,
    caption + tags), ragged labels padded, the captions embedded by the
    caller's text encoder (`models/text_encoder.py:CLIPTextEncoder`)
  * `evaluate_coco`: `make_detect`'s batch detector over the dataset on
    the model's device (the cascade `EmbodiedDetector`, the `Res5Detector`
    or the `DeformableDetrDetector`), the trunk batched over `batch`
    images, one host copy of a batch's detections, COCO or LVIS-federated
    bbox AP on the original image sizes
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import DetectorConfig
from ..data.catalog import CocoDetectionDataset, MultiDatasetSampler
from ..data.prefetch import prefetch_iterator
from ..evaluation.coco_eval import COCOEvaluator
from ..models.deformable_detr import DeformableDetrDetector
from ..models.detector import EmbodiedDetector
from ..models.res5_detector import Res5Detector
from ..parallel.train_step import TrainBatch
from ..structures import Detections, MemoryState
from .eval import scored_detections


def items_to_train_batch(items: List[dict], cfg: DetectorConfig,
                         pad_to_multiple: int = 1) -> TrainBatch:
    """Catalog or mapper items -> a numpy `TrainBatch` with zero memories,
    padded with zero-weight frames to a multiple of `pad_to_multiple`;
    the GT is padded to the items' largest max_gt."""
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    b = len(items)
    pad = (-b) % max(pad_to_multiple, 1)
    h, w = cfg.input.height, cfg.input.width
    images = np.zeros((b + pad, h, w, 3), np.float32)
    g = max(it["gt_boxes"].shape[0] for it in items)
    gt_boxes = np.zeros((b + pad, g, 4), np.float32)
    gt_classes = np.zeros((b + pad, g), np.int32)
    gt_valid = np.zeros((b + pad, g), bool)
    for i, it in enumerate(items):
        images[i] = it["image"].astype(np.float32)
        gi = it["gt_boxes"].shape[0]
        gt_boxes[i, :gi] = it["gt_boxes"]
        gt_classes[i, :gi] = it["gt_classes"]
        gt_valid[i, :gi] = it["gt_valid"]
    return TrainBatch(
        image=images,
        proj_indices=np.zeros((b + pad, h, w), np.int32),
        mem_features=np.zeros((b + pad, cells, d), np.float32),
        mem_obs=np.zeros((b + pad, cells), np.float32),
        gt_boxes=gt_boxes, gt_classes=gt_classes, gt_valid=gt_valid,
        weight=np.asarray([1.0] * b + [0.0] * pad, np.float32))


def coco_train_batches(sampler: MultiDatasetSampler,
                       datasets: List[CocoDetectionDataset],
                       cfg: DetectorConfig, batch_size: int):
    """Endless box-supervised batches, each from one source the sampler
    draws (the reference's per-dataset batches, custom_rcnn.py:203-206)."""
    while True:
        d = sampler.sample_source()
        items = [datasets[d][i] for i in sampler.sample_items(d, batch_size)]
        yield items_to_train_batch(items, cfg)


def caption_items_to_batch(items: List[dict], embed_fn, rng=None):
    """(images [B, H, W, 3] f32, caption_features [B, D] f32, weight [B])
    for `make_caption_train_step`: one caption an image (the mapper's
    pick, else drawn from `rng`, numpy's global stream when None, as the
    reference's torch.randint, custom_rcnn.py:226-232), embedded by
    `embed_fn(list[str]) -> [B, D]`; weight 0 where an image has no
    caption."""
    if rng is None:
        rng = np.random
    caps = []
    for it in items:
        if "caption" in it:
            caps.append(it["caption"])
        else:
            cc = it.get("captions", [])
            caps.append(cc[rng.randint(len(cc))] if cc else "")
    feats = np.asarray(embed_fn(caps), np.float32)
    images = np.stack([np.asarray(it["image"], np.float32) for it in items])
    weight = np.asarray([1.0 if c else 0.0 for c in caps], np.float32)
    return images, feats, weight


def pad_image_labels(items: List[dict]):
    """(labels [B, L] int32, labels_valid [B, L]): the items' ragged
    pos_category_ids (catalog items) or fixed labels with labels_valid
    (mapper items), padded to the batch's longest (at least 1)."""
    raw = [np.asarray(it.get("labels", it.get("pos_category_ids", [])),
                      np.int32).reshape(-1) for it in items]
    ln = max([len(r) for r in raw] + [1])
    labels = np.zeros((len(items), ln), np.int32)
    lv = np.zeros((len(items), ln), bool)
    for i, (it, r) in enumerate(zip(items, raw)):
        labels[i, :len(r)] = r
        v = np.asarray(it.get("labels_valid",
                              np.ones(len(r), bool))).reshape(-1)
        lv[i, :len(v)] = v[:ln]
    return labels, lv


def multi_source_train_batches(sampler: MultiDatasetSampler,
                               datasets: List[CocoDetectionDataset],
                               ann_types: List[str], cfg: DetectorConfig,
                               batch_size: int, embed_fn=None, seed: int = 0):
    """Endless (ann_type, batch) pairs over Detic's co-training sources,
    one source a batch by the sampler's ratios (custom_rcnn.py:203-206,
    custom_dataset_dataloader.py:195-266):
      'box'        -> TrainBatch
      'image'      -> (images, labels [B, L], labels_valid [B, L]) for
                      ann types 'image', 'prop', 'proptag'
      'caption'    -> (images, caption_features, weight)
      'captiontag' -> (images, caption_features, weight, labels,
                       labels_valid): both losses apply (only 'caption'
                       skips the tag loss, detic_fast_rcnn.py:370-375)
    The captions are drawn from `RandomState(seed)`."""
    rng = np.random.RandomState(seed)
    while True:
        d = sampler.sample_source()
        items = [datasets[d][i] for i in sampler.sample_items(d, batch_size)]
        at = ann_types[d]
        if at == "box":
            yield "box", items_to_train_batch(items, cfg)
        elif at == "captiontag":
            assert embed_fn is not None, "caption source needs a text encoder"
            images, feats, wt = caption_items_to_batch(items, embed_fn, rng)
            labels, lv = pad_image_labels(items)
            yield "captiontag", (images, feats, wt, labels, lv)
        elif "caption" in at:
            assert embed_fn is not None, "caption source needs a text encoder"
            yield "caption", caption_items_to_batch(items, embed_fn, rng)
        else:
            images = np.stack([np.asarray(it["image"], np.float32)
                               for it in items])
            labels, lv = pad_image_labels(items)
            yield "image", (images, labels, lv)


def make_detect(model: "EmbodiedDetector | Res5Detector | "
                "DeformableDetrDetector", cfg: DetectorConfig,
                zs: torch.Tensor):
    """The single-frame path's batch detector, `detect(images [B, H, W, 3]
    on the model's device) -> Detections [B, N, ...]`, with no host sync:
    the trunk over the batch, then each frame's heads in turn (the
    cascade's `frame_step` on zero memory, the Res5 heads), or the
    Deformable-DETR's `detect` (its transformer a frame at a time, one
    top-k over the batch). Call it under `torch.no_grad()`."""
    if isinstance(model, DeformableDetrDetector):
        return lambda images: model.detect(images, zs)
    if isinstance(model, Res5Detector):
        def per_frame(images):
            c4 = model.backbone_c4(images)
            return [model.frame_step(images[k], zs, c4=c4[k]).detections
                    for k in range(images.shape[0])]
    else:
        device = zs.device
        h, w = cfg.input.height, cfg.input.width
        memory = MemoryState.zeros(cfg.memory.max_cells,
                                   cfg.memory.memory_dim, device)
        proj = torch.zeros((h, w), dtype=torch.int32, device=device)
        outlier = torch.zeros((h, w), dtype=torch.bool, device=device)

        def per_frame(images):
            feats = model.backbone_raw(images)
            return [model.frame_step(
                images[k], zs, memory.features, memory.obs_count, proj,
                outlier, backbone_feats=tuple(f[k] for f in feats)
            ).detections for k in range(images.shape[0])]

    return lambda images: Detections(*(torch.stack(x)
                                       for x in zip(*per_frame(images))))


def evaluate_coco(model: "EmbodiedDetector | Res5Detector | "
                  "DeformableDetrDetector", cfg: DetectorConfig,
                  dataset: CocoDetectionDataset, zs_weight: np.ndarray,
                  batch: int = 8, max_images: Optional[int] = None,
                  verbose: bool = True, federated: bool = False,
                  num_workers: int = 2) -> Dict[str, float]:
    """Single-frame inference and bbox AP (inference_on_dataset analog) on
    the model's device. The dataset letterboxes each image; its detections
    are divided by the letterbox scale and clipped to the original size
    (detector_postprocess). `federated=True` selects the LVIS protocol
    (federated category drop, 300 detections an image; the items'
    neg_category_ids are the verified-absent classes), else COCO's (100).
    `make_detect` runs each batch of `batch` images with no host sync;
    one copy brings a batch's detections to the host. Returns the
    evaluator's AP dict. No memory is carried from image to image, so the
    embodied model is built with `memory.write_memory=False`, as
    `run.py --coco-json` builds it."""
    if isinstance(model, EmbodiedDetector) and \
            model.cfg.memory.write_memory:
        raise ValueError("evaluate_coco: the single-frame path writes no "
                         "memory; build the model with "
                         "memory.write_memory=False")
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    zs = torch.from_numpy(np.asarray(zs_weight, np.float32)).to(device)
    detect = make_detect(model, cfg, zs)

    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    ev = COCOEvaluator(list(range(cfg.roi.num_classes)),
                       dataset.entry.thing_classes or None,
                       max_dets=300 if federated else 100,
                       federated=federated)
    t0 = time.perf_counter()
    items_iter = prefetch_iterator(dataset.__getitem__, range(n),
                                   num_workers=num_workers)
    done = 0
    while done < n:
        items = [next(items_iter) for _ in range(min(batch, n - done))]
        host = torch.from_numpy(np.stack([it["image"] for it in items]))
        if on_card:
            host = host.pin_memory()
        images = host.to(device, non_blocking=on_card).float()
        with torch.no_grad():
            dets = detect(images)
        boxes, scores, classes, valid = scored_detections(dets, 1)
        for k, it in enumerate(items):
            img_id = it["image_id"]
            ev.add_image(img_id, it.get("neg_category_ids", ()))
            gv = it["gt_valid"]
            s = it["scale"]
            oh, ow = it["orig_hw"]
            ev.add_ground_truth(img_id, it["gt_boxes"][gv] / s,
                                it["gt_classes"][gv])
            v = valid[k]
            ev.add_detections(img_id, np.clip(boxes[k][v] / s, 0,
                                              [ow, oh, ow, oh]).astype(
                                                  np.float32),
                              scores[k][v], classes[k][v])
        done += len(items)
        if verbose and done % (batch * 10) == 0:
            print(f"eval {done}/{n} "
                  f"({(time.perf_counter() - t0) / done:.3f}s/img)")
    return ev.evaluate()
