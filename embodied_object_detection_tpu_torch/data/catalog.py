"""Dataset catalog, COCO-json dataset and multi-dataset sampler, and the
built-in vocabularies.

Counterpart of the JAX package's `data/catalog.py` (ref: detectron2's
DatasetCatalog as the reference registers its splits, Detic/detic/data/
datasets/*.py): a registry mapping a name to (annotations json, image
root, metadata) with the reference's predefined splits
(`register_builtin_datasets`), `CocoDetectionDataset`, which reads a
COCO json into fixed-shape letterboxed frames for the single-frame
trainer and evaluator, and `MultiDatasetSampler` (ratio-weighted sources,
repeat-factor sampling within one). The image decode is one method,
`read_image`; `ArrayCocoDataset` takes the images from uint8 arrays
instead of files. The demos read `COCO_CLASSES`, `load_categories` and
`builtin_class_names` (ref: the BUILDIN_METADATA_PATH lookups of
Detic/predict.py:38-43); the federated loss reads `load_class_freq`. The
category tables are the vendored JSON under `data/metadata/`, beside the
CLIP classifier `.npy` files that `demo/demo.py:find_classifier_npy`
resolves. PIL is imported where an image is decoded or resized.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

METADATA_DIR = os.path.join(os.path.dirname(__file__), "metadata")

# the standard 80 COCO-2017 thing classes (public schema)
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush"]

# vocabulary -> its category table under data/metadata/
_TABLES = {"lvis": "lvis_v1", "openimages": "oid",
           "objects365": "objects365", "in21k": "lvis_22k"}


def load_categories(table: str) -> List[dict]:
    """A vendored category table: 'lvis_v1', 'oid', 'objects365',
    'lvis_22k', or 'coco_zeroshot' (a dict of seen / unseen)."""
    with open(os.path.join(METADATA_DIR, f"{table}_categories.json")) as f:
        return json.load(f)


def builtin_class_names(vocabulary: str) -> List[str]:
    """The class names of a built-in vocabulary: 'coco', 'mp3d', 'lvis',
    'openimages', 'objects365' or 'in21k', in category-id order."""
    if vocabulary == "coco":
        return list(COCO_CLASSES)
    if vocabulary == "mp3d":
        from .episode_dataset import OBJECT_LVIS
        return list(OBJECT_LVIS)
    cats = load_categories(_TABLES[vocabulary])
    return [c["name"] for c in sorted(cats, key=lambda c: c["id"])]


def load_class_freq(path: str = "", freq_weight: float = 0.5) -> np.ndarray:
    """Per-class image count ** freq_weight, in category-id order: the
    federated loss's sampling weights (ref: detic/modeling/utils.py:
    load_class_freq). The default table is the vendored LVIS v1 train
    category info, data/metadata/lvis_v1_train_cat_info.json (1203
    classes)."""
    if not path:
        path = os.path.join(METADATA_DIR, "lvis_v1_train_cat_info.json")
    with open(path) as f:
        cat_info = json.load(f)
    counts = np.asarray([c["image_count"] for c in
                         sorted(cat_info, key=lambda x: x["id"])],
                        np.float32)
    return counts ** freq_weight


# ---------------------------------------------------------------- registry

@dataclass
class DatasetEntry:
    json_file: str
    image_root: str
    thing_classes: List[str] = field(default_factory=list)
    # raw category_id -> contiguous [0, C) (detectron2's
    # thing_dataset_id_to_contiguous_id)
    id_map: Dict[int, int] = field(default_factory=dict)
    # per-class image counts for repeat-factor and federated sampling
    class_image_count: Dict[int, int] = field(default_factory=dict)
    # per-dataset metadata: OID freebase ids, zero-shot split, ann_type
    extras: Dict[str, object] = field(default_factory=dict)


_CATALOG: Dict[str, DatasetEntry] = {}


def register_coco_instances(name: str, json_file: str, image_root: str):
    """ref: detectron2 register_coco_instances (train_mp3d.py:81)."""
    _CATALOG[name] = DatasetEntry(json_file=json_file, image_root=image_root)


def register_dataset(name: str, entry: DatasetEntry):
    _CATALOG[name] = entry


def get_dataset(name: str) -> DatasetEntry:
    return _CATALOG[name]


def list_datasets() -> List[str]:
    return sorted(_CATALOG)


def register_builtin_datasets(root: str = "datasets"):
    """Register the reference's predefined splits under `root` with the
    vendored category metadata (ref: _PREDEFINED_SPLITS_* in Detic/detic/
    data/datasets/lvis_v1.py:119, objects365.py:757, oid.py:518,
    coco_zeroshot.py:95, imagenet.py:19, cc.py:9-22). The json files need
    not exist until a dataset is read."""

    def entry(json_file, image_root, cats, extras=None):
        cats = sorted(cats, key=lambda c: c["id"])
        return DatasetEntry(
            json_file=os.path.join(root, json_file),
            image_root=os.path.join(root, image_root),
            thing_classes=[c["name"] for c in cats],
            id_map={c["id"]: i for i, c in enumerate(cats)},
            class_image_count={i: c["image_count"]
                               for i, c in enumerate(cats)
                               if "image_count" in c},
            extras=extras or {})

    lvis = load_categories("lvis_v1")
    for name, (img, js) in {
        "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
        "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
        "lvis_v1_train+coco": ("coco/", "lvis/lvis_v1_train+coco_mask.json"),
        "lvis_v1_train_norare": ("coco/", "lvis/lvis_v1_train_norare.json"),
    }.items():
        register_dataset(name, entry(js, img, lvis))

    o365 = load_categories("objects365")
    for name, (img, js) in {
        "objects365_v2_train": (
            "objects365/train",
            "objects365/annotations/zhiyuan_objv2_train_fixname_fixmiss.json"),
        "objects365_v2_val": (
            "objects365/val",
            "objects365/annotations/zhiyuan_objv2_val_fixname.json"),
    }.items():
        register_dataset(name, entry(js, img, o365))

    oid = load_categories("oid")
    for name, (img, js) in {
        "oid_train": ("oid/images/",
                      "oid/annotations/oid_challenge_2019_train_bbox.json"),
        "oid_val_expanded": (
            "oid/images/validation/",
            "oid/annotations/oid_challenge_2019_val_expanded.json"),
    }.items():
        register_dataset(name, entry(
            js, img, oid,
            extras={"freebase_id": [c["freebase_id"] for c in
                                    sorted(oid, key=lambda c: c["id"])]}))

    zs = load_categories("coco_zeroshot")
    register_dataset("coco_zeroshot_train", entry(
        "coco/zero-shot/instances_train2017_seen_2.json", "coco/train2017",
        zs["seen"], extras={"split": "seen"}))
    register_dataset("coco_zeroshot_val", entry(
        "coco/zero-shot/instances_val2017_unseen_2.json", "coco/val2017",
        zs["unseen"], extras={"split": "unseen"}))
    # generalized zero-shot eval reads the original-order 80-class json,
    # whose categories are the label space (coco_zeroshot.py:95-110)
    for name in ("coco_generalized_zeroshot_val", "coco_zeroshot_val_all"):
        register_dataset(name, entry(
            "coco/zero-shot/instances_val2017_all_2_oriorder.json",
            "coco/val2017", [], extras={"split": "all"}))

    register_dataset("imagenet_lvis_v1", entry(
        "imagenet/annotations/imagenet_lvis_image_info.json",
        "imagenet/ImageNet-LVIS/", lvis, extras={"ann_type": "image"}))
    lvis22k = load_categories("lvis_22k")
    register_dataset("imagenet_lvis-22k", entry(
        "imagenet/annotations/imagenet-22k_image_info_lvis-22k.json",
        "imagenet/ImageNet-LVIS/", lvis22k, extras={"ann_type": "image"}))

    # Conceptual Captions in the LVIS v1 category space; the tags variant
    # also carries pos_category_ids (lvis_v1.py:84-96)
    for name, (img, js, ann) in {
        "cc3m_v1_val": ("cc3m/validation/", "cc3m/val_image_info.json",
                        "caption"),
        "cc3m_v1_train": ("cc3m/training/", "cc3m/train_image_info.json",
                          "caption"),
        "cc3m_v1_train_tags": ("cc3m/training/",
                               "cc3m/train_image_info_tags.json",
                               "captiontag"),
    }.items():
        register_dataset(name, entry(js, img, lvis,
                                     extras={"ann_type": ann}))

    register_coco_instances(
        "mp3d_example",
        os.path.join(root, "../embodied_data/mp3d_example/annotations.json"),
        os.path.join(root, "../embodied_data/mp3d_example"))


# ----------------------------------------------------------------- dataset

def read_rgb(path_or_file) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB, turned by its EXIF
    orientation as detectron2's read_image does (web-sourced JPEGs are
    annotated on the turned image)."""
    from PIL import Image, ImageOps
    with Image.open(path_or_file) as im:
        return np.asarray(ImageOps.exif_transpose(im).convert("RGB"))


class CocoDetectionDataset:
    """COCO-format detection dataset with padded fixed-shape outputs.

    An item: image [H, W, 3] uint8 letterboxed into the target (height,
    width) (scaled to fit, bilinear, at the top left of a zero canvas),
    gt_boxes [max_gt, 4] XYXY scaled alike, gt_classes, gt_valid,
    image_id, file_name, scale and orig_hw, and the co-training fields
    the image dict carries (captions, caption_features, pos/neg category
    ids, the latter remapped like the classes)."""

    def __init__(self, name_or_entry, height: int = 480, width: int = 640,
                 max_gt: int = 64, filter_empty: bool = False,
                 remap_ids: bool = True, coco: Optional[dict] = None):
        """remap_ids=True maps category ids to contiguous [0, C) (the
        detectron2 convention); False keeps raw ids, for jsons whose ids
        are the model's vocabulary indices (the mp3d jsons). `coco` is the
        parsed json in place of reading the entry's json_file."""
        entry = (get_dataset(name_or_entry)
                 if isinstance(name_or_entry, str) else name_or_entry)
        self.remap_ids = remap_ids
        self.height = height
        self.width = width
        self.max_gt = max_gt
        if coco is None:
            with open(entry.json_file) as f:
                coco = json.load(f)
        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        # a copy: the registered entry keeps its vendored metadata; only
        # its empty class list is filled from the json
        registered = entry
        entry = dataclasses.replace(entry)
        self.entry = entry
        entry.thing_classes = [c.get("name", str(c["id"])) for c in cats]
        if not registered.thing_classes:
            registered.thing_classes = list(entry.thing_classes)
        entry.id_map = {c["id"]: (i if remap_ids else c["id"])
                        for i, c in enumerate(cats)}
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        counts: Dict[int, int] = {}
        for anns in self.anns_by_image.values():
            for c in {entry.id_map[a["category_id"]] for a in anns}:
                counts[c] = counts.get(c, 0) + 1
        entry.class_image_count = counts
        self.ids = [i for i in self.images
                    if not filter_empty or self.anns_by_image.get(i)]

    def __len__(self):
        return len(self.ids)

    def class_repeat_factors(self, repeat_thresh: float) -> np.ndarray:
        """RepeatFactorTrainingSampler factors: r(img) = max over its
        categories of max(1, sqrt(t / f_c)). A dataset without box
        annotations (tag and caption sources) takes the frequencies from
        pos_category_ids, as the reference's
        repeat_factors_from_tag_frequency (custom_dataset_dataloader.py:
        308-330)."""
        n = max(len(self.ids), 1)
        if not any(self.anns_by_image.values()):
            tag_freq: Dict[int, int] = defaultdict(int)
            per_img_tags = []
            for img_id in self.ids:
                tags = [int(c) for c in
                        self.images[img_id].get("pos_category_ids", [])]
                per_img_tags.append(tags)
                for c in set(tags):
                    tag_freq[c] += 1
            cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / (cnt / n)))
                       for c, cnt in tag_freq.items()}
            return np.asarray([
                max([cat_rep.get(c, 1.0) for c in tags], default=1.0)
                for tags in per_img_tags])
        freq = {c: cnt / n for c, cnt in self.entry.class_image_count.items()}
        cat_rep = {c: max(1.0, np.sqrt(repeat_thresh / max(f, 1e-12)))
                   for c, f in freq.items()}
        factors = []
        for img_id in self.ids:
            cats = {self.entry.id_map[a["category_id"]]
                    for a in self.anns_by_image.get(img_id, [])}
            factors.append(max([cat_rep.get(c, 1.0) for c in cats],
                               default=1.0))
        return np.asarray(factors)

    def read_image(self, info: dict) -> np.ndarray:
        """The image of one image dict as [H, W, 3] uint8 RGB."""
        return read_rgb(os.path.join(self.entry.image_root,
                                     info["file_name"]))

    def __getitem__(self, index: int) -> dict:
        img_id = self.ids[index]
        info = self.images[img_id]
        img = self.read_image(info)
        h0, w0 = img.shape[:2]
        scale = min(self.height / h0, self.width / w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        if (nh, nw) != (h0, w0):
            # bilinear, as detectron2's ResizeTransform (PIL's default is
            # bicubic)
            from PIL import Image
            img = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                         Image.BILINEAR))
        canvas = np.zeros((self.height, self.width, 3), np.uint8)
        canvas[:nh, :nw] = img

        boxes = np.zeros((self.max_gt, 4), np.float32)
        classes = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        anns = self.anns_by_image.get(img_id, [])
        if len(anns) > self.max_gt:
            # the reference keeps every annotation: the dropped objects'
            # detections would count as false positives
            print(f"WARNING: image {img_id}: {len(anns)} annotations exceed "
                  f"max_gt={self.max_gt}; {len(anns) - self.max_gt} dropped "
                  "— raise input.max_gt_boxes")
        for i, ann in enumerate(anns[: self.max_gt]):
            x, y, w, h = ann["bbox"]
            boxes[i] = np.array([x, y, x + w, y + h]) * scale
            classes[i] = self.entry.id_map[ann["category_id"]]
            valid[i] = True
        out = dict(image=canvas, gt_boxes=boxes, gt_classes=classes,
                   gt_valid=valid, image_id=img_id,
                   file_name=info["file_name"], scale=scale,
                   orig_hw=(h0, w0))
        # co-training fields of the image dict (lvis_v1.py:84-96); pos/neg
        # category ids are remapped like the classes (lvis_v1.py:83-88)
        for k in ("captions", "caption_features"):
            if k in info:
                out[k] = info[k]
        for k in ("pos_category_ids", "neg_category_ids"):
            if k in info:
                out[k] = [self.entry.id_map.get(int(c), int(c))
                          if self.remap_ids else int(c) for c in info[k]]
        return out


class ArrayCocoDataset(CocoDetectionDataset):
    """A `CocoDetectionDataset` whose images are uint8 [H, W, 3] arrays
    keyed by the image dicts' file_name, not files (data made in memory:
    the same letterbox and ground truth, no decode)."""

    def __init__(self, name_or_entry, arrays: Mapping[str, np.ndarray],
                 **kwargs):
        super().__init__(name_or_entry, **kwargs)
        self.arrays = arrays

    def read_image(self, info: dict) -> np.ndarray:
        return np.asarray(self.arrays[info["file_name"]], np.uint8)


class MultiDatasetSampler:
    """Ratio-weighted multi-dataset sampling with optional repeat-factor
    sampling within each dataset (ref: Detic/detic/data/
    custom_dataset_dataloader.py:195-266, DATASET_RATIO + USE_RFS). One
    `RandomState(seed)` draws the sources and the items in call order."""

    def __init__(self, datasets: List[CocoDetectionDataset],
                 ratios: List[float], use_rfs: Optional[List[bool]] = None,
                 repeat_thresh: float = 0.001, seed: int = 0):
        self.datasets = datasets
        ratios = np.asarray(ratios, np.float64)
        self.p_dataset = ratios / ratios.sum()
        self.rng = np.random.RandomState(seed)
        self.item_p = []
        for i, ds in enumerate(datasets):
            if use_rfs and use_rfs[i]:
                f = ds.class_repeat_factors(repeat_thresh)
                self.item_p.append(f / f.sum())
            else:
                self.item_p.append(None)

    def sample(self, n: int) -> List[Tuple[int, int]]:
        """n (dataset index, item index) pairs, each from its own source
        draw."""
        out = []
        for _ in range(n):
            d = self.sample_source()
            out.append((d, self.sample_items(d, 1)[0]))
        return out

    def sample_source(self) -> int:
        """One dataset by ratio: a batch comes from one source
        (custom_dataset_dataloader.py:268-306; custom_rcnn.py:203-206
        asserts one ann_type a batch)."""
        return int(self.rng.choice(len(self.datasets), p=self.p_dataset))

    def sample_items(self, d: int, n: int) -> List[int]:
        p = self.item_p[d]
        return [int(self.rng.choice(len(self.datasets[d]), p=p))
                for _ in range(n)]
