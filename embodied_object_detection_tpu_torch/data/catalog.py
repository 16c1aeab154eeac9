"""Built-in vocabularies of the demos: class names and category tables.

The part of the JAX package's `data/catalog.py` that the demo and serving
surface reads (`COCO_CLASSES`, `load_categories`, `builtin_class_names`;
ref: the BUILDIN_METADATA_PATH lookups of Detic/predict.py:38-43), and the
federated loss's class-frequency table (`load_class_freq`). The
category tables are the vendored JSON under `data/metadata/`, beside the
CLIP classifier `.npy` files that `demo/demo.py:find_classifier_npy`
resolves.
"""

from __future__ import annotations

import json
import os
from typing import List

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
    """A vendored category table: 'lvis_v1', 'oid', 'objects365' or
    'lvis_22k'."""
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
