"""COCO annotations.json builder from sensor h5 episode files.

The port's copy of the JAX package's `data/create_coco.py` (ref:
Detic/SMNet/create_coco_mp3d.py): walks the sensor_data h5 files, takes
every 5th frame, decodes the stringified GT records, and writes a
COCO-format annotations.json whose file_names are the JPEGs beside them,
the dataset registered as `mp3d_example` (train_mp3d.py:81).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from .episode_dataset import (CLASS_IDS, OBJECT_LVIS, parse_detection_record,
                              sort_episode_files)


def create_coco_annotations(data_path: str, out_json: Optional[str] = None,
                            every: int = 5, height: Optional[int] = None,
                            width: Optional[int] = None) -> dict:
    """Build the COCO dict (and optionally write it). Image dims come from
    each file's rgb dataset unless overridden — hardcoding 480x640 would
    stamp wrong sizes into non-mp3d (e.g. miniature fixture) jsons."""
    from .build_data import require_h5py
    h5py = require_h5py()
    sensor_dir = os.path.join(data_path, "sensor_data")
    files = sort_episode_files(os.listdir(sensor_dir))

    images: List[dict] = []
    annotations: List[dict] = []
    img_id = 0
    ann_id = 0
    for f in files:
        with h5py.File(os.path.join(sensor_dir, f), "r") as h5:
            n = len(h5["detection_data"])
            records = [h5["detection_data"][i] for i in range(n)]
            if "rgb" in h5:
                h, w = h5["rgb"].shape[1:3]
            else:
                h, w = height or 480, width or 640
            h, w = height or h, width or w
        # every-5th-frame selection (ref: create_coco_mp3d.py:187-197)
        for i in range(0, len(records), every):
            file_name, boxes, classes = parse_detection_record(records[i])
            images.append({"id": img_id, "file_name": file_name,
                           "height": int(h), "width": int(w)})
            for b, c in zip(boxes, classes):
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": int(c),
                    "bbox": [float(b[0]), float(b[1]),
                             float(b[2] - b[0]), float(b[3] - b[1])],
                    "iscrowd": 0, "area": float((b[2] - b[0]) * (b[3] - b[1])),
                })
                ann_id += 1
            img_id += 1

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i, "name": n}
                       for i, n in enumerate(OBJECT_LVIS) if i in CLASS_IDS],
    }
    if out_json:
        with open(out_json, "w") as fp:
            json.dump(coco, fp)
    return coco


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", required=True)
    p.add_argument("--out", default="annotations.json")
    p.add_argument("--every", type=int, default=5)
    args = p.parse_args(argv)
    coco = create_coco_annotations(args.data_path, args.out, args.every)
    print(f"{len(coco['images'])} images, {len(coco['annotations'])} "
          f"annotations -> {args.out}")


if __name__ == "__main__":
    main()
