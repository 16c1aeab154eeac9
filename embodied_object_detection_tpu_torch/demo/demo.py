"""The vanilla Detic demo: image, video or webcam inference with a choice
of vocabulary (the memory-free single-frame path).

Counterpart of the JAX package's `demo/demo.py` (ref: Detic/demo.py:1-230,
detic/predictor.py:46-180 VisualizationDemo). The frame step runs with no
memory read or write; `--parallel` spreads frames over every card with
`AsyncPredictor`. Runs on the card unless `--device cpu` is given.

Examples:
  python -m embodied_object_detection_tpu_torch.demo.demo \
      --input 'images/*.jpg' --output out/ --vocabulary lvis \
      --weights model.pth
  python -m embodied_object_detection_tpu_torch.demo.demo \
      --video-input in.mp4 --output out.mp4
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import DetectorConfig, apply_opts
from ..structures import Detections
from .visualizer import Visualizer

# vocabulary -> CLIP class-embedding .npy (ref: predictor.py:25-44,
# predict.py:33-38 BUILDIN_CLASSIFIER), vendored under data/metadata/
_CLASSIFIER_FILES = {
    "mp3d": "mp3d_clip.npy",
    "lvis": "lvis_v1_clip_a+cname.npy",
    "objects365": "o365_clip_a+cnamefix.npy",
    "openimages": "oid_clip_a+cname.npy",
    "coco": "coco_clip_a+cname.npy",
}
_METADATA_ROOTS = [
    os.path.join(os.path.dirname(__file__), "..", "data", "metadata"),
    "datasets/metadata",
]


def find_classifier_npy(vocabulary: str) -> Optional[str]:
    """The classifier .npy of a built-in vocabulary, or None."""
    fn = _CLASSIFIER_FILES.get(vocabulary)
    if fn is None:
        return None
    for root in _METADATA_ROOTS:
        p = os.path.join(root, fn)
        if os.path.exists(p):
            return p
    return None


def resolve_vocabulary(vocabulary: str, custom_vocabulary: str = "",
                       zs_weight_path: str = ""
                       ) -> Tuple[np.ndarray, List[str]]:
    """-> (zs_weight [D, C+1], class names) (ref: demo.py --vocabulary,
    predict.py:66-82). A vocabulary without a classifier .npy (custom,
    in21k) needs the CLIP text encoder, which raises
    `NotImplementedError` (ROADMAP queue 1 item 12c)."""
    from ..data.catalog import builtin_class_names
    from .predictor import (build_zs_weight, get_clip_embeddings,
                            load_zs_weight_npy)

    if vocabulary == "custom":
        names = [x.strip() for x in custom_vocabulary.split(",") if x.strip()]
        if not names:
            raise ValueError("vocabulary 'custom' needs --custom-vocabulary "
                             "with at least one name")
        return build_zs_weight(get_clip_embeddings(names)), names

    names = builtin_class_names(vocabulary)
    path = zs_weight_path or find_classifier_npy(vocabulary)
    if path and os.path.exists(path):
        zs = load_zs_weight_npy(path)
        if zs.shape[1] != len(names) + 1:
            raise ValueError(f"{path} has {zs.shape[1] - 1} classes, the "
                             f"'{vocabulary}' vocabulary {len(names)}")
        return zs, names
    print(f"WARNING: no classifier .npy for '{vocabulary}'; embedding the "
          "names with the CLIP text encoder")
    return build_zs_weight(get_clip_embeddings(names)), names


class VisualizationDemo:
    """Single-frame detector and visualizer (ref:
    detic/predictor.py:46-180): memory_type image_only, no memory write.
    With parallel=True frames go round-robin over `devices` (default every
    card) through `AsyncPredictor`, results in order."""

    def __init__(self, cfg: DetectorConfig, zs_weight: np.ndarray,
                 class_names: List[str], model=None, parallel: bool = False,
                 device: "torch.device | str" = "cuda", devices=None):
        cfg = cfg.replace(
            roi=dataclasses.replace(cfg.roi, num_classes=len(class_names)),
            memory=dataclasses.replace(cfg.memory, memory_type="image_only",
                                       write_memory=False))
        self.cfg = cfg
        self.class_names = class_names
        self.visualizer = Visualizer(class_names)
        self.parallel = parallel
        if parallel:
            from .predictor import AsyncPredictor
            self.predictor = AsyncPredictor(cfg, model=model,
                                            zs_weight=zs_weight,
                                            devices=devices)
        else:
            from .predictor import EmbodiedPredictor
            self.predictor = EmbodiedPredictor(cfg, model=model,
                                               zs_weight=zs_weight,
                                               class_names=class_names,
                                               device=device)

    def _resize(self, image_rgb: np.ndarray) -> np.ndarray:
        from .predictor import resize_image
        return resize_image(image_rgb, self.cfg.input.height,
                            self.cfg.input.width)

    def _postprocess(self, image_rgb: np.ndarray, dets: Detections,
                     confidence_threshold: float
                     ) -> Tuple[Detections, np.ndarray]:
        """Boxes rescaled to the original resolution (ref:
        custom_rcnn.py:579), and the drawing."""
        h, w = self.cfg.input.height, self.cfg.input.width
        sy = image_rgb.shape[0] / h
        sx = image_rgb.shape[1] / w
        boxes = np.asarray(dets.boxes) * np.array([sx, sy, sx, sy],
                                                  np.float32)
        dets = Detections(boxes=boxes, scores=np.asarray(dets.scores),
                          classes=np.asarray(dets.classes),
                          valid=np.asarray(dets.valid))
        vis = self.visualizer.draw_detections(
            image_rgb, dets, score_thresh=confidence_threshold)
        return dets, vis

    def run_on_image(self, image_rgb: np.ndarray,
                     confidence_threshold: float = 0.5
                     ) -> Tuple[Detections, np.ndarray]:
        """-> (detections as numpy arrays at the image's resolution, the
        drawn RGB image)."""
        dets = self.predictor(self._resize(image_rgb))
        return self._postprocess(image_rgb, dets, confidence_threshold)

    def run_on_video(self, video, confidence_threshold: float = 0.5):
        """Drawn BGR frames of a cv2.VideoCapture-like object. With
        parallel=True frames are submitted `default_buffer_size` ahead of
        their results, so that every worker stays busy."""
        def frames():
            while True:
                ok, frame_bgr = video.read()
                if not ok:
                    return
                yield frame_bgr[:, :, ::-1]

        def to_bgr(vis):
            return np.ascontiguousarray(vis[:, :, ::-1])

        if not self.parallel:
            for rgb in frames():
                _, vis = self.run_on_image(rgb, confidence_threshold)
                yield to_bgr(vis)
            return

        from collections import deque
        buffer_size = self.predictor.default_buffer_size
        pending: deque = deque()
        for rgb in frames():
            pending.append(rgb)
            self.predictor.put(self._resize(rgb))
            if len(pending) > buffer_size:
                _, vis = self._postprocess(pending.popleft(),
                                           self.predictor.get(),
                                           confidence_threshold)
                yield to_bgr(vis)
        while pending:
            _, vis = self._postprocess(pending.popleft(),
                                       self.predictor.get(),
                                       confidence_threshold)
            yield to_bgr(vis)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Detic demo (torch port)")
    parser.add_argument("--input", nargs="+",
                        help="space-separated image paths or one glob")
    parser.add_argument("--video-input", help="path to a video file")
    parser.add_argument("--webcam", help="webcam device index")
    parser.add_argument("--output", help="output file or directory")
    parser.add_argument("--vocabulary", default="lvis",
                        choices=["lvis", "openimages", "objects365", "coco",
                                 "mp3d", "custom"])
    parser.add_argument("--custom-vocabulary", "--custom_vocabulary",
                        dest="custom_vocabulary", default="")
    parser.add_argument("--confidence-threshold", type=float, default=0.5)
    parser.add_argument("--pred-all-class", "--pred_all_class",
                        dest="pred_all_class", action="store_true")
    parser.add_argument("--parallel", action="store_true",
                        help="round-robin frames over every card")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; raises without a card) "
                             "or 'cpu'")
    parser.add_argument("--weights", default="",
                        help="a detectron2 .pth (converted on the fly) or a "
                             "checkpoint of the port")
    parser.add_argument("--zs-weight", default="",
                        help="override classifier .npy path")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="config overrides: section.field=value")
    return parser


def load_model(cfg: DetectorConfig, weights: str,
               device: "torch.device | str" = "cuda"):
    """The model on `device`: random weights from seed 0, then `weights`
    (a .pth converted on the fly, which must match the model, or a
    checkpoint of the port) when given."""
    from ..models.detector import build_detector
    from ..run import load_weights
    model = build_detector(cfg, seed=0, device=device)
    if weights:
        load_weights(model, cfg, weights)
    return model


def main(argv=None):
    args = get_parser().parse_args(argv)
    from ..models.detector import resolve_device
    device = resolve_device(args.device)
    cfg = DetectorConfig()
    # plain Detic checkpoints have no spatial memory: the image-only model,
    # or the .pth check would demand the memory-merge parameters
    cfg = cfg.replace(memory=dataclasses.replace(
        cfg.memory, memory_type="", write_memory=False))
    # ref: demo.py:55-57 setup_cfg: the score threshold is the CLI's, one
    # class per proposal unless --pred-all-class
    cfg = cfg.replace(roi=dataclasses.replace(
        cfg.roi, score_thresh_test=args.confidence_threshold,
        one_class_per_proposal=not args.pred_all_class))
    cfg = apply_opts(cfg, args.opts)

    zs_weight, class_names = resolve_vocabulary(
        args.vocabulary, args.custom_vocabulary, args.zs_weight)
    model = load_model(cfg.replace(roi=dataclasses.replace(
        cfg.roi, num_classes=len(class_names))), args.weights, device)
    demo = VisualizationDemo(
        cfg, zs_weight, class_names, model=model, parallel=args.parallel,
        device=device, devices=None if device.type == "cuda" else [device])

    if args.input:
        from PIL import Image
        paths = args.input
        if len(paths) == 1:
            paths = glob.glob(os.path.expanduser(paths[0])) or paths
        if len(paths) > 1 and args.output and \
                not os.path.isdir(args.output) and \
                os.path.splitext(args.output)[1]:
            raise ValueError("--output must be a directory for several "
                             "inputs")
        results = []
        for path in paths:
            img = np.asarray(Image.open(path).convert("RGB"))
            t0 = time.time()
            dets, vis = demo.run_on_image(img, args.confidence_threshold)
            n = int(np.asarray(dets.valid).sum())
            print(f"{path}: detected {n} instances in {time.time() - t0:.2f}s")
            results.append((path, dets))
            if args.output:
                if os.path.isdir(args.output) or len(paths) > 1:
                    os.makedirs(args.output, exist_ok=True)
                    out = os.path.join(args.output, os.path.basename(path))
                else:
                    out = args.output
                Image.fromarray(vis).save(out)
        return results

    if args.video_input or args.webcam is not None:
        import cv2
        cam = (cv2.VideoCapture(args.video_input) if args.video_input
               else cv2.VideoCapture(int(args.webcam)))
        writer = None
        shown = 0
        try:
            for vis_bgr in demo.run_on_video(cam, args.confidence_threshold):
                if args.output:
                    if writer is None:
                        fps = cam.get(cv2.CAP_PROP_FPS) or 30.0
                        h, w = vis_bgr.shape[:2]
                        writer = cv2.VideoWriter(
                            args.output, cv2.VideoWriter_fourcc(*"mp4v"),
                            float(fps), (w, h), True)
                    writer.write(vis_bgr)
                else:
                    cv2.imshow("Detic", vis_bgr)
                    if cv2.waitKey(1) == 27:
                        break
                shown += 1
        finally:
            cam.release()
            if writer is not None:
                writer.release()
        print(f"processed {shown} frames")
        return shown

    get_parser().print_help()


if __name__ == "__main__":
    main()
