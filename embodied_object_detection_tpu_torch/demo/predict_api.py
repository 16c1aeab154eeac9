"""One-call serving predictor (the cog wrapper analog).

Counterpart of the JAX package's `demo/predict_api.py` (ref:
Detic/predict.py:21-97, cog.Predictor): `setup()` builds the model once;
`predict(image, vocabulary, custom_vocabulary)` swaps the vocabulary, runs
one image and returns the path of the drawn result; `detect` returns the
detections of an RGB array with no file IO.

    from embodied_object_detection_tpu_torch.demo.predict_api import (
        Predictor)
    p = Predictor()
    p.setup(weights="model.pth")               # device="cpu" off the card
    out_path = p.predict("image.jpg", vocabulary="lvis")
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..config import DetectorConfig
from ..structures import Detections


class Predictor:
    """cog.Predictor-style wrapper around the single-frame detector."""

    def setup(self, cfg: Optional[DetectorConfig] = None, weights: str = "",
              model=None, device: "torch.device | str" = "cuda"):
        """Configure once (ref: predict.py:23-43: score threshold 0.3 on
        the card, one class per proposal, the vocabulary loaded per
        call). The model is built on the first call, on `device`."""
        from ..models.detector import resolve_device
        self.device = resolve_device(device)
        cfg = cfg or DetectorConfig()
        self.cfg = cfg.replace(
            roi=dataclasses.replace(cfg.roi, score_thresh_test=0.3,
                                    one_class_per_proposal=True),
            memory=dataclasses.replace(cfg.memory, memory_type="image_only",
                                       write_memory=False))
        self._weights = weights
        self._model = model
        self._demo = None
        self._vocab_key = None

    def _ensure_vocab(self, vocabulary: str, custom_vocabulary: str):
        from .demo import VisualizationDemo, load_model, resolve_vocabulary
        key = (vocabulary, custom_vocabulary)
        if self._vocab_key == key:
            return
        zs, names = resolve_vocabulary(vocabulary, custom_vocabulary)
        if self._demo is None:
            if self._model is None:
                self._model = load_model(self.cfg.replace(
                    roi=dataclasses.replace(self.cfg.roi,
                                            num_classes=len(names))),
                    self._weights, self.device)
            self._demo = VisualizationDemo(self.cfg, zs, names,
                                           model=self._model,
                                           device=self.device)
        else:
            # the vocabulary swap: zs_weight is an input of the frame
            from .visualizer import Visualizer
            self._demo.predictor.set_vocabulary(zs, names)
            self._demo.class_names = names
            self._demo.visualizer = Visualizer(names)
        self._vocab_key = key

    def predict(self, image: str, vocabulary: str = "lvis",
                custom_vocabulary: Optional[str] = None,
                confidence_threshold: float = 0.5,
                output_path: Optional[str] = None) -> str:
        """Run one image file; returns the drawn image's path (ref:
        predict.py:45-90; a custom vocabulary draws from 0.3, :83-86)."""
        from PIL import Image
        self._ensure_vocab(vocabulary, custom_vocabulary or "")
        thresh = 0.3 if vocabulary == "custom" else confidence_threshold
        img = np.asarray(Image.open(image).convert("RGB"))
        self.last_detections, vis = self._demo.run_on_image(img, thresh)
        if output_path is None:
            output_path = os.path.join(tempfile.mkdtemp(), "out.png")
        Image.fromarray(vis).save(output_path)
        return output_path

    def detect(self, image_rgb: np.ndarray, vocabulary: str = "lvis",
               custom_vocabulary: Optional[str] = None) -> Detections:
        """The detections of an RGB array, no file IO."""
        self._ensure_vocab(vocabulary, custom_vocabulary or "")
        dets, _ = self._demo.run_on_image(image_rgb)
        return dets
