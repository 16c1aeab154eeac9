"""Streaming inference with a persistent spatial memory (the serving layer).

Counterpart of the JAX package's `demo/predictor.py` (ref:
Detic/detic/predictor.py: EmbodiedVisualizationDemo :183,
EmbodiedPredictor :361, AsyncPredictor :441, the vocabulary registry
:25-65). The reference keeps the memory as module state and feeds
one-frame episodes a call; here `EmbodiedPredictor` owns an explicit
`MemoryState` on its device and calls `EmbodiedDetector.frame_step`, the
same recurrence. A request makes two host round trips: the cell-id guard's
copy of the ids (none when they come from the host) and one copy of the
detections; the image and the host-computed visibility go up from pinned
memory without blocking. The kernels are built when a predictor is made,
so that no request compiles one.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import DetectorConfig
from ..data.episode_dataset import OBJECT_LVIS
from ..models.detector import (EmbodiedDetector, build_detector,
                               resolve_device)
from ..ops.memory_ops import (check_proj_indices, obs_visibility_host,
                              semmap_classes)
from ..structures import Detections, MemoryState
from .visualizer import Visualizer

# the kernels one eval frame launches (`EmbodiedDetector.frame_step`)
FRAME_KERNELS = ("segment_sum", "memory_read", "nms", "roi_align",
                 "mask_paste", "write_select")


def get_clip_embeddings(vocabulary: List[str], prompt: str = "a ",
                        text_encoder=None) -> np.ndarray:
    """[C, 512] f32 CLIP embeddings of `prompt` + each name (underscores
    as spaces; ref: predictor.py:61-65) from `text_encoder`, by default
    `models/text_encoder.py:load_default_text_encoder()`, which raises
    `FileNotFoundError` without the CLIP weights and merge table."""
    if text_encoder is None:
        from ..models.text_encoder import load_default_text_encoder
        text_encoder = load_default_text_encoder()
    texts = [prompt + x.replace("_", " ") for x in vocabulary]
    return np.asarray(text_encoder(texts), np.float32)


def build_zs_weight(class_embeddings: np.ndarray,
                    normalize: bool = True) -> np.ndarray:
    """[C, D] class embeddings -> the [D, C+1] zs_weight input: a zero
    background column, each column l2-normalised (ref: reset_cls_test,
    detic/modeling/utils.py:32-50; swapping the vocabulary is passing
    another zs_weight)."""
    w = np.asarray(class_embeddings, np.float32).T          # D x C
    w = np.concatenate([w, np.zeros((w.shape[0], 1), np.float32)], axis=1)
    if normalize:
        n = np.linalg.norm(w, axis=0, keepdims=True)
        w = w / np.maximum(n, 1e-12)
    return w


def load_zs_weight_npy(path: str) -> np.ndarray:
    """The zs_weight of a metadata .npy of [C, D] CLIP embeddings (e.g.
    `data/metadata/mp3d_clip.npy`)."""
    return build_zs_weight(np.load(path).astype(np.float32))


def concrete_device(device: "torch.device | str") -> torch.device:
    """`resolve_device(device)` with the card's index filled in, so that
    it compares equal to a tensor's device."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def prepare_kernels(device: torch.device) -> None:
    """Build and bind every kernel of the frame now, on the card (a
    kernel that fails to build raises here, not in a request)."""
    if device.type == "cuda":
        from ..kernels import build
        with torch.cuda.device(device):
            build.build(FRAME_KERNELS)
            for name in FRAME_KERNELS:
                build.load(name)


def to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array on `device` in `dtype`; to the card from pinned
    memory, without blocking the host. A tensor already on `device` is
    taken as it is."""
    if isinstance(a, torch.Tensor) and a.device == device:
        return a.to(dtype)
    t = torch.as_tensor(np.asarray(a)).to(dtype)
    if device.type == "cuda":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device)


def detections_to_host(dets: Detections) -> Detections:
    """The detections on the host in one copy: boxes, scores, classes and
    valid packed into one f32 tensor on the device (class ids are exact
    in f32)."""
    packed = torch.cat([dets.boxes.float(), dets.scores.float()[:, None],
                        dets.classes.float()[:, None],
                        dets.valid.float()[:, None]], dim=1).cpu()
    return Detections(boxes=packed[:, :4].contiguous(),
                      scores=packed[:, 4].contiguous(),
                      classes=packed[:, 5].to(torch.int32),
                      valid=packed[:, 6] > 0)


def resize_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """`image` as float32 [height, width, 3]; resized with PIL (bicubic,
    as the JAX package) when its size differs."""
    if image.shape[:2] != (height, width):
        from PIL import Image
        image = np.asarray(Image.fromarray(
            np.asarray(image).astype(np.uint8)).resize((width, height)))
    return np.asarray(image, np.float32)


class AsyncPredictor:
    """Single-frame inference over several devices, results in order.

    ref: detic/predictor.py:441-529 (one worker process a GPU with task
    and result queues). Here one worker thread a device, each with its own
    copy of the model; frames go round-robin over them. Memory-free
    (vanilla demo) inference only: the embodied recurrence is serial and
    uses `EmbodiedPredictor`. A worker's exception is raised in `get`.
    """

    def __init__(self, cfg: DetectorConfig,
                 model: Optional[EmbodiedDetector] = None,
                 zs_weight: Optional[np.ndarray] = None,
                 devices: Optional[Sequence["torch.device | str"]] = None,
                 seed: int = 0):
        import queue
        import threading

        self.cfg = cfg
        if devices is None:
            resolve_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = [concrete_device(d) for d in devices]
        if model is None:
            model = build_detector(cfg, seed, devices[0])
        if zs_weight is None:
            zs_weight = np.zeros((cfg.roi.zs_weight_dim,
                                  cfg.roi.num_classes + 1), np.float32)
        h, w = cfg.input.height, cfg.input.width
        cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim

        spare = [model]     # the caller's model serves one worker

        def make_step(device):
            prepare_kernels(device)
            m = spare.pop() if spare and \
                next(model.parameters()).device == device \
                else copy.deepcopy(model).to(device)
            zs = torch.as_tensor(zs_weight, dtype=torch.float32,
                                 device=device)
            memory = MemoryState.zeros(cells, dim, device)
            proj = torch.zeros((h, w), dtype=torch.int32, device=device)
            outl = torch.zeros((h, w), dtype=torch.bool, device=device)

            def run(image_np):
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                image = to_device(np.asarray(image_np, np.float32),
                                  torch.float32, device)
                out = m.frame_step(image, zs, memory.features,
                                   memory.obs_count, proj, outl)
                return detections_to_host(out.detections)
            return run

        self._tasks: "queue.Queue" = queue.Queue()
        self._results: dict = {}
        self._cv = threading.Condition(threading.Lock())
        self._next_put = 0
        self._next_get = 0

        def worker(run):
            while True:
                item = self._tasks.get()
                if item is None:
                    return
                idx, image = item
                try:
                    det = run(image)
                except Exception as e:  # raised in get(), not lost
                    det = e
                with self._cv:
                    self._results[idx] = det
                    self._cv.notify_all()

        runs = [make_step(d) for d in devices]
        self._threads = []
        for run in runs:
            t = threading.Thread(target=worker, args=(run,), daemon=True)
            t.start()
            self._threads.append(t)
        # how far ahead a pipelined caller should submit to keep every
        # device busy (ref: predictor.py:455, num_gpus * 3)
        self.default_buffer_size = len(self._threads) * 3

    def put(self, image_rgb: np.ndarray) -> None:
        self._tasks.put((self._next_put, image_rgb))
        self._next_put += 1

    def get(self) -> Detections:
        with self._cv:
            while self._next_get not in self._results:
                self._cv.wait()
            det = self._results.pop(self._next_get)
            self._next_get += 1
        if isinstance(det, Exception):
            raise det
        return det

    def __call__(self, image_rgb: np.ndarray) -> Detections:
        self.put(image_rgb)
        return self.get()

    def shutdown(self) -> None:
        for _ in self._threads:
            self._tasks.put(None)
        for t in self._threads:
            t.join()


class EmbodiedPredictor:
    """Persistent-memory streaming predictor.

        pred = EmbodiedPredictor(cfg, model, zs_weight)
        dets = pred(image_rgb, proj_indices)        # the memory persists
        pred.reset_memory()                         # a new scene
        semmap = pred.semantic_map(map_h, map_w)    # the live class map

    `model` defaults to a model with random weights from `seed`; the
    memory lives on `device`, the card unless the caller asks for the CPU.
    Detections come back on the host (CPU tensors).
    """

    def __init__(self, cfg: DetectorConfig,
                 model: Optional[EmbodiedDetector] = None,
                 zs_weight: Optional[np.ndarray] = None,
                 class_names: Optional[List[str]] = None,
                 device: "torch.device | str" = "cuda", seed: int = 0):
        self.cfg = cfg
        self.device = concrete_device(device)
        prepare_kernels(self.device)
        self.model = build_detector(cfg, seed, self.device) \
            if model is None else model.to(self.device).eval()
        if zs_weight is None:
            zs_weight = np.zeros((cfg.roi.zs_weight_dim,
                                  cfg.roi.num_classes + 1), np.float32)
        self.zs_weight = torch.as_tensor(np.asarray(zs_weight, np.float32),
                                         device=self.device)
        self.class_names = class_names or OBJECT_LVIS[:cfg.roi.num_classes]
        self._visualizer = Visualizer(self.class_names)
        self.reset_memory()

    def reset_memory(self) -> None:
        """ref: custom_rcnn.py:470-479 (memory reset)."""
        self.memory = MemoryState.zeros(self.cfg.memory.max_cells,
                                        self.cfg.memory.memory_dim,
                                        self.device)

    def set_vocabulary(self, zs_weight: np.ndarray,
                       class_names: Optional[List[str]] = None) -> None:
        """Swap the vocabulary at run time (reset_cls_test analog)."""
        self.zs_weight = torch.as_tensor(np.asarray(zs_weight, np.float32),
                                         device=self.device)
        if class_names:
            self.class_names = class_names
            self._visualizer = Visualizer(class_names)

    def _prep_image(self, image: np.ndarray) -> np.ndarray:
        return resize_image(image, self.cfg.input.height,
                            self.cfg.input.width)

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray,
                 proj_indices: "np.ndarray | torch.Tensor | None" = None,
                 outlier_mask: "np.ndarray | torch.Tensor | None" = None
                 ) -> Detections:
        """Run one frame; the memory persists across calls (ref:
        EmbodiedPredictor.__call__, predictor.py:406-439). `proj_indices`
        [H, W] and `outlier_mask` [H, W] may be host arrays or tensors on
        the predictor's device."""
        h, w = self.cfg.input.height, self.cfg.input.width
        cells = self.cfg.memory.max_cells
        dev = self.device
        if proj_indices is None:
            proj_indices = np.zeros((h, w), np.int32)
        # the host guard and the host visibility, as the eval engine
        # computes them: an id outside the memory must fail here
        proj_np = proj_indices.cpu().numpy() \
            if isinstance(proj_indices, torch.Tensor) \
            else np.asarray(proj_indices)
        check_proj_indices(proj_np, cells)
        vis = obs_visibility_host(proj_np, cells)
        if outlier_mask is None:
            outlier_mask = np.zeros((h, w), bool)
        image = to_device(self._prep_image(image_rgb), torch.float32, dev)
        out = self.model.frame_step(
            image, self.zs_weight, self.memory.features,
            self.memory.obs_count, to_device(proj_indices, torch.int32, dev),
            to_device(outlier_mask, torch.bool, dev),
            to_device(vis, torch.float32, dev))
        self.memory = MemoryState(
            features=self.memory.features + out.write.features_update,
            obs_count=self.memory.obs_count + out.write.obs_update)
        return detections_to_host(out.detections)

    @torch.no_grad()
    def semantic_map(self, map_h: int, map_w: int) -> np.ndarray:
        """The live CLIP-argmax class map [map_h, map_w] int32, -1 where
        unobserved (ref: visualise_clip_image_features via
        update_implicit_memory, custom_rcnn.py:756, 938-1017)."""
        cls = semmap_classes(self.memory.features, self.memory.obs_count,
                             self.zs_weight, self.cfg.memory.obs_score_thresh,
                             self.cfg.roi.norm_temperature)
        return cls.cpu().numpy()[: map_h * map_w].reshape(map_h, map_w)

    def render_map(self, map_h: int, map_w: int, scale: int = 4
                   ) -> np.ndarray:
        """RGB picture of the semantic map (`Visualizer.draw_semmap`)."""
        return self._visualizer.draw_semmap(self.semantic_map(map_h, map_w),
                                            scale=scale)

    def frame_step_detections(self, image_rgb: np.ndarray,
                              proj_indices: "np.ndarray | torch.Tensor | None"
                              = None,
                              outlier_mask: "np.ndarray | torch.Tensor | None"
                              = None) -> Detections:
        """`__call__` under the JAX package's name for it."""
        return self(image_rgb, proj_indices, outlier_mask)

    def render_detections(self, image_rgb: np.ndarray, dets: Detections,
                          score_thresh: float = 0.3) -> np.ndarray:
        """Boxes and labels in the palette of `render_map`."""
        return self._visualizer.draw_detections(image_rgb, dets,
                                                score_thresh=score_thresh)
