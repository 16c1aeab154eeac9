"""The embodied detector: one recurrent eval frame, and an episode chunk.

Counterpart of the JAX package's `models/detector.py`. One frame is

    image x zs_weight x memory -> detections x memory update

(ResNet-50 -> memory-fused FPN -> CenterNet proposals -> 3-stage cascade
-> multiclass NMS -> write-row selection -> mask head -> mask paste ->
memory write), and `make_episode_runner` drives it over a chunk of frames
with the memory carried (test_type "default"). Public tensors keep the
JAX package's channels-last layout. Everything runs on the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import DetectorConfig, check_slice_config
from ..ops.mask_paste import paste_masks
from ..ops.memory_ops import (MemoryWriteResult, check_proj_indices,
                              memory_read, memory_write, obs_visibility_host)
from ..ops.nms import multiclass_nms, sort_desc
from ..structures import Detections, MemoryState
from .centernet import CenterNetHead, decode_proposals
from .fpn import RecurrentFPN
from .layers import DTYPES
from .resnet import ResNet50
from .roi_heads import CascadeOutputs, CascadeROIHeads


class FrameInputs(NamedTuple):
    """One frame, or a chunk of T frames with a leading [T] axis."""
    image: torch.Tensor           # [H, W, 3] float32 RGB, 0..255
    proj_indices: torch.Tensor    # [H, W] int32 map-cell id per pixel
    outlier_mask: torch.Tensor    # [H, W] bool
    obs_visibility: torch.Tensor  # [max_cells] float32, host-computed
    memory_reset: torch.Tensor    # [] bool: reset memory before this frame
    frame_valid: Optional[torch.Tensor] = None   # [] bool; None = all valid


class FrameOutputs(NamedTuple):
    detections: Detections        # [detections_per_image]
    proposals: Detections         # [post_nms_topk_test]
    write: MemoryWriteResult
    write_boxes: torch.Tensor     # [write_topk, 4]
    write_valid: torch.Tensor     # [write_topk]


class EpisodeOutputs(NamedTuple):
    detections: Detections        # [T, detections_per_image]
    memory: MemoryState           # final live memory
    any_detection: torch.Tensor   # [T]
    first_memory: MemoryState     # memory right after the chunk's frame 0


class EmbodiedDetector(nn.Module):
    """ResNet-50 + FPN (memory fusion) + CenterNet + cascade heads."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        check_slice_config(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.backbone = ResNet50(cfg.backbone.depths, dtype=dtype)
        self.fpn = RecurrentFPN(
            cfg.backbone.in_channels, cfg.backbone.fpn_channels,
            cfg.memory.memory_dim, cfg.memory.feat_fusion,
            cfg.memory.map_feature_weight, dtype=dtype)
        self.centernet = CenterNetHead(
            len(cfg.centernet.strides), cfg.backbone.fpn_channels,
            cfg.centernet.num_box_convs, dtype=dtype)
        self.roi_heads = CascadeROIHeads(cfg.roi, cfg.backbone.fpn_channels,
                                         dtype=dtype)
        self.register_buffer("pixel_mean", torch.tensor(
            cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(
            cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def backbone_raw(self, image: torch.Tensor):
        """Normalise + trunk: [H, W, 3] or [T, H, W, 3] -> (C3, C4, C5).
        Memory-independent, so a chunk's frames run it as one batch."""
        return self.backbone((image - self.pixel_mean) / self.pixel_std)

    @torch.no_grad()
    def frame_step(self, image: torch.Tensor, zs_weight: torch.Tensor,
                   mem_features: torch.Tensor, mem_obs: torch.Tensor,
                   proj_indices: torch.Tensor, outlier_mask: torch.Tensor,
                   obs_visibility: Optional[torch.Tensor] = None,
                   backbone_feats: Optional[tuple] = None) -> FrameOutputs:
        """Full single-frame inference and the memory-write update.
        `backbone_feats` (C3, C4, C5) skips the trunk when it was run
        outside the frame loop."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        ego = memory_read(mem_features, mem_obs, proj_indices) \
            if cfg.memory.reads_memory() else None
        if backbone_feats is None:
            backbone_feats = self.backbone_raw(image)
        c3, c4, c5 = backbone_feats
        p3, p4, p5, p6, p7 = self.fpn(c3, c4, c5, ego)

        agn_hms, regs = self.centernet((p3, p4, p5, p6, p7))
        proposals = decode_proposals(agn_hms, regs, cfg.centernet)
        cascade = self.roi_heads.run_cascade((p3, p4, p5), proposals,
                                             zs_weight, (h, w))
        scores = cascade.mean_scores
        if cfg.roi.mult_proposal_score:
            scores = torch.sqrt(scores * proposals.scores[:, None].clamp(
                min=0.0))
        if cfg.roi.one_class_per_proposal:
            best = scores[:, :-1].max(dim=1, keepdim=True).values
            scores = scores * (scores == best).to(scores.dtype)
        detections, _ = multiclass_nms(
            cascade.final_boxes, scores, proposals.valid,
            cfg.roi.score_thresh_test, cfg.roi.nms_thresh_test,
            cfg.roi.detections_per_image)

        if cfg.memory.write_memory:
            write, wboxes, wvalid = self._memory_write(
                proposals, cascade, (p3, p4, p5), proj_indices,
                obs_visibility)
        else:
            k = cfg.memory.write_topk
            write = MemoryWriteResult(
                features_update=torch.zeros_like(mem_features),
                obs_update=torch.zeros_like(mem_obs),
                any_detection=torch.zeros((), dtype=torch.bool,
                                          device=mem_obs.device))
            wboxes = torch.zeros((k, 4), device=mem_obs.device)
            wvalid = torch.zeros((k,), dtype=torch.bool,
                                 device=mem_obs.device)
        return FrameOutputs(detections=detections, proposals=proposals,
                            write=write, write_boxes=wboxes,
                            write_valid=wvalid)

    def _memory_write(self, proposals: Detections, cascade: CascadeOutputs,
                      features, proj_indices: torch.Tensor,
                      obs_visibility: Optional[torch.Tensor] = None
                      ) -> Tuple[MemoryWriteResult, torch.Tensor,
                                 torch.Tensor]:
        """Write-NMS on the stage-0 proposals, the mask head on up to
        `write_topk` kept rows, paste, and the memory write."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        k = cfg.memory.write_topk
        # the write reads the unregressed stage-0 boxes and their CLIP
        # features; injected GT proposals (score >= 1) are dropped
        boxes = cascade.stages[0].boxes
        feats = cascade.stages[0].clip_feats
        obj = proposals.scores
        valid = proposals.valid & (obj < 1.0)
        wscores = torch.sqrt(torch.sigmoid(cascade.stages[0].logits) *
                             obj[:, None].clamp(min=0.0))
        _, rows = multiclass_nms(boxes, wscores, valid,
                                 cfg.memory.cls_score_thresh,
                                 cfg.memory.write_nms_thresh, k)

        # unique kept rows, up to k in ascending row order
        r = boxes.shape[0]
        row_kept = torch.zeros((r + 1,), dtype=torch.bool,
                               device=boxes.device)
        row_kept[torch.where(rows >= 0, rows, torch.full_like(rows, r))
                 .long()] = True
        row_kept = row_kept[:r]
        key = row_kept.float() * (2.0 - torch.arange(
            r, device=boxes.device) / r)
        pad = max(0, k - r)
        if pad:
            key = torch.cat([key, key.new_zeros(pad)])
            row_kept = torch.cat([row_kept, row_kept.new_zeros(pad)])
        _, sel = sort_desc(key, k)
        wvalid = row_kept[sel]
        sel = sel.clamp(max=r - 1)
        wboxes, wfeats = boxes[sel], feats[sel]

        mask_probs = torch.sigmoid(self.roi_heads.mask_logits(features,
                                                              wboxes))
        s = cfg.memory.pixel_subsample
        if cfg.memory.exact_write_subsample:
            masks = paste_masks(mask_probs, wboxes, h, w,
                                cfg.memory.mask_thresh, pixel_major=True)
            write = memory_write(wfeats, masks, wvalid, proj_indices,
                                 num_cells=cfg.memory.max_cells,
                                 subsample=s, exact_subsample=True,
                                 obs_visibility=obs_visibility,
                                 pixel_major=True)
        else:
            masks = paste_masks(mask_probs, wboxes, h, w,
                                cfg.memory.mask_thresh, x_stride=s)
            write = memory_write(wfeats, masks, wvalid, proj_indices[:, ::s],
                                 num_cells=cfg.memory.max_cells,
                                 subsample=1, exact_subsample=False,
                                 obs_proj_indices=proj_indices,
                                 obs_visibility=obs_visibility)
        return write, wboxes, wvalid


def _where_state(pred: torch.Tensor, a: MemoryState,
                 b: MemoryState) -> MemoryState:
    return MemoryState(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def make_episode_runner(model: EmbodiedDetector, cfg: DetectorConfig):
    """An episode function (frames [T, ...], zs_weight, init_memory) ->
    EpisodeOutputs for test_type "default": the read memory is the live
    memory of every frame, a frame with `memory_reset` starts from zeros,
    padding frames (frame_valid False) neither reset nor write, and the
    trunk runs batched over the chunk before the serial frame loop."""
    check_slice_config(cfg)

    @torch.no_grad()
    def episode(frames: FrameInputs, zs_weight: torch.Tensor,
                init_memory: MemoryState) -> EpisodeOutputs:
        t_max = frames.image.shape[0]
        zeros = MemoryState(torch.zeros_like(init_memory.features),
                            torch.zeros_like(init_memory.obs_count))
        feats = model.backbone_raw(frames.image)
        live = first = init_memory
        dets, any_det = [], []
        for t in range(t_max):
            do_reset = frames.memory_reset[t]
            if frames.frame_valid is not None:
                do_reset = do_reset & frames.frame_valid[t]
            live = _where_state(do_reset, zeros, live)
            out = model.frame_step(
                frames.image[t], zs_weight, live.features, live.obs_count,
                frames.proj_indices[t], frames.outlier_mask[t],
                frames.obs_visibility[t],
                backbone_feats=tuple(f[t] for f in feats))
            updated = MemoryState(live.features + out.write.features_update,
                                  live.obs_count + out.write.obs_update)
            live = updated if frames.frame_valid is None else \
                _where_state(frames.frame_valid[t], updated, live)
            if t == 0:
                first = live
            dets.append(out.detections)
            any_det.append(out.write.any_detection)
        return EpisodeOutputs(
            detections=Detections(*(torch.stack(x) for x in zip(*dets))),
            memory=live, any_detection=torch.stack(any_det),
            first_memory=first)

    return episode


def frame_inputs(images: np.ndarray, proj_indices: np.ndarray,
                 memory_reset: np.ndarray, max_cells: int,
                 device: "torch.device | str",
                 frame_valid: Optional[np.ndarray] = None) -> FrameInputs:
    """Host boundary: check the cell ids, compute the cell visibility on
    the host, and move a chunk [T, ...] of frames to the device."""
    check_proj_indices(proj_indices, max_cells)

    def to(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return FrameInputs(
        image=to(images, torch.float32),
        proj_indices=to(proj_indices, torch.int32),
        outlier_mask=torch.zeros(proj_indices.shape, dtype=torch.bool,
                                 device=device),
        obs_visibility=to(obs_visibility_host(proj_indices, max_cells),
                          torch.float32),
        memory_reset=to(memory_reset, torch.bool),
        frame_valid=None if frame_valid is None
        else to(frame_valid, torch.bool))


def resolve_device(device: "torch.device | str" = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU; without a card, asking for it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the torch port runs on the card; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def _fill(t: torch.Tensor, gen: torch.Generator, kind: str, **kw) -> None:
    """Draw `t` on the CPU from `gen` in f32, then copy it into place."""
    shape = t.shape
    if kind == "normal":
        val = torch.randn(shape, generator=gen) * kw["std"]
    elif kind == "uniform":
        val = (torch.rand(shape, generator=gen) * 2.0 - 1.0) * kw["bound"]
    else:
        val = torch.full(shape, kw["value"])
    t.copy_(val)


def init_weights(model: EmbodiedDetector, seed: int) -> None:
    """Random weights from `seed`, drawn with the JAX package's init
    families: fan-in normal convs in trunk and FPN, normal(0.01) CenterNet
    convs with the focal prior bias on the heatmap and 8.0 on the
    regression, c2_xavier box FCs, PyTorch's default Linear init for the
    zero-shot projection, normal(0.001) delta and mask predictors,
    c2_msra mask convs. Norm statistics and scales stay at identity."""
    gen = torch.Generator().manual_seed(seed)
    prior = model.cfg.centernet.prior_prob
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "_gn" in name or name.startswith("centernet.scale"):
                continue
            if leaf == "bias":
                if name == "centernet.agn_hm.bias":
                    _fill(p, gen, "const", value=-math.log((1 - prior) / prior))
                elif name == "centernet.bbox_pred.bias":
                    _fill(p, gen, "const", value=8.0)
                else:
                    p.zero_()
                continue
            fan_in = p[0].numel()
            if ".deconv." in name:        # [in, out, kh, kw]
                fan_out = p.shape[1] * p[0, 0].numel()
            else:
                fan_out = p.shape[0] * p[0, 0].numel() if p.dim() == 4 \
                    else p.shape[0]
            if name.startswith("centernet."):
                _fill(p, gen, "normal", std=0.01)
            elif ".box_head" in name or ".bbox_fc1." in name:
                _fill(p, gen, "uniform", bound=math.sqrt(3.0 / fan_in))
            elif ".cls_linear." in name:
                _fill(p, gen, "uniform", bound=math.sqrt(1.0 / fan_in))
            elif ".bbox_fc2." in name or "mask_head.predictor" in name:
                _fill(p, gen, "normal", std=0.001)
            elif ".mask_head." in name:
                _fill(p, gen, "normal", std=math.sqrt(2.0 / fan_out))
            else:
                _fill(p, gen, "normal", std=math.sqrt(1.0 / fan_in))


def build_detector(cfg: Optional[DetectorConfig] = None, seed: int = 0,
                   device: "torch.device | str" = "cuda"
                   ) -> EmbodiedDetector:
    """The model on `device` with random weights from `seed` (load real
    ones with `convert.from_jax.load_jax_params`). TF32 is switched off
    for the process: the f32 sites (memory-merge projections, heatmap and
    regression convs, zero-shot logits, mask deconv and predictor, mask
    paste, the write's feature product) must run in full f32."""
    cfg = cfg or DetectorConfig()
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = EmbodiedDetector(cfg)
    init_weights(model, seed)
    return model.to(device).eval()
