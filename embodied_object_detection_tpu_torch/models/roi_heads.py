"""Cascade R-CNN ROI heads with the CLIP zero-shot classifier + mask head.

Counterpart of the JAX package's `models/roi_heads.py`. The class
embedding matrix `zs_weight` [512, C+1] is an input, not a parameter.
The zero-shot classifier, the box-delta MLP, the mask deconv and the mask
predictor run in f32 (callers disable TF32); the box FCs and mask convs
in the compute dtype, from f32 parameters.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ROIHeadsConfig
from ..ops.roi_align import multilevel_roi_align
from ..parallel.mesh import ColumnShard, column_matmul
from ..structures import Detections, clip_boxes
from .layers import conv, linear, nchw


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: Tuple[float, ...],
                 scale_clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """detectron2 Box2BoxTransform.apply_deltas: dx, dy, dw, dh -> XYXY."""
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx = deltas[:, 0] / wx
    dy = deltas[:, 1] / wy
    dw = (deltas[:, 2] / ww).clamp(max=scale_clamp)
    dh = (deltas[:, 3] / wh).clamp(max=scale_clamp)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                       dim=-1)


def get_deltas(src: torch.Tensor, target: torch.Tensor,
               weights: Tuple[float, ...]) -> torch.Tensor:
    """detectron2 Box2BoxTransform.get_deltas: the dx, dy, dw, dh that
    take `src` XYXY boxes to `target` (regression targets)."""
    src_w = src[:, 2] - src[:, 0]
    src_h = src[:, 3] - src[:, 1]
    src_cx = src[:, 0] + 0.5 * src_w
    src_cy = src[:, 1] + 0.5 * src_h
    t_w = target[:, 2] - target[:, 0]
    t_h = target[:, 3] - target[:, 1]
    t_cx = target[:, 0] + 0.5 * t_w
    t_cy = target[:, 1] + 0.5 * t_h
    wx, wy, ww, wh = weights
    eps = 1e-8
    return torch.stack([
        wx * (t_cx - src_cx) / src_w.clamp(min=eps),
        wy * (t_cy - src_cy) / src_h.clamp(min=eps),
        ww * torch.log(t_w.clamp(min=eps) / src_w.clamp(min=eps)),
        wh * torch.log(t_h.clamp(min=eps) / src_h.clamp(min=eps)),
    ], dim=-1)


class BoxHead(nn.Module):
    """2 FC layers over the pooled [R, 7, 7, C] map, flattened in HWC
    order (the JAX package's layout, so its fc1 kernel needs no
    permutation)."""

    def __init__(self, in_dim: int, fc_dim: int = 1024, num_fc: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_fc = num_fc
        self.dtype = dtype
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(
                in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(linear(x, getattr(self, f"fc{i + 1}"), self.dtype))
        return x


class ZeroShotPredictor(nn.Module):
    """Outputs (logits [R, C+1], deltas [R, 4], clip_feats [R, zs_dim]):
    clip_feats = T * l2norm(linear(x)), logits = clip_feats @ zs_weight,
    deltas from a 2-layer class-agnostic MLP; all f32. A `zs_weight`
    sharded by columns over the model axis (`parallel/mesh.py:
    ColumnShard`) gives the same logits through `column_matmul`."""

    def __init__(self, in_dim: int, zs_dim: int = 512,
                 norm_temperature: float = 50.0):
        super().__init__()
        self.norm_temperature = norm_temperature
        self.cls_linear = nn.Linear(in_dim, zs_dim)
        self.bbox_fc1 = nn.Linear(in_dim, in_dim)
        self.bbox_fc2 = nn.Linear(in_dim, 4)

    def forward(self, x: torch.Tensor, zs_weight: torch.Tensor):
        x = x.float()
        feat = self.cls_linear(x)
        norm = torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        feat_n = self.norm_temperature * feat / norm.clamp(min=1e-12)
        if isinstance(zs_weight, ColumnShard):
            logits = column_matmul(feat_n, zs_weight)
        else:
            logits = feat_n @ zs_weight.float()
        deltas = self.bbox_fc2(F.relu(self.bbox_fc1(x)))
        return logits, deltas, feat_n


class SoftmaxPropHead(nn.Module):
    """The WITH_SOFTMAX_PROP score head of the wsddn / wsod image-label
    loss (ref: detic_fast_rcnn.py:118-125): Linear -> ReLU -> Linear(C+1),
    in f32."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim)
        self.fc2 = nn.Linear(in_dim, num_classes + 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x.float())))


class MaskHead(nn.Module):
    """Class-agnostic mask head: 4x (3x3 conv + ReLU), a 2x2 stride-2
    deconv (f32) + ReLU and a 1x1 f32 predictor: [R, 14, 14, C] pooled ->
    [R, 28, 28] logits."""

    def __init__(self, in_channels: int = 256, channels: int = 256,
                 num_convs: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(
                in_channels if i == 0 else channels, channels, 3, 1, 1))
        self.deconv = nn.ConvTranspose2d(channels, channels, 2, 2)
        self.predictor = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x)
        for i in range(self.num_convs):
            x = F.relu(conv(x, getattr(self, f"mask_fcn{i + 1}"), self.dtype))
        x = F.relu(conv(x, self.deconv).to(self.dtype))
        return conv(x, self.predictor)[:, 0]


class StageOutput(NamedTuple):
    logits: torch.Tensor      # [R, C+1]
    deltas: torch.Tensor      # [R, 4]
    clip_feats: torch.Tensor  # [R, zs_dim]
    boxes: torch.Tensor       # [R, 4] input proposal boxes of this stage


class CascadeOutputs(NamedTuple):
    stages: Tuple[StageOutput, ...]
    final_boxes: torch.Tensor   # [R, 4] last stage regressed, clipped
    mean_scores: torch.Tensor   # [R, C+1] mean probability over stages


class CascadeROIHeads(nn.Module):

    def __init__(self, cfg: ROIHeadsConfig, in_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.num_stages = len(cfg.cascade_ious)
        pooled_dim = in_channels * cfg.pooler_resolution ** 2
        for k in range(self.num_stages):
            self.add_module(f"box_head{k}", BoxHead(
                pooled_dim, cfg.fc_dim, cfg.num_fc, dtype=dtype))
            self.add_module(f"box_predictor{k}", ZeroShotPredictor(
                cfg.fc_dim, cfg.zs_weight_dim, cfg.norm_temperature))
        self.mask_head = MaskHead(in_channels, cfg.mask_channels,
                                  cfg.mask_num_convs, dtype=dtype)

    def _pool(self, features, boxes, resolution):
        return multilevel_roi_align(
            features, boxes, strides=tuple(self.cfg.strides),
            output_size=resolution, sampling_ratio=self.cfg.sampling_ratio,
            canonical_box_size=self.cfg.canonical_box_size,
            canonical_level=self.cfg.canonical_level,
            impl=self.cfg.align_impl)

    def run_cascade(self, features: Sequence[torch.Tensor],
                    proposals: Detections, zs_weight: torch.Tensor,
                    image_hw: Tuple[int, int]) -> CascadeOutputs:
        """Stage-0 proposals enter unclipped; later stages take the
        previous stage's regressed boxes clipped to the image."""
        h, w = image_hw
        boxes = proposals.boxes
        stages = []
        for k in range(self.num_stages):
            pooled = self._pool(features, boxes, self.cfg.pooler_resolution)
            x = getattr(self, f"box_head{k}")(pooled)
            logits, deltas, clip_feats = getattr(
                self, f"box_predictor{k}")(x, zs_weight)
            stages.append(StageOutput(logits=logits, deltas=deltas,
                                      clip_feats=clip_feats, boxes=boxes))
            boxes = clip_boxes(apply_deltas(
                deltas, boxes, self.cfg.cascade_bbox_reg_weights[k]), h, w)
        prob = torch.sigmoid if self.cfg.use_sigmoid_ce \
            else (lambda t: torch.softmax(t, dim=-1))
        mean_scores = sum(prob(s.logits) for s in stages) / len(stages)
        return CascadeOutputs(stages=tuple(stages), final_boxes=boxes,
                              mean_scores=mean_scores)

    def mask_logits(self, features: Sequence[torch.Tensor],
                    boxes: torch.Tensor) -> torch.Tensor:
        """Mask head on the given boxes -> [R, 28, 28] logits."""
        pooled = self._pool(features, boxes, self.cfg.mask_pooler_resolution)
        return self.mask_head(pooled)
