"""CenterNet proposal generator (ONLY_PROPOSAL + WITH_AGN_HM mode).

Counterpart of the JAX package's `models/centernet.py`: a bbox tower of
3x3 conv + GroupNorm(32) + ReLU shared across the five levels, an f32
agnostic-heatmap conv and an f32 ltrb regression conv scaled per level,
and a fixed-shape decode (per-level top-k, a candidate cap, NMS at 0.9;
the training settings take 4000 -> 2000 proposals).

Two paths through the head, chosen by what the call can observe:

- packed, wherever autograd records none of the head's work (no grad
  mode, or neither the parameters nor the features require grad): the
  levels go onto one canvas (`ops/centernet.py:canvas_layout`, kernel
  10), each tower layer is one convolution a band of its rows and one
  GroupNorm a level with its ReLU (kernel 10b), and both heads are one
  f32 convolution with 5 output channels; the eval frame, the
  co-training's proposals, the Res5 heads and the export run it;
- level by level otherwise (the training forward): kernel 10b has no
  backward.

Every caller decodes with one launch of kernel 10c and one stable sort
(`decode_proposals`, or `CenterNetHead.proposals` on the canvas).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CenterNetConfig
from ..ops.centernet import (canvas_layout, centernet_decode,
                             group_norm_relu, level_grid, pack_levels)
from ..ops.nms import NEG_INF, nms_padded, sort_desc, topk_padded
from ..structures import Detections
from ..utils.tracing import span
from .layers import GroupNorm, conv, nchw, nhwc


class Scale(nn.Module):
    """Per-level learnable scalar."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


def joined(owner: nn.Module, name: str,
           parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """`torch.cat(parts)`, cached on `owner` under `name` until a part is
    changed in place or moved (as `layers.as_dtype` caches a cast); made
    anew while a compiler traces."""
    if torch.compiler.is_compiling():
        return torch.cat(list(parts))
    key = tuple((p.device, p.data_ptr(), p._version) for p in parts)
    cached = owner.__dict__.get(name)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, torch.cat([p.detach() for p in parts]))
        owner.__dict__[name] = cached
    return cached[1]


class CenterNetHead(nn.Module):

    def __init__(self, num_levels: int = 5, in_channels: int = 256,
                 num_box_convs: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_box_convs = num_box_convs
        for i in range(num_box_convs):
            self.add_module(f"bbox_tower_conv{i}", nn.Conv2d(
                in_channels, in_channels, 3, 1, 1))
            self.add_module(f"bbox_tower_gn{i}", GroupNorm(32, in_channels))
        self.agn_hm = nn.Conv2d(in_channels, 1, 3, 1, 1)
        self.bbox_pred = nn.Conv2d(in_channels, 4, 3, 1, 1)
        for i in range(num_levels):
            self.add_module(f"scale{i}", Scale())

    def packs(self, features: Sequence[torch.Tensor]) -> bool:
        """True where the packed tower runs: autograd records none of the
        head's work."""
        if not torch.is_grad_enabled():
            return True
        return not any(t.requires_grad for t in features) and \
            not any(p.requires_grad for p in self.parameters())

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per-level [H, W, C] -> (heatmap logits [H, W, 1], regressions
        [H, W, 4]) per level, both f32."""
        if self.packs(features):
            agn_hms, regs = [], []
            for lvl, out in enumerate(self.packed(features)):
                agn_hms.append(out[..., :1])
                regs.append(F.relu(getattr(self, f"scale{lvl}")(
                    out[..., 1:])))
            return agn_hms, regs
        agn_hms, regs = [], []
        for lvl, feat in enumerate(features):
            x = nchw(feat)
            for i in range(self.num_box_convs):
                x = conv(x, getattr(self, f"bbox_tower_conv{i}"), self.dtype)
                x = getattr(self, f"bbox_tower_gn{i}")(x).to(self.dtype)
                x = F.relu(x)
            agn_hms.append(nhwc(conv(x, self.agn_hm), batched=False))
            reg = getattr(self, f"scale{lvl}")(conv(x, self.bbox_pred))
            regs.append(nhwc(F.relu(reg), batched=False))
        return agn_hms, regs

    def packed(self, features: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """The tower and both heads on one canvas -> each level's f32
        [h, w, 5] view of the heads' output: the heatmap logit, then the
        four regressions before their `Scale` and ReLU. Each tower
        convolution runs a band of the canvas at a time (`canvas_layout`
        says why); the f32 heads run over the whole canvas in one
        convolution, whose outputs equal the bands' (at 480 x 640 on an
        H100)."""
        layout = canvas_layout(tuple((f.shape[0], f.shape[1])
                                     for f in features))
        last = self.num_box_convs - 1
        x = pack_levels(features, layout,
                        self.dtype if self.num_box_convs else torch.float32)
        for i in range(self.num_box_convs):
            layer = getattr(self, f"bbox_tower_conv{i}")
            gn = getattr(self, f"bbox_tower_gn{i}")
            x = group_norm_relu(
                [nhwc(conv(nchw(x[r0:r1]), layer, self.dtype), batched=False)
                 for r0, r1 in layout.bands],
                gn.weight, gn.bias, layout, gn.num_groups, gn.eps,
                out_f32=i == last)
        heads = (self.agn_hm, self.bbox_pred)
        weight = joined(self, "_head_weight", [h.weight for h in heads])
        bias = joined(self, "_head_bias", [h.bias for h in heads])
        return layout.levels(nhwc(F.conv2d(nchw(x), weight, bias,
                                           padding=1), batched=False))

    def proposals(self, features: Sequence[torch.Tensor],
                  cfg: CenterNetConfig, training: bool = False
                  ) -> Detections:
        """Per-level [H, W, C] -> the decoded proposals
        (`decode_proposals`'s): on the canvas where the head packs, under
        the span `eodt.frame.proposals.packed`; else level by level."""
        if not self.packs(features):
            agn_hms, regs = self(features)
            return decode_proposals(agn_hms, regs, cfg, training)
        with span("eodt.frame.proposals.packed"):
            outs = self.packed(features)
            scales = joined(self, "_scales", [
                getattr(self, f"scale{i}").scale for i in range(len(outs))])
            return _decode([o[..., 0] for o in outs],
                           [o[..., 1:] for o in outs], scales, cfg, training)


def level_grids(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                device: "torch.device | str" = "cpu") -> List[torch.Tensor]:
    """Per-level [H*W, 2] grid centres: index * stride + stride // 2."""
    return [level_grid(h, w, s, device) for (h, w), s in zip(shapes, strides)]


def decode_proposals(agn_hms: Sequence[torch.Tensor],
                     regs: Sequence[torch.Tensor],
                     cfg: CenterNetConfig, training: bool = False
                     ) -> Detections:
    """Heatmaps + regressions -> top-k NMS'd proposals (fixed shape):
    per-level top `pre_nms_topk`, boxes = grid -/+ reg * stride with at
    least 0.01 extent, score = sqrt(sigmoid), class-agnostic NMS (none
    with `not_nms`), top `post_nms_topk`; the train or test settings."""
    return _decode([hm[..., 0] for hm in agn_hms], list(regs), None, cfg,
                   training)


def _decode(hms: Sequence[torch.Tensor], regs: Sequence[torch.Tensor],
            scales: Optional[torch.Tensor], cfg: CenterNetConfig,
            training: bool) -> Detections:
    """`decode_proposals` on heatmap logits [H, W] and regressions
    [H, W, 4] a level, scaled and rectified first with `scales`: one
    decode launch (kernel 10c) and one stable sort of its keys, whose
    first min(pre_nms_topk, H * W) entries of each level's run are that
    level's top scores, as one stable descending sort a level gives
    them."""
    if training:
        pre_topk, post_topk = cfg.pre_nms_topk_train, cfg.post_nms_topk_train
        nms_thresh = cfg.nms_thresh_train
    else:
        pre_topk, post_topk = cfg.pre_nms_topk_test, cfg.post_nms_topk_test
        nms_thresh = cfg.nms_thresh_test
    levels = min(len(hms), len(cfg.strides))
    key, rows = centernet_decode(
        [hm.float() for hm in hms[:levels]],
        [reg.float() for reg in regs[:levels]],
        scales, cfg.strides[:levels], cfg.score_thresh)
    _, order = torch.sort(key, stable=True)
    parts, start = [], 0
    for hm in hms[:levels]:
        n = hm.shape[0] * hm.shape[1]
        parts.append(order[start:start + min(pre_topk, n)])
        start += n
    rows = rows[parts[0] if len(parts) == 1 else torch.cat(parts)]
    boxes, scores, valid = rows[:, :4], rows[:, 4], rows[:, 5] > 0

    cap = cfg.nms_candidate_cap
    if cap:
        # a cost cap only: never below the requested output size
        cap = max(cap, post_topk)
    if cap and cap < boxes.shape[0]:
        key = torch.where(valid, scores, scores.new_full((), NEG_INF))
        _, keep = sort_desc(key, cap)
        rows, valid = rows[keep], valid[keep]
        boxes, scores = rows[:, :4], rows[:, 4]
    if cfg.not_nms:
        key = torch.where(valid, scores, scores.new_full((), NEG_INF))
        top_scores, out_valid, (top_boxes,) = topk_padded(key, post_topk,
                                                          boxes)
        zero = torch.zeros((), device=boxes.device)
        return Detections(
            boxes=torch.where(out_valid[:, None], top_boxes, zero),
            scores=torch.where(out_valid, top_scores, zero),
            classes=torch.zeros((post_topk,), dtype=torch.int32,
                                device=boxes.device),
            valid=out_valid)
    return nms_padded(boxes, scores, valid, nms_thresh, post_topk,
                      ml_nms_semantics=True)
