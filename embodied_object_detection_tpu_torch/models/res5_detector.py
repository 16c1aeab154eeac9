"""The Res5 ROI heads variant: single-frame, no FPN, no memory.

Counterpart of the JAX package's `models/res5_detector.py` (ref:
Detic/detic/modeling/roi_heads/res5_roi_heads.py:20-172,
CustomRes5ROIHeads). ResNet-50 runs to C4 (stride 16); a one-level
CenterNet head proposes on C4; each proposal pools 14 x 14 from C4
(ROIAlignV2, kernel 4, and its backward, kernel 4b, in training), runs
through the trunk's own stage 4 (`backbone.layer4_*`, shared: there are
no `res5.*` parameters) to 7 x 7 x 2048, is averaged over space in f32,
and one zero-shot predictor (`box_predictor`) gives its class logits,
box deltas and CLIP-space region embedding. Final detections come from
the multiclass NMS (kernel 3). Select it with `roi.head_type="res5"`:
`models/detector.py:build_detector` builds it, and `build_res5_detector`
whatever the config's head type.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import DetectorConfig, check_slice_config
from ..ops.nms import multiclass_nms
from ..ops.roi_align import multilevel_roi_align
from ..structures import Detections, GroundTruth, clip_boxes
from .centernet import CenterNetHead, decode_proposals
from .layers import DTYPES, nchw, nhwc
from .losses import (add_gt_to_proposals, centernet_losses,
                     centernet_targets, fed_loss_class_weight, fed_uniform,
                     match_proposals, sample_proposals, stage_losses)
from .resnet import ResNet50
from .roi_heads import ZeroShotPredictor, apply_deltas


class Res5Outputs(NamedTuple):
    detections: Detections    # [detections_per_image]
    proposals: Detections     # [post_nms_topk_test]
    logits: torch.Tensor      # [R, C+1]
    clip_feats: torch.Tensor  # [R, zs_dim] region embeddings


class Res5Detector(nn.Module):
    """ResNet-50 to C4 + one-level CenterNet proposals + Res5 box heads."""

    # detectron2's Res5ROIHeads pools 14 x 14, which stage 4 takes to 7 x 7
    pooler_resolution = 14
    c4_stride = 16

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        check_slice_config(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.backbone = ResNet50(cfg.backbone.depths, dtype=dtype)
        self.centernet = CenterNetHead(1, 1024, cfg.centernet.num_box_convs,
                                       dtype=dtype)
        # stage 4's 2048 channels (res5_roi_heads.py:33-41)
        self.box_predictor = ZeroShotPredictor(2048, cfg.roi.zs_weight_dim,
                                               cfg.roi.norm_temperature)
        self.register_buffer("pixel_mean", torch.tensor(
            cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(
            cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def backbone_c4(self, image: torch.Tensor) -> torch.Tensor:
        """Normalise + trunk to C4: [H, W, 3] or [B, H, W, 3] -> [H/16,
        W/16, 1024] in the same layout."""
        x = (image - self.pixel_mean) / self.pixel_std
        _, c4 = self.backbone.stem_to_c4(nchw(x))
        return nhwc(c4, image.dim() == 4)

    def _centernet_config(self, training: bool):
        # the lone level's size-of-interest range covers every box in
        # training (the 5-level ladder would leave large objects without
        # a positive location)
        extra = dict(sizes_of_interest=((0, 10000000),)) if training else {}
        return dataclasses.replace(self.cfg.centernet,
                                   strides=(self.c4_stride,), **extra)

    def _roi_features(self, c4: torch.Tensor,
                      boxes: torch.Tensor) -> torch.Tensor:
        """detectron2's _shared_roi_transform: pool 14 x 14 from C4, run
        stage 4, average over space in f32 -> [R, 2048]."""
        pooled = multilevel_roi_align(
            (c4,), boxes, strides=(self.c4_stride,),
            output_size=self.pooler_resolution,
            sampling_ratio=self.cfg.roi.sampling_ratio)
        return self.backbone.res5(nchw(pooled)).float().mean(dim=(2, 3))

    @torch.no_grad()
    def frame_step(self, image: torch.Tensor, zs_weight: torch.Tensor,
                   c4: Optional[torch.Tensor] = None) -> Res5Outputs:
        """One image [H, W, 3] -> Res5Outputs; `c4` skips the trunk when
        it ran batched (`backbone_c4`)."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        if c4 is None:
            c4 = self.backbone_c4(image)
        proposals = self.centernet.proposals((c4,),
                                             self._centernet_config(False))
        x = self._roi_features(c4, proposals.boxes)
        logits, deltas, clip_feats = self.box_predictor(x, zs_weight)
        boxes = clip_boxes(apply_deltas(
            deltas, proposals.boxes, cfg.roi.cascade_bbox_reg_weights[0]),
            h, w)
        # sigmoid or softmax per USE_SIGMOID_CE (detic_fast_rcnn.py:334-338)
        scores = torch.sigmoid(logits) if cfg.roi.use_sigmoid_ce \
            else torch.softmax(logits, dim=-1)
        if cfg.roi.mult_proposal_score:
            scores = torch.sqrt(scores * proposals.scores[:, None].clamp(
                min=0.0))
        detections, _ = multiclass_nms(
            boxes, scores, proposals.valid, cfg.roi.score_thresh_test,
            cfg.roi.nms_thresh_test, cfg.roi.detections_per_image)
        return Res5Outputs(detections=detections, proposals=proposals,
                           logits=logits, clip_feats=clip_feats)

    def frame_train(self, image: torch.Tensor, zs_weight: torch.Tensor,
                    gt: GroundTruth,
                    generator: Optional[torch.Generator] = None,
                    fed_freq_weight: Optional[torch.Tensor] = None) -> dict:
        """One image's training losses: the CenterNet losses normalised by
        the frame's own counts, then the box head at IoU 0.5 on the
        training proposals plus the GT, subsampled to
        `roi.batch_size_per_image` where there are more (`generator`
        draws the sample and, with the federated loss, the class draw
        after it; seed 0 on the frame's device when None).
        `fed_freq_weight` [C] turns on `roi.use_fed_loss` and
        `roi.ignore_zero_cats` as in `EmbodiedDetector.frame_train`."""
        roi = self.cfg.roi
        c = roi.num_classes
        ccfg = self._centernet_config(True)
        c4 = self.backbone_c4(image)
        agn_hms, regs = self.centernet((c4,))
        targets = centernet_targets(gt, [(c4.shape[0], c4.shape[1])], ccfg)
        losses = centernet_losses(
            torch.cat([x.reshape(-1) for x in agn_hms]),
            torch.cat([x.reshape(-1, 4) for x in regs]), targets, ccfg,
            targets.pos_count.float().sum())

        # the proposals take no gradient (the JAX package stops it)
        with torch.no_grad():
            proposals = decode_proposals(agn_hms, regs, ccfg, training=True)
        proposals = add_gt_to_proposals(proposals, gt)
        boxes, valid = proposals.boxes, proposals.valid
        if generator is None:
            generator = torch.Generator(device=boxes.device)
            generator.manual_seed(0)
        bsz = roi.batch_size_per_image
        if bsz and boxes.shape[0] > bsz:
            m0 = match_proposals(boxes, valid, gt, 0.5, c)
            fg = (m0.gt_classes < c) & m0.valid
            idx, keep = sample_proposals(valid, fg, bsz,
                                         roi.positive_fraction, generator)
            boxes, valid = boxes[idx], valid[idx] & keep
        matched = match_proposals(boxes, valid, gt, 0.5, c)
        logits, deltas, _ = self.box_predictor(
            self._roi_features(c4, boxes), zs_weight)
        class_weight = None
        if roi.use_fed_loss and fed_freq_weight is not None:
            class_weight = fed_loss_class_weight(
                matched.gt_classes, matched.valid, fed_freq_weight,
                roi.fed_loss_num_cat, c,
                fed_uniform(c, generator, boxes.device))
        if roi.ignore_zero_cats and fed_freq_weight is not None:
            # sigmoid: multiplies into the federated mask; softmax:
            # replaces it (detic_fast_rcnn.py:225-228, :244-251)
            zero_cat_w = (fed_freq_weight[:c] > 1e-4).float()
            class_weight = zero_cat_w if class_weight is None or \
                not roi.use_sigmoid_ce else class_weight * zero_cat_w
        losses.update(stage_losses(
            logits, deltas, matched, roi.cascade_bbox_reg_weights[0], c,
            use_sigmoid_ce=roi.use_sigmoid_ce, class_weight=class_weight))
        return losses


def build_res5_detector(cfg: Optional[DetectorConfig] = None, seed: int = 0,
                        device: "torch.device | str" = "cuda"
                        ) -> Res5Detector:
    """The Res5 detector of `cfg` (its `roi.head_type` set to "res5") on
    `device` with random weights from `seed`: `build_detector`'s Res5
    branch. The module holds its parameters (the JAX package's returns
    them beside the model)."""
    from .detector import build_detector
    cfg = cfg or DetectorConfig()
    return build_detector(cfg.replace(roi=dataclasses.replace(
        cfg.roi, head_type="res5")), seed, device)
