"""The embodied detector: one recurrent eval frame, an episode chunk, and
one frame's training losses.

Counterpart of the JAX package's `models/detector.py`. One frame is

    image x zs_weight x memory -> detections x memory update

(ResNet-50 or Swin-B -> memory-fused FPN -> CenterNet proposals ->
3-stage cascade -> multiclass NMS -> write-row selection -> mask head ->
mask paste -> memory write). `make_episode_runner` drives it over a
chunk of frames with the memory carried, under every episode protocol
(test_type "default", "episodic", "longterm") and with the external
GT-memory tables;
`make_pipelined_episode_runner` splits the chunk into its trunk and its
frame loop, and `make_batched_episode_runner` runs B scene streams, each
with its own memory. `frame_train` gives the losses of one frame that
reads a precomputed memory; `frame_train_weak` the image-label losses of
Detic's weak co-training and `image_box_embedding` the caption region's
CLIP embedding, both without memory; `frame_step_debug` the per-stage
boxes, region embeddings and scores of one frame. A Swin-B trunk runs
its stochastic depth in the training paths, on coins drawn before the
trunk (`drop_path_coins`). `build_detector` builds the Res5 variant
(`models/res5_detector.py`) for `roi.head_type="res5"`. Public tensors
keep the JAX package's channels-last layout. Everything runs on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..config import DetectorConfig, check_slice_config
from ..ops.mask_paste import paste_masks, paste_masks_observed
from ..ops.memory_ops import (MemoryWriteResult, check_proj_indices,
                              memory_read, memory_write, obs_visibility_host)
from ..ops.nms import multiclass_nms, sort_desc
from ..structures import (Detections, GroundTruth, MemoryState, clip_boxes,
                          nonempty)
from ..utils.tracing import span
from .centernet import CenterNetHead, decode_proposals
from .fpn import RecurrentFPN
from .layers import DTYPES
from .resnet import ResNet50
from .swin import SwinTransformer
from .losses import (add_gt_to_proposals, add_more_pos, centernet_normalize,
                     centernet_raw_losses, centernet_targets,
                     fed_loss_class_weight, fed_uniform, match_proposals,
                     image_label_loss, sample_proposals, stage_losses)
from .roi_heads import (CascadeOutputs, CascadeROIHeads, SoftmaxPropHead,
                        apply_deltas)


def grad_scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """Forward x (as x * s + x * (1 - s), rounded as the JAX package
    rounds it), backward times s."""
    return x * s + x.detach() * (1.0 - s)


class FrameInputs(NamedTuple):
    """One frame, or a chunk of T frames with a leading [T] axis (and B
    scene streams with a leading [B, T] for the batched runner)."""
    image: torch.Tensor           # [H, W, 3] float32 RGB, 0..255
    proj_indices: torch.Tensor    # [H, W] int32 map-cell id per pixel
    outlier_mask: torch.Tensor    # [H, W] bool
    obs_visibility: torch.Tensor  # [max_cells] float32, host-computed
    memory_reset: torch.Tensor    # [] bool: reset memory before this frame
    # [] bool: first frame of an episode, where the longterm protocol
    # snapshots its read memory; None for the protocols that read the live
    # memory (longterm raises without it)
    episode_start: Optional[torch.Tensor] = None
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


def image_box(h: int, w: int, image_box_size: float,
              device: "torch.device | str") -> torch.Tensor:
    """[1, 4] the centred box covering `image_box_size` of each side of
    the image (ref: _add_image_box, detic_roi_heads.py:271-295), filled on
    the device from Python numbers (no host-to-device copy)."""
    f = image_box_size
    corners = (w * (1 - f) / 2, h * (1 - f) / 2, w * (1 - (1 - f) / 2),
               h * (1 - (1 - f) / 2))
    return torch.stack([torch.full((), v, device=device)
                        for v in corners])[None]


def recompute(fn, *args):
    """fn(*args) with its activations recomputed in the backward instead
    of kept (`torch.utils.checkpoint`, non-reentrant): the JAX package's
    `nn.remat` regions. The random state is not saved: no region recomputed
    here draws random numbers, and `checkpoint` would restore only the
    default generators, not the explicit `torch.Generator`s of the
    training step."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


class EmbodiedDetector(nn.Module):
    """ResNet-50 or Swin-B + FPN (memory fusion) + CenterNet + cascade
    heads."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        check_slice_config(cfg)
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        if cfg.backbone.name == "swin_b":
            # Swin-B at its published widths, as the JAX package builds it
            self.backbone = SwinTransformer(
                drop_path_rate=cfg.backbone.drop_path_rate, dtype=dtype)
        else:
            self.backbone = ResNet50(cfg.backbone.depths, dtype=dtype)
        # the laterals take the trunk's own channels (the JAX package's
        # convs infer them)
        self.fpn = RecurrentFPN(
            self.backbone.out_channels, cfg.backbone.fpn_channels,
            cfg.memory.memory_dim, cfg.memory.feat_fusion,
            cfg.memory.map_feature_weight, dtype=dtype,
            with_memory=cfg.memory.reads_memory())
        self.centernet = CenterNetHead(
            len(cfg.centernet.strides), cfg.backbone.fpn_channels,
            cfg.centernet.num_box_convs, dtype=dtype)
        self.roi_heads = CascadeROIHeads(cfg.roi, cfg.backbone.fpn_channels,
                                         dtype=dtype)
        if cfg.roi.with_softmax_prop:
            # the wsddn / wsod loss's score heads, one a stage
            for k in range(len(cfg.roi.cascade_ious)):
                self.add_module(f"prop_score{k}", SoftmaxPropHead(
                    cfg.roi.fc_dim, cfg.roi.num_classes))
        self.register_buffer("pixel_mean", torch.tensor(
            cfg.input.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(
            cfg.input.pixel_std, dtype=torch.float32), persistent=False)

    def backbone_raw(self, image: torch.Tensor, train: bool = False,
                     coins: Optional[torch.Tensor] = None):
        """Normalise + trunk: [H, W, 3] or [T, H, W, 3] -> (C3, C4, C5).
        Memory-independent, so a chunk's frames run it as one batch.
        `train` turns on a Swin trunk's stochastic depth on `coins` ([T,
        blocks, 2] or [blocks, 2], from `drop_path_coins`); the ResNet-50 trunk
        (FrozenBN) has no train mode."""
        with span("eodt.trunk"):
            x = (image - self.pixel_mean) / self.pixel_std
            if not isinstance(self.backbone, SwinTransformer):
                return self.backbone(x)
            if train and coins is None and self.drops_paths:
                raise ValueError("a Swin trunk in train mode needs its "
                                 "stochastic-depth coins: drop_path_coins()")
            return self.backbone(x, coins if train else None)

    @property
    def drops_paths(self) -> bool:
        """Whether the trunk has stochastic depth: a Swin trunk at a rate
        above 0."""
        return isinstance(self.backbone, SwinTransformer) and \
            max(self.backbone.rates, default=0.0) > 0.0

    def drop_path_coins(self, batch: int, generator: torch.Generator
                        ) -> Optional[torch.Tensor]:
        """[batch, blocks, 2] bool stochastic-depth coins of a Swin trunk
        (a block's attention and MLP branches), drawn from `generator` on its device; None, drawing nothing, when
        the trunk has no stochastic depth."""
        if not self.drops_paths:
            return None
        return self.backbone.draw_coins(batch, generator)

    @torch.no_grad()
    def frame_step(self, image: torch.Tensor, zs_weight: torch.Tensor,
                   mem_features: torch.Tensor, mem_obs: torch.Tensor,
                   proj_indices: torch.Tensor, outlier_mask: torch.Tensor,
                   obs_visibility: Optional[torch.Tensor] = None,
                   backbone_feats: Optional[tuple] = None) -> FrameOutputs:
        """Full single-frame inference and the memory-write update.
        `backbone_feats` (C3, C4, C5) skips the trunk when it was run
        outside the frame loop. The spans `eodt.frame.*` split it in five
        stages that cover it whole."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        with span("eodt.frame"):
            with span("eodt.frame.fpn"):
                ego = memory_read(mem_features, mem_obs, proj_indices) \
                    if cfg.memory.reads_memory() else None
                if backbone_feats is None:
                    backbone_feats = self.backbone_raw(image)
                c3, c4, c5 = backbone_feats
                p3, p4, p5, p6, p7 = self.fpn(c3, c4, c5, ego)

            with span("eodt.frame.proposals"):
                proposals = self.centernet.proposals(
                    (p3, p4, p5, p6, p7), cfg.centernet)
            with span("eodt.frame.cascade"):
                cascade = self.roi_heads.run_cascade(
                    (p3, p4, p5), proposals, zs_weight, (h, w))
            with span("eodt.frame.detect"):
                scores = cascade.mean_scores
                if cfg.roi.mult_proposal_score:
                    scores = torch.sqrt(scores * proposals.scores[
                        :, None].clamp(min=0.0))
                if cfg.roi.one_class_per_proposal:
                    best = scores[:, :-1].max(dim=1, keepdim=True).values
                    scores = scores * (scores == best).to(scores.dtype)
                detections, _ = multiclass_nms(
                    cascade.final_boxes, scores, proposals.valid,
                    cfg.roi.score_thresh_test, cfg.roi.nms_thresh_test,
                    cfg.roi.detections_per_image)

            with span("eodt.frame.write"):
                # an external GT-memory table is never written
                if cfg.memory.write_memory and \
                        not cfg.memory.external_memory():
                    write, wboxes, wvalid = self._memory_write(
                        proposals, cascade, (p3, p4, p5), proj_indices,
                        obs_visibility)
                else:
                    k = cfg.memory.write_topk
                    dev = mem_obs.device
                    write = MemoryWriteResult(
                        features_update=torch.zeros_like(mem_features),
                        obs_update=torch.zeros_like(mem_obs),
                        any_detection=torch.zeros((), dtype=torch.bool,
                                                  device=dev))
                    wboxes = torch.zeros((k, 4), device=dev)
                    wvalid = torch.zeros((k,), dtype=torch.bool, device=dev)
            return FrameOutputs(detections=detections, proposals=proposals,
                                write=write, write_boxes=wboxes,
                                write_valid=wvalid)

    def frame_train(self, image: torch.Tensor, zs_weight: torch.Tensor,
                    mem_features: torch.Tensor, mem_obs: torch.Tensor,
                    proj_indices: torch.Tensor, gt: GroundTruth,
                    generator: Optional[torch.Generator] = None,
                    defer_centernet_norm: bool = False,
                    ego: Optional[torch.Tensor] = None,
                    backbone_feats: Optional[tuple] = None,
                    fed_freq_weight: Optional[torch.Tensor] = None,
                    coins: Optional[torch.Tensor] = None) -> dict:
        """One frame's training losses; the frame reads a precomputed
        memory and writes none. `ego` is the frame's memory image when the
        caller read it for a batch, `backbone_feats` (C3, C4, C5) when it
        ran the trunk for a batch. With `defer_centernet_norm` the
        CenterNet entries are raw sums, with their counts under
        `_centernet_num_pos` and `_centernet_reg_cnt` for the batch to
        normalise. `generator` draws the proposal sample and, with the
        federated loss, each stage's class draw after it (seed 0 on the
        frame's device when None). `fed_freq_weight` [C] (the class
        frequencies of `roi.cat_freq_path`) turns on `roi.use_fed_loss`
        and `roi.ignore_zero_cats`; without it both are off, as in the
        JAX package. The trunk, when run here, runs in train mode: a Swin
        trunk's stochastic depth takes `coins` [blocks, 2]
        (`drop_path_coins`). `backbone.train_remat` recomputes the trunk
        (when run here) and the FPN in the backward,
        `roi.train_stage_remat` each stage's pool, box head and predictor;
        no recomputed region draws random numbers."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        if ego is None and cfg.memory.reads_memory():
            ego = memory_read(mem_features, mem_obs, proj_indices)
        remat = cfg.backbone.train_remat
        if backbone_feats is None:
            backbone_feats = recompute(self.backbone_raw, image, True,
                                       coins) if remat \
                else self.backbone_raw(image, True, coins)
        p3, p4, p5, p6, p7 = recompute(self.fpn, *backbone_feats, ego) \
            if remat else self.fpn(*backbone_feats, ego)
        feats = (p3, p4, p5, p6, p7)

        agn_hms, regs = self.centernet(feats)
        shapes = [(f.shape[0], f.shape[1]) for f in feats]
        targets = centernet_targets(gt, shapes, cfg.centernet)
        reg_flat = torch.cat([x.reshape(-1, 4) for x in regs])
        # MORE_POS (centernet.py:203-208): the loss-selected center-3x3
        # positives replace the peaks
        more_pos = add_more_pos(reg_flat, gt, shapes, cfg.centernet) \
            if cfg.centernet.more_pos else None
        raw = centernet_raw_losses(
            torch.cat([x.reshape(-1) for x in agn_hms]), reg_flat, targets,
            cfg.centernet, more_pos=more_pos)
        if defer_centernet_norm:
            losses = {"loss_centernet_agn_pos": raw.pos,
                      "loss_centernet_agn_neg": raw.neg,
                      "loss_centernet_loc": raw.loc,
                      "_centernet_num_pos": raw.num_pos,
                      "_centernet_reg_cnt": raw.reg_cnt}
        else:
            losses = centernet_normalize(raw, raw.num_pos, raw.reg_cnt)

        # the proposals take no gradient (the JAX package stops it)
        with torch.no_grad():
            proposals = decode_proposals(agn_hms, regs, cfg.centernet,
                                         training=True)
        proposals = add_gt_to_proposals(proposals, gt)
        boxes, valid = proposals.boxes, proposals.valid
        roi = cfg.roi
        c = roi.num_classes
        bsz = roi.batch_size_per_image
        if bsz and boxes.shape[0] > bsz:
            if generator is None:
                generator = torch.Generator(device=boxes.device)
                generator.manual_seed(0)
            m0 = match_proposals(boxes, valid, gt, roi.cascade_ious[0], c)
            fg = (m0.gt_classes < c) & m0.valid
            idx, keep = sample_proposals(valid, fg, bsz,
                                         roi.positive_fraction, generator)
            boxes, valid = boxes[idx], valid[idx] & keep

        num_stages = len(roi.cascade_ious)
        matched = match_proposals(boxes, valid, gt, roi.cascade_ious[0], c)
        # the federated loss draws each stage's classes anew, as each
        # reference losses() call does (detic_fast_rcnn.py:214-218)
        use_fed = roi.use_fed_loss and fed_freq_weight is not None
        zero_cat_w = (fed_freq_weight[:c] > 1e-4).float() \
            if roi.ignore_zero_cats and fed_freq_weight is not None else None
        if use_fed and generator is None:
            generator = torch.Generator(device=boxes.device)
            generator.manual_seed(0)

        def stage_forward(k, stage_boxes):
            pooled = self.roi_heads._pool((p3, p4, p5), stage_boxes,
                                          roi.pooler_resolution)
            pooled = grad_scale(pooled, 1.0 / num_stages)
            x = getattr(self.roi_heads, f"box_head{k}")(pooled)
            return getattr(self.roi_heads, f"box_predictor{k}")(x,
                                                                zs_weight)

        for k in range(num_stages):
            if k > 0:
                boxes = clip_boxes(prev_boxes.detach(), h, w)
                valid = valid & nonempty(boxes)
                matched = match_proposals(boxes, valid, gt,
                                          roi.cascade_ious[k], c)
            logits, deltas, _ = recompute(stage_forward, k, boxes) \
                if roi.train_stage_remat else stage_forward(k, boxes)
            class_weight = fed_loss_class_weight(
                matched.gt_classes, matched.valid, fed_freq_weight,
                roi.fed_loss_num_cat, c,
                fed_uniform(c, generator, boxes.device)) if use_fed else None
            if zero_cat_w is not None:
                # sigmoid: multiplies into the federated mask (detic_fast_
                # rcnn.py:225-228); softmax: replaces it (:244-251)
                class_weight = zero_cat_w if class_weight is None or \
                    not roi.use_sigmoid_ce else class_weight * zero_cat_w
            stage = stage_losses(logits, deltas, matched,
                                 roi.cascade_bbox_reg_weights[k], c,
                                 use_sigmoid_ce=roi.use_sigmoid_ce,
                                 class_weight=class_weight)
            losses.update({f"{n}_stage{k}": v for n, v in stage.items()})
            prev_boxes = apply_deltas(deltas, boxes,
                                      roi.cascade_bbox_reg_weights[k])
        return losses

    def frame_train_weak(self, image: torch.Tensor, zs_weight: torch.Tensor,
                         labels: torch.Tensor, labels_valid: torch.Tensor,
                         variant: str = "max_size",
                         image_loss_weight: float = 0.1,
                         ws_num_props: int = 128,
                         image_box_size: float = 1.0,
                         return_image_box_embedding: bool = False,
                         backbone_feats: Optional[tuple] = None,
                         train: bool = False,
                         coins: Optional[torch.Tensor] = None):
        """Image-label weak supervision of one frame (ref: CustomRCNN with
        ann_type 'image', custom_rcnn.py:188-278; get_top_proposals and
        _add_image_box, detic_roi_heads.py:239, 271-295): the frame reads
        no memory; its top `ws_num_props` training proposals (the proposal
        NMS at the training top-k), clipped, plus the whole-image box go
        through the three stages, each stage's pool scaled by 1 /
        num_stages in the backward and its boxes taking no gradient, with
        empty boxes dropped from stage 1 on; each stage's
        `image_label_loss` under "image_loss_stage{s}". labels /
        labels_valid [L]. With `return_image_box_embedding`, also the
        whole-image box's stage-0 CLIP feature (the caption region, from
        this one forward). `backbone_feats` (C3, C4, C5) skips the trunk
        when it ran batched; else `train` runs a Swin trunk's stochastic
        depth on `coins`, as the co-training steps do."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        if variant in ("wsddn", "wsod") and not cfg.roi.with_softmax_prop:
            raise ValueError(f"variant {variant!r} needs "
                             "roi.with_softmax_prop=True")
        if backbone_feats is None:
            backbone_feats = self.backbone_raw(image, train, coins)
        p3, p4, p5, p6, p7 = self.fpn(*backbone_feats, None)
        # the proposals take no gradient (the JAX package stops it)
        with torch.no_grad():
            proposals = self.centernet.proposals(
                (p3, p4, p5, p6, p7), cfg.centernet, training=True)
        k = min(ws_num_props, proposals.boxes.shape[0])
        device = proposals.boxes.device
        boxes = torch.cat([clip_boxes(proposals.boxes[:k], h, w),
                           image_box(h, w, image_box_size, device)])
        valid = torch.cat([proposals.valid[:k],
                           torch.ones((1,), dtype=torch.bool,
                                      device=device)])
        roi = cfg.roi
        num_stages = len(roi.cascade_ious)
        losses = {}
        emb = None
        for s in range(num_stages):
            if s > 0:
                # empty boxes leave every training forward
                # (detic_roi_heads.py:314-318)
                valid = valid & nonempty(boxes)
            pooled = self.roi_heads._pool((p3, p4, p5), boxes,
                                          roi.pooler_resolution)
            pooled = grad_scale(pooled, 1.0 / num_stages)
            x = getattr(self.roi_heads, f"box_head{s}")(pooled)
            logits, deltas, clip_feats = getattr(
                self.roi_heads, f"box_predictor{s}")(x, zs_weight)
            if s == 0:
                emb = clip_feats[-1]
            prop_logits = getattr(self, f"prop_score{s}")(x) \
                if variant in ("wsddn", "wsod") else None
            losses[f"image_loss_stage{s}"] = image_label_loss(
                logits, boxes, valid, labels, labels_valid, roi.num_classes,
                variant=variant, image_loss_weight=image_loss_weight,
                prop_logits=prop_logits)
            boxes = clip_boxes(apply_deltas(
                deltas, boxes, roi.cascade_bbox_reg_weights[s]).detach(),
                h, w)
        if return_image_box_embedding:
            return losses, emb
        return losses

    def image_box_embedding(self, image: torch.Tensor,
                            image_box_size: float = 1.0,
                            backbone_feats: Optional[tuple] = None,
                            train: bool = False,
                            coins: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """The whole-image box's CLIP-space embedding [zs_dim], the
        caption region (ref: the caption path's score[-1:],
        detic_fast_rcnn.py:477): one box pooled on the frame's FPN
        (no memory), stage 0's box head and its zero-shot projection
        against a [zs_dim, 1] zero classifier. `train` and `coins` as in
        `frame_train_weak`."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        if backbone_feats is None:
            backbone_feats = self.backbone_raw(image, train, coins)
        p3, p4, p5, _, _ = self.fpn(*backbone_feats, None)
        box = image_box(h, w, image_box_size, p3.device)
        pooled = self.roi_heads._pool((p3, p4, p5), box,
                                      cfg.roi.pooler_resolution)
        x = self.roi_heads.box_head0(pooled)
        zs_dummy = torch.zeros((cfg.roi.zs_weight_dim, 1), device=p3.device)
        _, _, feat = self.roi_heads.box_predictor0(x, zs_dummy)
        return feat[0]

    @torch.no_grad()
    def frame_step_debug(self, image: torch.Tensor, zs_weight: torch.Tensor,
                         mem_features: torch.Tensor, mem_obs: torch.Tensor,
                         proj_indices: torch.Tensor,
                         outlier_mask: torch.Tensor) -> dict:
        """One frame's inference with its intermediates, for diffing
        against another implementation (ref: the prompt_learning dump,
        zero_shot_classifier.py:91-100, detic_roi_heads.py:182-212): the
        proposals ("proposal_boxes", "objectness", "proposal_valid"), the
        final detections ("final_boxes", "final_scores",
        "final_classes", "final_valid") and each cascade stage's input
        boxes, region embeddings and sigmoid scores
        ("stage{k}_boxes", "stage{k}_region_embeddings",
        "stage{k}_scores"). No memory write runs."""
        cfg = self.cfg
        h, w = cfg.input.height, cfg.input.width
        ego = memory_read(mem_features, mem_obs, proj_indices) \
            if cfg.memory.reads_memory() else None
        p3, p4, p5, p6, p7 = self.fpn(*self.backbone_raw(image), ego)
        proposals = self.centernet.proposals((p3, p4, p5, p6, p7),
                                             cfg.centernet)
        cascade = self.roi_heads.run_cascade((p3, p4, p5), proposals,
                                             zs_weight, (h, w))
        scores = cascade.mean_scores
        if cfg.roi.mult_proposal_score:
            scores = torch.sqrt(scores * proposals.scores[:, None].clamp(
                min=0.0))
        detections, _ = multiclass_nms(
            cascade.final_boxes, scores, proposals.valid,
            cfg.roi.score_thresh_test, cfg.roi.nms_thresh_test,
            cfg.roi.detections_per_image)
        out = {"proposal_boxes": proposals.boxes,
               "objectness": proposals.scores,
               "proposal_valid": proposals.valid,
               "final_boxes": detections.boxes,
               "final_scores": detections.scores,
               "final_classes": detections.classes,
               "final_valid": detections.valid}
        for k, st in enumerate(cascade.stages):
            out[f"stage{k}_boxes"] = st.boxes
            out[f"stage{k}_region_embeddings"] = st.clip_feats
            out[f"stage{k}_scores"] = torch.sigmoid(st.logits)
        return out

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
                               device=boxes.device).scatter_(
            0, torch.where(rows >= 0, rows, torch.full_like(rows, r)).long(),
            True)[:r]
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
            # the paste also writes the write's observed flags and counts
            masks, observed, counts = paste_masks_observed(
                mask_probs, wboxes, wvalid, h, w, cfg.memory.mask_thresh)
            write = memory_write(wfeats, masks, wvalid, proj_indices,
                                 num_cells=cfg.memory.max_cells,
                                 subsample=s, exact_subsample=True,
                                 obs_visibility=obs_visibility,
                                 pixel_major=True, observed=observed,
                                 row_counts=counts)
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


def _frame(frames: FrameInputs, *at) -> FrameInputs:
    """Frame `at` of a chunk ([t]) or of a batch of streams ([b, t])."""
    return FrameInputs(*(None if x is None else x[at] for x in frames))


class _Stream(NamedTuple):
    """One scene stream's carry through a chunk."""
    live: MemoryState      # the memory the frames write
    read: MemoryState      # the memory the frames read
    first: MemoryState     # the live memory right after the chunk's frame 0


def _stream_step(model: EmbodiedDetector, cfg: DetectorConfig,
                 frame: FrameInputs, zs_weight: torch.Tensor,
                 carry: _Stream, zeros: MemoryState, t: int,
                 backbone_feats: Optional[tuple]
                 ) -> Tuple[_Stream, FrameOutputs]:
    """One frame of one stream: reset, choose the read memory by the
    protocol, run the frame, carry its write. Its span's self part, the
    part outside `eodt.frame`, is this carry."""
    with span("eodt.stream_step"):
        live, read = carry.live, carry.read
        external = cfg.memory.external_memory()
        if external:
            read = live                 # a fixed table: no reset, no write
        else:
            # padding frames must not reset either (producers that pad by
            # repeating a reset-bearing frame would wipe the carry)
            do_reset = frame.memory_reset if frame.frame_valid is None \
                else frame.memory_reset & frame.frame_valid
            live = _where_state(do_reset, zeros, live)
            if cfg.memory.test_type == "longterm":
                read = _where_state(frame.episode_start, live,
                                    _where_state(do_reset, zeros, read))
            else:                       # default, episodic
                read = live
        out = model.frame_step(frame.image, zs_weight, read.features,
                               read.obs_count, frame.proj_indices,
                               frame.outlier_mask, frame.obs_visibility,
                               backbone_feats=backbone_feats)
        if not external:
            updated = MemoryState(live.features + out.write.features_update,
                                  live.obs_count + out.write.obs_update)
            live = updated if frame.frame_valid is None else \
                _where_state(frame.frame_valid, updated, live)
        return _Stream(live, read, live if t == 0 else carry.first), out


def _check_frames(cfg: DetectorConfig, frames: FrameInputs) -> None:
    if cfg.memory.test_type == "longterm" and frames.episode_start is None \
            and not cfg.memory.external_memory():
        raise ValueError("memory.test_type='longterm' snapshots the read "
                         "memory at episode starts: pass episode_start")


def _zeros(memory: MemoryState) -> MemoryState:
    return MemoryState(*(torch.zeros_like(x) for x in memory))


def _episode_outputs(dets: List[Detections], any_det: List[torch.Tensor],
                     carry: _Stream) -> EpisodeOutputs:
    return EpisodeOutputs(
        detections=Detections(*(torch.stack(x) for x in zip(*dets))),
        memory=carry.live, any_detection=torch.stack(any_det),
        first_memory=carry.first)


def make_episode_runner(model: EmbodiedDetector, cfg: DetectorConfig,
                        precompute_backbone=True):
    """An episode function (frames [T, ...], zs_weight, init_memory) ->
    EpisodeOutputs, the JAX package's runner as a loop over frames:
    - a frame with `memory_reset` starts from zeros, and padding frames
      (frame_valid False) neither reset nor write;
    - test_type "default" / "episodic": each frame reads the live memory;
    - "longterm": the read memory is snapshotted only where
      `episode_start` holds, so within an episode the frames read a frozen
      memory while the live memory accumulates (resets zero both);
    - an external GT-memory type: the table is never reset or written, and
      `first_memory` is the table.
    `precompute_backbone`: True runs the trunk batched over the chunk
    before the serial frame loop, False inside each frame, "external"
    returns an episode function that takes the trunk's (C3, C4, C5) over
    the chunk as a fourth argument (`make_pipelined_episode_runner`)."""
    check_slice_config(cfg)
    if precompute_backbone not in (True, False, "external"):
        raise ValueError(f"precompute_backbone={precompute_backbone!r}: "
                         "True, False or 'external'")

    @torch.no_grad()
    def episode(frames: FrameInputs, zs_weight: torch.Tensor,
                init_memory: MemoryState,
                backbone_feats: Optional[tuple] = None) -> EpisodeOutputs:
        _check_frames(cfg, frames)
        if precompute_backbone == "external":
            if backbone_feats is None:
                raise ValueError("this episode function takes the trunk's "
                                 "features over the chunk")
            feats = backbone_feats
        elif precompute_backbone:
            feats = model.backbone_raw(frames.image)
        else:
            feats = None
        zeros = _zeros(init_memory)
        carry = _Stream(init_memory, init_memory, init_memory)
        dets, any_det = [], []
        for t in range(frames.image.shape[0]):
            carry, out = _stream_step(
                model, cfg, _frame(frames, t), zs_weight, carry, zeros, t,
                None if feats is None else tuple(f[t] for f in feats))
            dets.append(out.detections)
            any_det.append(out.write.any_detection)
        return _episode_outputs(dets, any_det, carry)

    if precompute_backbone == "external":
        return episode

    def episode3(frames: FrameInputs, zs_weight: torch.Tensor,
                 init_memory: MemoryState) -> EpisodeOutputs:
        return episode(frames, zs_weight, init_memory)
    return episode3


def make_pipelined_episode_runner(model: EmbodiedDetector,
                                  cfg: DetectorConfig):
    """The episode split in two: (trunk_fn(images [T, H, W, 3]) -> (C3,
    C4, C5), scan_fn(frames, zs_weight, memory, feats) -> EpisodeOutputs),
    so that a caller can issue chunk k+1's trunk before chunk k's frame
    loop. Numerically the single runner: only the order of issue moves."""
    scan_fn = make_episode_runner(model, cfg, precompute_backbone="external")

    @torch.no_grad()
    def trunk_fn(images: torch.Tensor) -> tuple:
        return model.backbone_raw(images)

    return trunk_fn, scan_fn


def make_batched_episode_runner(model: EmbodiedDetector, cfg: DetectorConfig):
    """B independent scene streams: (frames [B, T, ...], zs_weight,
    init_memory [B, ...]) -> EpisodeOutputs with a leading [B]. The trunk
    runs once over the B * T frames; then, frame by frame, each stream
    runs in turn with its own memory, under the single runner's
    semantics."""
    check_slice_config(cfg)

    @torch.no_grad()
    def episode(frames: FrameInputs, zs_weight: torch.Tensor,
                init_memory: MemoryState) -> EpisodeOutputs:
        _check_frames(cfg, frames)
        b, t_max = frames.image.shape[:2]
        feats = model.backbone_raw(frames.image.flatten(0, 1))
        feats = tuple(f.unflatten(0, (b, t_max)) for f in feats)
        inits = [MemoryState(*(x[i] for x in init_memory)) for i in range(b)]
        zeros = _zeros(inits[0])
        carries = [_Stream(m, m, m) for m in inits]
        dets = [[] for _ in range(b)]
        any_det = [[] for _ in range(b)]
        for t in range(t_max):
            for i in range(b):
                carries[i], out = _stream_step(
                    model, cfg, _frame(frames, i, t), zs_weight, carries[i],
                    zeros, t, tuple(f[i, t] for f in feats))
                dets[i].append(out.detections)
                any_det[i].append(out.write.any_detection)
        outs = [_episode_outputs(d, a, c)
                for d, a, c in zip(dets, any_det, carries)]
        return EpisodeOutputs(
            detections=Detections(*(torch.stack(x) for x in zip(
                *(o.detections for o in outs)))),
            memory=MemoryState(*(torch.stack(x) for x in zip(
                *(o.memory for o in outs)))),
            any_detection=torch.stack([o.any_detection for o in outs]),
            first_memory=MemoryState(*(torch.stack(x) for x in zip(
                *(o.first_memory for o in outs)))))

    return episode


def frame_inputs(images: np.ndarray, proj_indices: np.ndarray,
                 memory_reset: np.ndarray, max_cells: int,
                 device: "torch.device | str",
                 frame_valid: Optional[np.ndarray] = None,
                 episode_start: Optional[np.ndarray] = None) -> FrameInputs:
    """Host boundary: check the cell ids, compute the cell visibility on
    the host, and move a chunk [T, ...] of frames (or B streams of them,
    [B, T, ...]) to the device."""
    check_proj_indices(proj_indices, max_cells)

    def to(a, dtype):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=device)

    return FrameInputs(
        image=to(images, torch.float32),
        proj_indices=to(proj_indices, torch.int32),
        outlier_mask=torch.zeros(proj_indices.shape, dtype=torch.bool,
                                 device=device),
        obs_visibility=to(obs_visibility_host(proj_indices, max_cells),
                          torch.float32),
        memory_reset=to(memory_reset, torch.bool),
        episode_start=to(episode_start, torch.bool),
        frame_valid=to(frame_valid, torch.bool))


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
    c2_msra mask convs; the softmax-prop heads c2_xavier fc1 and
    normal(0.001) fc2; a Swin trunk's fan-in normal linears and patch
    embedding and normal(0.02) relative position bias tables. Norm
    statistics and scales stay at identity."""
    gen = torch.Generator().manual_seed(seed)
    prior = model.cfg.centernet.prior_prob
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "_gn" in name or name.startswith("centernet.scale") or \
                    ("norm" in name and leaf == "weight" and p.dim() == 1):
                continue
            if leaf == "relative_position_bias_table":
                _fill(p, gen, "normal", std=0.02)
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
            elif name.startswith("prop_score"):
                if ".fc1." in name:
                    _fill(p, gen, "uniform", bound=math.sqrt(3.0 / fan_in))
                else:
                    _fill(p, gen, "normal", std=0.001)
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
    ones with `convert.from_jax.load_jax_params`): the embodied detector,
    the Res5 variant (`models/res5_detector.py`) for
    `roi.head_type="res5"`, as the JAX package dispatches, or the
    Deformable-DETR (`models/deformable_detr.py`, its JAX init families)
    for `roi.head_type="detr"`, sized by `cfg.detr`. TF32 is
    switched off for the process: the f32 sites (memory-merge
    projections, heatmap and regression convs, zero-shot logits, mask
    deconv and predictor, mask paste, the write's feature product, the
    Swin attention logits) must run in full f32."""
    cfg = cfg or DetectorConfig()
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if cfg.roi.head_type == "res5":
        from .res5_detector import Res5Detector
        model = Res5Detector(cfg)
        init_weights(model, seed)
        return model.to(device).eval()
    if cfg.roi.head_type == "detr":
        from .deformable_detr import build_deformable_detr
        return build_deformable_detr(cfg, seed, device)
    model = EmbodiedDetector(cfg)
    init_weights(model, seed)
    return model.to(device).eval()
