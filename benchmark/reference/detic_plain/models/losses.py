"""Training losses: CenterNet heatmap and regression, cascade R-CNN stages.

Counterpart of the JAX package's `models/losses.py`: ground-truth boxes are
padded to [G] with a valid mask, FPN locations are a fixed [M], and every
gather or select of the reference's dynamic-shape indexing is a where or
argmin over the [M, G] interaction matrix, so nothing here waits for the
host. With them: the MORE_POS assignment (`add_more_pos`, the indexed
focal loss) and the federated loss's class mask (`fed_loss_class_weight`,
its uniform draw taken as an input). Detic's co-training losses: the
image-label loss in all seven proposal-selection variants
(`image_label_loss`) and the region-caption contrastive loss
(`caption_loss`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import CenterNetConfig
from ..ops.nms import sort_desc
from ..structures import Detections, GroundTruth, giou_xyxy, pairwise_iou
from .centernet import level_grids
from .roi_heads import apply_deltas

INF = 1e8


class CenterNetTargets(NamedTuple):
    agn_heatmap: torch.Tensor   # [M] gaussian-ish heatmap
    reg_targets: torch.Tensor   # [M, 4] ltrb in stride units; -INF invalid
    pos_count: torch.Tensor     # [M] int32 peak-positive multiplicity


def centernet_targets(gt: GroundTruth, shapes: Sequence[Tuple[int, int]],
                      cfg: CenterNetConfig) -> CenterNetTargets:
    """Heatmap, regression targets and peak positives of the agnostic
    (only_proposal) CenterNet over levels of `shapes`."""
    device = gt.boxes.device
    grids = torch.cat(level_grids(shapes, cfg.strides, device=device))
    m = grids.shape[0]
    num_loc = [h * w for h, w in shapes]
    def per_location(values):
        # filled on the device from Python numbers: no host-to-device copy
        return torch.cat([torch.full((n,), float(v), device=device)
                          for n, v in zip(num_loc, values)])

    strides = per_location(cfg.strides)
    size_ranges = torch.stack(
        [per_location([r[0] for r in cfg.sizes_of_interest]),
         per_location([r[1] for r in cfg.sizes_of_interest])], -1)  # [M, 2]

    boxes = gt.boxes                                                # [G, 4]
    valid = gt.valid
    area = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp(min=0)

    left = grids[:, 0:1] - boxes[None, :, 0]                        # [M, G]
    top = grids[:, 1:2] - boxes[None, :, 1]
    right = boxes[None, :, 2] - grids[:, 0:1]
    bottom = boxes[None, :, 3] - grids[:, 1:2]
    reg = torch.stack([left, top, right, bottom], dim=-1)           # [M, G, 4]

    centers = (boxes[:, :2] + boxes[:, 2:]) / 2                     # [G, 2]
    s_m = strides[:, None, None]
    centers_discret = torch.floor(centers[None] / s_m) * s_m + s_m / 2

    is_peak = ((grids[:, None, :] - centers_discret) ** 2).sum(-1) == 0
    is_in_boxes = reg.min(dim=-1).values > 0
    dist_xy = (grids[:, None, :] - centers_discret).abs()
    is_center3x3 = (dist_xy[..., 0] <= strides[:, None]) & \
        (dist_xy[..., 1] <= strides[:, None]) & is_in_boxes
    crit = torch.sqrt(((reg[..., :2] + reg[..., 2:]) ** 2).sum(-1)) / 2
    is_cared = (crit >= size_ranges[:, 0:1]) & (crit <= size_ranges[:, 1:2])
    reg_mask = is_center3x3 & is_cared & valid[None, :]

    dist2 = ((grids[:, None, :] - centers[None]) ** 2).sum(-1)      # [M, G]
    dist2 = torch.where(is_peak, torch.zeros_like(dist2), dist2)
    delta = (1 - cfg.hm_min_overlap) / (1 + cfg.hm_min_overlap)
    radius2 = (delta ** 2 * 2 * area).clamp(min=cfg.min_radius ** 2)
    wdist2 = dist2 / radius2[None, :].clamp(min=1e-12)
    inf = torch.full((), INF, device=device)
    wdist2 = torch.where(valid[None, :], wdist2, inf)

    # regression target: the nearest (weighted) centre among reg_mask'd GTs
    wd_reg = torch.where(reg_mask, wdist2, inf)
    min_dist = wd_reg.min(dim=1).values
    min_idx = wd_reg.argmin(dim=1)                  # first of tied minima
    reg_targets = torch.gather(reg, 1, min_idx[:, None, None].expand(
        m, 1, 4))[:, 0, :]
    reg_targets = torch.where((min_dist < INF)[:, None], reg_targets, -inf)
    reg_targets = torch.where(reg_targets <= -INF / 2, reg_targets,
                              reg_targets / strides[:, None])

    hm = torch.exp(-wdist2.min(dim=1).values)
    hm = torch.where(hm < 1e-4, torch.zeros_like(hm), hm)
    hm = torch.where(valid.any(), hm, torch.zeros_like(hm))

    # peak positives: per GT x level, the discretised centre cell if the
    # box diag / 2 falls in the level's size range
    diag = torch.sqrt(((boxes[:, 2:] - boxes[:, :2]) ** 2).sum(-1)) / 2
    pos_count = torch.zeros((m,), dtype=torch.int32, device=device)
    base = 0
    for (h, w), stride, (lo, hi) in zip(shapes, cfg.strides,
                                        cfg.sizes_of_interest):
        cx = (centers[:, 0] / stride).to(torch.int32)
        cy = (centers[:, 1] / stride).to(torch.int32)
        inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        cared = (diag >= lo) & (diag <= hi) & valid & inside
        flat = base + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
        pos_count = pos_count.index_add(0, flat.long(),
                                        cared.to(torch.int32))
        base += h * w
    return CenterNetTargets(agn_heatmap=hm, reg_targets=reg_targets,
                            pos_count=pos_count)


def binary_heatmap_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                              pos_count: torch.Tensor, cfg: CenterNetConfig
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_loss_sum, neg_loss_sum) of the binary heatmap focal loss; a
    positive shared by two GTs counts twice."""
    pred = torch.sigmoid(logits).clamp(cfg.sigmoid_clamp,
                                       1 - cfg.sigmoid_clamp)
    neg_weights = torch.pow(1 - targets, cfg.hm_focal_beta)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, cfg.loss_gamma)
    pos_loss = (pos_loss * pos_count.to(pos_loss.dtype)).sum()
    neg_loss = torch.log(1 - pred) * torch.pow(pred, cfg.loss_gamma) * \
        neg_weights
    if cfg.ignore_high_fp > 0:
        neg_loss = neg_loss * (pred < cfg.ignore_high_fp)
    neg_loss = neg_loss.sum()
    if cfg.hm_focal_alpha >= 0:
        pos_loss = cfg.hm_focal_alpha * pos_loss
        neg_loss = (1 - cfg.hm_focal_alpha) * neg_loss
    return -pos_loss, -neg_loss


class MorePos(NamedTuple):
    """The MORE_POS positives (ref: centernet.py:748-878 _add_more_pos /
    _get_c33_inds): flat heatmap locations over all levels, [G * L * 9],
    the slots of the reference's variable-length list that hold no
    positive carry pos_valid False."""
    pos_inds: torch.Tensor    # [G * L * 9] int32
    pos_valid: torch.Tensor   # [G * L * 9] bool
    labels: torch.Tensor      # [G * L * 9] int32 GT class


def add_more_pos(reg_pred_flat: torch.Tensor, gt: GroundTruth,
                 shapes: Sequence[Tuple[int, int]],
                 cfg: CenterNetConfig) -> MorePos:
    """MORE_POS: the cells of each GT's center 3x3 on every level whose
    (no-grad) gIoU regression loss lies below min(its more_pos_topk-th
    smallest, more_pos_thresh) become positives; the center itself costs
    0 on the GT's assigned level. Levels are looped in Python, so no
    constant is copied from the host."""
    boxes = gt.boxes
    dev = boxes.device
    g = boxes.shape[0]
    m = sum(h * w for h, w in shapes)
    centers = (boxes[:, :2] + boxes[:, 2:]) / 2                    # [G, 2]
    diag = torch.sqrt(((boxes[:, 2:] - boxes[:, :2]) ** 2).sum(-1)) / 2
    tap = torch.arange(9, device=dev)
    dx, dy = tap % 3 - 1, tap // 3 - 1                             # [9]
    shift = torch.stack([dx, dy, -dx, -dy], -1).float()            # [9, 4]
    inds, regs, level_masks, c33_masks = [], [], [], []
    base = 0
    for (h, w), stride, (lo, hi) in zip(shapes, cfg.strides,
                                        cfg.sizes_of_interest):
        ci = torch.floor(centers / stride)                         # [G, 2]
        grid = ci * stride + float(stride // 2)
        reg = torch.stack([grid[:, 0] - boxes[:, 0], grid[:, 1] - boxes[:, 1],
                           boxes[:, 2] - grid[:, 0],
                           boxes[:, 3] - grid[:, 1]], -1) / stride  # [G, 4]
        level_masks.append((reg.min(-1).values >= 0) & (diag >= lo) &
                           (diag <= hi) & gt.valid)
        nx = ci[:, 0:1].long() + dx
        ny = ci[:, 1:2].long() + dy                                # [G, 9]
        c33_reg = reg[:, None, :] + shift                          # [G, 9, 4]
        c33_masks.append((nx >= 0) & (nx < w) & (ny >= 0) & (ny < h) &
                         (c33_reg.min(-1).values >= 0))
        inds.append(base + ny * w + nx)
        regs.append(c33_reg)
        base += h * w
    c33_ind = torch.stack(inds, 1).clamp(0, m - 1)                 # [G, L, 9]
    c33_reg = torch.stack(regs, 1)                                 # [G, L, 9, 4]
    levels = len(shapes)
    pred = reg_pred_flat.detach()[c33_ind]
    loss = giou_loss_ltrb(pred.reshape(-1, 4),
                          c33_reg.clamp(min=0.0).reshape(-1, 4))
    loss = torch.where(torch.stack(c33_masks, 1),
                       loss.reshape(g, levels, 9), INF)
    center = (tap == 4) & torch.stack(level_masks, 1)[..., None]
    loss = torch.where(center, 0.0, loss)
    kth = torch.sort(loss.reshape(g, levels * 9), dim=1).values[
        :, cfg.more_pos_topk - 1]
    thresh = kth.clamp(max=cfg.more_pos_thresh)
    new_pos = (loss < thresh[:, None, None]) & gt.valid[:, None, None]
    return MorePos(pos_inds=c33_ind.reshape(-1).to(torch.int32),
                   pos_valid=new_pos.reshape(-1),
                   labels=gt.classes[:, None, None].expand(
                       g, levels, 9).reshape(-1).to(torch.int32))


def binary_heatmap_focal_loss_indexed(logits: torch.Tensor,
                                      targets: torch.Tensor,
                                      pos_inds: torch.Tensor,
                                      pos_valid: torch.Tensor,
                                      cfg: CenterNetConfig
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The focal loss with its positives given as indices (the
    reference's `pred[pos_inds]`, heatmap_focal_loss.py:70-73): a repeated
    index contributes repeated terms. The negative term is the mask
    form's."""
    pred = torch.sigmoid(logits).clamp(cfg.sigmoid_clamp,
                                       1 - cfg.sigmoid_clamp)
    neg_weights = torch.pow(1 - targets, cfg.hm_focal_beta)
    pos_pred = pred[pos_inds.long()]
    pos_loss = torch.log(pos_pred) * torch.pow(1 - pos_pred, cfg.loss_gamma)
    pos_loss = torch.where(pos_valid, pos_loss, 0.0).sum()
    neg_loss = torch.log(1 - pred) * torch.pow(pred, cfg.loss_gamma) * \
        neg_weights
    if cfg.ignore_high_fp > 0:
        neg_loss = neg_loss * (pred < cfg.ignore_high_fp)
    neg_loss = neg_loss.sum()
    if cfg.hm_focal_alpha >= 0:
        pos_loss = cfg.hm_focal_alpha * pos_loss
        neg_loss = (1 - cfg.hm_focal_alpha) * neg_loss
    return -pos_loss, -neg_loss


def giou_loss_ltrb(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - gIoU of boxes given as ltrb distances from one point, [K, 4]."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)
    t_area = (tl + tr) * (tt + tb)
    p_area = (pl + pr) * (pt + pb)
    w_i = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    h_i = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    gw_i = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    gh_i = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = gw_i * gh_i
    inter = w_i * h_i
    union = t_area + p_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    gious = ious - (ac_union - union) / ac_union.clamp(min=1e-12)
    return 1 - gious


class CenterNetRawLosses(NamedTuple):
    """Weighted loss sums and the counts they are divided by."""
    pos: torch.Tensor       # pos_weight * focal positive sum
    neg: torch.Tensor       # neg_weight * focal negative sum
    loc: torch.Tensor       # reg_weight * gIoU sum
    num_pos: torch.Tensor   # positive-location count
    reg_cnt: torch.Tensor   # regression-location count


def centernet_raw_losses(agn_logits_flat: torch.Tensor,
                         reg_pred_flat: torch.Tensor,
                         targets: CenterNetTargets,
                         cfg: CenterNetConfig,
                         more_pos: "MorePos | None" = None
                         ) -> CenterNetRawLosses:
    """The CenterNet losses before the division by the (batch-averaged)
    counts: agn_logits_flat [M], reg_pred_flat [M, 4] (stride units).
    With `more_pos` the positives are its assignment (centernet.py:203-208)
    instead of the targets' peaks."""
    if more_pos is not None:
        pos_loss, neg_loss = binary_heatmap_focal_loss_indexed(
            agn_logits_flat, targets.agn_heatmap, more_pos.pos_inds,
            more_pos.pos_valid, cfg)
        num_pos = more_pos.pos_valid.float().sum()
    else:
        pos_loss, neg_loss = binary_heatmap_focal_loss(
            agn_logits_flat, targets.agn_heatmap, targets.pos_count, cfg)
        num_pos = targets.pos_count.float().sum()
    reg_valid = targets.reg_targets.max(dim=1).values >= 0
    reg_cnt = reg_valid.float().sum()
    per_loc = giou_loss_ltrb(reg_pred_flat, torch.where(
        reg_valid[:, None], targets.reg_targets,
        torch.zeros((), device=reg_pred_flat.device)))
    reg_loss = torch.where(reg_valid, per_loc,
                           torch.zeros((), device=per_loc.device)).sum()
    return CenterNetRawLosses(pos=cfg.pos_weight * pos_loss,
                              neg=cfg.neg_weight * neg_loss,
                              loc=cfg.reg_weight * reg_loss,
                              num_pos=num_pos, reg_cnt=reg_cnt)


def centernet_normalize(raw: CenterNetRawLosses, num_pos_avg: torch.Tensor,
                        reg_norm: torch.Tensor) -> dict:
    """Divide the raw sums by the counts, each at least 1."""
    num_pos_avg = num_pos_avg.clamp(min=1.0)
    reg_norm = reg_norm.clamp(min=1.0)
    return {"loss_centernet_agn_pos": raw.pos / num_pos_avg,
            "loss_centernet_agn_neg": raw.neg / num_pos_avg,
            "loss_centernet_loc": raw.loc / reg_norm}


def centernet_losses(agn_logits_flat: torch.Tensor,
                     reg_pred_flat: torch.Tensor, targets: CenterNetTargets,
                     cfg: CenterNetConfig,
                     num_pos_avg: torch.Tensor) -> dict:
    """The CenterNet losses of one frame, the positives normalised by
    `num_pos_avg` and the location loss by the frame's own count."""
    raw = centernet_raw_losses(agn_logits_flat, reg_pred_flat, targets, cfg)
    return centernet_normalize(raw, num_pos_avg, raw.reg_cnt)


class MatchedProposals(NamedTuple):
    boxes: torch.Tensor        # [R, 4]
    gt_boxes: torch.Tensor     # [R, 4] matched GT (the proposal itself if bg)
    gt_classes: torch.Tensor   # [R] in [0, C]; C is background
    valid: torch.Tensor        # [R]


def match_proposals(boxes: torch.Tensor, valid: torch.Tensor,
                    gt: GroundTruth, iou_threshold: float,
                    num_classes: int) -> MatchedProposals:
    """A single-threshold matcher: foreground iff the best IoU with a
    valid GT is at least `iou_threshold`."""
    iou = pairwise_iou(boxes, gt.boxes)                            # [R, G]
    iou = torch.where(gt.valid[None, :], iou,
                      torch.full((), -1.0, device=iou.device))
    best_iou, _ = iou.max(dim=1)
    best = iou.argmax(dim=1)                    # first of tied maxima
    fg = best_iou >= iou_threshold
    g_classes = torch.where(fg, gt.classes[best],
                            torch.full_like(gt.classes[best], num_classes))
    g_boxes = torch.where(fg[:, None], gt.boxes[best], boxes)
    return MatchedProposals(
        boxes=boxes, gt_boxes=g_boxes,
        gt_classes=torch.where(valid, g_classes,
                               torch.full_like(g_classes, num_classes)),
        valid=valid)


def add_gt_to_proposals(proposals: Detections,
                        gt: GroundTruth) -> Detections:
    """Append the GT boxes to the proposals with score 1 (0 for padding)."""
    return Detections(
        boxes=torch.cat([proposals.boxes, gt.boxes]),
        scores=torch.cat([proposals.scores, gt.valid.to(
            proposals.scores.dtype)]),
        classes=torch.cat([proposals.classes,
                           torch.zeros_like(gt.classes)]),
        valid=torch.cat([proposals.valid, gt.valid]))


def sample_proposals(valid: torch.Tensor, fg: torch.Tensor, batch_size: int,
                     positive_fraction: float, generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2's `subsample_labels` as a fixed-shape masked top-k: up
    to batch_size * positive_fraction foreground rows drawn uniformly,
    the rest of `batch_size` filled with uniform background rows. The
    uniform keys come from `generator`, on the rows' device. Returns
    (idx [batch_size], keep [batch_size]); keep masks slots that found no
    candidate."""
    n = valid.shape[0]
    num_pos_cap = int(batch_size * positive_fraction)
    r = torch.rand((n,), generator=generator, device=valid.device)
    pos = fg & valid
    minus_one = torch.full((), -1.0, device=valid.device)
    pos_key = torch.where(pos, r, minus_one)
    _, pos_idx = sort_desc(pos_key, min(num_pos_cap, n))
    pos_sel = torch.zeros((n,), dtype=torch.bool,
                          device=valid.device).scatter(0, pos_idx, True) & pos
    neg_key = torch.where(valid & ~pos, r, minus_one)
    final_key = torch.where(pos_sel, 2.0 + r, neg_key)
    keys, idx = sort_desc(final_key, min(batch_size, n))
    return idx, keys >= 0.0


def fed_uniform(num_classes: int, generator: torch.Generator,
                device: "torch.device | str") -> torch.Tensor:
    """The [C] uniform draw of `fed_loss_class_weight`, in [1e-10, 1) as
    the JAX package's `jax.random.uniform(minval=1e-10)`, from
    `generator` on `device`."""
    return torch.rand((num_classes,), generator=generator,
                      device=device) + 1e-10


def fed_loss_class_weight(gt_classes: torch.Tensor, valid: torch.Tensor,
                          freq_weight: torch.Tensor, num_sample_cats: int,
                          num_classes: int,
                          uniform: torch.Tensor) -> torch.Tensor:
    """The federated loss's [C] 0/1 class mask (ref: get_fed_loss_inds,
    detic/modeling/utils.py:16-29): every class of a valid matched row
    (the background, class C, takes one of the `num_sample_cats` slots
    and is left out of the mask), and as many more classes as the slots
    left, drawn without replacement with probability proportional to
    `freq_weight` among the positive-frequency classes that did not
    appear: a Gumbel top-k over the log frequencies with the Gumbel noise
    from `uniform` [C] (the draw is an input so that a test can feed
    JAX's; `fed_uniform` makes one), the same distribution as
    torch.multinomial. No extras when the appeared classes fill the
    slots."""
    c = num_classes
    dev = gt_classes.device
    idx = torch.where(valid, gt_classes.long(), c + 1)
    appeared_full = torch.zeros((c + 2,), dtype=torch.bool,
                                device=dev).scatter_(0, idx, True)[:c + 1]
    appeared = appeared_full[:c]
    k_extra = (num_sample_cats - appeared_full.sum()).clamp(0, c)
    freq = freq_weight[:c]
    logw = torch.where(freq > 0, torch.log(freq.clamp(min=1e-20)),
                       float("-inf"))
    gumbel = -torch.log(-torch.log(uniform))
    key = torch.where(appeared, float("-inf"), logw + gumbel)
    sorted_desc = torch.sort(key, descending=True).values
    cut = sorted_desc.gather(0, (k_extra - 1).clamp(0, c - 1).reshape(1))
    extras = (key >= cut) & (k_extra > 0) & torch.isfinite(key)
    return (appeared | extras).float()


def softmax_cross_entropy_loss(logits: torch.Tensor,
                               gt_classes: torch.Tensor,
                               valid: torch.Tensor,
                               num_classes: int) -> torch.Tensor:
    """Mean softmax cross-entropy over C+1 classes incl. background."""
    logp = F.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, 1, gt_classes.long()[:, None])[:, 0]
    n = valid.float().sum().clamp(min=1.0)
    return -torch.where(valid, picked, torch.zeros_like(picked)).sum() / n


def stage_losses(logits: torch.Tensor, deltas: torch.Tensor,
                 matched: MatchedProposals, reg_weights: Tuple[float, ...],
                 num_classes: int, use_sigmoid_ce: bool = True,
                 class_weight: "torch.Tensor | None" = None) -> dict:
    """One cascade stage: sigmoid BCE over the C foreground classes (or
    softmax CE over C+1) and the class-agnostic gIoU box loss, both over
    the number of valid proposals. `class_weight` [C] (the federated mask,
    the zero-category mask or their product) weights the BCE's classes,
    or the softmax rows by their class (background weight 1, torch's
    weighted mean; detic_fast_rcnn.py:201-266)."""
    c = num_classes
    b = matched.valid.float().sum().clamp(min=1.0)
    zero = torch.zeros((), device=logits.device)
    if use_sigmoid_ce:
        # a compare, not F.one_hot, whose range check reads the classes
        # back to the host
        onehot = (matched.gt_classes[:, None] == torch.arange(
            c, device=logits.device)).float()
        logit_fg = logits[:, :c]
        bce = logit_fg.clamp(min=0) - logit_fg * onehot + \
            torch.log1p(torch.exp(-logit_fg.abs()))
        if class_weight is not None:
            bce = bce * class_weight[None, :]
        loss_cls = torch.where(matched.valid[:, None], bce, zero).sum() / b
    else:
        logp = F.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(logp, 1,
                              matched.gt_classes.long()[:, None])[:, 0]
        row_w = matched.valid.float()
        if class_weight is not None:
            cw = torch.cat([class_weight, class_weight.new_ones(1)])
            row_w = cw[matched.gt_classes.long()] * row_w
        loss_cls = -(picked * row_w).sum() / row_w.sum().clamp(min=1.0)

    fg = (matched.gt_classes < c) & matched.valid
    pred_boxes = apply_deltas(deltas, matched.boxes, reg_weights)
    giou = giou_xyxy(pred_boxes, matched.gt_boxes)
    loss_box = torch.where(fg, 1 - giou, zero).sum() / b
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def _bce_logits(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE of logits x against target, in the JAX
    package's form."""
    return x.clamp(min=0) - x * target + torch.log1p(torch.exp(-x.abs()))


IMAGE_LABEL_VARIANTS = ("max_size", "max_score", "first", "image",
                        "min_loss", "wsddn", "wsod")


def image_label_selection(logits: torch.Tensor, boxes: torch.Tensor,
                          valid: torch.Tensor, labels: torch.Tensor,
                          num_classes: int, variant: str) -> torch.Tensor:
    """[L] the proposal row `image_label_loss` picks for each label under
    a selection variant (max_size, max_score, first, image, min_loss);
    ties take the first index."""
    r = logits.shape[0]
    with torch.no_grad():
        if variant == "max_size":
            areas = (boxes[:, 2] - boxes[:, 0]).clamp(min=0) * \
                (boxes[:, 3] - boxes[:, 1]).clamp(min=0)
            areas = torch.where(valid, areas, -1.0)
            areas = torch.cat([areas[:r - 1], areas.new_full((1,), -1.0)])
            return areas.argmax().expand(labels.shape[0])
        if variant == "max_score":
            score = torch.where(valid[:, None], logits[:, labels.long()],
                                -1e10)
            return score.argmax(dim=0)
        if variant == "first":
            return torch.zeros_like(labels, dtype=torch.long)
        if variant == "image":
            return torch.full_like(labels, r - 1, dtype=torch.long)
        if variant == "min_loss":
            target = (labels.long()[:, None] == torch.arange(
                num_classes + 1, device=logits.device)).float()
            bce_all = _bce_logits(logits[None], target[:, None])  # [L, R, C+1]
            row_loss = torch.where(valid[None], bce_all.sum(-1), 1e10)
            return row_loss.argmin(dim=1)
    raise ValueError(f"{variant!r} is no selection variant")


def image_label_loss(logits: torch.Tensor, boxes: torch.Tensor,
                     valid: torch.Tensor, labels: torch.Tensor,
                     labels_valid: torch.Tensor, num_classes: int,
                     variant: str = "max_size",
                     image_loss_weight: float = 0.1,
                     prop_logits: "torch.Tensor | None" = None
                     ) -> torch.Tensor:
    """Weak supervision from image-level labels (ref:
    DeticFastRCNNOutputLayers.image_label_losses and its selection
    variants, detic_fast_rcnn.py:342-434, 509-581). logits [R, C+1] of R
    proposals whose last row is the whole-image box, boxes [R, 4], valid
    [R], labels / labels_valid [L]. For each valid label one proposal is
    picked and its full class row takes the BCE against the label:
      max_size   the largest valid proposal, the image box excluded (:572)
      max_score  the valid proposal scoring highest for the label (:524)
      first      proposal 0 (:547)
      image      the whole-image box (:557)
      min_loss   the proposal whose full-row BCE (no gradient) is least
                 (:534)
    wsddn / wsod (:509-522): sigmoid(logits) times a softmax over the
    valid proposals of `prop_logits` [R, C+1] (the WITH_SOFTMAX_PROP head;
    padded rows at -1e10), summed over proposals and clipped to [1e-10,
    1 - 1e-7], then F.binary_cross_entropy's mean over C+1 for each
    label. Ties take the first index. Returns the summed loss over the
    valid labels' count (at least 1) times `image_loss_weight`."""
    if variant not in IMAGE_LABEL_VARIANTS:
        raise ValueError(f"image_label_loss variant {variant!r} is not one "
                         f"of {IMAGE_LABEL_VARIANTS}")
    c = num_classes
    dev = logits.device
    zero = torch.zeros((), device=dev)
    # a compare, not F.one_hot (its range check reads back to the host)
    target = (labels.long()[:, None] ==
              torch.arange(c + 1, device=dev)).float()          # [L, C+1]
    n = labels_valid.float().sum().clamp(min=1.0)
    if variant in ("wsddn", "wsod"):
        if prop_logits is None:
            raise ValueError("the wsddn / wsod image-label loss needs the "
                             "softmax-prop head (roi.with_softmax_prop)")
        pl = torch.where(valid[:, None], prop_logits, -1e10)
        final = torch.sigmoid(logits) * torch.softmax(pl, dim=0)
        img_score = torch.where(valid[:, None], final, zero).sum(0).clamp(
            1e-10, 1 - 1e-7)                                    # [C+1]
        bce = -(target * torch.log(img_score) +
                (1 - target) * torch.log(1 - img_score))        # [L, C+1]
        per = torch.where(labels_valid, bce.mean(dim=1), zero)
        return per.sum() / n * image_loss_weight

    row = logits[image_label_selection(logits, boxes, valid, labels,
                                       num_classes, variant)]  # [L, C+1]
    per = torch.where(labels_valid, _bce_logits(row, target).sum(-1), zero)
    return per.sum() / n * image_loss_weight


def caption_loss(region_embeddings: torch.Tensor,
                 caption_features: torch.Tensor, image_index: int,
                 norm_temperature: float = 50.0,
                 neg_cap_weight: float = 1.0,
                 caption_valid: "torch.Tensor | None" = None
                 ) -> torch.Tensor:
    """Region-caption contrastive loss (ref: DeticFastRCNNOutputLayers.
    _caption_loss, detic_fast_rcnn.py:469-506): the last row of
    `region_embeddings` [R, D] (the whole-image box), scaled to norm
    `norm_temperature` (the norm clamped at 1e-12), is scored against
    every caption embedding of the batch, caption_features [B, D], in f32
    as elementwise products and sums (no tensor core, the JAX package's
    Precision.HIGHEST); BCE with caption `image_index` the positive, the
    negatives weighted by `neg_cap_weight` and masked by `caption_valid`
    [B] (padding rows are no negatives)."""
    emb = region_embeddings[-1].float()
    emb = norm_temperature * emb / torch.linalg.vector_norm(emb).clamp(
        min=1e-12)
    scores = (caption_features.float() * emb).sum(-1)          # [B]
    b = scores.shape[0]
    target = (torch.arange(b, device=scores.device) ==
              image_index).float()
    bce = _bce_logits(scores, target)
    valid = torch.ones_like(bce) if caption_valid is None \
        else caption_valid.float()
    pos = (bce * target).sum()
    neg = (bce * (1 - target) * valid).sum()
    return pos + neg_cap_weight * neg

