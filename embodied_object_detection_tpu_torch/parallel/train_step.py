"""The training step over a batch of frames, at world size 1.

Counterpart of the JAX package's `parallel/train_step.py`
(`make_train_step`'s `loss_fn` and step): the batch's memories are read in
one launch (`memory_read_batched`), the trunk runs batched over the
frames, each frame's losses come from `frame_train` with the CenterNet
normalisers deferred, and the batch normalises them by the batch-global
mean counts. Padding frames carry weight 0. The step sums the losses,
backpropagates, clips and applies AdamW. Detic's co-training losses come
as loss functions over a batch, as the JAX package's do:
`make_caption_train_step`, `make_captiontag_train_step` and
`make_image_label_train_step` (image-label batches; the JAX package
calls `frame_train_weak` frame by frame there); `make_loss_step` turns
any of them into an optimizer step. Data parallelism over
`torch.distributed` is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DetectorConfig
from ..engine.solver import GroupedOptimizer, build_optimizer
from ..models.detector import EmbodiedDetector, recompute
from ..models.losses import caption_loss
from ..ops.memory_ops import memory_read_batched
from ..structures import GroundTruth

SAMPLE_SEED = 17


class TrainBatch(NamedTuple):
    """A batch of independent frames, each with its precomputed memory."""
    image: torch.Tensor          # [B, H, W, 3] float32
    proj_indices: torch.Tensor   # [B, H, W] int32
    mem_features: torch.Tensor   # [B, cells, D] float32
    mem_obs: torch.Tensor        # [B, cells] float32
    gt_boxes: torch.Tensor       # [B, G, 4] float32
    gt_classes: torch.Tensor     # [B, G] int32
    gt_valid: torch.Tensor       # [B, G] bool
    weight: torch.Tensor         # [B] float32; 0 marks a padding frame
    # the reference's normaliser per row (n_chunks * frames of the first
    # chunk); None normalises by sum(weight)
    loss_norm: Optional[torch.Tensor] = None


class TrainState(NamedTuple):
    model: EmbodiedDetector
    optimizer: GroupedOptimizer
    step: int


def sample_generators(step: int, batch: int,
                      device: torch.device) -> list:
    """One proposal-sampling generator per frame, seeded from (step,
    frame): the draws depend on the step, never on what ran before."""
    gens = []
    for b in range(batch):
        seed = np.random.SeedSequence([SAMPLE_SEED, step, b]).generate_state(
            1, dtype=np.uint64)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        gens.append(gen)
    return gens


def batch_losses(model: EmbodiedDetector, cfg: DetectorConfig,
                 batch: TrainBatch, zs_weight: torch.Tensor,
                 step: int, fed_freq_weight: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, losses) of a batch: per-frame losses weighted and divided
    by the normaliser, the CenterNet terms by the batch-global mean
    positive and regression-location counts. `fed_freq_weight` [C] turns
    on the federated loss and the zero-category mask where the config
    asks for them; `backbone.train_remat` recomputes the batched trunk in
    the backward."""
    n = batch.image.shape[0]
    egos = memory_read_batched(batch.mem_features, batch.mem_obs,
                               batch.proj_indices) \
        if cfg.memory.reads_memory() else None
    feats = recompute(model.backbone_raw, batch.image) \
        if cfg.backbone.train_remat else model.backbone_raw(batch.image)
    gens = sample_generators(step, n, batch.image.device)
    per_frame = []
    for b in range(n):
        gt = GroundTruth(batch.gt_boxes[b], batch.gt_classes[b],
                         batch.gt_valid[b])
        per_frame.append(model.frame_train(
            batch.image[b], zs_weight, batch.mem_features[b],
            batch.mem_obs[b], batch.proj_indices[b], gt, gens[b],
            defer_centernet_norm=True,
            ego=None if egos is None else egos[b],
            backbone_feats=tuple(f[b] for f in feats),
            fed_freq_weight=fed_freq_weight))
    losses = {k: torch.stack([f[k] for f in per_frame]) for k in per_frame[0]}
    weight = batch.weight
    wsum = weight.sum().clamp(min=1.0)
    norm = wsum if batch.loss_norm is None else \
        batch.loss_norm.mean().clamp(min=1.0)
    num_pos_avg = ((losses.pop("_centernet_num_pos") * weight).sum() /
                   wsum).clamp(min=1.0)
    reg_norm = ((losses.pop("_centernet_reg_cnt") * weight).sum() /
                wsum).clamp(min=1.0)
    losses = {k: (v * weight).sum() / norm for k, v in losses.items()}
    losses["loss_centernet_agn_pos"] = \
        losses["loss_centernet_agn_pos"] / num_pos_avg
    losses["loss_centernet_agn_neg"] = \
        losses["loss_centernet_agn_neg"] / num_pos_avg
    losses["loss_centernet_loc"] = losses["loss_centernet_loc"] / reg_norm
    total = sum(losses.values())
    return total, losses


def make_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                    optimizer: Optional[GroupedOptimizer] = None,
                    fed_freq_weight: Optional[np.ndarray] = None):
    """(init_state, step_fn): init_state() -> TrainState at step 0;
    step_fn(state, batch, zs_weight) -> (state, losses), the losses
    detached, with "total_loss". The model's parameters are updated in
    place. `fed_freq_weight` ([C] class frequencies,
    `engine/train.py:load_fed_freq_weight`) enables the federated loss
    and zero-category masking the config sets."""
    fed_w = None if fed_freq_weight is None else torch.as_tensor(
        np.asarray(fed_freq_weight, np.float32)).to(
            next(model.parameters()).device)
    return make_loss_step(
        model, cfg, lambda step, batch, zs_weight: batch_losses(
            model, cfg, batch, zs_weight, step, fed_w), optimizer)


def batch_to_device(batch, device: "torch.device | str",
                    pin: bool = False) -> TrainBatch:
    """A batch of numpy arrays (or tensors) as tensors on `device`. With
    `pin`, host arrays are staged in pinned memory and copied without
    waiting for the host."""
    dtypes = {"image": torch.float32, "proj_indices": torch.int32,
              "mem_features": torch.float32, "mem_obs": torch.float32,
              "gt_boxes": torch.float32, "gt_classes": torch.int32,
              "gt_valid": torch.bool, "weight": torch.float32,
              "loss_norm": torch.float32}
    out = {}
    for name, value in batch._asdict().items():
        if value is None:
            out[name] = None
            continue
        t = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value, dtype=dtypes[name])
        if pin and t.device.type == "cpu":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=pin)
    return TrainBatch(**out)


def _weak_frames(model: EmbodiedDetector, images: torch.Tensor,
                 zs_weight: torch.Tensor, labels: torch.Tensor,
                 labels_valid: torch.Tensor, variant: str,
                 image_loss_weight: float):
    """(per-frame summed tag losses [B], stage-0 image-box embeddings [B,
    zs_dim]): `frame_train_weak` on each frame over one batched trunk."""
    feats = model.backbone_raw(images)
    tags, embs = [], []
    for b in range(images.shape[0]):
        losses, emb = model.frame_train_weak(
            images[b], zs_weight, labels[b], labels_valid[b],
            variant=variant, image_loss_weight=image_loss_weight,
            return_image_box_embedding=True,
            backbone_feats=tuple(f[b] for f in feats))
        tags.append(sum(losses.values()))
        embs.append(emb)
    return torch.stack(tags), torch.stack(embs)


def _caption_losses(embs: torch.Tensor, caption_features: torch.Tensor,
                    norm_temperature: float, neg_cap_weight: float,
                    caption_valid: torch.Tensor) -> torch.Tensor:
    """[B]: each image's caption loss against the whole batch's
    captions."""
    return torch.stack([
        caption_loss(embs[i][None], caption_features, i, norm_temperature,
                     neg_cap_weight, caption_valid=caption_valid)
        for i in range(embs.shape[0])])


def make_caption_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                            caption_weight: float = 1.0,
                            neg_cap_weight: float = 0.125):
    """Caption co-training (ref: CustomRCNN with ann_type 'caption',
    custom_rcnn.py:188-278): each image's whole-image-box embedding
    (`image_box_embedding`, one batched trunk) against every caption of
    the batch, the images without a caption (weight 0) no negatives.
    Returns loss_fn(images [B, H, W, 3], caption_features [B, D], weight
    [B]) -> (total, {"caption_loss": total}), normalised by the full B
    (detic_fast_rcnn.py:418-422). The JAX package's drop-path keys feed
    the swin trunk's stochastic depth (item 12c); the ResNet-50 trunk
    has none, so this step takes no generator."""

    def loss_fn(images, caption_features, weight):
        feats = model.backbone_raw(images)
        embs = torch.stack([
            model.image_box_embedding(images[b],
                                      backbone_feats=tuple(f[b]
                                                           for f in feats))
            for b in range(images.shape[0])])
        losses = _caption_losses(embs, caption_features,
                                 cfg.roi.norm_temperature, neg_cap_weight,
                                 weight > 0)
        total = caption_weight * (losses * weight).sum() / images.shape[0]
        return total, {"caption_loss": total}

    return loss_fn


def make_captiontag_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                               caption_weight: float = 1.0,
                               neg_cap_weight: float = 0.125,
                               variant: str = "max_size",
                               image_loss_weight: float = 0.1):
    """'captiontag' sources take the caption loss and the image-label tag
    loss (detic_fast_rcnn.py:370-375) from one forward a frame:
    `frame_train_weak` returns the tag losses and the stage-0 image-box
    embedding. Returns loss_fn(images, caption_features, weight, labels
    [B, L], labels_valid [B, L], zs_weight, frame_valid=None) -> (total,
    {"caption_loss", "tag_loss"}). `weight` is 0 for an image without a
    caption, which still takes the tag loss; `frame_valid` [B] (all True
    when None) marks padding rows, which take neither. Both losses are
    normalised by the real frames' count. No generator, as in
    `make_caption_train_step`."""

    def loss_fn(images, caption_features, weight, labels, labels_valid,
                zs_weight, frame_valid=None):
        b = images.shape[0]
        if frame_valid is None:
            frame_valid = torch.ones((b,), dtype=torch.bool,
                                     device=images.device)
        fv = frame_valid.float()
        tags, embs = _weak_frames(model, images, zs_weight, labels,
                                  labels_valid, variant, image_loss_weight)
        cap = _caption_losses(embs, caption_features,
                              cfg.roi.norm_temperature, neg_cap_weight,
                              (weight > 0) & frame_valid)
        b_real = fv.sum().clamp(min=1.0)
        cap_total = caption_weight * (cap * weight * fv).sum() / b_real
        tag_w = labels_valid.any(dim=1).float() * fv
        tag_total = (tags * tag_w).sum() / b_real
        return cap_total + tag_total, {"caption_loss": cap_total,
                                       "tag_loss": tag_total}

    return loss_fn


def make_image_label_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                                variant: str = "max_size",
                                image_loss_weight: float = 0.1):
    """Image-label batches (ann_type 'image'): the tag half of
    `make_captiontag_train_step`, each frame's `frame_train_weak` over
    one batched trunk, summed over the frames with a valid label and
    divided by B (the reference's image_label_losses divide by the batch,
    detic_fast_rcnn.py:418-422). Returns loss_fn(images, labels,
    labels_valid, zs_weight) -> (total, {"image_loss": total})."""

    def loss_fn(images, labels, labels_valid, zs_weight):
        tags, _ = _weak_frames(model, images, zs_weight, labels,
                               labels_valid, variant, image_loss_weight)
        total = (tags * labels_valid.any(dim=1).float()).sum() / \
            images.shape[0]
        return total, {"image_loss": total}

    return loss_fn


def make_loss_step(model: EmbodiedDetector, cfg: DetectorConfig, loss_fn,
                   optimizer: Optional[GroupedOptimizer] = None):
    """(init_state, step_fn) of the optimizer step over any loss function
    loss_fn(step, *inputs) -> (total, losses): init_state() -> TrainState
    at step 0; step_fn(state, *inputs) -> (state, losses), the losses
    detached, with "total_loss". A co-training loss function, which
    takes no step, goes in as `lambda step, *x: fn(*x)`."""

    def init_state() -> TrainState:
        nonlocal optimizer
        if optimizer is None:
            optimizer = build_optimizer(model, cfg.solver)
        return TrainState(model=model, optimizer=optimizer, step=0)

    def step_fn(state: TrainState, *inputs
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model.zero_grad(set_to_none=True)
        total, losses = loss_fn(state.step, *inputs)
        total.backward()
        state.optimizer.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total_loss"] = total.detach()
        return state._replace(step=state.step + 1), losses

    return init_state, step_fn
