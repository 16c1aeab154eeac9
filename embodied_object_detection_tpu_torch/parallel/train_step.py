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
any of them into an optimizer step. Every step runs the trunk in train
mode: a Swin trunk's stochastic-depth coins are drawn, [B, blocks, 2]
at once, before the trunk runs, from the step's `torch.Generator` (by
default one seeded from the step, as the JAX package folds the step into
its keys), so that a recomputed trunk sees the same coins; a ResNet-50
trunk draws nothing.

Data parallelism (the JAX package computes one function of the global
batch and XLA inserts the collectives): given a `parallel/mesh.py:Mesh`,
each rank holds its rows of the global batch and the steps give the
numbers of the global batch. The normalisers (`sum(weight)`, the
CenterNet mean counts, the co-training steps' real-frame counts) are
summed over the data group before they divide, so each rank's loss is
its rows' numerator over the global normaliser; the gradients are summed
(not averaged) over the data group in one flat bucket a dtype before
clipping and AdamW, which then run on equal gradients, so the parameters
stay equal across the ranks; row b's sampler and coins are those of its
global row; the caption negatives are the global batch's captions
(gathered); the reported losses are summed over the data group.
`replicate_state` broadcasts rank 0's parameters and optimizer state
once; with a step made on the mesh it is the counterpart of the JAX
package's `jit_train_step`.
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
from .mesh import (Mesh, all_reduce_gradients, all_reduce_sum, gather_rows,
                   replicate)

SAMPLE_SEED = 17
# the stochastic-depth streams, after the JAX package's keys: key 7 folded
# into the flagship step's frame keys, PRNGKey(23) for the caption step
# and PRNGKey(29) for the weak steps, each with the step
DROP_PATH_SEEDS = {"box": 7, "caption": 23, "weak": 29}


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


def sample_generators(step: int, batch: int, device: torch.device,
                      first_row: int = 0) -> list:
    """One proposal-sampling generator per frame, seeded from (step,
    global row): the draws depend on the step, never on what ran before.
    `first_row` is the global row of this rank's first frame."""
    gens = []
    for b in range(first_row, first_row + batch):
        seed = np.random.SeedSequence([SAMPLE_SEED, step, b]).generate_state(
            1, dtype=np.uint64)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        gens.append(gen)
    return gens


def drop_path_generator(kind: str, step: int,
                        device: torch.device) -> torch.Generator:
    """The stochastic-depth generator of a step of `kind` ("box",
    "caption" or "weak"), seeded from (the kind's seed, step)."""
    seed = np.random.SeedSequence([DROP_PATH_SEEDS[kind], step]
                                  ).generate_state(1, dtype=np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def data_rows(mesh: Optional[Mesh], batch: int) -> Tuple[int, int]:
    """(global batch, this rank's first global row) of `batch` local
    rows."""
    if mesh is None:
        return batch, 0
    return batch * mesh.data_size, batch * mesh.data_index


def train_coins(model: EmbodiedDetector, batch: int, kind: str, step: int,
                generator: Optional[torch.Generator],
                device: torch.device,
                mesh: Optional[Mesh] = None) -> Optional[torch.Tensor]:
    """[batch, blocks, 2] coins of a Swin trunk from `generator` (else
    `drop_path_generator(kind, step)`), drawn for the global batch and
    cut to this rank's rows; None, drawing nothing, for a trunk without
    stochastic depth."""
    if not model.drops_paths:
        return None
    if generator is None:
        generator = drop_path_generator(kind, step, device)
    total, first = data_rows(mesh, batch)
    return model.drop_path_coins(total, generator)[first:first + batch]


def _data_group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.data_group


def batch_losses(model: EmbodiedDetector, cfg: DetectorConfig,
                 batch: TrainBatch, zs_weight: torch.Tensor,
                 step: int, fed_freq_weight: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, losses) of a batch: per-frame losses weighted and divided
    by the normaliser, the CenterNet terms by the batch-global mean
    positive and regression-location counts. `fed_freq_weight` [C] turns
    on the federated loss and the zero-category mask where the config
    asks for them; `backbone.train_remat` recomputes the batched trunk in
    the backward. `generator` draws a Swin trunk's coins (default: seeded
    from the step). With a `mesh`, `batch` is this rank's rows and the
    normalisers are the global batch's: the losses are this rank's part
    of the global losses, which sum over the data group."""
    n = batch.image.shape[0]
    group = _data_group(mesh)
    _, first = data_rows(mesh, n)
    egos = memory_read_batched(batch.mem_features, batch.mem_obs,
                               batch.proj_indices) \
        if cfg.memory.reads_memory() else None
    coins = train_coins(model, n, "box", step, generator,
                        batch.image.device, mesh)
    feats = recompute(model.backbone_raw, batch.image, True, coins) \
        if cfg.backbone.train_remat else \
        model.backbone_raw(batch.image, True, coins)
    gens = sample_generators(step, n, batch.image.device, first)
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
    d = 1 if mesh is None else mesh.data_size
    # the normalisers of the global batch: sums over the data group
    # before they divide (the loss_norm rows are equal, so the mean of
    # the ranks' means is the global mean)
    wsum = all_reduce_sum(weight.sum(), group).clamp(min=1.0)
    norm = wsum if batch.loss_norm is None else \
        (all_reduce_sum(batch.loss_norm.mean(), group) / d).clamp(min=1.0)
    num_pos_avg = (all_reduce_sum(
        (losses.pop("_centernet_num_pos") * weight).sum().detach(), group) /
        wsum).clamp(min=1.0)
    reg_norm = (all_reduce_sum(
        (losses.pop("_centernet_reg_cnt") * weight).sum().detach(), group) /
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
                    fed_freq_weight: Optional[np.ndarray] = None,
                    mesh: Optional[Mesh] = None):
    """(init_state, step_fn): init_state() -> TrainState at step 0;
    step_fn(state, batch, zs_weight) -> (state, losses), the losses
    detached, with "total_loss". The model's parameters are updated in
    place. `fed_freq_weight` ([C] class frequencies,
    `engine/train.py:load_fed_freq_weight`) enables the federated loss
    and zero-category masking the config sets. With a `mesh`, `batch` is
    this rank's rows of the global batch (`mesh.py:shard_batch`), and the
    step is the global batch's (see the module's docstring)."""
    fed_w = None if fed_freq_weight is None else torch.as_tensor(
        np.asarray(fed_freq_weight, np.float32)).to(
            next(model.parameters()).device)
    return make_loss_step(
        model, cfg, lambda step, batch, zs_weight: batch_losses(
            model, cfg, batch, zs_weight, step, fed_w, mesh=mesh),
        optimizer, mesh)


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
                 image_loss_weight: float, coins: Optional[torch.Tensor]):
    """(per-frame summed tag losses [B], stage-0 image-box embeddings [B,
    zs_dim]): `frame_train_weak` on each frame over one batched trunk in
    train mode."""
    feats = model.backbone_raw(images, True, coins)
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
                    caption_valid: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> torch.Tensor:
    """[B]: each image's caption loss against the whole global batch's
    captions (gathered over the data group, with their gradient), the
    image's own caption at its global row."""
    _, first = data_rows(mesh, embs.shape[0])
    if mesh is not None:
        caption_features = gather_rows(mesh, caption_features)
        caption_valid = gather_rows(mesh, caption_valid.float()) > 0
    return torch.stack([
        caption_loss(embs[i][None], caption_features, first + i,
                     norm_temperature, neg_cap_weight,
                     caption_valid=caption_valid)
        for i in range(embs.shape[0])])


def make_caption_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                            caption_weight: float = 1.0,
                            neg_cap_weight: float = 0.125,
                            mesh: Optional[Mesh] = None):
    """Caption co-training (ref: CustomRCNN with ann_type 'caption',
    custom_rcnn.py:188-278): each image's whole-image-box embedding
    (`image_box_embedding`, one batched trunk) against every caption of
    the batch, the images without a caption (weight 0) no negatives.
    Returns loss_fn(images [B, H, W, 3], caption_features [B, D], weight
    [B]) -> (total, {"caption_loss": total}), normalised by the full B
    (detic_fast_rcnn.py:418-422). The trunk runs in train mode, as the
    reference trains every co-training forward: a Swin trunk's coins come
    from `generator` (default: seeded from `step` and the JAX package's
    caption key, 23); a ResNet-50 trunk draws nothing. With a `mesh`,
    the inputs are this rank's rows, the negatives the global batch's
    captions and the normaliser the global B: the total is this rank's
    part of the global loss."""

    def loss_fn(images, caption_features, weight, step: int = 0,
                generator: Optional[torch.Generator] = None):
        b_global, _ = data_rows(mesh, images.shape[0])
        coins = train_coins(model, images.shape[0], "caption", step,
                            generator, images.device, mesh)
        feats = model.backbone_raw(images, True, coins)
        embs = torch.stack([
            model.image_box_embedding(images[b],
                                      backbone_feats=tuple(f[b]
                                                           for f in feats))
            for b in range(images.shape[0])])
        losses = _caption_losses(embs, caption_features,
                                 cfg.roi.norm_temperature, neg_cap_weight,
                                 weight > 0, mesh)
        total = caption_weight * (losses * weight).sum() / b_global
        return total, {"caption_loss": total}

    return loss_fn


def make_captiontag_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                               caption_weight: float = 1.0,
                               neg_cap_weight: float = 0.125,
                               variant: str = "max_size",
                               image_loss_weight: float = 0.1,
                               mesh: Optional[Mesh] = None):
    """'captiontag' sources take the caption loss and the image-label tag
    loss (detic_fast_rcnn.py:370-375) from one forward a frame:
    `frame_train_weak` returns the tag losses and the stage-0 image-box
    embedding. Returns loss_fn(images, caption_features, weight, labels
    [B, L], labels_valid [B, L], zs_weight, frame_valid=None) -> (total,
    {"caption_loss", "tag_loss"}). `weight` is 0 for an image without a
    caption, which still takes the tag loss; `frame_valid` [B] (all True
    when None) marks padding rows, which take neither. Both losses are
    normalised by the real frames' count. A Swin trunk's coins come from
    `generator` (default: seeded from `step` and the JAX package's
    captiontag key, 29). With a `mesh`, as `make_caption_train_step`,
    the real frames counted over the global batch."""

    def loss_fn(images, caption_features, weight, labels, labels_valid,
                zs_weight, frame_valid=None, step: int = 0,
                generator: Optional[torch.Generator] = None):
        b = images.shape[0]
        if frame_valid is None:
            frame_valid = torch.ones((b,), dtype=torch.bool,
                                     device=images.device)
        fv = frame_valid.float()
        coins = train_coins(model, b, "weak", step, generator, images.device,
                            mesh)
        tags, embs = _weak_frames(model, images, zs_weight, labels,
                                  labels_valid, variant, image_loss_weight,
                                  coins)
        cap = _caption_losses(embs, caption_features,
                              cfg.roi.norm_temperature, neg_cap_weight,
                              (weight > 0) & frame_valid, mesh)
        b_real = all_reduce_sum(fv.sum(), _data_group(mesh)).clamp(min=1.0)
        cap_total = caption_weight * (cap * weight * fv).sum() / b_real
        tag_w = labels_valid.any(dim=1).float() * fv
        tag_total = (tags * tag_w).sum() / b_real
        return cap_total + tag_total, {"caption_loss": cap_total,
                                       "tag_loss": tag_total}

    return loss_fn


def make_image_label_train_step(model: EmbodiedDetector, cfg: DetectorConfig,
                                variant: str = "max_size",
                                image_loss_weight: float = 0.1,
                                mesh: Optional[Mesh] = None):
    """Image-label batches (ann_type 'image'): the tag half of
    `make_captiontag_train_step`, each frame's `frame_train_weak` over
    one batched trunk, summed over the frames with a valid label and
    divided by B (the reference's image_label_losses divide by the batch,
    detic_fast_rcnn.py:418-422). Returns loss_fn(images, labels,
    labels_valid, zs_weight, step=0, generator=None) -> (total,
    {"image_loss": total}); a Swin trunk's coins as in
    `make_captiontag_train_step`. With a `mesh`, divided by the global
    B."""

    def loss_fn(images, labels, labels_valid, zs_weight, step: int = 0,
                generator: Optional[torch.Generator] = None):
        coins = train_coins(model, images.shape[0], "weak", step, generator,
                            images.device, mesh)
        tags, _ = _weak_frames(model, images, zs_weight, labels,
                               labels_valid, variant, image_loss_weight,
                               coins)
        total = (tags * labels_valid.any(dim=1).float()).sum() / \
            data_rows(mesh, images.shape[0])[0]
        return total, {"image_loss": total}

    return loss_fn


def make_loss_step(model: EmbodiedDetector, cfg: DetectorConfig, loss_fn,
                   optimizer: Optional[GroupedOptimizer] = None,
                   mesh: Optional[Mesh] = None):
    """(init_state, step_fn) of the optimizer step over any loss function
    loss_fn(step, *inputs) -> (total, losses): init_state() -> TrainState
    at step 0; step_fn(state, *inputs) -> (state, losses), the losses
    detached, with "total_loss". A co-training loss function goes in as
    `lambda step, *x: fn(*x, step=step)`, so that its stochastic depth
    (a Swin trunk's) is drawn anew each step. With a `mesh`, loss_fn
    returns this rank's part of the global losses (a loss function made
    with the same mesh): the gradients and the reported losses are summed
    over the data group."""
    group = _data_group(mesh)

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
        all_reduce_gradients(list(model.parameters()), group)
        state.optimizer.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total_loss"] = total.detach()
        if group is not None:
            # one all-reduce of every loss
            summed = all_reduce_sum(torch.stack(list(losses.values())),
                                    group)
            losses = dict(zip(losses, summed.unbind()))
        return state._replace(step=state.step + 1), losses

    return init_state, step_fn


def replicate_state(mesh: Mesh, state: TrainState) -> TrainState:
    """Broadcast rank 0's parameters, buffers, optimizer state, update
    count and step to every rank of the mesh, in place."""
    if mesh.data_group is None:
        return state
    opt = state.optimizer
    replicate(mesh, list(state.model.state_dict().values()) +
              [t for ts in opt.state.values() for t in ts])
    device = next(state.model.parameters()).device
    counts = torch.tensor([opt.count, state.step], dtype=torch.int64,
                          device=device)
    replicate(mesh, [counts])
    opt.count, step = (int(x) for x in counts.tolist())
    return state._replace(step=step)

