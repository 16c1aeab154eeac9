"""The plain reference of the training step: the port's
`parallel/train_step.py:batch_losses` + `make_loss_step` at world size 1,
rewritten over the frozen copy `detic_plain` so that its heads run a
frame at a time.

The trunk runs over the whole batch, as the port runs it (cuDNN picks
its bf16 algorithms by batch size, and a trunk over other batches rounds
otherwise). A first pass without gradients gives each frame's CenterNet
counts (so the batch's detached normalisers); then each frame's share of
the total loss is formed on the trunk's detached features and
backpropagated on its own, and one backward of the trunk takes the
features' summed gradients. The sum is the port's; only its order
differs. The proposal sampler of row b at step s draws from a generator
seeded SeedSequence([17, s, b]), as the port's `sample_generators` seeds
it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .detic_plain.engine.solver import GroupedOptimizer
from .detic_plain.ops.memory_ops import memory_read
from .detic_plain.structures import GroundTruth

SAMPLE_SEED = 17
CENTERNET = ("loss_centernet_agn_pos", "loss_centernet_agn_neg",
             "loss_centernet_loc")


def _generator(step: int, row: int, device) -> torch.Generator:
    seed = np.random.SeedSequence([SAMPLE_SEED, step, row]).generate_state(
        1, dtype=np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _frame_losses(model, cfg, batch, b: int, zs, step: int,
                  feats) -> dict:
    gt = GroundTruth(batch["gt_boxes"][b], batch["gt_classes"][b],
                     batch["gt_valid"][b])
    ego = memory_read(batch["mem_features"][b], batch["mem_obs"][b],
                      batch["proj_indices"][b]) \
        if cfg.memory.reads_memory() else None
    return model.frame_train(
        batch["image"][b], zs, batch["mem_features"][b], batch["mem_obs"][b],
        batch["proj_indices"][b], gt, _generator(step, b, zs.device),
        defer_centernet_norm=True, ego=ego,
        backbone_feats=tuple(f[b] for f in feats))


def step(model, cfg, optimizer: GroupedOptimizer, batch: Dict[str, torch.Tensor],
         zs: torch.Tensor, step_index: int) -> Dict[str, float]:
    """One optimizer step of the reference on a batch of device tensors
    (the fields of the port's TrainBatch, loss_norm None); returns the
    losses as the port reports them, "total_loss" included."""
    n = batch["image"].shape[0]
    weight = batch["weight"]
    model.zero_grad(set_to_none=True)
    trunk = model.backbone_raw(batch["image"], True, None)
    feats = [f.detach().requires_grad_() for f in trunk]
    with torch.no_grad():
        counts = [_frame_losses(model, cfg, batch, b, zs, step_index, feats)
                  for b in range(n)]
    wsum = weight.sum().clamp(min=1.0)
    num_pos_avg = (torch.stack([c["_centernet_num_pos"] for c in counts]) *
                   weight).sum() / wsum
    reg_norm = (torch.stack([c["_centernet_reg_cnt"] for c in counts]) *
                weight).sum() / wsum
    num_pos_avg, reg_norm = num_pos_avg.clamp(min=1.0), reg_norm.clamp(min=1.0)
    totals: Dict[str, float] = {}
    for b in range(n):
        f = _frame_losses(model, cfg, batch, b, zs, step_index, feats)
        f.pop("_centernet_num_pos")
        f.pop("_centernet_reg_cnt")
        part = {}
        for k, v in f.items():
            v = v * weight[b] / wsum
            if k in CENTERNET[:2]:
                v = v / num_pos_avg
            elif k == CENTERNET[2]:
                v = v / reg_norm
            part[k] = v
        total = sum(part.values())
        total.backward()
        for k, v in part.items():
            totals[k] = totals.get(k, 0.0) + float(v.detach())
        totals["total_loss"] = totals.get("total_loss", 0.0) + \
            float(total.detach())
    torch.autograd.backward(trunk, [f.grad for f in feats])
    optimizer.step()
    return totals


def leaf_gaps(got: List[torch.Tensor], want: List[torch.Tensor],
              keep: List[bool]) -> torch.Tensor:
    """Each leaf's gap between the port's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's; 0 for
    the leaves not kept."""
    g = torch.stack([x.float().norm() for x in got]).double()
    w = torch.stack([x.float().norm() for x in want]).double()
    k = torch.tensor(keep)
    scale = torch.maximum(w, w[k].median())
    return torch.where(k, (g - w).abs() / scale, torch.zeros_like(w))
