"""Ahead-of-time export of the frame step for serving.

Counterpart of the JAX package's `serve/export.py`, with a `torch.export`
program (`.pt2`) in place of its StableHLO blob: the serving process
loads it and calls it without the model code. Loading needs only the
port's `ops` package imported, which registers the kernels' custom ops
(`torch.ops.eodt.*`); the exported program calls them, so it launches
the same kernels (and ticks the same launch counters) as the eager frame
on the card, and their plain versions on the CPU.

The exported callable is the persistent-memory streaming step of
`demo/predictor.py`, with the weights baked in:

    (image [H, W, 3] f32, zs_weight [D, C+1] f32, mem_features
     [cells, D] f32, mem_obs [cells] f32, proj_indices [H, W] int32,
     outlier_mask [H, W] bool)
    -> (boxes, scores, classes, valid, mem_features', mem_obs')

The vocabulary stays an input (at the class count it was exported
with). `valid` marks the real detections among the fixed
detections_per_image rows; the rest are padding. The program holds the
device it was exported on.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn


class _FrameStep(nn.Module):
    """`frame_step` and the memory carry as one module."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, image, zs_weight, mem_features, mem_obs, proj_indices,
                outlier_mask):
        out = self.model.frame_step(image, zs_weight, mem_features, mem_obs,
                                    proj_indices, outlier_mask)
        d = out.detections
        return (d.boxes, d.scores, d.classes, d.valid,
                mem_features + out.write.features_update,
                mem_obs + out.write.obs_update)


def example_inputs(cfg, num_classes: Optional[int] = None,
                   device: "torch.device | str" = "cuda") -> tuple:
    """Zero inputs of the exported step's shapes on `device`."""
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    nc = num_classes or cfg.roi.num_classes
    kw = dict(device=device)
    return (torch.zeros((h, w, 3), **kw),
            torch.zeros((cfg.roi.zs_weight_dim, nc + 1), **kw),
            torch.zeros((cells, dim), **kw), torch.zeros((cells,), **kw),
            torch.zeros((h, w), dtype=torch.int32, **kw),
            torch.zeros((h, w), dtype=torch.bool, **kw))


def export_frame_step(model, cfg, num_classes: Optional[int] = None
                      ) -> "torch.export.ExportedProgram":
    """The frame step of `model` (weights baked in) as an exported
    program on the model's device."""
    device = next(model.parameters()).device
    with torch.no_grad():
        return torch.export.export(
            _FrameStep(model).eval(),
            example_inputs(cfg, num_classes, device))


def save_frame_step(path: str, model, cfg, **kw) -> str:
    """Export the frame step and write it to `path` (.pt2)."""
    program = export_frame_step(model, cfg, **kw)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def load_frame_step(path: str):
    """Load an exported frame step; returns a callable (image, zs_weight,
    mem_features, mem_obs, proj_indices, outlier_mask) -> (boxes, scores,
    classes, valid, mem_features', mem_obs'). Switches TF32 off for the
    process, as `models.detector.build_detector` does."""
    from .. import ops  # noqa: F401  registers the kernels' custom ops
    # the frame's f32 sites must run in f32, as `build_detector` sets
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    module = torch.export.load(path).module()

    def step(*args):
        with torch.no_grad():
            return module(*args)
    return step
