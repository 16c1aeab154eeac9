"""The port's detector and the plain reference, built from one
configuration file and one set of seeded weights."""

from __future__ import annotations

from typing import Tuple

import torch

from .common import torch_seed
from .weights import load, make_weights


def opts(config: dict) -> list:
    """The configuration file's overrides as `--opts` strings."""
    return [f"{k}={v}" for k, v in config["overrides"].items()]


def program_config(config: dict):
    from embodied_object_detection_tpu_torch.config import (DetectorConfig,
                                                            apply_opts)
    return apply_opts(DetectorConfig(), opts(config))


def reference_config(config: dict):
    """The reference's own config with the same overrides, and ROIAlign's
    tap form (the math kernel 4 computes on the card for every impl)."""
    from .reference.detic_plain.config import DetectorConfig, apply_opts
    return apply_opts(DetectorConfig(), opts(config) +
                      ["roi.align_impl=v1"])


def full_f32() -> None:
    """TF32 off for the process, as the port's `build_detector` sets it:
    the f32 sites of the model run in f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_program(cfg, seed: int, device: str = "cuda"
                  ) -> Tuple[torch.nn.Module, dict]:
    """The port's `EmbodiedDetector` on the card with weights drawn from
    `seed` there; returns (model in eval mode, the weights)."""
    from embodied_object_detection_tpu_torch.models.detector import (
        EmbodiedDetector)
    full_f32()
    with torch.device(device):
        model = EmbodiedDetector(cfg)
    weights = make_weights(model, seed, cfg.centernet.prior_prob)
    load(model, weights)
    return model.eval(), weights


def build_reference(cfg, weights: dict, device: str = "cuda"
                    ) -> torch.nn.Module:
    from .reference.detic_plain.models.detector import EmbodiedDetector
    full_f32()
    with torch.device(device):
        model = EmbodiedDetector(cfg)
    load(model, weights)
    return model.eval()


def make_zs(dim: int, classes: int, seed: int,
            device: str = "cuda") -> torch.Tensor:
    """A [dim, classes + 1] zero-shot classifier from `seed`: unit
    columns and a zero background column, as CLIP embeddings of a
    vocabulary are normalised."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 7))
    zs = torch.randn(dim, classes + 1, generator=gen, device=device)
    zs[:, -1] = 0.0
    zs[:, :-1] /= zs[:, :-1].norm(dim=0, keepdim=True)
    return zs
