"""Config dataclasses read by the recurrent eval frame.

The port's own copy of the JAX package's `config.py` fields that the eval
frame reads (backbone, CenterNet, ROI heads, memory, input and the
top-level `DetectorConfig`). Names and defaults are the same, so a config
built for one package can be rebuilt field by field for the other.
Training, solver, mesh and other model settings come with the port of
those paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """ResNet-50 (timm `resnet50_in21k` layout) + FPN p3-p7."""
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    in_channels: Tuple[int, ...] = (512, 1024, 2048)
    fpn_channels: int = 256


@dataclass(frozen=True)
class CenterNetConfig:
    """CenterNet proposal head, ONLY_PROPOSAL + WITH_AGN_HM mode."""
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    num_box_convs: int = 4
    prior_prob: float = 0.01
    score_thresh: float = 1e-4
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 256
    nms_thresh_test: float = 0.9
    # top-k cap on the joint cross-level NMS working set; 0 disables
    nms_candidate_cap: int = 1024


@dataclass(frozen=True)
class ROIHeadsConfig:
    """3-stage cascade heads + zero-shot classifier + class-agnostic masks."""
    strides: Tuple[int, ...] = (8, 16, 32)
    num_classes: int = 20
    pooler_resolution: int = 7
    mask_pooler_resolution: int = 14
    sampling_ratio: int = 2
    # "v4": separable hat-weight matmuls; "v1": the bilinear tap form
    align_impl: str = "v4"
    canonical_box_size: int = 224
    canonical_level: int = 4
    fc_dim: int = 1024
    num_fc: int = 2
    zs_weight_dim: int = 512
    norm_temperature: float = 50.0
    use_sigmoid_ce: bool = True
    mult_proposal_score: bool = True
    one_class_per_proposal: bool = False
    cascade_ious: Tuple[float, ...] = (0.6, 0.7, 0.8)
    cascade_bbox_reg_weights: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0))
    mask_num_convs: int = 4
    mask_channels: int = 256
    score_thresh_test: float = 0.02
    nms_thresh_test: float = 0.5
    detections_per_image: int = 300


@dataclass(frozen=True)
class MemoryConfig:
    """Spatial feature memory read/write."""
    memory_type: str = "implicit_memory"
    feat_fusion: str = "sum"
    map_feature_weight: float = 5.0
    cls_score_thresh: float = 0.3
    test_type: str = "default"
    memory_dim: int = 512
    max_cells: int = 8192
    write_nms_thresh: float = 0.5
    write_topk: int = 100
    mask_thresh: float = 0.5
    pixel_subsample: int = 8
    # True: every `pixel_subsample`-th pixel of the row-major compacted
    # observed set (the reference selection); False: observed pixels on a
    # static stride grid
    exact_write_subsample: bool = True
    write_memory: bool = True

    def reads_memory(self) -> bool:
        return self.memory_type in ("implicit_memory", "semantic_gt",
                                    "map_gt", "explicit_map")

    def external_memory(self) -> bool:
        return self.memory_type in ("semantic_gt", "map_gt", "explicit_map")


@dataclass(frozen=True)
class InputConfig:
    """Fixed-shape RGB input (raw 480x640, pixel mean/std in RGB order)."""
    height: int = 480
    width: int = 640
    pixel_mean: Tuple[float, ...] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    centernet: CenterNetConfig = field(default_factory=CenterNetConfig)
    roi: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    input: InputConfig = field(default_factory=InputConfig)
    # backbone / head compute dtype; the fp32 sites stay fp32 regardless
    compute_dtype: str = "bfloat16"

    def replace(self, **kw) -> "DetectorConfig":
        return dataclasses.replace(self, **kw)


def check_slice_config(cfg: DetectorConfig) -> DetectorConfig:
    """Raise on settings this port does not implement yet, rather than
    silently running another path."""
    if cfg.memory.test_type != "default":
        raise NotImplementedError(
            f"memory.test_type={cfg.memory.test_type!r}: the torch port runs "
            "only 'default'")
    if cfg.memory.external_memory():
        raise NotImplementedError(
            f"memory.memory_type={cfg.memory.memory_type!r}: external GT "
            "memories are not ported yet")
    if cfg.roi.align_impl not in ("v1", "v4"):
        raise NotImplementedError(
            f"roi.align_impl={cfg.roi.align_impl!r}: the port has v1 and v4")
    return cfg
