"""Config dataclasses read by the recurrent eval frame and the training
step.

The port's own copy of the JAX package's `config.py` fields that the eval
frame and the training step read (backbone, CenterNet, ROI heads, memory,
input, solver and the top-level `DetectorConfig`). Names and defaults are
the same, so a config built for one package can be rebuilt field by field
for the other. Mesh and other model settings come with the port of those
paths; `check_slice_config` raises on settings the port does not run and
on an unknown episode protocol.
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
    # rematerialise trunk + FPN in frame_train; not ported (raises)
    train_remat: bool = False


@dataclass(frozen=True)
class CenterNetConfig:
    """CenterNet proposal head, ONLY_PROPOSAL + WITH_AGN_HM mode."""
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    num_box_convs: int = 4
    prior_prob: float = 0.01
    score_thresh: float = 1e-4
    pre_nms_topk_train: int = 4000
    post_nms_topk_train: int = 2000
    pre_nms_topk_test: int = 1000
    post_nms_topk_test: int = 256
    nms_thresh_train: float = 0.9
    nms_thresh_test: float = 0.9
    # top-k cap on the joint cross-level NMS working set; 0 disables
    nms_candidate_cap: int = 1024
    not_nms: bool = False           # skip the proposal NMS, keep the top-k
    # losses (ONLY_PROPOSAL + WITH_AGN_HM, gIoU location loss)
    hm_min_overlap: float = 0.8
    min_radius: int = 4
    hm_focal_alpha: float = 0.25
    hm_focal_beta: float = 4.0
    loss_gamma: float = 2.0
    reg_weight: float = 1.0
    pos_weight: float = 0.5
    neg_weight: float = 0.5
    sigmoid_clamp: float = 1e-4
    ignore_high_fp: float = 0.85
    # MORE_POS assignment; not ported (raises)
    more_pos: bool = False
    sizes_of_interest: Tuple[Tuple[int, int], ...] = (
        (0, 80), (64, 160), (128, 320), (256, 640), (512, 10000000))


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
    # federated loss, zero-category masking and per-stage remat are not
    # ported (raise)
    use_fed_loss: bool = False
    ignore_zero_cats: bool = False
    train_stage_remat: bool = False
    mult_proposal_score: bool = True
    one_class_per_proposal: bool = False
    cascade_ious: Tuple[float, ...] = (0.6, 0.7, 0.8)
    cascade_bbox_reg_weights: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0))
    # training-time proposal sampling per image
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    mask_num_convs: int = 4
    mask_channels: int = 256
    score_thresh_test: float = 0.02
    nms_thresh_test: float = 0.5
    detections_per_image: int = 300


@dataclass(frozen=True)
class MemoryConfig:
    """Spatial feature memory read/write."""
    # "implicit_memory": the recurrent memory the frames write; the GT-memory
    # baselines "semantic_gt" / "map_gt" / "explicit_map": a fixed external
    # table, read through the same path and never reset or written
    memory_type: str = "implicit_memory"
    feat_fusion: str = "sum"
    map_feature_weight: float = 5.0
    cls_score_thresh: float = 0.3
    # "default"/"episodic": each frame reads the live memory; "longterm":
    # the read memory is snapshotted at episode starts only
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
    max_sequence_length: int = 20   # frames of an episode chunk
    max_gt_boxes: int = 64          # padded GT capacity per frame


@dataclass(frozen=True)
class SolverConfig:
    """Optimizer, LR schedule, clipping and freezing (the reference's
    custom_solver and mp3d SOLVER block)."""
    optimizer: str = "adamw"                    # adamw | sgd
    base_lr: float = 1e-5
    weight_decay: float = 1e-4
    momentum: float = 0.9                       # sgd only
    nesterov: bool = False                      # sgd only
    max_iter: int = 10000
    warmup_iters: int = 1000
    warmup_factor: float = 0.001
    lr_scheduler: str = "warmup_cosine"         # or warmup_multistep
    steps: Tuple[int, ...] = (60000, 80000)     # multistep milestones
    gamma: float = 0.1
    backbone_multiplier: float = 1.0
    custom_multiplier: float = 10.0
    custom_multiplier_name: Tuple[str, ...] = ("map_merge",)
    clip_gradients: bool = True
    # "value": elementwise clip; "full_model": global norm. <= 0 disables
    clip_type: str = "value"
    clip_value: float = 1.0
    ims_per_batch: int = 2
    checkpoint_period: int = 1000
    freeze_backbone: bool = False
    unfrozen_layers: Tuple[str, ...] = ("roi", "map_merge",
                                        "proposal_generator")


@dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    centernet: CenterNetConfig = field(default_factory=CenterNetConfig)
    roi: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    input: InputConfig = field(default_factory=InputConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    # backbone / head compute dtype; the fp32 sites stay fp32 regardless
    compute_dtype: str = "bfloat16"
    output_dir: str = "output"

    def replace(self, **kw) -> "DetectorConfig":
        return dataclasses.replace(self, **kw)


def check_slice_config(cfg: DetectorConfig) -> DetectorConfig:
    """Raise on settings this port does not implement yet, rather than
    silently running another path, and on a `memory.test_type` that is no
    protocol at all (a typo must not select another one)."""
    if cfg.memory.test_type not in ("default", "episodic", "longterm"):
        raise ValueError(
            f"memory.test_type={cfg.memory.test_type!r} is not one of "
            "'default'/'episodic'/'longterm' (ref: detic/config.py:74)")
    if cfg.roi.align_impl not in ("v1", "v4"):
        raise NotImplementedError(
            f"roi.align_impl={cfg.roi.align_impl!r}: the port has v1 and v4")
    for knob, value in (("centernet.more_pos", cfg.centernet.more_pos),
                        ("roi.use_fed_loss", cfg.roi.use_fed_loss),
                        ("roi.ignore_zero_cats", cfg.roi.ignore_zero_cats),
                        ("roi.train_stage_remat", cfg.roi.train_stage_remat),
                        ("backbone.train_remat", cfg.backbone.train_remat)):
        if value:
            raise NotImplementedError(
                f"{knob}=True: the torch port does not implement it yet")
    return cfg
