"""Config dataclasses read by the recurrent eval frame, the training
step, the evaluation engine and the CLI.

The port's own copy of the JAX package's `config.py` fields that these
paths read (backbone, CenterNet, ROI heads, memory, input, solver, the
process mesh and the top-level `DetectorConfig` with its data paths), with `validate_config`,
the `--opts` overrides (`apply_opts`) and the four golden presets
(`parity_config`). Names and defaults are the same, so a config built for
one package can be rebuilt field by field for the other. The JAX
package's fields that no path reads (its pinned knobs, `input.format` and
`memory.memory_feature_weight`, `backbone.in_strides` and
`backbone.in_channels`) are no fields here: `apply_opts` accepts each
only at its default (`PINNED_OPTS`).
`check_slice_config` raises on settings the port does not run and on an
unknown episode protocol.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """The trunk (ResNet-50 in timm's `resnet50_in21k` layout, or Swin-B)
    + FPN p3-p7."""
    # "resnet50", or "swin_b" (Swin-B at its published widths; `depths`
    # are the ResNet's)
    name: str = "resnet50"
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    fpn_channels: int = 256
    # swin_b only: stochastic depth, linearly decayed over the blocks to
    # this rate at the last; train mode only
    drop_path_rate: float = 0.2
    # recompute trunk + FPN in the backward of a training step
    # (torch.utils.checkpoint) instead of keeping their activations
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
    # MORE_POS assignment (ref: centernet.py:59-61, 748-878): extra
    # positive locations in each GT's center 3x3 whose regression loss is
    # small
    more_pos: bool = False
    more_pos_thresh: float = 0.2
    more_pos_topk: int = 9
    sizes_of_interest: Tuple[Tuple[int, int], ...] = (
        (0, 80), (64, 160), (128, 320), (256, 640), (512, 10000000))


@dataclass(frozen=True)
class ROIHeadsConfig:
    """3-stage cascade heads + zero-shot classifier + class-agnostic masks."""
    # "cascade"; "res5": the single-frame Res5 heads
    # (`models/res5_detector.py`)
    head_type: str = "cascade"
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
    # the federated loss (USE_FED_LOSS): each stage's BCE over the GT
    # classes present and fed_loss_num_cat classes in all, the rest drawn
    # by class frequency from cat_freq_path ("" = the vendored LVIS v1
    # table, whose length must equal num_classes)
    use_fed_loss: bool = False
    fed_loss_num_cat: int = 50
    cat_freq_path: str = ""
    # IGNORE_ZERO_CATS: no loss on classes of (near-)zero frequency
    ignore_zero_cats: bool = False
    # recompute each cascade stage's pool, box head and predictor in the
    # backward (torch.utils.checkpoint)
    train_stage_remat: bool = False
    mult_proposal_score: bool = True
    # WITH_SOFTMAX_PROP (detic_fast_rcnn.py:118-125): a per-proposal score
    # head a stage, which the wsddn / wsod image-label loss needs
    with_softmax_prop: bool = False
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
    # cells of the semmap snapshot below this normalised observation
    # intensity get class -1 (`ops/memory_ops.py:semmap_classes`)
    obs_score_thresh: float = 0.4
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
    # write each chunk's first-frame memory snapshot to
    # <output_dir>/memory/<sequence>.h5 during evaluation
    save_semmap: bool = False
    # class-id space of the memory h5's semmap_gt for map_gt: "smnet",
    # "lvis" or "auto" (the h5 attribute, else a max-id heuristic)
    semmap_dialect: str = "auto"
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
    score_every: int = 5            # evaluation scores every 5th frame
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
class ParallelConfig:
    """The process mesh (`parallel/mesh.py:make_mesh`): the world's ranks
    factored into data x model. `data_parallel` -1 puts every rank not on
    the model axis on the data axis."""
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    centernet: CenterNetConfig = field(default_factory=CenterNetConfig)
    roi: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    input: InputConfig = field(default_factory=InputConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # backbone / head compute dtype; the fp32 sites stay fp32 regardless
    compute_dtype: str = "bfloat16"
    # host-side data paths
    test_data_path: str = "embodied_data/mp3d_example/"
    train_data_path: str = "embodied_data/mp3d_example/"
    zeroshot_weight_path: str = "datasets/metadata/mp3d_clip.npy"
    semmap_path: str = ""
    output_dir: str = "output"

    def replace(self, **kw) -> "DetectorConfig":
        return dataclasses.replace(self, **kw)


def check_slice_config(cfg: DetectorConfig) -> DetectorConfig:
    """Raise on settings this port does not implement yet, rather than
    silently running another path, and on a `memory.test_type` that is no
    protocol at all (a typo must not select another one)."""
    validate_config(cfg)
    if cfg.roi.align_impl not in ("v1", "v4"):
        raise NotImplementedError(
            f"roi.align_impl={cfg.roi.align_impl!r}: the port has v1 and v4")
    return cfg


def validate_config(cfg: DetectorConfig) -> DetectorConfig:
    """Raise on an unknown episode protocol: a typo must not select
    another one. Called from `apply_opts` and `check_slice_config`."""
    if cfg.memory.test_type not in ("default", "episodic", "longterm"):
        raise ValueError(
            f"memory.test_type={cfg.memory.test_type!r} is not one of "
            "'default'/'episodic'/'longterm' (ref: detic/config.py:74)")
    return cfg


# The reference's knobs that the model hard-wires to one value. The port
# has no field for them: `--opts` may name one only with that value, and
# any other raises (a knob that silently does nothing is worse than an
# absent one). key: (the value, where it is hard-wired)
PINNED_OPTS: Dict[str, Tuple[Any, str]] = {
    "centernet.only_proposal": (
        True, "models/centernet.py builds the proposal-only head (no cls "
        "tower)"),
    "centernet.with_agn_hm": (
        True, "the agnostic heatmap IS the proposal scorer (centernet.py "
        "decode)"),
    "centernet.num_cls_convs": (0, "only_proposal mode has no cls tower"),
    "centernet.num_share_convs": (
        0, "the tower stack is bbox-only (centernet_head.py defaults)"),
    "centernet.not_norm_reg": (
        True, "models/losses.py giou_loss normalizes by num_pos only"),
    "centernet.loc_loss_type": (
        "giou", "models/losses.py implements the gIoU location loss"),
    "backbone.freeze_at": (
        0, "freezing is solver-level: solver.freeze_backbone/"
        "unfrozen_layers"),
    "backbone.in_strides": (
        (8, 16, 32), "the FPN reads the trunk's stride-8/16/32 stages; no "
        "path reads the field"),
    "backbone.in_channels": (
        (512, 1024, 2048), "the FPN laterals take the trunk's own channels "
        "(ResNet-50 or Swin-B); no path reads the field"),
    "roi.add_feature_to_prop": (
        True, "roi_heads always appends the pooled feature to proposals"),
    "roi.cls_agnostic_bbox_reg": (
        True, "predictors emit 4 deltas per box (class-agnostic)"),
    "roi.cls_agnostic_mask": (True, "mask head emits one mask per box"),
    "roi.mask_weight": (
        1.0, "the train path has no mask loss (zero on mp3d; detector.py "
        "frame_train docstring)"),
    "input.format": (
        "RGB", "the loaders decode RGB and pixel_mean/std are in RGB "
        "order"),
    "memory.memory_feature_weight": (
        100.0, "the reference stores it and never applies it"),
}


def _coerce(old: Any, raw: str) -> Any:
    """`raw` as the type of the field's current value `old`; tuples are
    parsed as Python literals (nested ones too) or split on commas."""
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        try:
            parsed = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            parsed = None
        if isinstance(parsed, (tuple, list)):
            def co(template, v):
                if isinstance(v, (tuple, list)):
                    t = template[0] if isinstance(template, tuple) \
                        and template else (v[0] if v else "")
                    return tuple(co(t, y) for y in v)
                t = template[0] if isinstance(template, tuple) \
                    and template else template
                return _coerce(t, str(v))
            elem = old[0] if old else ""
            return tuple(co(elem, x) for x in parsed)
        items = [x for x in raw.strip("()[] ").split(",") if x]
        elem = old[0] if old else ""
        return tuple(_coerce(elem, x.strip()) for x in items)
    return raw


def apply_opts(cfg: DetectorConfig, opts: Sequence[str]) -> DetectorConfig:
    """`--opts` overrides: apply_opts(cfg, ["memory.map_feature_weight=5",
    "roi.num_classes=20"]), then `validate_config`. A key of
    `PINNED_OPTS` is checked against its value and sets nothing."""
    updates: Dict[str, Dict[str, Any]] = {}
    for opt in opts:
        key, _, raw = opt.partition("=")
        key = key.strip()
        if key in PINNED_OPTS:
            required, where = PINNED_OPTS[key]
            value = _coerce(required, raw)
            if value != required:
                raise NotImplementedError(
                    f"config {key}={value!r} is not implemented (pinned to "
                    f"{required!r}: {where})")
            continue
        parts = key.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(
                cfg, **{parts[0]: _coerce(getattr(cfg, parts[0]), raw)})
            continue
        section, fieldname = parts[0], ".".join(parts[1:])
        old = getattr(getattr(cfg, section), fieldname)
        updates.setdefault(section, {})[fieldname] = _coerce(old, raw)
    for section, kv in updates.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
            getattr(cfg, section), **kv)})
    return validate_config(cfg)


def parity_config(name: str) -> DetectorConfig:
    """The four golden eval configurations. The three image-only presets
    differ only in their weights: they read no memory (the reference's FPN
    merge is gated on implicit_memory) but still write it, with the exact
    write subsample pinned."""
    base = DetectorConfig()
    if name in ("pretrained", "vanilla_training", "detic_finetuned"):
        return base.replace(memory=dataclasses.replace(
            base.memory, memory_type="image_only",
            exact_write_subsample=True))
    if name == "implicit_object_memory":
        return base.replace(memory=dataclasses.replace(
            base.memory, memory_type="implicit_memory", feat_fusion="sum",
            map_feature_weight=5.0, exact_write_subsample=True))
    raise ValueError(f"unknown parity config {name!r}")
