"""Slice 10's detector against the JAX package, on the CPU:
`DeformableDetrDetector` end to end, `detr_inference` on its output, and
the converter for the detector's tree.

The detector runs at 64x96 with ResNet depths (1, 1, 1, 1) in f32 and the
DETR at the JAX defaults, which the detector fixes (hidden 256, 8 heads,
6 + 6 layers, FFN 2048, 100 queries, 4 levels x 4 points): the
single-stage linear classifier with 20 classes, and the two-stage,
box-refine, zero-shot variant on the vendored mp3d classifier. The
`detr-r50-frame` cell's structure (two-stage, box refinement, zero-shot,
an FFN, queries and a test top-k unlike the defaults) runs at a small
width, the port's detector built by `build_detector` from its `detr`
section and the JAX one from the same JAX modules at the same widths.
Sampling-offset and attention-weight kernels are drawn from a seeded
normal (the JAX init zeroes them).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.config import DetectorConfig as JaxConfig
from embodied_object_detection_tpu.models import deformable_detr as jd

from embodied_object_detection_tpu_torch.config import DetrConfig
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.data.catalog import (
    METADATA_DIR)
from embodied_object_detection_tpu_torch.demo.predictor import (
    load_zs_weight_npy)
from embodied_object_detection_tpu_torch.models import deformable_detr as td
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector)

from test_torch_frame import _port_config
from test_torch_slice10 import _close, _jax_tree, _t, spread

H, W = 64, 96
DETECTORS = {
    "single_stage": {},
    "two_stage_refine_zeroshot": dict(use_zeroshot=True,
                                      with_box_refine=True, two_stage=True),
}


def _jax_cfg():
    cfg = JaxConfig()
    return cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=H, width=W))


@pytest.fixture(scope="module", params=list(DETECTORS))
def detector(request):
    cfg = _jax_cfg()
    kw = DETECTORS[request.param]
    rng = np.random.RandomState(20)
    image = rng.randint(0, 255, (H, W, 3)).astype(np.float32)
    zs = load_zs_weight_npy(os.path.join(METADATA_DIR, "mp3d_clip.npy")) \
        if kw.get("use_zeroshot") else None
    jm = jd.DeformableDetrDetector(cfg, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(image),
                              None if zs is None else jnp.asarray(zs))
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.15)
    want = jax.jit(jm.apply)(_jax_tree(tree), jnp.asarray(image),
                             None if zs is None else jnp.asarray(zs))
    pcfg = _port_config(cfg)
    pcfg = pcfg.replace(detr=dataclasses.replace(pcfg.detr, **kw))
    port = td.build_deformable_detr(pcfg, seed=1, device="cpu")
    return dict(tree=tree, port=port, image=image, zs=zs, want=want)


def test_detector_matches_flax(detector):
    """DETROutputs at 64x96 from an image of pixels. Tolerance: rtol 1e-4
    of each output's largest element (the f32 trunk's convolutions sum in
    other orders, and six encoder layers carry it on)."""
    port = detector["port"]
    port.load_state_dict(load_jax_params(detector["tree"]))
    zs = detector["zs"]
    with torch.no_grad():
        got = port(_t(detector["image"]), None if zs is None else _t(zs))
    want = detector["want"]
    assert got.logits.shape == (6, 100, 20)
    for field, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), field
        if g is not None:
            _close(g, w, 1e-4)
    dets = td.detr_inference(got.logits[-1], got.boxes_cxcywh[-1], (H, W))
    jdets = jd.detr_inference(want.logits[-1], want.boxes_cxcywh[-1], (H, W))
    assert dets.boxes.shape == (100, 4)
    _close(dets.scores, jdets.scores, 1e-4)


def test_detector_converter_maps_every_leaf_once(detector):
    """The detector's JAX tree (FrozenBN statistics among its params, as
    in the embodied detector) becomes the port's state dict, parameters
    and FrozenBN buffers, one key a leaf, strictly."""
    tree = detector["tree"]
    port = detector["port"]
    sd = load_jax_params(tree)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    own = port.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    buffers = {n for n, _ in port.named_buffers()}
    assert buffers and all(".bn" in n or "downsample_bn" in n
                           for n in buffers)
    res = port.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys


class _WidthsDetector(jd.DeformableDetrDetector):
    """The JAX detector with its transformer's widths as fields (the JAX
    detector builds `DeformableDETR` at its defaults); the same modules
    and names, so the tree loads into the port's detector."""
    hidden_dim: int = 256
    heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn: int = 2048
    zs_dim: int = 512

    def setup(self):
        from flax import linen as fnn
        from embodied_object_detection_tpu.models.layers import GroupNorm
        from embodied_object_detection_tpu.models.resnet import ResNet50
        self.backbone = ResNet50(depths=self.cfg.backbone.depths,
                                 dtype=jnp.float32, name="backbone")
        self.detr = jd.DeformableDETR(
            num_classes=self.cfg.roi.num_classes, hidden_dim=self.hidden_dim,
            heads=self.heads, enc_layers=self.enc_layers,
            dec_layers=self.dec_layers, ffn=self.ffn,
            num_queries=self.num_queries, use_zeroshot=self.use_zeroshot,
            zs_dim=self.zs_dim, with_box_refine=self.with_box_refine,
            two_stage=self.two_stage, pre_projected=1, name="detr")
        self.extra_level = fnn.Conv(self.hidden_dim, (3, 3), strides=(2, 2),
                                    padding=1, dtype=jnp.float32,
                                    name="extra_level")
        self.extra_gn = GroupNorm(num_groups=32, name="extra_gn")


# the cell's structure at a small width: (port `detr` section, JAX fields)
CELL_DETR = DetrConfig(hidden_dim=32, heads=4, enc_layers=2, dec_layers=3,
                       ffn_dim=48, num_queries=12, two_stage=True,
                       with_box_refine=True, use_zeroshot=True, test_topk=20)
CELL_CLASSES, CELL_ZS_DIM = 7, 16


def test_cell_structure_matches_flax():
    """The cell's structure built by `build_detector` from the port's
    config (`roi.head_type="detr"`, the widths from its `detr` section)
    and by the JAX modules at the same widths, on the same weights
    through `load_jax_params`: DETROutputs of two frames, and the batched
    `detect`'s detections against the JAX `detr_inference` at the
    section's `test_topk`. Tolerance as `test_detector_matches_flax`'s:
    rtol 1e-4 of each output's largest element."""
    cfg = _jax_cfg()
    cfg = cfg.replace(roi=dataclasses.replace(
        cfg.roi, num_classes=CELL_CLASSES, zs_weight_dim=CELL_ZS_DIM))
    d = CELL_DETR
    rng = np.random.RandomState(21)
    images = rng.randint(0, 255, (2, H, W, 3)).astype(np.float32)
    zs = rng.randn(CELL_ZS_DIM, CELL_CLASSES + 1).astype(np.float32)
    zs /= np.linalg.norm(zs, axis=0, keepdims=True)
    jm = _WidthsDetector(cfg, num_queries=d.num_queries,
                         use_zeroshot=d.use_zeroshot,
                         with_box_refine=d.with_box_refine,
                         two_stage=d.two_stage, hidden_dim=d.hidden_dim,
                         heads=d.heads, enc_layers=d.enc_layers,
                         dec_layers=d.dec_layers, ffn=d.ffn_dim,
                         zs_dim=CELL_ZS_DIM)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(images[0]),
                              jnp.asarray(zs))
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.15)
    pcfg = _port_config(cfg).replace(detr=d)
    pcfg = pcfg.replace(roi=dataclasses.replace(pcfg.roi, head_type="detr"))
    port = build_detector(pcfg, seed=1, device="cpu")
    assert isinstance(port, td.DeformableDetrDetector)
    port.load_state_dict(load_jax_params(tree), strict=True)
    apply = jax.jit(jm.apply)
    with torch.no_grad():
        dets = port.detect(_t(images), _t(zs))
    assert dets.scores.shape == (2, d.test_topk)
    for k in range(2):
        want = apply(_jax_tree(tree), jnp.asarray(images[k]), jnp.asarray(zs))
        with torch.no_grad():
            got = port(_t(images[k]), _t(zs))
        assert got.logits.shape == (d.dec_layers, d.num_queries, CELL_CLASSES)
        for field, g, w in zip(want._fields, got, want):
            assert (g is None) == (w is None), field
            if g is not None:
                _close(g, w, 1e-4)
        jdets = jd.detr_inference(want.logits[-1], want.boxes_cxcywh[-1],
                                  (H, W), topk=d.test_topk)
        assert np.array_equal(dets.classes[k].numpy(),
                              np.asarray(jdets.classes))
        _close(dets.scores[k], jdets.scores, 1e-4)
        _close(dets.boxes[k], jdets.boxes, 1e-4)
