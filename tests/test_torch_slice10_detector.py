"""Slice 10's detector against the JAX package, on the CPU:
`DeformableDetrDetector` end to end, `detr_inference` on its output, and
the converter for the detector's tree.

The detector runs at 64x96 with ResNet depths (1, 1, 1, 1) in f32 and the
DETR at the JAX defaults, which the detector fixes (hidden 256, 8 heads,
6 + 6 layers, FFN 2048, 100 queries, 4 levels x 4 points): the
single-stage linear classifier with 20 classes, and the two-stage,
box-refine, zero-shot variant on the vendored mp3d classifier.
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

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.data.catalog import (
    METADATA_DIR)
from embodied_object_detection_tpu_torch.demo.predictor import (
    load_zs_weight_npy)
from embodied_object_detection_tpu_torch.models import deformable_detr as td

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
    port = td.build_deformable_detr(_port_config(cfg), seed=1, device="cpu",
                                    **kw)
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
