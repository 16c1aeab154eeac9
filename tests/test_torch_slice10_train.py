"""Slice 10's train step against the JAX package, on the CPU:
`detr_train_step_host_matched`, single-stage and two-stage with box
refine.

JAX's function runs op by op (it matches on the host between the forward
and the backward), so it is held at the miniature `DeformableDETR` of
tests/test_torch_slice10.py behind a small wrapper on each side that gives
it what the function reads: `num_queries`, `cfg.roi.num_classes` and
`apply(params, image, zs)` (here the image is the feature levels).
Sampling-offset and attention-weight kernels are drawn from a seeded
normal (the JAX init zeroes them).
"""

from types import SimpleNamespace
from typing import Any

import numpy as np
import pytest
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from embodied_object_detection_tpu.models import deformable_detr as jd
from embodied_object_detection_tpu.structures import GroundTruth as JaxGT

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.models import deformable_detr as td
from embodied_object_detection_tpu_torch.structures import GroundTruth

from test_torch_slice10 import (FEAT_SHAPES, MINI, _close, _feats, _jax_tree,
                                _t, spread)


class JaxMiniDetector(fnn.Module):
    """The miniature DeformableDETR as `detr`, with the fields the JAX
    train step reads."""
    cfg: Any
    num_queries: int = 12
    with_box_refine: bool = False
    two_stage: bool = False

    @fnn.compact
    def __call__(self, feats, zs_weight=None):
        kw = dict(MINI, num_queries=self.num_queries)
        return jd.DeformableDETR(points=2, with_box_refine=self.with_box_refine,
                                 two_stage=self.two_stage, name="detr",
                                 **kw)(feats, zs_weight)


class PortMiniDetector(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.cfg = cfg
        self.detr = td.DeformableDETR(in_channels=(32,) * 4, points=2,
                                      **dict(MINI, **kw))

    def forward(self, feats, zs_weight=None):
        return self.detr(feats, zs_weight)


@pytest.mark.parametrize("variant", [
    {}, dict(with_box_refine=True, two_stage=True)],
    ids=["single_stage", "two_stage_refine"])
def test_train_step_matches_jax(variant):
    """detr_train_step_host_matched against JAX's own function on the same
    weights, features and GT (3 valid boxes of 4): the total, every aux
    loss (`{loss}_l{layer}`, two-stage `{loss}_enc`) within rtol 1e-5, and
    every parameter's gradient within rtol 1e-4 of its largest element
    plus 1e-6 of the largest gradient element of the step (through the
    converter's key map). The absolute term bounds the rounding noise of
    gradients that are 0 in exact arithmetic: the input projections'
    biases before a GroupNorm of one channel a group, and the
    self-attention keys' bias, which shifts a query's logits alike."""
    rng = np.random.RandomState(21)
    cfg = SimpleNamespace(roi=SimpleNamespace(num_classes=MINI["num_classes"]))
    feats = _feats(rng, FEAT_SHAPES)
    jm = JaxMiniDetector(cfg, **variant)
    params = jm.init(jax.random.PRNGKey(3), [jnp.asarray(f) for f in feats])
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.5)
    boxes = np.array([[10, 12, 60, 70], [80, 20, 150, 90],
                      [30, 60, 110, 125], [0, 0, 0, 0]], np.float32)
    classes = np.array([1, 3, 0, 0], np.int32)
    valid = np.array([True, True, True, False])
    hw = (128, 160)
    (j_total, j_aux), j_grads = jd.detr_train_step_host_matched(
        jm, _jax_tree(tree), [jnp.asarray(f) for f in feats],
        JaxGT(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)),
        hw)

    port = PortMiniDetector(cfg, **variant)
    port.load_state_dict(load_jax_params(tree), strict=True)
    (total, aux), grads = td.detr_train_step_host_matched(
        port, [_t(f) for f in feats],
        GroundTruth(_t(boxes), _t(classes), _t(valid)), hw)
    assert sorted(aux) == sorted(j_aux)
    if variant:
        assert any(k.endswith("_enc") for k in aux)
    _close(total, j_total, 1e-5)
    for k in j_aux:
        _close(aux[k], j_aux[k], 1e-5, atol=1e-5)
    want = load_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    assert set(grads) == set(want)
    noise = 1e-6 * max(float(w.abs().max()) for w in want.values())
    for k in grads:
        _close(grads[k], want[k], 1e-4, atol=noise)
    assert float(grads["detr.encoder0.self_attn.sampling_offsets.weight"]
                 .abs().sum()) > 0
