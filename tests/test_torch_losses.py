"""The torch port's training losses and training-time proposal decode
against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages; each
comparison states its tolerance (f32 both sides: rtol 1e-5, exact where
the result is a selection). `sample_proposals` draws from a
`torch.Generator`, which cannot reproduce JAX's random stream, so its
invariants are tested instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.config import CenterNetConfig as JaxCN
from embodied_object_detection_tpu.models import centernet as jcn
from embodied_object_detection_tpu.models import losses as jl
from embodied_object_detection_tpu.models.detector import (
    grad_scale as jax_grad_scale)
from embodied_object_detection_tpu.structures import (
    Detections as JaxDetections, GroundTruth as JaxGT)

from embodied_object_detection_tpu_torch import config as port_config
from embodied_object_detection_tpu_torch.models import centernet as tcn
from embodied_object_detection_tpu_torch.models import losses as tl
from embodied_object_detection_tpu_torch.models.detector import grad_scale
from embodied_object_detection_tpu_torch.structures import (
    Detections, GroundTruth)

T = torch.from_numpy
CN = port_config.CenterNetConfig()
JCN = JaxCN()
SHAPES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]     # p3-p7 at 64 x 96


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=rtol, atol=atol)


def _gt(seed, g=4, valid=(True, True, True, False), h=64, w=96):
    rng = np.random.RandomState(seed)
    bw, bh = rng.uniform(8, 60, g), rng.uniform(8, 50, g)
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)
    classes = rng.randint(0, 5, g).astype(np.int32)
    v = np.array(valid[:g])
    boxes[~v] = 0.0
    return (GroundTruth(T(boxes), T(classes), T(v)),
            JaxGT(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(v)))


@pytest.mark.parametrize("valid", [(True, True, True, False),
                                   (False, False, False, False)])
def test_centernet_targets_vs_jax(valid):
    tgt, jgt = _gt(1, valid=valid)
    got = tl.centernet_targets(tgt, SHAPES, CN)
    want = jl.centernet_targets(jgt, SHAPES, JCN)
    _close(got.agn_heatmap, want.agn_heatmap)
    _close(got.reg_targets, want.reg_targets)
    assert np.array_equal(got.pos_count.numpy(), np.asarray(want.pos_count))
    if any(valid):
        assert int(got.pos_count.sum()) > 0
        assert float(got.agn_heatmap.max()) > 0.5


def _head_outputs(seed, m):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(m) * 3).astype(np.float32)
    reg = np.abs(rng.randn(m, 4) * 2).astype(np.float32)
    return logits, reg


def test_focal_and_giou_losses_vs_jax():
    tgt, jgt = _gt(2)
    m = sum(h * w for h, w in SHAPES)
    logits, reg = _head_outputs(3, m)
    t = tl.centernet_targets(tgt, SHAPES, CN)
    jt = jl.centernet_targets(jgt, SHAPES, JCN)
    pos, neg = tl.binary_heatmap_focal_loss(T(logits), t.agn_heatmap,
                                            t.pos_count, CN)
    jpos, jneg = jl.binary_heatmap_focal_loss(jnp.asarray(logits),
                                              jt.agn_heatmap, jt.pos_count,
                                              JCN)
    _close(pos, jpos)
    _close(neg, jneg)
    target = np.abs(np.random.RandomState(4).randn(m, 4)).astype(np.float32)
    _close(tl.giou_loss_ltrb(T(reg), T(target)),
           jl.giou_loss_ltrb(jnp.asarray(reg), jnp.asarray(target)))

    raw = tl.centernet_raw_losses(T(logits), T(reg), t, CN)
    jraw = jl.centernet_raw_losses(jnp.asarray(logits), jnp.asarray(reg), jt,
                                   JCN)
    for g, w in zip(raw, jraw):
        _close(g, w)
    num = torch.tensor(3.0)
    got = tl.centernet_normalize(raw, num, raw.reg_cnt)
    want = jl.centernet_normalize(jraw, jnp.float32(3.0), jraw.reg_cnt)
    got2 = tl.centernet_losses(T(logits), T(reg), t, CN, num)
    want2 = jl.centernet_losses(jnp.asarray(logits), jnp.asarray(reg), jt,
                                JCN, jnp.float32(3.0))
    assert set(got) == set(want) == set(got2) == set(want2)
    for k in want:
        _close(got[k], want[k])
        _close(got2[k], want2[k])


def _proposal_boxes(seed, r=40, h=64, w=96):
    rng = np.random.RandomState(seed)
    bw, bh = rng.uniform(4, 60, r), rng.uniform(4, 50, r)
    x0, y0 = rng.uniform(-8, w - bw / 2), rng.uniform(-8, h - bh / 2)
    return np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)


def test_match_and_add_gt_vs_jax():
    tgt, jgt = _gt(5)
    boxes = _proposal_boxes(6)
    boxes[:3] = np.asarray(jgt.boxes)[:3] + 0.5       # clear foreground
    valid = np.random.RandomState(7).rand(len(boxes)) > 0.2
    got = tl.match_proposals(T(boxes), T(valid), tgt, 0.6, 5)
    want = jl.match_proposals(jnp.asarray(boxes), jnp.asarray(valid), jgt,
                              0.6, 5)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int((got.gt_classes < 5).sum()) >= 3

    props = Detections(T(boxes), T(np.linspace(0.1, 0.9, len(boxes))
                                   .astype(np.float32)),
                       torch.zeros(len(boxes), dtype=torch.int32), T(valid))
    jprops = JaxDetections(*[jnp.asarray(x.numpy()) for x in props])
    for g, w in zip(tl.add_gt_to_proposals(props, tgt),
                    jl.add_gt_to_proposals(jprops, jgt)):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,batch,fg_rows", [(2020, 512, 300), (600, 512, 40),
                                             (100, 512, 10)])
def test_sample_proposals_invariants(n, batch, fg_rows):
    rng = np.random.RandomState(n)
    valid = T(rng.rand(n) > 0.1)
    fg = torch.zeros(n, dtype=torch.bool)
    fg[T(rng.choice(n, fg_rows, replace=False))] = True
    gen = torch.Generator().manual_seed(3)
    idx, keep = tl.sample_proposals(valid, fg, batch, 0.25, gen)
    assert idx.shape == keep.shape == (min(batch, n),)
    kept = idx[keep]
    assert bool(valid[kept].all()), "a sampled slot holds an invalid row"
    assert len(set(kept.tolist())) == len(kept)
    assert int(fg[kept].sum()) <= int(batch * 0.25)
    n_fg = int((fg & valid).sum())
    # positives up to the cap, background fills the rest
    assert int(fg[kept].sum()) == min(n_fg, int(batch * 0.25))
    assert int(keep.sum()) == min(int(valid.sum()), batch,
                                  min(n_fg, int(batch * 0.25)) +
                                  int((valid & ~fg).sum()))
    idx2, keep2 = tl.sample_proposals(valid, fg, batch, 0.25,
                                      torch.Generator().manual_seed(3))
    assert torch.equal(idx, idx2) and torch.equal(keep, keep2)
    idx3, _ = tl.sample_proposals(valid, fg, batch, 0.25,
                                  torch.Generator().manual_seed(4))
    if n > batch:
        assert not torch.equal(idx, idx3)


@pytest.mark.parametrize("sigmoid", [True, False])
def test_stage_losses_vs_jax(sigmoid):
    tgt, jgt = _gt(8)
    boxes = _proposal_boxes(9)
    boxes[:4] = np.asarray(jgt.boxes)[[0, 1, 2, 0]] + 0.7
    valid = np.random.RandomState(10).rand(len(boxes)) > 0.1
    m = tl.match_proposals(T(boxes), T(valid), tgt, 0.6, 5)
    jm = jl.match_proposals(jnp.asarray(boxes), jnp.asarray(valid), jgt, 0.6,
                            5)
    rng = np.random.RandomState(11)
    logits = (rng.randn(len(boxes), 6) * 4).astype(np.float32)
    deltas = (rng.randn(len(boxes), 4) * 0.3).astype(np.float32)
    w = (10.0, 10.0, 5.0, 5.0)
    got = tl.stage_losses(T(logits), T(deltas), m, w, 5,
                          use_sigmoid_ce=sigmoid)
    want = jl.stage_losses(jnp.asarray(logits), jnp.asarray(deltas), jm, w,
                           5, use_sigmoid_ce=sigmoid)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    assert float(got["loss_box_reg"]) > 0
    _close(tl.softmax_cross_entropy_loss(T(logits), m.gt_classes, m.valid, 5),
           jl.softmax_cross_entropy_loss(jnp.asarray(logits), jm.gt_classes,
                                         jm.valid, 5))


def test_grad_scale_vs_jax():
    x = np.random.RandomState(12).randn(50).astype(np.float32)
    t = T(x).requires_grad_(True)
    y = grad_scale(t, 1.0 / 3.0)
    jy, vjp = jax.vjp(lambda a: jax_grad_scale(a, 1.0 / 3.0), jnp.asarray(x))
    assert np.array_equal(y.detach().numpy(), np.asarray(jy))
    (y * T(x)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(x))[0]), rtol=1e-6)


@pytest.mark.parametrize("not_nms", [False, True])
def test_decode_proposals_training_vs_jax(not_nms):
    """The training settings (pre 4000 -> post 2000 at the defaults; here
    pre 64 -> post 40 over the miniature's 128 locations, so the
    candidate cap is inactive) and the not_nms branch: the same
    proposals (boxes, classes, valid exactly; scores within an ulp, since
    the two frameworks' sigmoids may differ in the last bit)."""
    rng = np.random.RandomState(13)
    hms = [(rng.randn(h, w, 1) * 2).astype(np.float32) for h, w in SHAPES]
    regs = [np.abs(rng.randn(h, w, 4)).astype(np.float32) for h, w in SHAPES]
    kw = dict(pre_nms_topk_train=64, post_nms_topk_train=40,
              nms_thresh_train=0.6, not_nms=not_nms)
    cfg = dataclasses.replace(CN, **kw)
    jcfg = dataclasses.replace(JCN, **kw)
    got = tcn.decode_proposals([T(x) for x in hms], [T(x) for x in regs], cfg,
                               training=True)
    want = jcn.decode_proposals([jnp.asarray(x) for x in hms],
                                [jnp.asarray(x) for x in regs], jcfg,
                                training=True)
    for name in ("boxes", "classes", "valid"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=2e-7, atol=0)
    assert int(got.valid.sum()) == 40 if not_nms else int(got.valid.sum()) > 10


@pytest.mark.parametrize("knob", ["centernet.more_pos", "roi.use_fed_loss",
                                  "roi.ignore_zero_cats",
                                  "roi.train_stage_remat",
                                  "backbone.train_remat"])
def test_unported_training_settings_raise(knob):
    """The five training knobs raised here until the port implemented
    them (slice 11); `check_slice_config` now accepts each, and their
    parity with the JAX package is held in tests/test_torch_slice11_train.py."""
    section, name = knob.split(".")
    cfg = port_config.DetectorConfig()
    cfg = cfg.replace(**{section: dataclasses.replace(
        getattr(cfg, section), **{name: True})})
    assert port_config.check_slice_config(cfg) is cfg
