"""The CenterNet head on one canvas against the head level by level, on
the CPU (the plain versions of kernels 10, 10b and 10c,
`ops/centernet.py`).

- the canvas layout keeps one zero row or column between levels and
  wastes at most 15 % of a 480 x 640 frame's positions;
- the packed head equals the per-level head within f32 rounding, at a
  frame's five level shapes, at the 64 x 96 miniature's, and at Res5's one
  1024-channel level; every pad position is exactly 0 after every layer;
- the one-sort decode equals the per-level decode (five stable sorts) bit
  for bit, at the test and the training settings, with `not_nms`, with
  every score tied, and on a canvas with the scales applied inside;
- the packed path runs where autograd records nothing and never while it
  records, and `frame_train`'s losses and gradients are those of the
  per-level decode.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from centernet_reference import (FULL_LEVELS, MINI_LEVELS, decode_per_level,
                                 head_outputs)
from embodied_object_detection_tpu_torch.config import (CenterNetConfig,
                                                        DetectorConfig)
from embodied_object_detection_tpu_torch.models import centernet as tcn
from embodied_object_detection_tpu_torch.models import detector as tdet
from embodied_object_detection_tpu_torch.models.layers import conv, nchw, nhwc
from embodied_object_detection_tpu_torch.ops import centernet as ops
from embodied_object_detection_tpu_torch.structures import GroundTruth

CANVAS_OPS = ("centernet_pack", "group_norm_relu", "centernet_decode")


class _Calls(TorchDispatchMode):
    """Counts the calls of the canvas ops."""

    def __init__(self):
        super().__init__()
        self.n = dict.fromkeys(CANVAS_OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if func.namespace == "eodt" and name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def _head(channels: int, levels: int, dtype: torch.dtype,
          seed: int = 0) -> tcn.CenterNetHead:
    """A head with seeded weights, its GroupNorm affines and scales away
    from 1 and 0."""
    torch.manual_seed(seed)
    head = tcn.CenterNetHead(levels, channels, 4, dtype=dtype)
    with torch.no_grad():
        for name, p in head.named_parameters():
            if "tower_gn" in name and name.endswith("weight"):
                p.normal_(1.0, 0.2)
            elif "tower_gn" in name:
                p.normal_(0.0, 0.2)
            elif "scale" in name:
                p.uniform_(0.5, 1.5)
    return head


def _features(shapes, channels, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(h, w, channels, generator=g).to(dtype)
            for h, w in shapes]


def _pads(layout) -> torch.Tensor:
    pad = torch.ones((layout.height, layout.width), dtype=torch.bool)
    for (y0, x0), (h, w) in zip(layout.origins, layout.shapes):
        pad[y0:y0 + h, x0:x0 + w] = False
    return pad


@pytest.mark.parametrize("shapes", [
    FULL_LEVELS, MINI_LEVELS, ((30, 40),),
    ((100, 136), (50, 68), (25, 34), (13, 17), (7, 9)),
    ((5, 5), (9, 3), (2, 11))])
def test_canvas_layout_separates_levels(shapes):
    lay = ops.canvas_layout(shapes)
    assert lay.shapes == shapes and len(lay.origins) == len(shapes)
    owner = np.full((lay.height, lay.width), -1)
    for lvl, ((y0, x0), (h, w)) in enumerate(zip(lay.origins, shapes)):
        assert y0 >= 0 and x0 >= 0 and y0 + h <= lay.height and \
            x0 + w <= lay.width
        assert (owner[y0:y0 + h, x0:x0 + w] == -1).all()
        owner[y0:y0 + h, x0:x0 + w] = lvl
    for lvl, ((y0, x0), (h, w)) in enumerate(zip(lay.origins, shapes)):
        # a 3x3 window at the level's border reads no other level
        near = owner[max(y0 - 1, 0):y0 + h + 1, max(x0 - 1, 0):x0 + w + 1]
        assert set(np.unique(near)) <= {-1, lvl}
    # bands: runs of whole rows, each level inside one, a zero row between
    rows = [r for r0, r1 in lay.bands for r in range(r0, r1)]
    assert len(set(rows)) == len(rows) and lay.bands[0][0] == 0 and \
        lay.bands[-1][1] == lay.height
    for (r0, r1), (s0, _) in zip(lay.bands, lay.bands[1:]):
        assert s0 == r1 + 1 and (owner[r1] == -1).all()
    for (y0, _), (h, _) in zip(lay.origins, shapes):
        assert any(r0 <= y0 and y0 + h <= r1 for r0, r1 in lay.bands)
    if shapes == FULL_LEVELS:
        assert (lay.height, lay.width) == (91, 80)
        assert lay.bands == ((0, 60), (61, 91))
    if shapes[0] == FULL_LEVELS[0] or shapes[0] == (100, 136):
        used = sum(h * w for h, w in shapes)
        assert lay.height * lay.width <= 1.15 * used
    assert ops.canvas_layout(shapes) is lay          # cached by shape


@pytest.mark.parametrize("shapes,channels,dtype", [
    (FULL_LEVELS, 256, torch.bfloat16), (FULL_LEVELS, 256, torch.float32),
    (MINI_LEVELS, 256, torch.float32), (MINI_LEVELS, 64, torch.bfloat16),
    (((15, 20),), 1024, torch.bfloat16)],
    ids=["full-bf16", "full-f32", "mini-f32", "mini64-bf16", "res5-1024"])
def test_packed_head_matches_per_level(shapes, channels, dtype):
    """Within 1e-5 of the largest heatmap logit (regression) of any level:
    the canvas's convolutions (oneDNN blocks a canvas otherwise than a
    lone level, and the heads are one 5-channel convolution, not a 1- and
    a 4-channel one) sum their 9 C products in another order, an f32
    rounding of each sum (2^-24 of sum |w x| a term), carried through
    four layers; a small output is a near-cancellation of terms of the
    largest's size. The GroupNorm ops and the casts are the per-level
    path's own. The measured gap is under 2e-6 of it."""
    head = _head(channels, len(shapes), dtype)
    feats = _features(shapes, channels, dtype)
    want_hms, want_regs = head(feats)               # autograd records
    assert not head.packs(feats)
    with torch.no_grad():
        assert head.packs(feats)
        got_hms, got_regs = head(feats)
    for gots, wants in ((got_hms, want_hms), (got_regs, want_regs)):
        tol = 1e-5 * max(float(w.detach().abs().max()) for w in wants)
        for got, want in zip(gots, wants):
            assert got.shape == want.shape and got.dtype == torch.float32
            assert float((got - want.detach()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shapes", [FULL_LEVELS, MINI_LEVELS])
def test_pad_positions_zero_after_every_layer(shapes, dtype):
    head = _head(64, len(shapes), dtype)
    feats = _features(shapes, 64, dtype)
    layout = ops.canvas_layout(shapes)
    pad = _pads(layout)
    assert bool(pad.any())
    with torch.no_grad():
        x = ops.pack_levels(feats, layout, dtype)
        assert x.dtype == dtype and bool((x[pad] == 0).all())
        for i in range(4):
            ys = [nhwc(conv(nchw(x[r0:r1]),
                            getattr(head, f"bbox_tower_conv{i}"), dtype),
                       batched=False) for r0, r1 in layout.bands]
            # the convolution's bias lands on the pads
            assert any(bool((y[pad[r0:r1]] != 0).any())
                       for y, (r0, r1) in zip(ys, layout.bands))
            gn = getattr(head, f"bbox_tower_gn{i}")
            x = ops.group_norm_relu(ys, gn.weight, gn.bias, layout,
                                    out_f32=i == 3)
            assert x.dtype == (torch.float32 if i == 3 else dtype)
            assert bool((x[pad] == 0).all()), i
            assert bool((x[~pad] > 0).any())


@pytest.mark.parametrize("setting", ["test", "train", "not_nms", "tied"])
def test_decode_bit_equal_to_per_level(setting):
    cfg = CenterNetConfig(not_nms=setting == "not_nms")
    training = setting == "train"
    hms, regs = head_outputs(FULL_LEVELS, seed=5,
                             constant=setting == "tied")
    want = decode_per_level(hms, regs, cfg, training)
    got = tcn.decode_proposals(hms, regs, cfg, training)
    assert int(want.valid.sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("setting", ["test", "train"])
def test_decode_from_canvas_applies_scales(setting):
    """Regressions before the heads' Scale and ReLU on a canvas, scaled
    inside the decode: bit-equal to the per-level decode of the head's
    own scaled, rectified regressions."""
    cfg = CenterNetConfig()
    training = setting == "train"
    layout = ops.canvas_layout(FULL_LEVELS)
    rng = np.random.RandomState(7)
    raw = torch.from_numpy(rng.randn(layout.height, layout.width, 5)
                           .astype(np.float32) * 3)
    raw[..., 0] -= 3.0
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(np.float32))
    levels = layout.levels(raw)
    want = decode_per_level(
        [o[..., :1] for o in levels],
        [torch.relu(o[..., 1:] * scales[i:i + 1])
         for i, o in enumerate(levels)], cfg, training)
    got = tcn._decode([o[..., 0] for o in levels],
                      [o[..., 1:] for o in levels], scales, cfg, training)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("thresh", [1e-4, 0.0, 0.3])
def test_decode_plain_orders_levels_by_key(thresh):
    """A stable ascending sort of the int64 keys, at any threshold: level
    by level, each level's scores descending, ties in index order; the
    flags are the scores above the threshold."""
    hms, regs = head_outputs(MINI_LEVELS, seed=9)
    hms[1][:] = 0.0                                   # a level of ties
    hms[2][:] = -12.0                                 # a level all invalid
    key, rows = ops.centernet_decode(
        [h[..., 0] for h in hms], regs, None, (8, 16, 32, 64, 128), thresh)
    valid = rows[:, 5] > 0
    assert key.dtype == torch.int64
    _, order = torch.sort(key, stable=True)
    level = torch.cat([torch.full((h.numel(),), i)
                       for i, h in enumerate(hms)])
    assert torch.equal(level[order], level)
    start = 0
    for h in hms:
        n = h.numel()
        idx = order[start:start + n] - start
        s = torch.sigmoid(h.reshape(-1))
        ok = s > thresh
        want = torch.sort(s, descending=True, stable=True).indices
        assert torch.equal(idx, want)
        assert torch.equal(valid[start:start + n], ok)
        start += n


def test_packed_path_only_where_autograd_records_nothing():
    cfg = CenterNetConfig(pre_nms_topk_test=32, post_nms_topk_test=8)
    head = _head(64, 5, torch.float32)
    feats = _features(MINI_LEVELS, 64, torch.float32)
    with torch.no_grad(), _Calls() as calls:
        head.proposals(feats, cfg)
    assert calls.n == {"centernet_pack": 1, "group_norm_relu": 4,
                       "centernet_decode": 1}
    with _Calls() as calls:                         # autograd records
        head.proposals(feats, cfg)
        head(feats)
    assert calls.n == {"centernet_pack": 0, "group_norm_relu": 0,
                       "centernet_decode": 1}
    # grad mode on, but nothing requires grad: nothing is recorded
    head.requires_grad_(False)
    with _Calls() as calls:
        head(feats)
    assert calls.n["centernet_pack"] == 1
    head.requires_grad_(True)
    with _Calls() as calls:                         # a feature records
        head([feats[0].requires_grad_()] + feats[1:])
    assert calls.n["centernet_pack"] == 0
    feats[0].requires_grad_(False)

    def spans(grad: bool) -> int:
        with torch.set_grad_enabled(grad), \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            head.proposals(feats, cfg)
        return sum(e.name == "eodt.frame.proposals.packed"
                   for e in prof.events())
    assert spans(False) == 1 and spans(True) == 0


def _mini_detector_config() -> DetectorConfig:
    cfg = DetectorConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1),
                                     fpn_channels=64),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=4),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=32,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, num_classes=5, batch_size_per_image=8,
                                fc_dim=64, mask_channels=64),
        memory=dataclasses.replace(cfg.memory, max_cells=64))


def test_frame_train_losses_and_gradients_unchanged(monkeypatch):
    """`frame_train` runs the per-level head (autograd records it) and the
    one-sort decode: its losses and gradients equal those with the
    per-level decode, bit for bit; no canvas op runs but the decode."""
    cfg = _mini_detector_config()
    model = tdet.build_detector(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(11)
    zs = torch.from_numpy(rng.randn(cfg.roi.zs_weight_dim,
                                    cfg.roi.num_classes + 1)
                          .astype(np.float32))
    image = torch.from_numpy(rng.randint(0, 256, (64, 96, 3))
                             .astype(np.float32))
    memf = torch.from_numpy(rng.randn(64, cfg.memory.memory_dim)
                            .astype(np.float32))
    memo = torch.ones(64)
    proj = torch.from_numpy(rng.randint(0, 64, (64, 96)).astype(np.int32))
    gt = GroundTruth(
        boxes=torch.tensor([[8.0, 8.0, 40.0, 48.0], [50.0, 10.0, 90.0, 60.0],
                            [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]]),
        classes=torch.tensor([1, 3, 0, 0], dtype=torch.int32),
        valid=torch.tensor([True, True, False, False]))

    def run():
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(0)
        with _Calls() as calls:
            losses = model.frame_train(image, zs, memf, memo, proj, gt,
                                       generator=gen)
            sum(losses.values()).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return losses, grads, calls.n

    losses, grads, calls = run()
    assert calls == {"centernet_pack": 0, "group_norm_relu": 0,
                     "centernet_decode": 1}
    assert any("centernet.bbox_tower" in n for n in grads)
    monkeypatch.setattr(tdet, "decode_proposals", decode_per_level)
    want_losses, want_grads, calls = run()
    assert calls["centernet_decode"] == 0
    assert sorted(losses) == sorted(want_losses)
    for k in losses:
        assert torch.equal(losses[k], want_losses[k]), k
    assert sorted(grads) == sorted(want_grads)
    for n in grads:
        assert torch.equal(grads[n], want_grads[n]), n


class _Proposals(torch.nn.Module):
    def __init__(self, head, cfg):
        super().__init__()
        self.head, self.cfg = head, cfg

    def forward(self, *feats):
        with torch.no_grad():
            return tuple(self.head.proposals(feats, self.cfg))


def test_packed_proposals_trace_under_compile_and_export():
    """`torch.compile(fullgraph=True)` and `torch.export` trace the packed
    path through the canvas ops' fakes, and both run to the eager
    proposals."""
    cfg = CenterNetConfig(pre_nms_topk_test=32, post_nms_topk_test=8)
    module = _Proposals(_head(64, 5, torch.float32), cfg)
    feats = _features(MINI_LEVELS, 64, torch.float32)
    want = module(*feats)
    got = torch.compile(module, fullgraph=True, backend="eager")(*feats)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    program = torch.export.export(module, tuple(feats))
    ops_seen = {str(n.target) for m in program.graph_module.modules()
                if hasattr(m, "graph") for n in m.graph.nodes}
    assert {f"eodt.{op}.default" for op in CANVAS_OPS} <= ops_seen
    assert all(torch.equal(g, w)
               for g, w in zip(program.module()(*feats), want))
