"""Slice 19's public API against the JAX package on the CPU, and the
parity audit that keeps the port complete.

  * `COCOEvaluator.evaluate_split` (seen / unseen AP of the generalized
    zero-shot COCO protocol) and `reset`: dicts equal to JAX's, on
    tests/test_coco_eval.py's split case and a seeded 3-class case;
    `EvalCore.greedy_match` equal to JAX's binding of the same C function
  * `multilevel_roi_align(impl="v2" / "v3")` at tests/test_roi_align.py's
    impl shapes: f32 within 1e-5 of the largest feature (not bit-exact:
    XLA's CPU backend fuses multiply-adds into FMAs, among them the sample
    coordinates x1 + g * bin_w, rounding once where the port rounds the
    product and the sum, as kernel 4 does); v3 equal to v2 in every
    element, as JAX's are; bf16 within 9 roundings of 2^-9 of the sum of
    the taps' magnitudes (JAX's bf16 chain may keep excess precision) and
    so is kernel 4's form on the card (f32 sums rounded once); the v2
    gradient in the features against `jax.grad`; a v2 / v3 frame of the
    64x96 miniature against its v1 frame
  * `class_aware_nms`, `pad_boxes`, `Detections.capacity` / `num_valid`:
    exact; `get_deltas`: dx, dy exact, dw, dh within two ulps of the log
    times their weight (XLA's log is its own polynomial)
  * `EmbodiedPredictor.frame_step_detections` equal to `__call__`;
    `build_res5_detector` equal to `build_detector`'s Res5 branch
  * the audit: every public function, class and method of each JAX module
    has a counterpart of the same name in the port's module of the same
    path, or sits in `JAX_ONLY` with the port's counterpart and why; every
    argparse flag of the JAX package's CLIs is a flag of the port's; every
    config field is a port field or a key of `PINNED_OPTS`; the two
    `data/metadata/` directories hold the same files, byte for byte
"""

import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from embodied_object_detection_tpu import config as jcfg
from embodied_object_detection_tpu import structures as jstruct
from embodied_object_detection_tpu.evaluation import coco_eval as jeval
from embodied_object_detection_tpu.models import roi_heads as jrh
from embodied_object_detection_tpu.native import build as jnative
from embodied_object_detection_tpu.ops import nms as jnms
from embodied_object_detection_tpu.ops import roi_align as jroi

from embodied_object_detection_tpu_torch import config as tcfg
from embodied_object_detection_tpu_torch import structures as tstruct
from embodied_object_detection_tpu_torch.demo.predictor import (
    EmbodiedPredictor)
from embodied_object_detection_tpu_torch.evaluation import coco_eval as teval
from embodied_object_detection_tpu_torch.models import roi_heads as trh
from embodied_object_detection_tpu_torch.models.detector import build_detector
from embodied_object_detection_tpu_torch.models.res5_detector import (
    Res5Detector, build_res5_detector)
from embodied_object_detection_tpu_torch.native import build as tnative
from embodied_object_detection_tpu_torch.ops import class_aware_nms
from embodied_object_detection_tpu_torch.ops import roi_align as troi

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "embodied_object_detection_tpu"
PORT_PKG = REPO / "embodied_object_detection_tpu_torch"
T = torch.from_numpy


def _same_dict(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] or (math.isnan(got[k]) and
                                     math.isnan(want[k])), k


# ---------------------------------------------------------------- evaluator

def _box(x, y, w, h):
    return [x, y, x + w, y + h]


def _split_case(ev):
    """tests/test_coco_eval.py:107-121: perfect on class 0, nothing on 1."""
    ev.add_image(0)
    ev.add_ground_truth(0, np.array([_box(0, 0, 10, 10),
                                     _box(50, 50, 10, 10)], float),
                        np.array([0, 1]))
    ev.add_detections(0, np.array([_box(0, 0, 10, 10)], float),
                      np.array([0.9]), np.array([0]))


def _seeded_case(ev, seed):
    """12 images of 3 classes (ids 1, 5, 9): GT boxes, detections jittered
    from them with misses, duplicates and strays, tied scores."""
    rng = np.random.RandomState(seed)
    for img in range(12):
        ev.add_image(img)
        n = rng.randint(0, 6)
        xy = rng.uniform(0, 200, (n, 2))
        gt = np.concatenate([xy, xy + rng.uniform(8, 80, (n, 2))], 1)
        cls = rng.choice([1, 5, 9], n)
        ev.add_ground_truth(img, gt, cls)
        keep = rng.rand(n) < 0.8
        dets = gt[keep] + rng.randn(keep.sum(), 4) * 4
        dcls = cls[keep].copy()
        dcls[rng.rand(len(dcls)) < 0.15] = 5
        stray = rng.uniform(0, 200, (2, 2))
        dets = np.concatenate([dets, dets[:1], np.concatenate(
            [stray, stray + 30], 1)])
        dcls = np.concatenate([dcls, dcls[:1], rng.choice([1, 5, 9], 2)])
        scores = np.round(rng.rand(len(dets)) * 8) / 8
        ev.add_detections(img, dets, scores, dcls)


@pytest.mark.parametrize("case,cats,seen,img_ids", [
    ("split", [0, 1], [0], None),
    ("seeded", [1, 5, 9], [1, 9], None),
    ("seeded", [1, 5, 9], [5], [0, 2, 4, 6, 8, 10]),
    ("seeded", [1, 5, 9], [], None),
    ("seeded", [1, 5, 9, 11], [1, 5, 9], None)])
def test_evaluate_split_vs_jax(case, cats, seen, img_ids):
    evs = [jeval.COCOEvaluator(cats), teval.COCOEvaluator(cats)]
    for ev in evs:
        _split_case(ev) if case == "split" else _seeded_case(ev, 7)
    want, got = (ev.evaluate_split(seen, img_ids) for ev in evs)
    _same_dict(got, want)
    if case == "split":
        assert got["AP-seen"] == 100.0 and got["AP-unseen"] == 0.0
    else:
        assert {"AP-seen", "AP50-seen", "AP-unseen", "AP50-unseen"} <= \
            set(got)


def test_reset_vs_jax():
    """After `reset` an evaluator starts over: ids, images, detections and
    the last precisions go, as in JAX's (and a fresh evaluator)."""
    evs = [jeval.COCOEvaluator([1, 5, 9], first_ann_id=0,
                               federated=True),
           teval.COCOEvaluator([1, 5, 9], first_ann_id=0, federated=True)]
    for ev in evs:
        _seeded_case(ev, 8)
        ev.evaluate()
        ev.reset()
        assert ev._last_precisions is None and not ev._seen_ids
        _seeded_case(ev, 9)
    fresh = teval.COCOEvaluator([1, 5, 9], first_ann_id=0, federated=True)
    _seeded_case(fresh, 9)
    want = evs[0].evaluate_split([1])
    _same_dict(evs[1].evaluate_split([1]), want)
    _same_dict(fresh.evaluate_split([1]), want)


def test_greedy_match_vs_jax():
    got_core, want_core = tnative.load_eval_core(), jnative.load_eval_core()
    assert got_core is not None and want_core is not None, \
        "both eval cores build (g++)"
    rng = np.random.RandomState(5)
    for nd, ng in ((7, 5), (1, 0), (0, 3), (20, 20)):
        ious = rng.rand(nd, ng) * (rng.rand(nd, ng) < 0.6)
        g_ignore = np.sort(rng.rand(ng) < 0.3)     # non-ignored first
        thrs = np.linspace(0.5, 0.95, 10)
        got = got_core.greedy_match(ious, g_ignore, thrs)
        want = want_core.greedy_match(ious, g_ignore, thrs)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and (a == b).all()


# ----------------------------------------------------------------- ROIAlign

def _impl_inputs(seed=3):
    """tests/test_roi_align.py:134's features and boxes."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(60, 80, 16).astype(np.float32),
             rng.randn(30, 40, 16).astype(np.float32),
             rng.randn(15, 20, 16).astype(np.float32)]
    boxes = np.zeros((48, 4), np.float32)
    boxes[:, 0] = rng.uniform(-30, 620, 48)
    boxes[:, 1] = rng.uniform(-30, 460, 48)
    boxes[:, 2] = boxes[:, 0] + rng.uniform(1, 400, 48)
    boxes[:, 3] = boxes[:, 1] + rng.uniform(1, 400, 48)
    return feats, boxes


def _port(feats, boxes, out, impl, dtype=torch.float32):
    return troi.multilevel_roi_align(
        [torch.tensor(f, dtype=dtype) for f in feats], T(boxes),
        (8, 16, 32), out,
        impl=impl)


@pytest.mark.parametrize("out", [7, 14])
def test_roi_align_v2_v3_f32_vs_jax(out):
    feats, boxes = _impl_inputs()
    tol = 1e-5 * max(np.abs(f).max() for f in feats)
    v1 = _port(feats, boxes, out, "v1").numpy()
    got = {impl: _port(feats, boxes, out, impl).numpy()
           for impl in ("v2", "v3")}
    # the port's v3 is v2's code (same taps, same order), JAX's v3 equals
    # its v2 in every element
    assert (got["v3"] == got["v2"]).all()
    for impl in ("v2", "v3"):
        want = np.asarray(jroi.multilevel_roi_align(
            [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
            (8, 16, 32), out, impl=impl))
        assert got[impl].shape == want.shape == (48, out, out, 16)
        assert np.abs(got[impl] - want).max() <= tol, impl
    # the strided window sum x 1/4 against v1's mean: one rounding apart
    np.testing.assert_allclose(got["v2"], v1, rtol=2 ** -22,
                               atol=2 ** -22 * np.abs(v1).max())


@pytest.mark.parametrize("out", [7, 14])
def test_roi_align_v2_v3_bf16_vs_jax_and_kernel_form(out):
    """bf16: every weight, product and partial sum rounded to bf16 (unit
    roundoff u = 2^-9): at most 2 + 3 + 3 roundings of the window's taps
    and one of the result, so the CPU form lies within 9u x A of the exact
    value, A the window mean of sum |w f| (v1 of |features| in f32).
    JAX's chain and kernel 4's form on the card (f32 weights and sums of
    the bf16 features, rounded once) are held to the port's within 9u x
    A."""
    feats, boxes = _impl_inputs()
    bf = [np.asarray(jnp.asarray(f).astype(jnp.bfloat16)
                     .astype(jnp.float32)) for f in feats]
    bound = 9 * 2 ** -9 * _port([np.abs(f) for f in bf], boxes, out,
                                "v1").numpy()
    got = _port(feats, boxes, out, "v2", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    v3 = _port(feats, boxes, out, "v3", torch.bfloat16).float().numpy()
    assert (v3 == got).all()
    for impl in ("v2", "v3"):
        want = np.asarray(jroi.multilevel_roi_align(
            [jnp.asarray(f).astype(jnp.bfloat16) for f in feats],
            jnp.asarray(boxes), (8, 16, 32), out, impl=impl)
            .astype(jnp.float32))
        assert (np.abs(got - want) <= bound).all(), impl
    card_form = _port(bf, boxes, out, "v1").to(torch.bfloat16).float() \
        .numpy()
    assert (np.abs(got - card_form) <= bound).all()
    assert np.abs(got - card_form).max() > 0      # the forms do differ


def test_roi_align_v2_grad_vs_jax():
    """d sum(out^2) / d features of v2 in f32 against `jax.grad` (JAX's
    FMAs, and the scatter's summation order)."""
    feats, boxes = _impl_inputs()
    tf = [T(f).requires_grad_() for f in feats]
    out = troi.multilevel_roi_align(tf, T(boxes), (8, 16, 32), 7,
                                    impl="v2")
    (out ** 2).sum().backward()
    want = jax.grad(lambda fs: jnp.sum(jroi.multilevel_roi_align(
        fs, jnp.asarray(boxes), (8, 16, 32), 7, impl="v2") ** 2))(
        [jnp.asarray(f) for f in feats])
    for g, w in zip(tf, want):
        w = np.asarray(w)
        assert np.abs(g.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_roi_align_unknown_impl_raises():
    feats, boxes = _impl_inputs()
    with pytest.raises(ValueError, match="impl"):
        _port(feats, boxes, 7, "v5")


@pytest.fixture(scope="module")
def miniature():
    """The 64x96 f32 miniature of chip_smoke.py (phases 6, 18b), its
    seeded model, a random zs_weight and 3 frames."""
    cfg = chip_smoke.miniature(tcfg.DetectorConfig(), 1)
    model = build_detector(cfg, seed=19, device="cpu")
    rng = np.random.RandomState(19)
    zs = rng.randn(cfg.roi.zs_weight_dim,
                   cfg.roi.num_classes + 1).astype(np.float32)
    images = rng.randint(0, 255, (3, 64, 96, 3)).astype(np.float32)
    projs = rng.randint(0, cfg.memory.max_cells, (3, 64, 96)).astype(
        np.int32)
    return cfg, model, zs, images, projs


def test_v2_v3_frames_vs_v1(miniature, monkeypatch):
    """The miniature's frame with `roi.align_impl` v2 and v3 (the ROI
    heads read it at each pooling): v3's detections equal v2's; v2's match
    v1's (the same count, scores within 1e-5, boxes within 1e-3 px: the
    window sum and the mean are one rounding apart)."""
    cfg, model, zs, images, projs = miniature
    outs = {}
    for impl in ("v1", "v2", "v3"):
        monkeypatch.setattr(model.roi_heads, "cfg", dataclasses.replace(
            cfg.roi, align_impl=impl))
        outs[impl] = EmbodiedPredictor(cfg, model=model, zs_weight=zs,
                                       device="cpu")(images[0], projs[0])
    for a, b in zip(outs["v3"], outs["v2"]):
        assert torch.equal(a, b)
    v1, v2 = outs["v1"], outs["v2"]
    assert int(v1.valid.sum()) == int(v2.valid.sum()) > 0
    np.testing.assert_allclose(v2.scores.numpy(), v1.scores.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v2.boxes.numpy(), v1.boxes.numpy(),
                               atol=1e-3)


# ------------------------------------------------------ NMS, boxes, structs

def _candidates(seed, n, classes, ties):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))],
                           1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
        boxes[1::5] = boxes[0::5][: len(boxes[1::5])]
    cls = rng.randint(0, classes, n).astype(np.int32)
    return boxes, scores, cls, rng.rand(n) > 0.1


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,classes,thresh,topk", [
    (60, 4, 0.5, 40), (200, 20, 0.5, 100), (80, 1, 0.3, 100),
    (50, 6, 0.0, 30)])
def test_class_aware_nms_vs_jax(ties, n, classes, thresh, topk):
    boxes, scores, cls, valid = _candidates(n + classes, n, classes, ties)
    got = class_aware_nms(T(boxes), T(scores), T(cls), T(valid), thresh,
                          topk)
    want = jnms.class_aware_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(cls), jnp.asarray(valid),
                                thresh, topk)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
    assert got.classes.dtype == torch.int32


def test_get_deltas_vs_jax():
    rng = np.random.RandomState(6)
    xy = rng.uniform(-20, 600, (256, 2))
    src = np.concatenate([xy, xy + rng.uniform(0.5, 200, (256, 2))], 1)
    tgt = src + rng.randn(256, 4) * 6
    src[0, 2] = src[0, 0]                     # a zero-width source box
    src, tgt = src.astype(np.float32), tgt.astype(np.float32)
    for w in ((10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
              (30.0, 30.0, 15.0, 15.0)):
        got = trh.get_deltas(T(src), T(tgt), w).numpy()
        want = np.asarray(jrh.get_deltas(jnp.asarray(src), jnp.asarray(tgt),
                                         w))
        assert (got[:, :2] == want[:, :2]).all()
        assert np.abs(got[:, 2:] - want[:, 2:]).max() <= w[2] * 2 ** -22
        # apply_deltas inverts it where its size clamp does not bite
        ok = (got[:, 2:] / np.float32(w[2]) < math.log(1000 / 16)).all(1) \
            & (tgt[:, 2:] > tgt[:, :2]).all(1)
        back = trh.apply_deltas(T(got[ok]), T(src[ok]), w).numpy()
        np.testing.assert_allclose(back, tgt[ok], atol=2e-3)
        assert not ok[0] and ok.sum() > 200


@pytest.mark.parametrize("n,capacity", [(5, 8), (8, 8), (12, 8), (0, 4)])
def test_pad_boxes_and_detections_vs_jax(n, capacity):
    rng = np.random.RandomState(n)
    boxes = rng.uniform(0, 50, (n, 4))
    classes = rng.randint(0, 9, n)
    got = tstruct.pad_boxes(boxes, classes, capacity)
    want = jstruct.pad_boxes(boxes, classes, capacity)
    assert isinstance(got, tstruct.GroundTruth)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        assert (g == w).all()
    dets = tstruct.Detections(T(got.boxes), T(got.boxes[:, 0]),
                              T(got.classes), T(got.valid))
    jdets = jstruct.Detections(*(jnp.asarray(a) for a in (
        got.boxes, got.boxes[:, 0], got.classes, got.valid)))
    assert dets.capacity == jdets.capacity == capacity
    assert dets.num_valid().dtype == torch.int32
    assert int(dets.num_valid()) == int(jdets.num_valid()) == \
        min(n, capacity)
    stacked = tstruct.Detections(*(torch.stack([a, a]) for a in dets))
    assert stacked.capacity == capacity
    assert stacked.num_valid().tolist() == [min(n, capacity)] * 2


# ------------------------------------------------ predictor, Res5 builder

def test_frame_step_detections_equals_call(miniature):
    cfg, model, zs, images, projs = miniature
    a = EmbodiedPredictor(cfg, model=model, zs_weight=zs, device="cpu")
    b = EmbodiedPredictor(cfg, model=model, zs_weight=zs, device="cpu")
    outlier = np.zeros((64, 96), bool)
    outlier[:, :8] = True
    for t in range(3):
        mask = outlier if t == 1 else None
        want = a(images[t], projs[t], mask)
        got = b.frame_step_detections(images[t], projs[t], mask)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(a.memory.features, b.memory.features)
    assert float(b.memory.obs_count.sum()) > 0


def test_build_res5_detector():
    cfg = chip_smoke.miniature(tcfg.DetectorConfig(), 1)
    got = build_res5_detector(cfg, seed=4, device="cpu")
    want = build_detector(cfg.replace(roi=dataclasses.replace(
        cfg.roi, head_type="res5")), seed=4, device="cpu")
    assert isinstance(got, Res5Detector) and not got.training
    assert got.cfg.roi.head_type == "res5"
    gs, ws = got.state_dict(), want.state_dict()
    assert list(gs) == list(ws)
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k


# -------------------------------------------------------------------- audit

IDIOM = "flax builds submodules in setup; a torch module in __init__"
# JAX name -> (the port's counterpart, why the name differs). Idiom only.
JAX_ONLY = {
    "models/detector.py:EmbodiedDetector.setup":
        ("models/detector.py:EmbodiedDetector.__init__", IDIOM),
    "models/deformable_detr.py:DeformableDetrDetector.setup":
        ("models/deformable_detr.py:DeformableDetrDetector.__init__", IDIOM),
    "models/res5_detector.py:Res5Detector.setup":
        ("models/res5_detector.py:Res5Detector.__init__", IDIOM),
    "models/resnet.py:ResNet50.setup":
        ("models/resnet.py:ResNet50.__init__", IDIOM),
    "models/roi_heads.py:CascadeROIHeads.setup":
        ("models/roi_heads.py:CascadeROIHeads.__init__", IDIOM),
    "rl/monodepth.py:MonoDepthNet.setup":
        ("rl/monodepth.py:MonoDepthNet.__init__", IDIOM),
    "rl/policy.py:PointNavPolicy.setup":
        ("rl/policy.py:PointNavPolicy.__init__", IDIOM),
    "rl/resnet_policy.py:PointNavResNetPolicy.setup":
        ("rl/resnet_policy.py:PointNavResNetPolicy.__init__", IDIOM),
    "ops/pallas_scatter.py:scatter_sum_pallas":
        ("ops/segment_sum.py:segment_sum",
         "the Pallas TPU kernel; its CUDA port is kernel 1"),
    "parallel/train_step.py:jit_train_step":
        ("parallel/train_step.py:make_train_step",
         "jax.jit with shardings; the port's step runs eagerly, one "
         "process a card, gradients all-reduced in the step"),
    "rl/ppo.py:make_ppo":
        ("rl/ppo.py:PPO", "a pure (init, update) pair in JAX; a torch "
         "object holding the policy and Adam"),
    "rl/ppo.py:PPOState":
        ("rl/ppo.py:PPO", "the params / opt state tuple; PPO holds both"),
    "rl/policy.py:init_policy":
        ("rl/policy.py:make_policy", "flax init; a torch module makes its "
         "own parameters"),
    "rl/policy.py:PolicyOutputs":
        ("rl/policy.py:action_outputs", "an unused tuple subclass; the "
         "policy's act returns a plain tuple"),
}


def _module_names(path: Path, public: bool = True):
    """Module-level functions and classes (and their methods) defined in
    `path`, plus the names it imports or assigns at module level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
    if public:
        out = {n for n in out if not n.split(".")[-1].startswith("_")}
    return out


def _jax_public(path: Path):
    """Public functions, classes and methods the JAX module defines."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def _jax_modules():
    return sorted(p for p in JAX_PKG.rglob("*.py") if _jax_public(p))


@pytest.mark.parametrize("rel", [str(p.relative_to(JAX_PKG))
                                 for p in _jax_modules()])
def test_audit_public_names(rel):
    port = PORT_PKG / rel
    missing = sorted(n for n in _jax_public(JAX_PKG / rel)
                     if f"{rel}:{n}" not in JAX_ONLY and
                     (not port.exists() or n not in _module_names(port)))
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("key", sorted(JAX_ONLY))
def test_audit_jax_only_counterparts(key):
    """Each entry names a JAX definition that exists and a port
    counterpart that exists, and the port has no same-named definition
    (else the entry is stale)."""
    rel, name = key.split(":")
    assert name in _jax_public(JAX_PKG / rel)
    port_rel, port_name = JAX_ONLY[key][0].split(":")
    assert port_name in _module_names(PORT_PKG / port_rel, public=False)
    port = PORT_PKG / rel
    assert not port.exists() or name not in _module_names(port)


def _flags(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant) and
                    isinstance(a.value, str)}
    return out


def test_audit_cli_flags():
    clis = {str(p.relative_to(JAX_PKG)): _flags(p)
            for p in JAX_PKG.rglob("*.py") if _flags(p)}
    assert sorted(clis) == sorted([
        "run.py", "serve/server.py", "demo/demo.py", "demo/robot_demo.py",
        "rl/run.py", "data/build_data.py", "data/build_memory.py",
        "data/create_coco.py"])
    for rel, flags in clis.items():
        missing = flags - _flags(PORT_PKG / rel)
        assert not missing, f"{rel}: the port lacks {sorted(missing)}"


def _field_names(cls, prefix=""):
    out = set()
    for f in dataclasses.fields(cls):
        default = f.default_factory() if \
            f.default_factory is not dataclasses.MISSING else f.default
        if dataclasses.is_dataclass(default):
            out |= _field_names(type(default), f"{prefix}{f.name}.")
        else:
            out.add(prefix + f.name)
    return out


def test_audit_config_fields():
    from embodied_object_detection_tpu.rl import config as jrl
    from embodied_object_detection_tpu_torch.rl import config as trl
    missing = _field_names(jcfg.DetectorConfig) - \
        _field_names(tcfg.DetectorConfig) - set(tcfg.PINNED_OPTS)
    assert not missing, sorted(missing)
    for name in dir(jrl):
        cls = getattr(jrl, name)
        if isinstance(cls, type) and dataclasses.is_dataclass(cls):
            assert _field_names(cls) <= _field_names(getattr(trl, name)), \
                name


def test_audit_metadata_identical():
    jdir, pdir = JAX_PKG / "data" / "metadata", PORT_PKG / "data" / "metadata"
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    for name in names:
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name


def test_audit_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX, flax, optax,
    the JAX package or the repository's tools/."""
    banned = {"jax", "jaxlib", "flax", "optax", "embodied_object_detection_tpu",
              "tools"}
    for path in sorted(PORT_PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & banned, f"{path}: imports {roots & banned}"
