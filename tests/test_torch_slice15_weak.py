"""Slice 15's model side against the JAX package, on the CPU: Detic's weak
and caption co-training, and the single-frame COCO evaluation.

One JAX model is built (module scope, one jit of its init) at the frame
tests' 64x96 miniature (ResNet depths (1, 1, 1, 1), f32, 5 classes,
image_only) with `roi.with_softmax_prop`, training top-k 64 -> 24, and
carried into the port with `load_jax_params`. The JAX side runs op by
op, but for one jit inside its `evaluate_coco`. Checked:

  * `frame_train_weak` in every image-label variant: each stage's loss
    within rtol 1e-5 (R = 25: 24 proposals and the whole-image box; and
    at ws_num_props 8, R = 9, for max_size); for max_size and wsddn the
    gradient of their sum in every parameter within 1e-4 of each
    tensor's largest (plus 1e-6 of the largest of any tensor, for
    gradients that are 0 in exact arithmetic) against `jax.grad`, wsddn's
    prop heads within 1e-3 (their gradient cancels, see below)
  * `image_box_embedding` (R = 1) within rtol 1e-5 and its gradient
    as above
  * `make_caption_train_step` (a caption-less image) and
    `make_captiontag_train_step` (a caption-less image and a padding row)
    totals and parts within rtol 1e-5
  * `evaluate_coco` over 4 images (480x640-like letterboxes at 64x96:
    no resize, a narrower and a shorter image) under the COCO protocol
    and, on a 1-based json with neg_category_ids and remapped ids, the
    LVIS-federated one: each image's detections matched as a set
    (test_torch_slice8_engine.py's `_match_detections`, scores rtol 1e-3
    atol 1e-4, boxes 1e-2), AP within 1e-6 of AP from JAX's detections
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.data import catalog as jcat
from embodied_object_detection_tpu.engine import coco as jcoco
from embodied_object_detection_tpu.evaluation import coco_eval as jeval
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector)
from embodied_object_detection_tpu.parallel import train_step as jstep

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.data import catalog as tcat
from embodied_object_detection_tpu_torch.engine import coco as tcoco
from embodied_object_detection_tpu_torch.models.detector import build_detector
from embodied_object_detection_tpu_torch.models.losses import (
    IMAGE_LABEL_VARIANTS)
from embodied_object_detection_tpu_torch.parallel import train_step as tstep
from embodied_object_detection_tpu_torch.structures import Detections

from test_torch_frame import _jax_config, _port_config
from test_torch_slice8_engine import _match_detections

T = torch.from_numpy
embed = tcoco.stand_in_caption_embedding


@pytest.fixture(scope="module")
def fx():
    cfg = _jax_config()
    cfg = cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=24),
        roi=dataclasses.replace(cfg.roi, with_softmax_prop=True),
        memory=dataclasses.replace(cfg.memory, memory_type="image_only"))
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((h, w, 3)),
        jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)),
        jnp.zeros((cells, d)), jnp.zeros((cells,)),
        jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), bool))
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert "prop_score2" in tree["params"]
    rng = np.random.RandomState(15)
    zs = rng.randn(cfg.roi.zs_weight_dim,
                   cfg.roi.num_classes + 1).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    images = rng.randint(0, 255, (3, h, w, 3)).astype(np.float32)
    labels = np.array([[1, 3, 0], [4, 0, 0], [2, 2, 1]], np.int32)
    lv = np.array([[True, True, False], [True, False, False],
                   [False, False, False]])
    # the single-frame path writes no memory (JAX's jit drops the write)
    pcfg = _port_config(cfg)
    port = build_detector(pcfg.replace(memory=dataclasses.replace(
        pcfg.memory, write_memory=False)), seed=1, device="cpu")
    port.load_state_dict(load_jax_params(tree))
    return dict(cfg=cfg, model=model, params=params, port=port, zs=zs,
                images=images, labels=labels, lv=lv)


def _jax_weak(fx, params, variant, frame=0, **kw):
    return fx["model"].apply(
        params, jnp.asarray(fx["images"][frame]), jnp.asarray(fx["zs"]),
        jnp.asarray(fx["labels"][frame]), jnp.asarray(fx["lv"][frame]),
        variant=variant, method=JaxDetector.frame_train_weak, **kw)


def _port_weak(fx, variant, frame=0, **kw):
    return fx["port"].frame_train_weak(
        T(fx["images"][frame]), T(fx["zs"]), T(fx["labels"][frame]),
        T(fx["lv"][frame]), variant=variant, **kw)


def _check_grads(port, grads, rel=1e-4, least=10, prop_rel=1e-4):
    """Each parameter's gradient within `rel` (the prop heads' within
    `prop_rel`) of the JAX tensor's largest magnitude, plus 1e-6 of the largest gradient of any tensor, the
    rounding floor of gradients that are 0 in exact arithmetic (the
    background column of the wsddn prop heads, whose logits are 0 on
    every proposal); at least `least` tensors with a nonzero gradient.
    The prop heads' fc2 bias takes no gradient in exact arithmetic (the
    softmax over proposals is shift-invariant): both packages give
    rounding noise there, so the port's is only held under 1e-3 of its
    head's fc2 weight gradient."""
    want = load_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    floor = 1e-6 * max(float(np.abs(v.numpy()).max()) for v in want.values())
    named = dict(port.named_parameters())
    nonzero = 0
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = np.abs(w).max()
        if name.startswith("prop_score") and name.endswith("fc2.bias"):
            if p.grad is not None:
                head = named[name.replace("bias", "weight")].grad
                assert np.abs(g).max() <= 1e-3 * float(head.abs().max())
            continue
        tol = prop_rel if name.startswith("prop_score") else rel
        assert np.abs(g - w).max() <= tol * scale + floor, (name, scale)
        nonzero += scale > floor
    assert nonzero >= least


@pytest.mark.parametrize("variant", IMAGE_LABEL_VARIANTS)
def test_frame_train_weak_vs_jax(fx, variant):
    for kw in ({}, {"ws_num_props": 8})[:2 if variant == "max_size" else 1]:
        want = _jax_weak(fx, fx["params"], variant, **kw)
        with torch.no_grad():
            got = _port_weak(fx, variant, **kw)
        assert sorted(got) == sorted(want) == \
            [f"image_loss_stage{s}" for s in range(3)]
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=f"{k} {kw}")
        assert all(float(v) > 0 for v in want.values())


@pytest.mark.parametrize("variant", ["max_size", "wsddn"])
def test_frame_train_weak_gradients_vs_jax(fx, variant):
    grads = jax.grad(lambda p: sum(_jax_weak(fx, p, variant).values()))(
        fx["params"])
    port = fx["port"]
    port.zero_grad(set_to_none=True)
    sum(_port_weak(fx, variant).values()).backward()
    # wsddn's gradient in the prop heads is a softmax-weighted sum of
    # sigmoid(logit) - image score over the proposals, which cancels:
    # the packages' ~1e-6 forward differences reach ~2e-4 of a tensor
    _check_grads(port, grads, prop_rel=1e-3)
    # the stage heads and the trunk take the gradient; the proposals none
    assert port.roi_heads.box_head2.fc1.weight.grad is not None
    assert all(p.grad is None for n, p in port.named_parameters()
               if n.startswith("centernet."))
    assert (port.prop_score0.fc1.weight.grad is not None) == \
        (variant == "wsddn")
    port.zero_grad(set_to_none=True)


def test_image_box_embedding_vs_jax(fx):
    img = fx["images"][1]

    def jax_emb(p):
        return fx["model"].apply(p, jnp.asarray(img),
                                 method=JaxDetector.image_box_embedding)

    want = np.asarray(jax_emb(fx["params"]))
    port = fx["port"]
    got = port.image_box_embedding(T(img))
    assert got.shape == (fx["cfg"].roi.zs_weight_dim,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    probe = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jax_emb(p) * probe))(fx["params"])
    port.zero_grad(set_to_none=True)
    (got * T(probe)).sum().backward()
    _check_grads(port, grads)
    port.zero_grad(set_to_none=True)


def _caption_inputs(fx):
    feats = embed(["a cat on a mat", "", "two dogs"])
    weight = np.array([1.0, 0.0, 1.0], np.float32)
    return feats, weight


def test_caption_train_step_vs_jax(fx):
    feats, weight = _caption_inputs(fx)
    jfn = jstep.make_caption_train_step(fx["model"], fx["cfg"])
    want, _ = jfn(fx["params"], jnp.asarray(fx["images"]),
                  jnp.asarray(feats), jnp.asarray(weight))
    tfn = tstep.make_caption_train_step(fx["port"], _port_config(fx["cfg"]))
    with torch.no_grad():
        got, aux = tfn(T(fx["images"]), T(feats), T(weight))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(aux["caption_loss"]) == float(got) and float(got) > 0


def test_captiontag_train_step_vs_jax(fx):
    """Frame 1 has no caption (weight 0) and still takes its tag loss;
    frame 2 is a padding row (frame_valid False) and takes neither."""
    feats, weight = _caption_inputs(fx)
    fv = np.array([True, True, False])
    args = (fx["images"], feats, weight, fx["labels"], fx["lv"], fx["zs"])
    jfn = jstep.make_captiontag_train_step(fx["model"], fx["cfg"])

    def jax_total(p):
        return jfn(p, *map(jnp.asarray, args), frame_valid=jnp.asarray(fv))

    want, want_aux = jax_total(fx["params"])
    tfn = tstep.make_captiontag_train_step(fx["port"],
                                           _port_config(fx["cfg"]))
    with torch.no_grad():
        got, aux = tfn(*map(T, args), frame_valid=T(fv))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in ("caption_loss", "tag_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5, err_msg=k)
        assert float(aux[k]) > 0


def test_image_label_step_and_loss_step(fx):
    """The image-label batch loss is the tag half of the captiontag step
    (frames with a valid label over B), and `make_loss_step` applies it:
    every trained parameter with a gradient moves."""
    port_cfg = _port_config(fx["cfg"])
    args = (T(fx["images"]), T(fx["labels"]), T(fx["lv"]), T(fx["zs"]))
    fn = tstep.make_image_label_train_step(fx["port"], port_cfg)
    with torch.no_grad():
        total, _ = fn(*args)
        per = [sum(_port_weak(fx, "max_size", frame=b).values())
               for b in range(2)]
    np.testing.assert_allclose(float(total), float(sum(per)) / 3, rtol=1e-6)
    model = build_detector(port_cfg, seed=3, device="cpu")
    model.load_state_dict(fx["port"].state_dict())
    loss_fn = tstep.make_image_label_train_step(model, port_cfg)
    init, step = tstep.make_loss_step(model, port_cfg,
                                      lambda step, *x: loss_fn(*x))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, losses = step(init(), *args)
    assert state.step == 1 and float(losses["total_loss"]) > 0
    graded = {n for n, p in model.named_parameters()
              if p.grad is not None and bool(p.grad.ne(0).any())}
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert graded and sorted(graded - moved) == []
    assert any(n.startswith("roi_heads.box_head0") for n in graded)


# ------------------------------------------------------- single-frame eval

def _coco_arrays(rng):
    """Four letterboxes of a 64x96 input: a full image, a narrower, a
    shorter and a smaller one (the 480x640 card sizes scaled by 0.15:
    no resize), 1-6 GT boxes each in 3 classes."""
    sizes = [(64, 96), (64, 75), (54, 96), (48, 96)]
    arrays, images, anns = {}, [], []
    aid = 1
    for i, (h, w) in enumerate(sizes):
        name = f"im{i}.png"
        arrays[name] = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        images.append(dict(id=i + 1, file_name=name, height=h, width=w,
                           neg_category_ids=[(i % 3) + 1]))
        for _ in range(1 + 5 * (i % 2)):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append(dict(id=aid, image_id=i + 1,
                             category_id=int(rng.randint(0, 3)),
                             bbox=[x, y, rng.uniform(8, w / 2),
                                   rng.uniform(8, h / 2)], iscrowd=0))
            aid += 1
    return arrays, images, anns


class _Recorder(jeval.COCOEvaluator):
    """JAX's evaluator, keeping each image's detections."""
    seen = {}

    def add_detections(self, image_id, boxes_xyxy, scores, classes):
        _Recorder.seen[image_id] = (np.asarray(boxes_xyxy),
                                    np.asarray(scores), np.asarray(classes))
        super().add_detections(image_id, boxes_xyxy, scores, classes)


def _as_detections(rec):
    boxes, scores, classes = rec
    return Detections(boxes, scores, classes, np.ones(len(scores), bool))


def test_evaluate_coco_vs_jax(fx, tmp_path, monkeypatch):
    """The COCO protocol over the raw-id json (ids 0-2, the model's
    columns), then the federated one over the same images in a 1-based
    json (ids 1-3 remapped, neg_category_ids): the port's detections
    against JAX's, JAX's AP from its own evaluate_coco (COCO) and from
    its detections fed to its federated evaluator (one JAX jit)."""
    arrays, images, anns = _coco_arrays(np.random.RandomState(4))
    raw = dict(images=images, annotations=anns,
               categories=[dict(id=c, name=f"c{c}") for c in range(3)])
    fed = dict(images=images,
               annotations=[dict(a, category_id=a["category_id"] + 1)
                            for a in anns],
               categories=[dict(id=c + 1, name=f"c{c}") for c in range(3)])
    for name, arr in arrays.items():
        from PIL import Image
        Image.fromarray(arr).save(tmp_path / name)
    js = {}
    for key, coco in (("raw", raw), ("fed", fed)):
        js[key] = str(tmp_path / f"{key}.json")
        with open(js[key], "w") as f:
            json.dump(coco, f)

    cfg = fx["cfg"]
    port_cfg = _port_config(cfg)
    _Recorder.seen = {}
    monkeypatch.setattr(jcoco, "COCOEvaluator", _Recorder)
    jds = jcat.CocoDetectionDataset(jcat.DatasetEntry(js["raw"],
                                                      str(tmp_path)),
                                    height=64, width=96, max_gt=8,
                                    remap_ids=False)
    want = jcoco.evaluate_coco(fx["model"], fx["params"], cfg, jds, fx["zs"],
                               batch=4, verbose=False)
    jax_dets = dict(_Recorder.seen)
    assert len(jax_dets) == 4 and sum(len(d[1]) for d in jax_dets.values())

    fed_ds = jcat.CocoDetectionDataset(jcat.DatasetEntry(js["fed"],
                                                         str(tmp_path)),
                                       height=64, width=96, max_gt=8,
                                       remap_ids=True)
    ev = jeval.COCOEvaluator(list(range(cfg.roi.num_classes)),
                             fed_ds.entry.thing_classes, max_dets=300,
                             federated=True)
    for i in range(len(fed_ds)):
        it = fed_ds[i]
        ev.add_image(it["image_id"], it.get("neg_category_ids", ()))
        gv = it["gt_valid"]
        ev.add_ground_truth(it["image_id"], it["gt_boxes"][gv] / it["scale"],
                            it["gt_classes"][gv])
        ev.add_detections(it["image_id"], *jax_dets[it["image_id"]])
    want_fed = ev.evaluate()

    port_dets = {}
    real = tcoco.COCOEvaluator

    class PortRecorder(real):
        def add_detections(self, image_id, boxes_xyxy, scores, classes):
            port_dets[image_id] = (boxes_xyxy, scores, classes)
            super().add_detections(image_id, boxes_xyxy, scores, classes)

    monkeypatch.setattr(tcoco, "COCOEvaluator", PortRecorder)
    for key, remap, federated, expect in (("raw", False, False, want),
                                          ("fed", True, True, want_fed)):
        port_dets.clear()
        ds = tcat.ArrayCocoDataset(tcat.DatasetEntry(js[key], ""), arrays,
                                   height=64, width=96, max_gt=8,
                                   remap_ids=remap)
        got = tcoco.evaluate_coco(fx["port"], port_cfg, ds, fx["zs"],
                                  batch=3, verbose=False,
                                  federated=federated)
        for img_id, rec in jax_dets.items():
            _match_detections(_as_detections(port_dets[img_id]),
                              _as_detections(rec), (1e-3, 1e-4), 1e-2)
        assert sorted(got) == sorted(expect)
        for k in expect:
            np.testing.assert_allclose(got[k], expect[k], rtol=0, atol=1e-6,
                                       err_msg=f"{key} {k}")
        assert all(np.isfinite(v) for v in got.values())
