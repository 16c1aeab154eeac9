"""Slice 16's Res5 single-frame detector against the JAX package, on the
CPU, at the frame tests' 64x96 miniature (ResNet depths (1, 1, 1, 1),
f32, 5 classes; training top-k 64 -> 16).

  * `build_detector` dispatches on `roi.head_type="res5"`; stage 4 is the
    trunk's own (`backbone.layer4_*`), with no `res5.*` parameter
  * `frame_step`: proposals, logits, `clip_feats` and the detections
    within 1e-5 of each output's largest, classes and validity equal
  * `frame_train`: every loss within rtol 1e-5 and the gradient of their
    sum in every parameter within 1e-4 of each tensor's largest (plus
    1e-6 of the largest of any tensor, for gradients that are 0 in exact
    arithmetic) against `jax.grad`; 16 proposals + 8 GT rows stay under
    batch_size_per_image, so no subsampling draw runs and JAX's key stays
    out of the comparison; the shared stage 4 takes a gradient through
    the ROI path. The subsampled, federated path runs finite, repeats
    from one generator seed and draws other samples from others.
  * `evaluate_coco` with the Res5 model over 4 images under the COCO
    protocol: each image's detections matched to JAX's and AP within
    1e-6 of JAX's `evaluate_coco`; `run.py --coco-json --eval-only` with
    `roi.head_type=res5`, and training with it exits as JAX's CLI does

The JAX model is never initialised: its tree comes from `jax.eval_shape`
filled with the port's seeded weights (`jax_params_from_port`); its
frame step, loss gradient and evaluation run jitted.
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
from embodied_object_detection_tpu.models.res5_detector import (
    Res5Detector as JaxRes5)
from embodied_object_detection_tpu.structures import GroundTruth as JaxGT

from embodied_object_detection_tpu_torch import run
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.data import catalog as tcat
from embodied_object_detection_tpu_torch.engine import coco as tcoco
from embodied_object_detection_tpu_torch.models.detector import build_detector
from embodied_object_detection_tpu_torch.models.res5_detector import (
    Res5Detector)
from embodied_object_detection_tpu_torch.structures import (Detections,
                                                            GroundTruth)

from test_torch_frame import _jax_config, _port_config
from test_torch_slice8_engine import MINI_OPTS, _coco_json, _match_detections
from test_torch_slice16_swin import _rel, jax_params_from_port

T = torch.from_numpy


def _res5_cfg():
    cfg = _jax_config()
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, head_type="res5"),
        memory=dataclasses.replace(cfg.memory, memory_type="image_only",
                                   write_memory=False))


@pytest.fixture(scope="module")
def fx():
    cfg = _res5_cfg()
    port = build_detector(_port_config(cfg), seed=11, device="cpu")
    model = JaxRes5(cfg)
    h, w = cfg.input.height, cfg.input.width
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((h, w, 3)),
        jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)))
    params = {"params": jax_params_from_port(shapes["params"],
                                             port.state_dict())}
    rng = np.random.RandomState(6)
    g = cfg.input.max_gt_boxes
    boxes = np.zeros((g, 4), np.float32)
    boxes[:3] = [[16, 16, 90, 60], [4, 30, 40, 62], [50, 2, 70, 20]]
    return dict(
        cfg=cfg, port=port, model=model, params=params,
        image=rng.randint(0, 255, (h, w, 3)).astype(np.float32),
        zs=rng.randn(cfg.roi.zs_weight_dim,
                     cfg.roi.num_classes + 1).astype(np.float32),
        gt=(boxes, np.array([2, 0, 4] + [0] * (g - 3), np.int32),
            np.arange(g) < 3))


def test_build_detector_dispatches_on_head_type(fx):
    port = fx["port"]
    assert isinstance(port, Res5Detector)
    names = set(port.state_dict())
    assert "backbone.layer4_0.conv1.weight" in names
    assert not any(n.startswith("res5") or ".res5." in n for n in names)
    assert names == set(load_jax_params(fx["params"]))
    assert port.box_predictor.bbox_fc1.weight.shape == (2048, 2048)
    assert port.centernet.bbox_tower_conv0.weight.shape[:2] == (1024, 1024)


def test_res5_frame_step_vs_jax(fx):
    want = jax.jit(lambda p, i, z: fx["model"].apply(
        p, i, z, method=JaxRes5.frame_step))(fx["params"], fx["image"],
                                             fx["zs"])
    got = fx["port"].frame_step(T(fx["image"]), T(fx["zs"]))
    r = fx["cfg"].centernet.post_nms_topk_test
    assert got.logits.shape == (r, fx["cfg"].roi.num_classes + 1)
    assert got.clip_feats.shape == (r, fx["cfg"].roi.zs_weight_dim)
    for name in ("logits", "clip_feats"):
        assert _rel(getattr(got, name).numpy(), getattr(want, name)) < 1e-5
    for dets in ("proposals", "detections"):
        g, w = getattr(got, dets), getattr(want, dets)
        for name in ("boxes", "scores"):
            assert _rel(getattr(g, name).numpy(), getattr(w, name)) < 1e-5
        for name in ("classes", "valid"):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)))
    assert int(got.detections.valid.sum()) > 0
    assert torch.isfinite(got.detections.scores).all()


def test_res5_frame_train_vs_jax(fx):
    cfg, port = fx["cfg"], fx["port"]

    def loss_fn(p):
        losses = fx["model"].apply(p, fx["image"], fx["zs"],
                                   JaxGT(*map(jnp.asarray, fx["gt"])),
                                   method=JaxRes5.frame_train)
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        fx["params"])
    port.zero_grad(set_to_none=True)
    got = port.frame_train(T(fx["image"]), T(fx["zs"]),
                           GroundTruth(*map(T, fx["gt"])))
    sum(got.values()).backward()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want_g = load_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    floor = 1e-6 * max(float(g.abs().max()) for g in want_g.values())
    for n, p in port.named_parameters():
        w = want_g[n]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + floor, n
    l4 = port.backbone.layer4_0.conv1.weight.grad
    assert float(l4.abs().sum()) > 0


def test_res5_frame_train_subsampled_federated(fx):
    """batch_size_per_image 8 < 24 rows: the sample is drawn; with the
    federated loss and ignore_zero_cats, one generator seed gives the same
    finite losses twice, and other seeds other samples."""
    cfg = _port_config(fx["cfg"])
    cfg = cfg.replace(roi=dataclasses.replace(
        cfg.roi, batch_size_per_image=8, use_fed_loss=True,
        fed_loss_num_cat=2, ignore_zero_cats=True))
    model = Res5Detector(cfg)
    model.load_state_dict(fx["port"].state_dict())
    freq = torch.tensor([1.0, 0.0, 2.0, 0.5, 3.0])

    def losses(seed):
        with torch.no_grad():
            out = model.frame_train(T(fx["image"]), T(fx["zs"]),
                                    GroundTruth(*map(T, fx["gt"])),
                                    torch.Generator().manual_seed(seed),
                                    fed_freq_weight=freq)
        return {k: float(v) for k, v in out.items()}

    a, b = losses(1), losses(1)
    assert a == b and all(np.isfinite(v) for v in a.values())
    others = [losses(s) for s in (2, 3, 4)]
    assert any(o != a for o in others)


def test_evaluate_coco_res5_vs_jax(fx, tmp_path, monkeypatch):
    """evaluate_coco with the Res5 model: JAX's batches its frame step in
    one jit; the port runs the trunk to C4 batched and each image's heads
    in turn."""
    from test_torch_slice15_weak import _Recorder, _as_detections, \
        _coco_arrays
    arrays, images, anns = _coco_arrays(np.random.RandomState(8))
    raw = dict(images=images, annotations=anns,
               categories=[dict(id=c, name=f"c{c}") for c in range(3)])
    js = str(tmp_path / "raw.json")
    with open(js, "w") as f:
        json.dump(raw, f)
    from PIL import Image
    for name, arr in arrays.items():
        Image.fromarray(arr).save(tmp_path / name)
    _Recorder.seen = {}
    monkeypatch.setattr(jcoco, "COCOEvaluator", _Recorder)
    jds = jcat.CocoDetectionDataset(jcat.DatasetEntry(js, str(tmp_path)),
                                    height=64, width=96, max_gt=8,
                                    remap_ids=False)
    want = jcoco.evaluate_coco(fx["model"], fx["params"], fx["cfg"], jds,
                               fx["zs"], batch=4, verbose=False)
    jax_dets = dict(_Recorder.seen)
    port_dets = {}
    real = tcoco.COCOEvaluator

    class PortRecorder(real):
        def add_detections(self, image_id, boxes_xyxy, scores, classes):
            port_dets[image_id] = (boxes_xyxy, scores, classes)
            super().add_detections(image_id, boxes_xyxy, scores, classes)

    monkeypatch.setattr(tcoco, "COCOEvaluator", PortRecorder)
    ds = tcat.ArrayCocoDataset(tcat.DatasetEntry(js, ""), arrays, height=64,
                               width=96, max_gt=8, remap_ids=False)
    got = tcoco.evaluate_coco(fx["port"], _port_config(fx["cfg"]), ds,
                              fx["zs"], batch=3, verbose=False)
    assert len(jax_dets) == 4 and sum(len(d[1]) for d in jax_dets.values())
    for img_id, rec in jax_dets.items():
        _match_detections(_as_detections(port_dets[img_id]),
                          _as_detections(rec), (1e-3, 1e-4), 1e-2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_cli_res5_coco_eval_only(tmp_path, capsys):
    """`run.py --coco-json --eval-only` with roi.head_type=res5 prints a
    finite AP; training it from the CLI exits, as JAX's CLI does."""
    path = _coco_json(str(tmp_path))
    argv = ["--device", "cpu", "--coco-json", path, "--image-root",
            str(tmp_path), "--zs-weight", "random", "--output-dir",
            str(tmp_path / "out")]
    opts = ["--opts"] + MINI_OPTS + ["roi.head_type=res5"]
    res = run.main(argv + ["--eval-only"] + opts)
    assert np.isfinite(res["AP"])
    assert "coco:" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="Res5"):
        run.main(argv + ["--max-iter", "1"] + opts)


def test_res5_detections_structure(fx):
    """Detections of the Res5 frame come in the cascade's structure and
    capacity, so the engine's `scored_detections` reads them alike."""
    out = fx["port"].frame_step(T(fx["image"]), T(fx["zs"]))
    assert isinstance(out.detections, Detections)
    assert out.detections.boxes.shape == (
        fx["cfg"].roi.detections_per_image, 4)
