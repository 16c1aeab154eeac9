"""The Deformable-DETR family on the port's normal path, on the CPU: built
by `build_detector` from a `DetectorConfig` that selects it
(`roi.head_type="detr"`, sized by `cfg.detr`), held to the plain reference
`detr_reference.py` on seeded weights at a small width with the published
structure (two-stage, box refinement, the zero-shot classifier, an FFN
width unlike the default, a test top-k), its batched `detect` against a
per-frame loop, its spans, and `evaluate_coco` / `run.py --coco-json
--eval-only` over a tiny COCO-format set."""

import dataclasses
import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

import detr_reference as ref
from embodied_object_detection_tpu_torch import run
from embodied_object_detection_tpu_torch.config import (
    DetectorConfig, DetrConfig, apply_opts)
from embodied_object_detection_tpu_torch.data.catalog import (
    CocoDetectionDataset, DatasetEntry)
from embodied_object_detection_tpu_torch.engine.coco import evaluate_coco
from embodied_object_detection_tpu_torch.models import deformable_detr as td
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector)

H, W = 64, 96
OPTS = ["roi.head_type=detr", "backbone.depths=(1, 1, 1, 1)",
        f"input.height={H}", f"input.width={W}", "detr.hidden_dim=32",
        "detr.heads=4", "detr.enc_layers=2", "detr.dec_layers=3",
        "detr.ffn_dim=48", "detr.num_queries=12", "detr.two_stage=true",
        "detr.with_box_refine=true", "detr.use_zeroshot=true",
        "detr.test_topk=20", "roi.num_classes=7", "roi.zs_weight_dim=16"]


def small_config(*extra):
    return apply_opts(DetectorConfig(), OPTS + list(extra))


def spread(model, seed, std=0.1):
    """The sampling-offset biases as Deformable-DETR lays them (each
    head's direction, points 1-4 cells out) and normal(std) kernels for
    the offsets and the attention weights, so that the samples leave
    their reference points and the attention is not uniform."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in ("sampling_offsets", "attention_weights"):
                continue
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) *
                             std)
            if leaf == "sampling_offsets":
                heads = model.detr.encoder0.self_attn.heads
                theta = torch.arange(heads) * (2 * math.pi / heads)
                grid = torch.stack([theta.cos(), theta.sin()], -1)
                grid = grid / grid.abs().max(-1, keepdim=True)[0]
                grid = grid[:, None, None] * torch.arange(1, 5).view(
                    1, 1, 4, 1)
                mod.bias.copy_(grid.expand(heads, 4, 4, 2).reshape(-1))
    return model


def zs_weight(dim, classes, seed):
    g = torch.Generator().manual_seed(seed)
    zs = torch.randn(dim, classes + 1, generator=g)
    zs[:, -1] = 0
    return zs / zs.norm(dim=0, keepdim=True).clamp(min=1e-12)


def spec_of(cfg):
    d = cfg.detr
    return ref.Spec(depths=cfg.backbone.depths, hidden=d.hidden_dim,
                    heads=d.heads, enc_layers=d.enc_layers,
                    dec_layers=d.dec_layers, num_queries=d.num_queries,
                    num_classes=cfg.roi.num_classes,
                    temperature=cfg.roi.norm_temperature, topk=d.test_topk)


@pytest.fixture(scope="module")
def fx():
    cfg = small_config()
    model = spread(build_detector(cfg, seed=3, device="cpu"), 4)
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.randint(0, 255, (3, H, W, 3)).astype(
        np.float32))
    zs = zs_weight(cfg.roi.zs_weight_dim, cfg.roi.num_classes, 6)
    return cfg, model, images, zs


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_config_section_defaults_are_the_constructors():
    """`DetrConfig()` holds today's defaults of `DeformableDETR`,
    `detr_inference` and the detector (single-stage, linear classifier,
    100 queries), so every earlier DETR caller builds what it did."""
    d = DetrConfig()
    sig = inspect.signature(td.DeformableDETR.__init__).parameters
    assert (d.hidden_dim, d.heads, d.enc_layers, d.dec_layers, d.ffn_dim,
            d.num_queries, d.use_zeroshot, d.with_box_refine,
            d.two_stage) == tuple(
        sig[k].default for k in ("hidden_dim", "heads", "enc_layers",
                                 "dec_layers", "ffn", "num_queries",
                                 "use_zeroshot", "with_box_refine",
                                 "two_stage"))
    assert d.test_topk == \
        inspect.signature(td.detr_inference).parameters["topk"].default
    assert DetectorConfig().detr == d
    cfg = DetectorConfig()
    cfg = cfg.replace(detr=dataclasses.replace(cfg.detr, num_queries=8))
    model = td.DeformableDetrDetector(cfg)
    assert model.cfg.detr == dataclasses.replace(d, num_queries=8)
    assert model.detr.num_queries == 8
    assert model.detr.encoder0.linear1.out_features == 2048
    attn = model.detr.encoder0.self_attn
    assert (attn.levels, attn.points) == (4, 4)


def test_build_detector_selects_the_family(fx):
    """`roi.head_type="detr"` builds the DETR, its widths from `cfg.detr`
    and the zero-shot classifier's from `cfg.roi`; the levels and the
    points a level are the model's constants, which no option sets."""
    cfg, model, _, _ = fx
    assert isinstance(model, td.DeformableDetrDetector)
    detr = model.detr
    assert detr.two_stage and detr.with_box_refine and detr.use_zeroshot
    assert detr.num_queries == 12 and detr.dec_layers == 3
    assert detr.encoder1.linear1.out_features == 48
    assert not hasattr(detr, "encoder2")
    assert detr.cls_embed0.out_features == 16
    # box refine with two-stage: a head a decoder layer and the encoder's
    assert hasattr(detr, "bbox_embed3_out") and detr.n_heads == 4
    assert (detr.decoder0.cross_attn.levels,
            detr.decoder0.cross_attn.points) == (4, 4)
    for opt in ("detr.levels=5", "detr.points=2"):
        with pytest.raises(AttributeError):
            small_config(opt)


def test_port_matches_the_plain_reference(fx):
    """Each frame's encoder logits, top-k seeds, every decoder layer's
    logits and boxes and the detections against the reference on the same
    weights. Tolerance: 1e-4 of each output's largest element (the CPU's
    convolutions sum in other orders, the port's deformable attention is
    a gather and the reference's grid_sample); the seeds and the
    detections' classes exactly."""
    cfg, model, images, zs = fx
    spec = spec_of(cfg)
    w = dict(model.state_dict())
    with torch.no_grad():
        dets = model.detect(images, zs)
        for k in range(images.shape[0]):
            got = model(images[k], zs)
            want = ref.forward(w, spec, images[k], zs)
            assert torch.equal(got.topk_idx, want["topk_idx"])
            assert _rel(got.enc_logits, want["enc_logits"]) <= 1e-4
            assert _rel(got.logits, want["logits"]) <= 1e-4
            assert _rel(got.boxes_cxcywh, want["boxes"]) <= 1e-4
            boxes, scores, classes, _ = ref.inference(
                want["logits"][-1], want["boxes"][-1], (H, W), spec.topk)
            assert torch.equal(dets.classes[k].long(), classes)
            assert _rel(dets.scores[k], scores) <= 1e-4
            assert _rel(dets.boxes[k], boxes) <= 1e-4


def test_held_decoder_follows_the_given_seeds(fx):
    """The reference's decoder runs from the seeds it is given (the held
    check's pass-through): the port's seeds give back the port's logits,
    and seeds given in reverse order give the same queries in reverse
    order (the decoder is equivariant to the queries' order), not the same
    array."""
    cfg, model, images, zs = fx
    spec = spec_of(cfg)
    w = dict(model.state_dict())
    with torch.no_grad():
        got = model(images[0], zs)
        held = ref.forward(w, spec, images[0], zs, seed_idx=got.topk_idx)
        other = ref.forward(w, spec, images[0], zs,
                            seed_idx=got.topk_idx.flip(0))
    assert _rel(got.logits[-1], held["logits"][-1]) <= 1e-4
    assert _rel(other["logits"][-1].flip(0), held["logits"][-1]) <= 1e-5
    assert not torch.allclose(other["logits"][-1], held["logits"][-1])


def test_batched_detect_equals_a_per_frame_loop(fx):
    """`detect` over a batch equals `detr_inference` of each frame's
    transformer on the batch's trunk outputs, bit for bit, and the
    one-image forward within 1e-5 (the CPU trunk's batched convolutions
    round otherwise)."""
    cfg, model, images, zs = fx
    with torch.no_grad():
        dets = model.detect(images, zs)
        feats = model.levels(images)
        for k in range(images.shape[0]):
            out = model.detr(tuple(f[k] for f in feats), zs)
            one = td.detr_inference(out.logits[-1], out.boxes_cxcywh[-1],
                                    (H, W), cfg.detr.test_topk)
            for a, b in zip(one, dets):
                assert torch.equal(a, b[k])
            alone = model(images[k], zs)
            assert _rel(alone.logits, out.logits) <= 1e-5
    assert dets.boxes.shape == (3, 20, 4) and bool(dets.valid.all())


def test_spans_cover_the_family(fx):
    """Under the profiler, `detect` runs inside the five `eodt.detr.*`
    spans: the trunk and the top-k once a batch, the encoder, the query
    seeding and the decoder once a frame."""
    _, model, images, zs = fx
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.detect(images[:2], zs)
    counts = {}
    for e in prof.events():
        if e.name.startswith("eodt.detr."):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"eodt.detr.trunk": 1, "eodt.detr.encoder": 2,
                      "eodt.detr.two_stage": 2, "eodt.detr.decoder": 2,
                      "eodt.detr.post": 1}


def _coco_set(root, n=3):
    from PIL import Image
    rng = np.random.RandomState(7)
    images, anns = [], []
    for i in range(n):
        h, w = (H, W) if i % 2 == 0 else (48, 80)
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
                        ).save(os.path.join(root, f"{i}.png"))
        images.append(dict(id=i + 1, file_name=f"{i}.png", height=h,
                           width=w))
        for _ in range(2):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.randint(7)),
                             bbox=[x, y, rng.uniform(8, w / 2),
                                   rng.uniform(8, h / 2)], iscrowd=0))
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=c, name=f"c{c}")
                                   for c in range(7)]), f)
    return path


def test_evaluate_coco_runs_the_family(fx, tmp_path):
    """`evaluate_coco` over a tiny COCO-format set (two batches, one
    short): a finite AP dict."""
    cfg, model, _, zs = fx
    path = _coco_set(str(tmp_path))
    ds = CocoDetectionDataset(DatasetEntry(path, str(tmp_path)), height=H,
                              width=W, max_gt=4, remap_ids=False)
    res = evaluate_coco(model, cfg, ds, zs.numpy(), batch=2, verbose=False,
                        num_workers=0)
    assert "AP" in res and all(np.isfinite(v) for v in res.values())


def test_cli_coco_eval_only_runs_the_family(tmp_path):
    """`run.py --coco-json --eval-only --opts roi.head_type=detr ...`
    builds and evaluates the family; without `--coco-json` it exits."""
    path = _coco_set(str(tmp_path))
    opts = [o for o in OPTS if not o.startswith("roi.zs_weight_dim")]
    res = run.main(["--device", "cpu", "--coco-json", path, "--eval-only",
                    "--image-root", str(tmp_path), "--zs-weight", "random",
                    "--output-dir", str(tmp_path / "out"), "--opts"] + opts)
    assert "AP" in res and all(np.isfinite(v) for v in res.values())
    with pytest.raises(SystemExit, match="--coco-json"):
        run.main(["--device", "cpu", "--eval-only", "--output-dir",
                  str(tmp_path / "out2"), "--opts"] + opts)
