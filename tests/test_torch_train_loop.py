"""The torch port's training loop, checkpoints and parameter precision, on
the CPU at the training oracle's miniature (64x96, ResNet depths
(1, 1, 1, 1), 5 classes, 64 cells).

  * `train` with a `batch_fn`: 2 steps, a checkpoint, a resume and 2 more
    steps give the same parameters, bit for bit, as 4 uninterrupted steps
    (the proposal sampler is active: 12 rows kept of 20, so the resumed
    run must also draw what the uninterrupted one drew)
  * `metrics.json` gets one JSON line per logging period; the
    finite-loss assert stops a run whose batch makes the loss NaN
  * parameters stay f32 in a bf16 config, and so do their gradients;
    outside autograd the bf16 copies are cached until a parameter changes
  * `chunks_to_train_batch` pads with zero-weight frames and carries the
    reference normaliser
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from embodied_object_detection_tpu_torch.config import DetectorConfig
from embodied_object_detection_tpu_torch.data.synthetic import (
    synthetic_batch_fn, synthetic_train_batch)
from embodied_object_detection_tpu_torch.engine import checkpoint
from embodied_object_detection_tpu_torch.engine.train import (
    ChunkRecord, chunks_to_train_batch, train)
from embodied_object_detection_tpu_torch.models.detector import build_detector
from embodied_object_detection_tpu_torch.models.layers import as_dtype
from embodied_object_detection_tpu_torch.parallel.train_step import (
    batch_to_device)
from embodied_object_detection_tpu_torch.structures import GroundTruth


def _config(out_dir, **solver) -> DetectorConfig:
    cfg = DetectorConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=4, max_sequence_length=2),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                num_classes=5, batch_size_per_image=12),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=4),
        solver=dataclasses.replace(cfg.solver, base_lr=1e-3,
                                   warmup_iters=2, max_iter=4,
                                   ims_per_batch=1, **solver),
        output_dir=str(out_dir))


ZS = np.random.RandomState(3).randn(512, 6).astype(np.float32)


def _run(cfg, max_iter, resume=False, batch_fn=None):
    model = build_detector(cfg, seed=0, device="cpu")
    state = train(model, cfg, None, ZS, max_iter=max_iter, resume=resume,
                  log_period=1, seed=5, verbose=False,
                  batch_fn=batch_fn or synthetic_batch_fn(cfg, 2, 1))
    return model, state


def test_resume_matches_an_uninterrupted_run(tmp_path):
    straight, s1 = _run(_config(tmp_path / "a", checkpoint_period=0), 4)
    cfg = _config(tmp_path / "b", checkpoint_period=2)
    _, s2 = _run(cfg, 2)
    # metrics.json is mirrored into TensorBoard events under tb/
    assert sorted(os.listdir(cfg.output_dir)) == ["ckpt_0000002",
                                                  "metrics.json", "tb"]
    resumed, s3 = _run(cfg, 4, resume=True)
    assert s1.step == s3.step == 4 and s2.step == 2
    assert s3.optimizer.count == 4
    for (name, a), (_, b) in zip(straight.named_parameters(),
                                 resumed.named_parameters()):
        assert torch.equal(a, b), name
    fresh = build_detector(cfg, seed=0, device="cpu")
    assert not torch.equal(fresh.fpn.map_merge_projection1.weight,
                           resumed.fpn.map_merge_projection1.weight)

    lines = [json.loads(x) for x in
             open(os.path.join(cfg.output_dir, "metrics.json"))]
    assert [x["iteration"] for x in lines] == [1, 2, 3, 4]
    for x in lines:
        assert {"total_loss", "loss_cls_stage2", "lr", "time",
                "data_time"} <= set(x)
        assert np.isfinite(x["total_loss"])
    assert lines[0]["lr"] < lines[2]["lr"]            # warming up
    assert checkpoint.latest_checkpoint(cfg.output_dir).endswith(
        "ckpt_0000004")


def test_finite_loss_assert_stops_a_nan_batch(tmp_path):
    cfg = _config(tmp_path)
    make = synthetic_batch_fn(cfg, 2, 1)

    def nan_batch(it, rng, dp):
        batch = make(it, rng, dp)
        batch.image[0, :8] = np.nan
        return batch

    with pytest.raises(AssertionError, match="total_loss"):
        _run(cfg, 1, batch_fn=nan_batch)


def test_bf16_compute_keeps_f32_parameters_and_gradients(tmp_path):
    cfg = _config(tmp_path).replace(compute_dtype="bfloat16")
    model = build_detector(cfg, seed=0, device="cpu")
    batch = batch_to_device(synthetic_train_batch(
        cfg, np.random.RandomState(1), 1), "cpu")
    gt = GroundTruth(batch.gt_boxes[0], batch.gt_classes[0],
                     batch.gt_valid[0])
    losses = model.frame_train(batch.image[0], torch.from_numpy(ZS),
                               batch.mem_features[0], batch.mem_obs[0],
                               batch.proj_indices[0], gt)
    sum(losses.values()).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert len(grads) > 60
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {g.dtype for g in grads} == {torch.float32}
    # the bf16 trunk's weight: cast at each use under autograd, cached
    # outside it until the parameter changes in place
    w = model.backbone.conv1.weight
    with torch.no_grad():
        a, b = as_dtype(w, torch.bfloat16), as_dtype(w, torch.bfloat16)
        assert a is b and a.dtype == torch.bfloat16
        w.add_(1.0)
        c = as_dtype(w, torch.bfloat16)
    assert c is not a and torch.equal(c, (w.detach()).to(torch.bfloat16))
    assert as_dtype(w, torch.bfloat16).requires_grad


def test_chunks_to_train_batch_pads_and_normalises():
    cfg = _config("unused")
    rng = np.random.RandomState(9)
    t, g, h, w = 3, 4, 64, 96

    def chunk(name, n_valid):
        valid = np.arange(t) < n_valid
        return ChunkRecord(
            sequence_name=name,
            images=rng.randint(0, 255, (t, h, w, 3)).astype(np.uint8),
            proj_indices=rng.randint(0, 64, (t, h, w)).astype(np.int32),
            frame_valid=valid,
            gt_boxes=rng.rand(t, g, 4).astype(np.float32),
            gt_classes=rng.randint(0, 5, (t, g)).astype(np.int32),
            gt_valid=rng.rand(t, g) > 0.5,
            memory_features=rng.randn(40, 512).astype(np.float32),
            observations=rng.rand(40).astype(np.float32))

    chunks = [chunk("a", 2), chunk("b", 3)]
    batch = chunks_to_train_batch(chunks, cfg, pad_to_total=6)
    assert batch.image.shape == (6, h, w, 3)
    assert batch.weight.tolist() == [1, 1, 1, 1, 1, 0]
    assert batch.loss_norm.tolist() == [4.0] * 6     # 2 chunks x 2 frames
    assert np.array_equal(batch.mem_features[0, :40],
                          chunks[0].memory_features)
    assert not batch.mem_features[0, 40:].any()
    assert not batch.image[5].any()
    with pytest.raises(ValueError, match="max_cells"):
        bad = chunks[0]._replace(proj_indices=chunks[0].proj_indices + 64)
        chunks_to_train_batch([bad], cfg)
