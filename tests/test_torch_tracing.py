"""The port's spans (`utils/tracing.py`) on the CPU: the shared no-op
context when nothing records, the profiler ranges of the frame's five
stages, of the lane runner's stream steps and of the optimizer step's
phases, and the eval loop's clock behind `EvalResults.timing`.

A miniature detector: a (1, 1, 1, 1) ResNet trunk, 64-wide FPN and heads,
64 x 96 frames, a 64-cell memory."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from embodied_object_detection_tpu_torch.config import DetectorConfig
from embodied_object_detection_tpu_torch.data.episode_dataset import (
    EpisodeChunk)
from embodied_object_detection_tpu_torch.engine import eval as teval
from embodied_object_detection_tpu_torch.models.detector import (
    FrameInputs, build_detector, make_batched_episode_runner)
from embodied_object_detection_tpu_torch.parallel.train_step import (
    TrainBatch, make_train_step)
from embodied_object_detection_tpu_torch.structures import MemoryState
from embodied_object_detection_tpu_torch.utils import tracing

H, W, CELLS, G = 64, 96, 64, 4
STAGES = ("fpn", "proposals", "cascade", "detect", "write")


def _config() -> DetectorConfig:
    cfg = DetectorConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1),
                                     fpn_channels=64),
        input=dataclasses.replace(cfg.input, height=H, width=W,
                                  max_sequence_length=2, score_every=1,
                                  max_gt_boxes=G),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=32,
                                      post_nms_topk_test=8,
                                      pre_nms_topk_train=32,
                                      post_nms_topk_train=8),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                num_classes=5, batch_size_per_image=8,
                                fc_dim=64, mask_channels=64),
        memory=dataclasses.replace(cfg.memory, max_cells=CELLS,
                                   write_topk=4, cls_score_thresh=0.05),
        solver=dataclasses.replace(cfg.solver, warmup_iters=0))


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return build_detector(_config(), seed=0, device="cpu")


def _zs(cfg) -> torch.Tensor:
    zs = torch.randn(cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1,
                     generator=torch.Generator().manual_seed(3))
    zs[:, -1] = 0.0
    return zs / zs.norm(dim=0, keepdim=True).clamp(min=1e-6)


def _images(n: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (n, H, W, 3)).astype(np.uint8)


def _cells(n: int, seed: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, CELLS, (n, H, W)).astype(np.int32)


def _ranges(prof):
    """{name: [(start, end)]} of the eodt. ranges the profiler recorded."""
    out = {}
    for e in prof.events():
        if e.name.startswith("eodt."):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_is_one_shared_object(monkeypatch):
    first = tracing.span("eodt.a")
    assert first is tracing.span("eodt.b") is tracing.OFF
    with first:
        pass
    with _cpu_profile():
        assert tracing.span("eodt.a") is not tracing.OFF
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert tracing.span("eodt.a") is tracing.OFF


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with tracing.span("eodt.frame"):
            return x * 2


@pytest.mark.parametrize("how", ["export", "compile"])
def test_traced_graph_holds_no_profiler_op(how):
    """Under an active profiler, torch.export and torch.compile trace the
    span as off: the graph holds no profiler op."""
    graphs = []

    def backend(gm, _):
        graphs.append(gm.graph)
        return gm.forward

    x = torch.ones(3)
    with _cpu_profile():
        if how == "export":
            graphs.append(torch.export.export(_Spanned(), (x,)).graph)
        else:
            out = torch.compile(_Spanned(), backend=backend,
                                fullgraph=True)(x)
            assert out.tolist() == [2.0, 2.0, 2.0]
    targets = [str(n.target) for g in graphs for n in g.nodes]
    assert graphs and not [t for t in targets if "profiler" in t]


def test_span_clock_adds_host_seconds():
    clock = {}
    for _ in range(2):
        with tracing.span("eodt.x", clock):
            pass
    with pytest.raises(KeyError):
        with tracing.span("eodt.y", clock):
            raise KeyError("the span passes errors on")
    assert sorted(clock) == ["eodt.x", "eodt.y"]
    assert all(v >= 0.0 for v in clock.values())


def test_frame_step_spans_its_five_stages(model):
    cfg = model.cfg
    image = torch.from_numpy(_images(1)[0]).float()
    proj = torch.from_numpy(_cells(1)[0])
    mem = MemoryState.zeros(CELLS, cfg.memory.memory_dim, "cpu")
    with _cpu_profile() as prof:
        model.frame_step(image, _zs(cfg), mem.features, mem.obs_count, proj,
                         torch.zeros((H, W), dtype=torch.bool))
    got = _ranges(prof)
    assert len(got["eodt.frame"]) == 1
    (lo, hi), = got["eodt.frame"]
    # the trunk runs inside the frame when no features are passed
    assert len(got["eodt.trunk"]) == 1
    for stage in STAGES:
        (s, e), = got[f"eodt.frame.{stage}"]
        assert lo <= s <= e <= hi, stage
    starts = [got[f"eodt.frame.{s}"][0][0] for s in STAGES]
    assert starts == sorted(starts)


def test_batched_runner_spans_each_stream_step(model):
    cfg = model.cfg
    b, t = 2, 2
    frames = FrameInputs(
        image=torch.from_numpy(_images(b * t)).float().reshape(b, t, H, W, 3),
        proj_indices=torch.from_numpy(_cells(b * t)).reshape(b, t, H, W),
        outlier_mask=torch.zeros((b, t, H, W), dtype=torch.bool),
        obs_visibility=torch.ones((b, t, CELLS)),
        memory_reset=torch.tensor([[True, False]] * b))
    mem = MemoryState(torch.zeros((b, CELLS, cfg.memory.memory_dim)),
                      torch.zeros((b, CELLS)))
    runner = make_batched_episode_runner(model, cfg)
    with _cpu_profile() as prof:
        runner(frames, _zs(cfg), mem)
    got = _ranges(prof)
    assert len(got["eodt.stream_step"]) == b * t
    assert len(got["eodt.frame"]) == b * t
    assert len(got["eodt.trunk"]) == 1          # once over the B * T frames
    for s, e in got["eodt.frame"]:
        assert any(a <= s <= e <= z for a, z in got["eodt.stream_step"])


def test_train_step_spans_its_phases(model):
    cfg = model.cfg
    r = np.random.RandomState(4)
    b = 2
    boxes = np.zeros((b, G, 4), np.float32)
    boxes[:, 0] = [8, 8, 40, 48]
    valid = np.zeros((b, G), bool)
    valid[:, 0] = True
    batch = TrainBatch(
        image=torch.from_numpy(_images(b, 5)).float(),
        proj_indices=torch.from_numpy(_cells(b, 6)),
        mem_features=torch.from_numpy(
            r.randn(b, CELLS, cfg.memory.memory_dim).astype(np.float32)),
        mem_obs=torch.ones((b, CELLS)),
        gt_boxes=torch.from_numpy(boxes),
        gt_classes=torch.zeros((b, G), dtype=torch.int32),
        gt_valid=torch.from_numpy(valid),
        weight=torch.ones((b,)))
    init_state, step_fn = make_train_step(model, cfg)
    state = init_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with _cpu_profile() as prof:
            step_fn(state, batch, _zs(cfg))
    finally:
        model.load_state_dict(before)
        model.zero_grad(set_to_none=True)
        model.eval()
    got = _ranges(prof)
    for phase in ("forward", "backward", "allreduce", "optimizer"):
        assert len(got[f"eodt.train.{phase}"]) == 1, phase
    order = [got[f"eodt.train.{p}"][0] for p in
             ("forward", "backward", "allreduce", "optimizer")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def _chunk(k: int) -> EpisodeChunk:
    gt = np.zeros((2, G, 4), np.float32)
    gt[:, 0] = [10, 10, 50, 40]
    gt_valid = np.zeros((2, G), bool)
    gt_valid[:, 0] = True
    return EpisodeChunk(
        sequence_name=f"scene0000_lvl0_{k}.h5", file_names=["a", "b"],
        images=_images(2, 10 + k), proj_indices=_cells(2, 20 + k),
        gt_boxes=gt, gt_classes=np.zeros((2, G), np.int32),
        gt_valid=gt_valid, memory_reset=np.array([k == 0, False]),
        episode_start=np.array([k == 0, False]), num_cells=CELLS,
        frame_valid=np.ones(2, bool))


def test_evaluate_dataset_timing_from_the_clock(model, monkeypatch):
    clocks = []
    results = teval._results

    def spy(evaluator, quartile_ids, im_id, clock, *args, **kw):
        clocks.append(dict(clock))
        return results(evaluator, quartile_ids, im_id, clock, *args, **kw)

    monkeypatch.setattr(teval, "_results", spy)
    got = teval.evaluate_dataset(model, model.cfg, [_chunk(0), _chunk(1)],
                                 _zs(model.cfg).numpy(), verbose=False,
                                 num_workers=0)
    assert sorted(got.timing) == sorted(
        ["data_s_per_chunk", "compute_s_per_chunk", "eval_s_per_chunk",
         "total_s", "frames_per_s"])
    # one warm-up chunk, then one timed: the clock holds the timed chunk
    clock, = clocks
    assert sorted(clock) == sorted([teval.DATA, teval.COMPUTE, teval.SCORE])
    assert got.timing["data_s_per_chunk"] == clock[teval.DATA]
    assert got.timing["compute_s_per_chunk"] == clock[teval.COMPUTE]
    assert got.timing["eval_s_per_chunk"] == clock[teval.SCORE]
    assert got.timing["frames_per_s"] == pytest.approx(
        2 / clock[teval.COMPUTE])
    assert sum(clock.values()) <= got.timing["total_s"]
    assert got.num_images == 4
