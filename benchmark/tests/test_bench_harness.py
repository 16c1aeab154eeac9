"""The benchmark's own tests, on the CPU: the traffic is a function of the
seed, the bounds count what a hand count gives, no forbidden module is
let through, each piece is found by name, and a whole run (the cell's
miniature, `run.py --rehearse`) prints the result line the contract
asks for, with `correct` true against the plain reference."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.bounds import kernels
from benchmark.bounds.peaks import bound_s
from benchmark.traffic import episode_streams, train_batches

MINI = common.load_json(common.BENCH / "tests" / "miniature.json")


def mini_streams(seed):
    cell = common.find_cell("r50mem-eval-8x20")
    p = {**cell.traffic, **MINI["traffic"]["episode_streams"]}
    return episode_streams.Streams(p, 64, 96, 64, seed, "cpu")


def test_streams_are_a_function_of_the_seed():
    a, b, c = mini_streams(2 ** 40 + 3), mini_streams(2 ** 40 + 3), \
        mini_streams(5)
    for step, stream in ((0, 0), (3, 1), (7, 0)):
        x, y, z = a.chunk(step, stream), b.chunk(step, stream), \
            c.chunk(step, stream)
        for f, g, h in zip(x, y, z):
            assert np.array_equal(f, g)
            assert f.shape == h.shape and f.dtype == h.dtype
    assert not np.array_equal(a.chunk(3, 1).proj_indices,
                              c.chunk(3, 1).proj_indices)


def test_streams_overlap_and_reset_at_scene_starts():
    s = mini_streams(11)
    proj = s.chunk(0, 0).proj_indices
    assert proj.min() >= 0 and proj.max() < 64
    # consecutive frames share most of their cells
    a, b = set(proj[0].ravel()), set(proj[1].ravel())
    assert len(a & b) >= len(a) // 2
    starts = s.scene_start[0]
    for step in range(6):
        c = s.chunk(step, 0)
        assert bool(c.memory_reset[0]) == (step in starts)
        assert not c.memory_reset[1:].any()


def test_train_batches_are_a_function_of_the_seed():
    cell = common.find_cell("r50mem-train-2x20")
    p = {**cell.traffic, **MINI["traffic"]["train_batches"]}
    from benchmark.detector import program_config
    cfg = program_config({"overrides": MINI["overrides"]})
    st = episode_streams.Streams(p, 64, 96, 64, 9, "cpu")
    x = train_batches.make_batch(p, cfg, st, 9, 1, "cpu")
    y = train_batches.make_batch(p, cfg, st, 9, 1, "cpu")
    z = train_batches.make_batch(p, cfg, st, 9, 2, "cpu")
    for k in x:
        assert torch.equal(x[k], y[k]), k
    assert not torch.equal(x["image"], z["image"])
    assert x["gt_valid"].any(1).all()
    # a chunk's frames share its memory snapshot
    assert torch.equal(x["mem_features"][0], x["mem_features"][1])


def test_bounds_against_hand_counts():
    w = torch.tensor([[1.0, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 1],
                      [0, 0, 0, 0], [1, 1, 1, 1], [0, 2, 0, 0]])
    idx = torch.tensor([0, 1, -1, 2, 9, 1], dtype=torch.int32)
    # live rows 0, 1, 3, 5 (ids in [0, 4)); nonzero entries of those: 1+2+0+1
    assert kernels.segment_sum(w, idx, 4) == (4 * 4 * 4 + 6 * 4 + 4 * 4 * 4,
                                              4)
    boxes = torch.zeros((5, 4))
    classes = torch.tensor([0, 0, 1, 0, 1], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False])
    # class 0: 3 valid boxes, 3 pairs; class 1: one valid box
    assert kernels.nms_keep(boxes, classes, valid, 0.5, False) == \
        (5 * 21 + 5, 13 * 3)
    assert kernels.nms_keep(boxes, classes, valid, 0.5, True)[1] == 0
    feats = torch.zeros((16, 8))
    obs = torch.zeros(16)
    proj = torch.zeros((8, 8), dtype=torch.int32)
    proj[0, 0] = 5
    out = 2 * 2 * 8
    assert kernels.memory_read(feats, obs, proj, 4) == (
        2 * 8 * 4 + 16 * 4 + 64 * 4 + out * 4, out * 33)
    masks = torch.zeros((3, 28, 28))
    assert kernels.paste_masks_observed(masks, None, None, 10, 64, 0.5) == (
        3 * 28 * 28 * 4 + 3 * 16 + 3 + 10 * 64 * 3 + 10 * 64 + 10 * 2 * 4,
        10 * 64 * 3 * 10)


def test_roi_align_bound_counts_the_positions_read():
    # one ROI on one 16 x 16 level of stride 8, a 2 x 2 output with 2 x 2
    # samples: the taps of a box over pixels [2, 6) x [2, 6) read the
    # positions around the 16 sample points
    level = torch.zeros((16, 16, 8), dtype=torch.bfloat16)
    box = torch.tensor([[16.0, 16.0, 48.0, 48.0]])
    lvl = torch.zeros(1, dtype=torch.int32)
    read, ops = kernels.roi_align([level], box, lvl, (8,), 2, 2)
    rows, wgt = kernels._taps([level], box, lvl, (8,), 2, 2)
    positions = {int(r) for r, w in zip(rows.ravel(), wgt.ravel()) if w != 0}
    assert read == len(positions) * 8 * 2 + 20 + 2 * 2 * 8 * 2
    assert 16 <= len(positions) <= 36
    assert ops == 2 * 2 * 8 * 33
    assert bound_s(3.35e12, 0) == pytest.approx(1.0)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["embodied_object_detection_tpu_torch.ops", "jaxtyping",
             "numpy", "flaxen"]
    assert common.forbidden_modules(names) == []
    assert common.forbidden_modules(names + ["jax.numpy", "jaxlib"]) == \
        ["jax", "jaxlib"]
    assert common.forbidden_modules(
        ["embodied_object_detection_tpu.models.detector"]) == \
        ["embodied_object_detection_tpu"]


def test_pieces_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("traffic", "workloads", "metrics", "configs"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "tiny-model.json").write_text(json.dumps(
        {"overrides": {"memory.max_cells": 64}}))
    (bench / "traffic" / "short-mix.json").write_text(json.dumps(
        {"kind": "episode_streams", "streams": 3}))
    (bench / "workloads" / "tiny-cell.json").write_text(json.dumps(
        {"limits": {"x": 1.0}}))
    (bench / "metrics" / "new_metric.eval.py").write_text(
        "def read(t):\n    return t * 2\n")
    spec = {"configs": [{"name": "tiny-model", "file": str(
                bench / "configs" / "tiny-model.json")}],
            "workloads": [{"name": "tiny-cell", "config": "tiny-model",
                           "traffic": "short-mix", "chips": 1}],
            "end_to_end": [{"name": "eval_frames_per_s",
                            "workloads": ["tiny-cell"]},
                           {"name": "setup_s"}],
            "per_layer": [{"name": "new_metric.eval",
                           "workloads": ["tiny-cell"]},
                          {"name": "other.train", "workloads": ["x"]}]}
    cell = common.find_cell("tiny-cell", spec, bench)
    assert cell.config["overrides"] == {"memory.max_cells": 64}
    assert cell.traffic["streams"] == 3
    assert cell["checks_file"]["limits"] == {"x": 1.0}
    assert [m["name"] for m in cell["end_to_end"]] == ["eval_frames_per_s",
                                                       "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric.eval"]
    assert common.metric_reader("new_metric.eval", bench)(21) == 42
    assert common.traffic_kind(cell) is episode_streams


def rehearse(cell: str, *extra: str):
    out = subprocess.run(
        [sys.executable, str(common.BENCH / "run.py"), "--workload", cell,
         "--seed", str(2 ** 33 + 17), "--seconds", "1", "--rehearse",
         *extra], capture_output=True, text=True, timeout=600,
        cwd=common.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), \
        out.stderr.strip().splitlines()


@pytest.mark.parametrize("cell", ["r50mem-eval-8x20", "r50mem-train-2x20"])
def test_result_line_and_reference_agreement(cell):
    """A miniature run of the cell on the CPU: the result line's keys,
    the checks last on both streams, and the port's CPU path held to the
    plain reference (correct) at the cell's own limits."""
    line, err = rehearse(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    limits = common.load_json(common.BENCH / "workloads" /
                              f"{cell}.json")["limits"]
    assert set(line["checks"]) == set(limits)
    assert err[-len(limits):] == [
        f"check {k}: {v['value']!r} (limit {v['limit']!r})"
        for k, v in line["checks"].items()]
    e2e = {m["name"] for m in common.find_cell(cell)["end_to_end"]}
    assert set(line["metrics"]) == e2e
    assert line["device"]["platform"] == "cpu"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_traced_line_reports_per_layer_metrics():
    line, _ = rehearse("r50mem-eval-8x20", "--trace", "1")
    names = {m["name"] for m in common.find_cell("r50mem-eval-8x20")[
        "per_layer"]}
    assert set(line["metrics"]) <= names
    assert {"dispatch_ms_per_frame.eval", "mfu.eval"} <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in line["device"] and "busy_s" in line["device"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_eval_cell_on_the_card(card):
    """A short run of the first cell on the card, its own check
    included."""
    out = subprocess.run(
        [sys.executable, str(common.BENCH / "run.py"), "--workload",
         "r50mem-eval-8x20", "--seed", str(2 ** 33 + 1), "--seconds", "5"],
        capture_output=True, text=True, timeout=900, cwd=common.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is True, line["checks"]


def test_without_the_program_there_is_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the run fails and prints no result."""
    import shutil
    shutil.copy(common.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(common.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "r50mem-eval-8x20", "--seed", "1", "--seconds", "1",
         "--rehearse"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_without_a_card_there_is_no_result(card_absent):
    out = subprocess.run(
        [sys.executable, str(common.BENCH / "run.py"), "--workload",
         "r50mem-eval-8x20", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=common.REPO)
    assert out.returncode == 2 and out.stdout == ""


@pytest.fixture
def card_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
