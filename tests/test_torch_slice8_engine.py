"""Slice 8 of the port on the CPU, part 2: the evaluation engine, the
`.pth` loader and the CLI, against the JAX package.

  * protocol: `_score_chunk_frames` and `evaluate()` on the same recorded
    detection arrays in both packages (chunks at serial indices in all
    four quartiles, a padding frame): AP dicts equal exactly, overall and
    per quartile;
  * end to end: the port's `evaluate_dataset` on the CPU against the JAX
    package's on one synthetic root (64x96, 1 scene x 2 chunks x 4
    frames, every 2nd frame scored) at the f32 oracle miniature of
    tests/test_torch_frame.py, with the JAX weights carried by
    `load_jax_params`, for image_only (the three image-only golden
    presets) and implicit_memory under the strided and the exact write:
    equal images and quartiles, each scored image's detections within
    `test_episode_chunk_vs_jax`'s tolerances (scores rtol 1e-3 / atol
    1e-4, boxes rtol 1e-3 / atol 1e-2, classes equal) where the two
    memories agree (see the test), overall AP within 0.1 points where
    every image is held, the same timing keys;
  * `.pth` loader: a detectron2 state dict made from the JAX miniature's
    parameters with tests/test_convert.py's inverse rename and layout
    maps, a `zs_weight` buffer and an unrelated key: the port's state
    dict equals `load_jax_params` of the JAX converter's output per key,
    with the same zs_weight and `_unmapped`; `verify_against_model`
    reports nothing missing or mismatched, and a frame on the loaded
    weights equals a frame on `load_jax_params`' exactly;
  * CLI: `--dry-run --device cpu` runs the four presets, the sharded
    protocol and the three GT baselines and prints the port's golden
    commands; `--eval-only
    --device cpu` on a synthetic root prints overall and quartile AP and
    writes the semmap snapshots, from a `.pth` and from a checkpoint
    directory; `--coco-json` on a synthesized json evaluates and trains
    (2 iterations, then `--coco-json-test`) with a finite AP; res5
    without `--coco-json` exits, as the JAX CLI does, and `--device cuda`
    without a card raises.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.convert.torch_weights import (
    convert_state_dict as jax_convert_state_dict)
from embodied_object_detection_tpu.data.episode_dataset import (
    EpisodeDataset as JaxDataset)
from embodied_object_detection_tpu.data.synthetic import (
    generate_synthetic_dataset as jax_generate)
from embodied_object_detection_tpu.engine import eval as jeval
from embodied_object_detection_tpu.evaluation import coco_eval as jcoco
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector)

from embodied_object_detection_tpu_torch import run
from embodied_object_detection_tpu_torch.convert import torch_weights as tw
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.data import EpisodeDataset
from embodied_object_detection_tpu_torch.engine import eval as teval
from embodied_object_detection_tpu_torch.engine.checkpoint import (
    save_checkpoint)
from embodied_object_detection_tpu_torch.evaluation import coco_eval as tcoco
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector)
from embodied_object_detection_tpu_torch.parallel.train_step import (
    make_train_step)
from embodied_object_detection_tpu_torch.structures import Detections

from test_convert import (_flatten, _inverse_transform,
                          flax_path_to_torch_name)
from test_torch_frame import _jax_config, _port_config, _sorted_valid

GEN = dict(num_scenes=1, chunks_per_scene=2, frames=4, height=64, width=96,
           map_h=8, map_w=8, seed=0)


def _config(memory_type):
    cfg = _jax_config()
    return cfg.replace(
        input=dataclasses.replace(cfg.input, max_sequence_length=4,
                                  score_every=2),
        memory=dataclasses.replace(cfg.memory, memory_type=memory_type))


def _jax_model(cfg):
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), image=jnp.zeros((h, w, 3)),
        zs_weight=jnp.zeros((cfg.roi.zs_weight_dim,
                             cfg.roi.num_classes + 1)),
        mem_features=jnp.zeros((cells, d)), mem_obs=jnp.zeros((cells,)),
        proj_indices=jnp.zeros((h, w), jnp.int32),
        outlier_mask=jnp.zeros((h, w), bool))
    return model, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU models: the suite runs
    several test processes on one machine at once, and torch's default of
    one thread a core in each of them oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    jax_generate(root, **GEN)
    rng = np.random.RandomState(11)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    cfg = _config("implicit_memory")
    model, params, tree = _jax_model(cfg)
    return dict(root=root, zs=zs, cfg=cfg, model=model, params=params,
                tree=tree)


class _Spy:
    """Each scored image's detections, as the evaluator receives them."""

    def __init__(self, module):
        self.module, self.dets = module, {}

    def __enter__(self):
        spy, base = self, self.module.COCOEvaluator

        class Evaluator(base):
            def add_detections(self, image_id, boxes, scores, classes):
                spy.dets[image_id] = Detections(
                    np.asarray(boxes), np.asarray(scores),
                    np.asarray(classes), np.ones(len(scores), bool))
                super().add_detections(image_id, boxes, scores, classes)

        self.module.COCOEvaluator = Evaluator
        self.base = base
        return self

    def __exit__(self, *exc):
        self.module.COCOEvaluator = self.base


# --------------------------------------------------------------- protocol

def test_score_chunk_frames_vs_jax(fx):
    """The same recorded detections through both packages' scoring: GT
    truncated in xywh with area 0, first_ann_id 0, every 2nd valid frame,
    quartiles by serial index."""
    chunks = list(EpisodeDataset(fx["root"], max_sequence_length=4)) * 2
    chunks.append(dataclasses.replace(
        chunks[1], frame_valid=np.array([True, True, False, True])))
    serial = [0, 30, 60, 90, 99]
    rng = np.random.RandomState(3)
    results = []
    for module, coco in ((teval, tcoco), (jeval, jcoco)):
        ev = coco.COCOEvaluator(list(range(5)), first_ann_id=0)
        quartiles = [[], [], [], []]
        im_id = 0
        rng = np.random.RandomState(3)
        for chunk, idx in zip(chunks, serial):
            s, n = 2, 16
            boxes = np.sort(rng.uniform(0, 96, (s, n, 2, 2)), axis=2)
            boxes = boxes.transpose(0, 1, 3, 2).reshape(s, n, 4)
            gt = chunk.gt_boxes[::2]
            boxes[:, :4] = gt[:, :4] + rng.randn(s, 4, 4) * 2
            scores = rng.rand(s, n).astype(np.float32)
            classes = rng.randint(0, 5, (s, n)).astype(np.int32)
            classes[:, :4] = chunk.gt_classes[::2, :4]
            valid = rng.rand(s, n) < 0.7
            im_id = module._score_chunk_frames(
                ev, quartiles, chunk, idx, boxes.astype(np.float32), scores,
                classes, valid, im_id, 2)
        results.append((im_id, quartiles, ev.evaluate(),
                        [ev.evaluate(q) for q in quartiles]))
    (n_t, q_t, all_t, per_t), (n_j, q_j, all_j, per_j) = results
    assert n_t == n_j == 9 and q_t == q_j
    assert [len(q) for q in q_t] == [2, 2, 2, 3]
    for a, b in zip([all_t] + per_t, [all_j] + per_j):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k
    assert all_t["AP"] > 0


def test_scored_detections_packs_the_scored_frames():
    rng = np.random.RandomState(0)
    t, n = 5, 7
    det = Detections(torch.from_numpy(rng.rand(t, n, 4).astype(np.float32)),
                     torch.from_numpy(rng.rand(t, n).astype(np.float32)),
                     torch.from_numpy(rng.randint(0, 20, (t, n)).astype(
                         np.int32)),
                     torch.from_numpy(rng.rand(t, n) < 0.5))
    boxes, scores, classes, valid = teval.scored_detections(det, 2)
    for got, want in zip((boxes, scores, classes, valid), det):
        want = want.numpy()[::2]
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------- end to end

E2E_CASES = {
    # the three image-only golden presets: no memory read
    "image_only": ("image_only", True),
    # the memory read, written and carried across the chunks
    "implicit_strided": ("implicit_memory", False),
    # the golden implicit_object_memory preset: the exact write
    "implicit_exact": ("implicit_memory", True),
}


# the exact case's shift of the mask logits: the seeded predictor's logits
# lie near 0, so every pasted pixel sits near the 0.5 threshold; shifted
# by +2 (a probability of ~0.88 inside a box) only a box's edge crosses it
MASK_LOGIT_SHIFT = 2.0


def _shift_mask_logits(tree):
    """The parameter tree with the mask predictor's bias shifted."""
    def shift(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-2:] == ["predictor", "bias"] and \
                any("mask" in n for n in names):
            return x + MASK_LOGIT_SHIFT
        return x
    return jax.tree_util.tree_map_with_path(shift, tree)


class _JaxRunnerSpy:
    """Stands for the `jax` module in the JAX engine: records each chunk's
    starting memory and the jitted runner's output."""

    def __init__(self):
        self.chunks = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        run = jax.jit(fn, **kwargs)

        def recorded(params, frames, zs, memory):
            out = run(params, frames, zs, memory)
            self.chunks.append((memory, out))
            return out
        return recorded


class _PortStarts:
    """Starts the port engine's chunk i from `starts[i]` (numpy fields;
    None: the memory the engine carries), and records each chunk's
    output."""

    def __init__(self, starts):
        self.starts, self.chunks = starts, []

    def __enter__(self):
        self.base = base = teval.make_episode_runner

        def runner(model, cfg):
            run = base(model, cfg)

            def started(frames, zs, memory):
                if self.starts is not None:
                    start = self.starts[len(self.chunks)]
                    memory = type(memory)(*map(torch.tensor, start))
                out = run(frames, zs, memory)
                self.chunks.append(out)
                return out
            return started
        teval.make_episode_runner = runner
        return self

    def __exit__(self, *exc):
        teval.make_episode_runner = self.base


def _memories_agree(port, jax_state):
    return all(np.allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                           atol=1e-3) for a, b in zip(port, jax_state))


def _match_detections(got, want, score_tol, box_atol):
    """One image's detections held to the JAX program's one to one: each
    matched to one of the other side's with the same class, its score
    within `score_tol` (rtol, atol) and its box within rtol 1e-3 and
    `box_atol`, the tolerances of test_torch_frame.py's
    `_check_detections`. Two ties are matched as such:
    - detections whose scores tie within the tolerance may take each
      other's places in the two programs' ranking, so the rows are
      matched as a set, not row by row;
    - of two proposals whose scores for a class tie within the tolerance,
      the NMS may keep one in one program and the other in the other. At
      most one pair an image may then differ in its box alone, and only
      where each of its two boxes is one that the other program also
      detected in the image (for another class)."""
    from scipy.optimize import linear_sum_assignment
    gb, gs, gc = _sorted_valid(got)
    wb, ws, wc = _sorted_valid(want)
    assert len(gs) == len(ws)

    def close(a, b):
        return (np.abs(a[:, None] - b[None]) <=
                box_atol + 1e-3 * np.abs(b[None])).all(-1)

    same = (gc[:, None] == wc[None]) & (
        np.abs(gs[:, None] - ws[None]) <=
        score_tol[1] + score_tol[0] * np.abs(ws[None]))
    boxes = close(gb, wb)
    tied = same & close(gb, wb).any(1)[:, None] & \
        close(wb, gb).any(1)[None, :]
    cost = np.where(same & boxes, 0, np.where(tied, 1, 2))
    rows, cols = linear_sum_assignment(cost)
    assert (cost[rows, cols] < 2).all(), "detections without a match"
    assert (cost[rows, cols] == 1).sum() <= 1, "more than one NMS tie"


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_evaluate_dataset_vs_jax(fx, case):
    """Each scored image's detections are held where the two packages'
    memories agree. Under the exact write a mask pixel within ~1e-6 of
    the 0.5 threshold (the two packages' f32 sums differ in their last
    bits) moves the every-8th selection of the compacted observed pixels
    after it, and at the seeded weights every mask probability lies near
    0.5. So the exact case shifts the mask logits by MASK_LOGIT_SHIFT in
    both packages, starts each of the port's chunks from the memory the
    JAX chunk started from, and holds every image of a chunk whose
    memories (after frame 0 and at its end) agree within 1e-3, and each
    chunk's first frame in any case; images that read a written memory
    must be among those held, and the AP is compared where every image
    is. (The compaction of a partial observed set, which whole boxes may
    replace at the shift, is held to JAX frame by frame in
    tests/test_torch_frame.py.) The other cases carry their own memory.
    The strided write (exact_write_subsample False) keeps a flip to its
    own pixel: every image is held."""
    memory_type, exact = E2E_CASES[case]
    cfg = _config(memory_type)
    cfg = cfg.replace(memory=dataclasses.replace(
        cfg.memory, exact_write_subsample=exact))
    if case == "implicit_exact":
        model = fx["model"]
        params, tree = map(_shift_mask_logits, (fx["params"], fx["tree"]))
    else:
        model, params, tree = _jax_model(cfg)
    port = build_detector(_port_config(cfg), seed=1, device="cpu")
    port.load_state_dict(load_jax_params(tree))
    ds_kw = dict(max_sequence_length=4, max_gt=cfg.input.max_gt_boxes)
    jax_runs = _JaxRunnerSpy()
    with _Spy(jeval) as spy_j:
        jeval_jax, jeval.jax = jeval.jax, jax_runs
        try:
            want = jeval.evaluate_dataset(model, params, cfg,
                                          JaxDataset(fx["root"], **ds_kw),
                                          fx["zs"], verbose=False,
                                          num_workers=0)
        finally:
            jeval.jax = jeval_jax
    starts = [tuple(map(np.asarray, m)) for m, _ in jax_runs.chunks] \
        if case == "implicit_exact" else None
    with _Spy(teval) as spy_t, _PortStarts(starts) as port_runs:
        got = teval.evaluate_dataset(port, port.cfg,
                                     EpisodeDataset(fx["root"], **ds_kw),
                                     fx["zs"], verbose=False, num_workers=2)
    assert got.num_images == want.num_images == 4
    assert [len(q) for q in got.quartiles] == \
        [len(q) for q in want.quartiles]
    assert sorted(spy_t.dets) == sorted(spy_j.dets) == [0, 1, 2, 3]
    # 2 chunks of 4 frames, frames 0 and 2 scored: image i is chunk i // 2
    agree = [_memories_agree(p.first_memory, j.first_memory) and
             _memories_agree(p.memory, j.memory)
             for p, (_, j) in zip(port_runs.chunks, jax_runs.chunks)]
    assert len(agree) == 2
    if case == "implicit_exact":
        held = [im for im in sorted(spy_j.dets) if agree[im // 2] or
                im % 2 == 0]
        # image 2 reads the memory the scene's first chunk wrote
        assert 2 in held
    else:
        held = sorted(spy_j.dets)
    n_det = 0
    for im in held:
        g, w = spy_t.dets[im], spy_j.dets[im]
        _match_detections(Detections(*g), w, (1e-3, 1e-4), 1e-2)
        n_det += len(w.scores)
    assert n_det > 0
    if len(held) == 4:
        assert abs(got.overall["AP"] - want.overall["AP"]) <= 0.1
    assert np.isfinite(got.overall["AP"])
    assert got.timing.keys() == want.timing.keys()
    assert all(v >= 0 for v in got.timing.values())


# ------------------------------------------------------------ .pth loader

def _torch_state_dict(tree, cfg):
    rng = np.random.RandomState(0)
    sd = {flax_path_to_torch_name(path): _inverse_transform(path, arr)
          for path, arr in _flatten(tree["params"]).items()}
    sd["roi_heads.box_predictor.0.cls_score.zs_weight"] = rng.randn(
        cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1).astype(np.float32)
    sd["text_encoder.some.weight"] = np.zeros(3, np.float32)
    return sd


def test_pth_loader_vs_jax_converter(fx, tmp_path):
    cfg = fx["cfg"]
    sd = _torch_state_dict(fx["tree"], cfg)
    path = str(tmp_path / "model.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    converted, zs = tw.load_torch_checkpoint(path)
    jax_converted, jax_zs = jax_convert_state_dict(sd)
    want = load_jax_params(jax_converted)
    got = converted["state_dict"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k
    assert np.array_equal(zs, jax_zs)
    assert converted["_unmapped"] == jax_converted["_unmapped"] == \
        ["text_encoder.some.weight"]

    port = build_detector(_port_config(cfg), seed=5, device="cpu")
    assert tw.verify_against_model(converted, port) == ([], [], [])
    port.load_state_dict(got)
    ref = build_detector(_port_config(cfg), seed=6, device="cpu")
    ref.load_state_dict(load_jax_params(fx["tree"]))
    rng = np.random.RandomState(2)
    h, w = cfg.input.height, cfg.input.width
    args = [torch.from_numpy(a) for a in (
        rng.randint(0, 255, (h, w, 3)).astype(np.float32), fx["zs"],
        (rng.randn(64, 512) * 3).astype(np.float32),
        rng.randint(0, 3, 64).astype(np.float32),
        rng.randint(0, 64, (h, w)).astype(np.int32), np.zeros((h, w), bool))]
    a, b = port.frame_step(*args), ref.frame_step(*args)
    for x, y in zip(a.detections + a.write[:2], b.detections + b.write[:2]):
        assert torch.equal(x, y)

    # an image-only model takes the checkpoint with its memory-merge
    # projections as extra keys; a dropped key is reported missing
    image_only = build_detector(_port_config(_config("image_only")),
                                seed=5, device="cpu")
    missing, extra, mismatch = tw.verify_against_model(converted, image_only)
    assert missing == [] and mismatch == [] and len(extra) == 6 and \
        all(k.startswith("fpn.map_merge_projection") for k in extra)
    del got["fpn.p6.bias"]
    got["fpn.p7.bias"] = torch.zeros(3)
    missing, _, mismatch = tw.verify_against_model(converted, port)
    assert missing == ["fpn.p6.bias"]
    assert mismatch == [("fpn.p7.bias", (3,), (256,))]


# -------------------------------------------------------------------- CLI

MINI_OPTS = ["compute_dtype=float32", "backbone.depths=(1,1,1,1)",
             "input.height=64", "input.width=96",
             "input.max_sequence_length=4", "input.score_every=2",
             "input.max_gt_boxes=8", "centernet.pre_nms_topk_test=64",
             "centernet.post_nms_topk_test=16",
             "roi.detections_per_image=16", "roi.num_classes=5",
             "memory.max_cells=64", "memory.write_topk=8"]


def test_cli_dry_run(capsys):
    out = run.main(["--dry-run", "--device", "cpu"])
    assert sorted(out) == sorted(run.GOLDEN_PRESETS + ("surfaces",))
    assert sorted(out["surfaces"]) == ["explicit_map", "map_gt",
                                       "semantic_gt", "sharded"]
    text = capsys.readouterr().out
    assert text.count("python -m embodied_object_detection_tpu_torch.run "
                      "--eval-only") == 4
    assert "[dry-run] all parity pipelines verified" in text


def test_cli_eval_only(fx, tmp_path, capsys):
    """From a detectron2 .pth (with --save-semmap), then from a checkpoint
    directory of the port holding the same weights: the same AP; then one
    chunk (--max-chunks) with a profiler trace (--profile-dir)."""
    import h5py
    sd = _torch_state_dict(fx["tree"], fx["cfg"])
    pth = str(tmp_path / "model.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               pth)
    out_dir = str(tmp_path / "out")
    common = ["--eval-only", "--device", "cpu", "--data-path", fx["root"],
              "--zs-weight", "random", "--opts"] + MINI_OPTS
    first = run.main(common[:-len(MINI_OPTS) - 1] + [
        "--weights", pth, "--output-dir", out_dir, "--save-semmap",
        "--opts"] + MINI_OPTS)
    text = capsys.readouterr().out
    assert "converted" in text and "missing=0" in text
    assert "overall:" in text and "quartile 1: AP=" in text
    assert first.num_images == 4
    snaps = sorted(os.listdir(os.path.join(out_dir, "memory")))
    assert snaps == ["scene0000_lvl0_0.h5", "scene0000_lvl0_1.h5"]
    with h5py.File(os.path.join(out_dir, "memory", snaps[0]), "r") as f:
        assert sorted(f) == ["impicit_memory", "observations", "semmap"]
        assert f["semmap"].dtype == np.int32 and \
            f["impicit_memory"].shape == (64, 512)

    model = build_detector(_port_config(fx["cfg"]), seed=9, device="cpu")
    model.load_state_dict(load_jax_params(fx["tree"]))
    init_state, _ = make_train_step(model, model.cfg)
    save_checkpoint(str(tmp_path / "ckpt"), 7, init_state())
    second = run.main(common[:-len(MINI_OPTS) - 1] + [
        "--weights", str(tmp_path / "ckpt"), "--output-dir",
        str(tmp_path / "out2"), "--opts"] + MINI_OPTS)
    assert second.overall == first.overall
    third = run.main(common[:-len(MINI_OPTS) - 1] + [
        "--weights", pth, "--output-dir", str(tmp_path / "out3"),
        "--max-chunks", "1", "--profile-dir", str(tmp_path / "prof"),
        "--opts"] + MINI_OPTS)
    assert third.num_images == 2
    assert os.path.getsize(tmp_path / "prof" / "eval_trace.json") > 0


# argv -> (the error, what its message names): res5 without --coco-json
# exits as the JAX CLI does (a single-frame variant)
NOT_PORTED = {
    "res5": (["--eval-only", "--opts", "roi.head_type=res5"], SystemExit,
             "--coco-json"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_cli_paths_not_ported_raise(case, tmp_path):
    argv, err, item = NOT_PORTED[case]
    with pytest.raises(err, match=item):
        run.main(["--device", "cpu", "--output-dir", str(tmp_path)] + argv)


def _coco_json(root):
    """A COCO json over 3 PNGs of 64x96, 60x80 (scaled up, bilinear) and
    64x80, 1-3 boxes each with raw ids 0-4 (the miniature's classes)."""
    from PIL import Image
    rng = np.random.RandomState(12)
    images, anns = [], []
    for i, (h, w) in enumerate([(64, 96), (60, 80), (64, 80)]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
                        ).save(os.path.join(root, f"{i}.png"))
        images.append(dict(id=i + 1, file_name=f"{i}.png", height=h,
                           width=w))
        for _ in range(i + 1):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.randint(5)),
                             bbox=[x, y, rng.uniform(8, w / 2),
                                   rng.uniform(8, h / 2)], iscrowd=0))
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=c, name=f"c{c}")
                                   for c in range(5)]), f)
    return path


@pytest.mark.parametrize("mode", ["eval_only", "training"])
def test_cli_coco_json(mode, tmp_path, capsys):
    """`--coco-json` on the CPU at the 64x96 miniature: evaluation alone,
    and 2 training iterations followed by `--coco-json-test`; each
    prints the image_only default and a finite AP."""
    path = _coco_json(str(tmp_path))
    argv = ["--device", "cpu", "--coco-json", path, "--image-root",
            str(tmp_path), "--zs-weight", "random", "--output-dir",
            str(tmp_path / "out")]
    opts = ["--opts"] + MINI_OPTS + ["centernet.pre_nms_topk_train=64",
                                     "centernet.post_nms_topk_train=16",
                                     "solver.ims_per_batch=2",
                                     "solver.checkpoint_period=100"]
    if mode == "eval_only":
        res = run.main(argv + ["--eval-only"] + opts)
    else:
        state, res = run.main(argv + ["--max-iter", "2", "--coco-json-test",
                                      path] + opts)
        assert state.step == 2
    assert "memory_type defaulted to image_only" in capsys.readouterr().out
    assert "AP" in res and all(np.isfinite(v) for v in res.values())


@pytest.mark.parametrize("argv", [["--eval-only"], ["--dry-run"],
                                  ["--coco-json", "a.json"]])
def test_cli_without_card_raises(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(argv)
