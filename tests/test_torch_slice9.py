"""Slice 9 of the torch port, on the CPU: the serving layer against the JAX
package.

  * the projector, function by function, on random poses in both
    rotation dialects, with depth holes, points outside the map and above
    the z-clip: cell ids and outlier masks equal except at pixels whose map
    coordinate lies within 1e-4 cells of a rounding boundary (f32 sums in
    another order), and few such pixels; coordinates within rtol 1e-5
  * `robot_demo.compute_proj_indices` against the JAX demo's, the same way
  * the visualizer pixel-equal to the JAX package's on the same detections
  * `EmbodiedPredictor` over 6 frames with a reset against the JAX
    predictor at the 64x96 oracle miniature (one JAX model, its parameters
    carried over with `load_jax_params`, the mask logits shifted by +2 in
    both so that few pasted pixels sit at 0.5): detections a frame within the
    frame tests' tolerances (a frame after a fresh memory scores rtol 1e-4,
    boxes 5e-3 px; a later one, which reads memories summed in another
    order, rtol 1e-3, boxes 1e-2 px), the memory within rtol/atol 1e-3 and
    observation counts equal, `semantic_map` equal
  * `AsyncPredictor` with two CPU workers (order kept, a worker's
    exception raised in `get`), `robot_demo.main` end to end, `demo.main`
    and `predict_api` on images, `resolve_vocabulary` against the JAX
    package's, and every new entry point raising without a card
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.demo import demo as jdemo
from embodied_object_detection_tpu.demo import robot_demo as jrobot
from embodied_object_detection_tpu.demo.predictor import (
    EmbodiedPredictor as JaxPredictor)
from embodied_object_detection_tpu.demo.visualizer import (
    Visualizer as JaxVisualizer)
from embodied_object_detection_tpu.geometry import projector as jproj
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector)
from embodied_object_detection_tpu.structures import (
    Detections as JaxDetections)

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.demo import demo as tdemo
from embodied_object_detection_tpu_torch.demo import predict_api
from embodied_object_detection_tpu_torch.demo import robot_demo as trobot
from embodied_object_detection_tpu_torch.demo.predictor import (
    AsyncPredictor, EmbodiedPredictor, get_clip_embeddings)
from embodied_object_detection_tpu_torch.demo.visualizer import Visualizer
from embodied_object_detection_tpu_torch.geometry import projector as tproj
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector)
from embodied_object_detection_tpu_torch.structures import Detections

from test_torch_frame import (_blocky_proj, _check_detections, _jax_config,
                              _port_config)

BOUNDARY = 1e-4     # cells: a map coordinate this near x.5 may round apart


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _boundary(world, cell):
    """[..., 3] world xyz (f32) -> bool [...]: x or z within BOUNDARY
    cells of a rounding boundary."""
    xz = np.asarray(world, np.float64)[..., [0, 2]] / cell
    return (np.abs(np.abs(xz - np.floor(xz)) - 0.5) < BOUNDARY).any(-1)


def _scene(rng, h=48, w=64, dialect="euler"):
    """A random pose and depth in metres with holes, far points (outside
    the map) and points above the camera (past the z-clip)."""
    depth = rng.uniform(0.5, 6.0, (h, w)).astype(np.float32)
    depth[rng.rand(h, w) < 0.05] = 0.0
    depth[rng.rand(h, w) < 0.05] = 60.0
    pos = rng.uniform(-2, 2, 3)
    if dialect == "quat":
        # habitat's quaternion: a heading about y with a small tilt
        from scipy.spatial.transform import Rotation
        rot = Rotation.from_rotvec([rng.uniform(-0.6, 0.6),
                                    rng.uniform(-np.pi, np.pi),
                                    0.0]).as_quat()
    else:
        rot = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-np.pi, np.pi),
                        0.0])
    return depth, pos, rot


@pytest.mark.parametrize("dialect", ["euler", "quat"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projector_vs_jax(dialect, seed):
    rng = np.random.RandomState(seed)
    depth, pos, rot = _scene(rng, dialect=dialect)
    h, w = depth.shape
    vfov = math.radians(58.0)
    xyzhe = tproj.pose_to_xyzhe(pos, rot)
    assert np.array_equal(xyzhe, jproj.pose_to_xyzhe(pos, rot))

    T = tproj.transform3d(torch.from_numpy(xyzhe))
    T_j = jproj.transform3d(jnp.asarray(xyzhe))
    np.testing.assert_allclose(_np(T), np.asarray(T_j), rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(_np(tproj.intrinsic_matrix(w, h, vfov, "cpu")),
                          np.asarray(jproj.intrinsic_matrix(w, h, vfov)))
    for g, x in zip(tproj.pixel_scales(w, h, vfov, "cpu"),
                    jproj.pixel_scales(w, h, vfov)):
        np.testing.assert_allclose(_np(g), np.asarray(x), rtol=1e-6)
    cloud = tproj.depth_to_point_cloud(torch.from_numpy(depth), vfov, 1.0)
    cloud_j = jproj.depth_to_point_cloud(jnp.asarray(depth), vfov, 1.0)
    np.testing.assert_allclose(_np(cloud), np.asarray(cloud_j), rtol=1e-5,
                               atol=1e-6)
    world_c = tproj.camera_to_world(cloud, T[0])
    np.testing.assert_allclose(
        _np(world_c), np.asarray(jproj.camera_to_world(cloud_j, T_j[0])),
        rtol=1e-5, atol=1e-5)

    shift = np.array([-3.2, 0.0, -3.2], np.float32)
    world = tproj.pixel_to_world(torch.from_numpy(depth), T[0], vfov,
                                 torch.from_numpy(shift))
    world_j = np.asarray(jproj.pixel_to_world(
        jnp.asarray(depth), T_j[0], vfov, jnp.asarray(shift)))
    np.testing.assert_allclose(_np(world), world_j, rtol=1e-5, atol=1e-5)

    cam_y = float(xyzhe[0, 1])
    # a z-clip at the camera's height, so that many points lie above it
    args = (0.2, 32, 32, 0.0)
    xz, out = tproj.discretize_point_cloud(world, torch.tensor(cam_y), *args)
    xz_j, out_j = jproj.discretize_point_cloud(jnp.asarray(world_j),
                                               jnp.asarray(cam_y), *args)
    ids, mask = tproj.world_to_map_indices(world, torch.tensor(cam_y), *args)
    ids_j, mask_j = jproj.world_to_map_indices(jnp.asarray(world_j),
                                               jnp.asarray(cam_y), *args)
    edge = _boundary(world_j, 0.2)
    assert edge.sum() <= max(2, edge.size // 500), edge.sum()
    keep = ~edge
    assert np.array_equal(_np(out)[keep], np.asarray(out_j)[keep])
    assert np.array_equal(_np(mask)[keep], np.asarray(mask_j)[keep])
    assert np.array_equal(_np(ids)[keep], np.asarray(ids_j)[keep])
    inside = keep & ~np.asarray(out_j)
    assert np.array_equal(_np(xz)[inside], np.asarray(xz_j)[inside])
    assert ids.dtype == torch.int32 and mask.dtype == torch.bool
    # the scene exercises every branch
    above = world_j[..., 1] > cam_y
    assert inside.sum() > 0 and above.any() and np.asarray(out_j).sum() > \
        above.sum()


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_proj_indices_vs_jax(seed):
    rng = np.random.RandomState(seed)
    depth_m, pos, rot = _scene(rng)
    depth_mm = depth_m * 1000.0
    xyzhe = tproj.pose_to_xyzhe(pos, rot)[0]
    vfov = math.radians(trobot.DEFAULT_VFOV_DEG)
    ids, mask = trobot.compute_proj_indices(depth_mm, xyzhe, vfov, 32,
                                            device="cpu")
    ids_j, mask_j = jrobot.compute_proj_indices(depth_mm, xyzhe, vfov, 32)
    T = jproj.transform3d(jnp.asarray(xyzhe)[None])[0]
    world = np.asarray(jproj.pixel_to_world(
        jnp.asarray(depth_mm), T, vfov, jnp.asarray([-3.2, 0.0, -3.2]),
        depth_scaling=1000.0))
    keep = ~_boundary(world, trobot.GRID_CELL_M)
    assert (~keep).sum() <= max(2, keep.size // 500)
    assert np.array_equal(_np(mask)[keep], np.asarray(mask_j)[keep])
    assert np.array_equal(_np(ids)[keep], np.asarray(ids_j)[keep])
    assert _np(mask)[depth_mm <= 0].all()          # holes are outliers
    assert (~_np(mask)).sum() > 0


def _detections(rng, n=12, classes=5, h=64, w=96):
    xy = rng.uniform(0, [w, h], (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[3] = [np.nan, 0, 1, 1]             # skipped: not finite
    scores = rng.uniform(0, 1, n).astype(np.float32)
    cls = rng.randint(0, classes, n).astype(np.int32)
    valid = rng.rand(n) < 0.8
    return (Detections(*(torch.from_numpy(np.asarray(x)) for x in
                         (boxes, scores, cls, valid))),
            JaxDetections(boxes, scores, cls, valid))


def test_visualizer_pixel_equal_to_jax():
    rng = np.random.RandomState(0)
    names = ["bed", "chair", "sofa", "plant", "table"]
    got, want = Visualizer(names), JaxVisualizer(names)
    image = rng.randint(0, 255, (64, 96, 3)).astype(np.uint8)
    dt, dj = _detections(rng)
    for thresh in (0.0, 0.3):
        a = got.draw_detections(image, dt, score_thresh=thresh)
        assert np.array_equal(a, want.draw_detections(image, dj,
                                                      score_thresh=thresh))
    assert not np.array_equal(a, image)
    semmap = rng.randint(-1, 5, (12, 16)).astype(np.int32)
    assert np.array_equal(got.draw_semmap(semmap, 3),
                          want.draw_semmap(semmap, 3))
    assert np.array_equal(got.legend(120, 80), want.legend(120, 80))
    wide = [f"c{i}" for i in range(30)]       # palette past its 20 colours
    assert np.array_equal(Visualizer(wide).draw_semmap(semmap * 6 % 30),
                          JaxVisualizer(wide).draw_semmap(semmap * 6 % 30))


def _shift_mask_logits(tree, shift=2.0):
    """The parameter tree with the mask predictor's bias shifted by +2. At
    the seeded weights every mask probability sits near 0.5, so a pasted
    pixel may round to either side in the two packages and move the exact
    write's every-8th selection; shifted, only a box's edge crosses 0.5
    (tests/test_torch_slice8_engine.py does the same)."""
    def fn(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-2:] == ["predictor", "bias"] and \
                any("mask" in n for n in names):
            return x + shift
        return x
    return jax.tree_util.tree_map_with_path(fn, tree)


@pytest.fixture(scope="module")
def fx():
    cfg = _jax_config()
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((h, w, 3)),
        jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)),
        jnp.zeros((cells, d)), jnp.zeros((cells,)),
        jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), bool))
    params = _shift_mask_logits(params)
    pcfg = _port_config(cfg)
    port = build_detector(pcfg, seed=1, device="cpu")
    port.load_state_dict(load_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(5)
    zs = rng.randn(cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)
    zs = zs.astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    images = rng.randint(0, 255, (6, h, w, 3)).astype(np.uint8)
    projs = np.stack([_blocky_proj(rng, h, w, cells) for _ in range(6)])
    return dict(cfg=cfg, pcfg=pcfg, model=model, params=params, port=port,
                zs=zs, images=images, projs=projs)


def test_embodied_predictor_six_frames_with_reset_vs_jax(fx):
    cfg = fx["cfg"]
    want_p = JaxPredictor(cfg, fx["params"], fx["zs"])
    got_p = EmbodiedPredictor(fx["pcfg"], model=fx["port"],
                              zs_weight=fx["zs"], device="cpu")
    fresh = {0, 3}
    wrote = 0
    for t in range(6):
        if t == 3:
            want_p.reset_memory()
            got_p.reset_memory()
            assert float(got_p.memory.obs_count.abs().max()) == 0.0
        outl = np.zeros(fx["projs"][t].shape, bool)
        outl[:4] = True
        # the ids come as a host array on even frames, as a tensor on odd
        proj = fx["projs"][t] if t % 2 == 0 else torch.from_numpy(
            fx["projs"][t])
        got = got_p(fx["images"][t], proj, outl)
        want = want_p(fx["images"][t], fx["projs"][t], outl)
        assert isinstance(got.boxes, torch.Tensor) and \
            got.boxes.device.type == "cpu"
        tol = ((1e-4, 1e-5), 5e-3) if t in fresh else ((1e-3, 1e-4), 1e-2)
        _check_detections(got, want, *tol)
        np.testing.assert_allclose(_np(got_p.memory.features),
                                   np.asarray(want_p.memory.features),
                                   rtol=1e-3, atol=1e-3)
        assert np.array_equal(_np(got_p.memory.obs_count),
                              np.asarray(want_p.memory.obs_count))
        wrote += int(np.abs(np.asarray(want_p.memory.features)).max() > 0)
    assert wrote >= 4, "the frames wrote too little: weak fixture"
    assert float(got_p.memory.obs_count.max()) >= 2
    semmap = got_p.semantic_map(8, 8)
    assert semmap.shape == (8, 8) and semmap.dtype == np.int32
    assert np.array_equal(semmap, want_p.semantic_map(8, 8))
    assert (semmap >= 0).any()
    assert np.array_equal(got_p.render_map(8, 8, 2),
                          want_p.render_map(8, 8, 2))
    image = fx["images"][0]
    assert np.array_equal(
        got_p.render_detections(image, got, 0.0),
        want_p._visualizer.draw_detections(
            image, Detections(*(x.numpy() for x in got)), 0.0))

    # a swapped vocabulary is the classifier the next frame uses
    zs2 = np.roll(fx["zs"], 1, axis=1)
    got_p.set_vocabulary(zs2, ["a", "b", "c", "d", "e"])
    want_p.set_vocabulary(zs2, ["a", "b", "c", "d", "e"])
    _check_detections(got_p(fx["images"][0], fx["projs"][0]),
                      want_p(fx["images"][0], fx["projs"][0]),
                      (1e-3, 1e-4), 1e-2)
    assert got_p.class_names == ["a", "b", "c", "d", "e"]
    # the host guard: an id outside the memory raises before the frame
    bad = fx["projs"][0].copy()
    bad[0, 0] = cfg.memory.max_cells
    with pytest.raises(ValueError, match="max_cells"):
        got_p(fx["images"][0], bad)


def test_async_predictor_two_cpu_workers_in_order(fx):
    cfg = fx["pcfg"].replace(memory=dataclasses.replace(
        fx["pcfg"].memory, memory_type="image_only", write_memory=False))
    model = build_detector(cfg, seed=1, device="cpu")
    model.load_state_dict(fx["port"].state_dict(), strict=False)
    single = EmbodiedPredictor(cfg, model=model, zs_weight=fx["zs"],
                               device="cpu")
    pool = AsyncPredictor(cfg, model=model, zs_weight=fx["zs"],
                          devices=["cpu", "cpu"])
    try:
        assert pool.default_buffer_size == 6
        images = [fx["images"][t].astype(np.float32) for t in range(5)]
        for im in images:
            pool.put(im)
        for im in images:
            got, want = pool.get(), single(im)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        pool.put("not an image")
        pool.put(images[0])
        with pytest.raises(ValueError):
            pool.get()
        # the pool survives a failed frame
        assert torch.equal(pool.get().scores, single(images[0]).scores)
    finally:
        pool.shutdown()


TINY_OPTS = ["input.height=64", "input.width=96", "compute_dtype=float32",
             "backbone.depths=(1,1,1,1)", "centernet.pre_nms_topk_test=64",
             "centernet.post_nms_topk_test=16", "roi.detections_per_image=16",
             "memory.write_topk=8"]


def test_robot_demo_main_end_to_end(tmp_path):
    import cv2
    root = tmp_path / "robot"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.RandomState(0)
    with open(root / "poses.txt", "w") as f:
        for i in range(3):
            t = 100.0 + i * 0.1
            cv2.imwrite(str(root / "rgb" / f"{t:.3f}.jpg"),
                        rng.randint(0, 255, (64, 96, 3)).astype(np.uint8))
            depth = (rng.rand(64, 96) * 3000 + 500).astype(np.float32)
            depth[:4] = 0.0
            np.save(root / "depth" / f"{t:.3f}.npy", depth)
            f.write(f"{t:.3f} {0.1 * i} 1.2 0.0 {0.05 * i} 0.0\n")
    out = tmp_path / "out"
    trobot.main(["--data-dir", str(root), "--output", str(out),
                 "--stride", "1", "--map-cells", "16", "--device", "cpu",
                 "--opts"] + TINY_OPTS + ["roi.num_classes=5"])
    files = sorted(os.listdir(out))
    assert files == [f"{k}_{n:05d}.{e}" for k, e in (("frame", "jpg"),
                                                    ("map", "png"))
                     for n in range(3)]
    m = cv2.imread(str(out / "map_00002.png"))
    assert m.shape == (32, 32, 3)


def _write_images(tmp_path, n=2, h=64, w=96):
    from PIL import Image
    paths = []
    rng = np.random.RandomState(0)
    for i in range(n):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    return paths


def test_demo_main_on_images(tmp_path):
    from PIL import Image
    paths = _write_images(tmp_path, h=80, w=120)
    outdir = tmp_path / "out"
    results = tdemo.main(["--input", str(tmp_path / "*.png"), "--output",
                          str(outdir), "--vocabulary", "mp3d",
                          "--confidence-threshold", "0.0", "--device", "cpu",
                          "--opts"] + TINY_OPTS)
    assert len(results) == 2
    for p in paths:
        vis = np.asarray(Image.open(outdir / os.path.basename(p)))
        assert vis.shape == (80, 120, 3)
    # boxes rescaled to the input's resolution
    _, dets = results[0]
    boxes = np.asarray(dets.boxes)[np.asarray(dets.valid)]
    assert len(boxes) and boxes[:, 2].max() <= 120.5 and \
        boxes[:, 3].max() <= 80.5


def test_predict_api_predict_and_detect(tmp_path):
    from embodied_object_detection_tpu_torch.config import (DetectorConfig,
                                                            apply_opts)
    (img_path,) = _write_images(tmp_path, n=1)
    p = predict_api.Predictor()
    p.setup(cfg=apply_opts(DetectorConfig(), TINY_OPTS), device="cpu")
    out = p.predict(img_path, vocabulary="mp3d",
                    output_path=str(tmp_path / "vis.png"))
    assert os.path.exists(out) and p.last_detections is not None
    model = p._model
    image = np.random.RandomState(1).randint(0, 255, (64, 96, 3)).astype(
        np.uint8)
    dets = p.detect(image, vocabulary="coco")
    assert p._model is model                     # the swap keeps the model
    assert p._demo.predictor.zs_weight.shape == (512, 81)
    assert p._demo.class_names[0] == "person"
    assert np.asarray(dets.classes)[np.asarray(dets.valid)].max(
        initial=0) < 80


@pytest.mark.parametrize("vocabulary", ["mp3d", "coco", "lvis"])
def test_resolve_vocabulary_vs_jax(vocabulary):
    zs, names = tdemo.resolve_vocabulary(vocabulary)
    zs_j, names_j = jdemo.resolve_vocabulary(vocabulary)
    assert names == names_j
    assert np.array_equal(zs, zs_j)
    assert zs.shape[1] == len(names) + 1
    assert tdemo.find_classifier_npy(vocabulary).startswith(
        os.path.dirname(tdemo.__file__))


def test_custom_vocabulary_raises_naming_item_12(monkeypatch):
    """A custom vocabulary needs the CLIP text tower's weights, which the
    repository does not hold: both packages raise `FileNotFoundError`
    naming CLIP_TEXT_WEIGHTS (the tower itself, ROADMAP queue 1 item 12c,
    is held to JAX in tests/test_torch_slice16_text.py)."""
    from embodied_object_detection_tpu.demo import (
        predictor as jdemo_predictor)
    monkeypatch.delenv("CLIP_TEXT_WEIGHTS", raising=False)
    for resolve, embed in ((tdemo.resolve_vocabulary, get_clip_embeddings),
                           (jdemo.resolve_vocabulary,
                            jdemo_predictor.get_clip_embeddings)):
        with pytest.raises(FileNotFoundError, match="CLIP_TEXT_WEIGHTS"):
            resolve("custom", "cup,webcam")
        with pytest.raises(FileNotFoundError, match="CLIP_TEXT_WEIGHTS"):
            embed(["cup"])


def test_new_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.serve import server
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DetectorConfig()
    zs = np.zeros((512, 21), np.float32)
    calls = {
        "EmbodiedPredictor": lambda: EmbodiedPredictor(cfg),
        "AsyncPredictor": lambda: AsyncPredictor(cfg),
        "VisualizationDemo": lambda: tdemo.VisualizationDemo(
            cfg, zs, ["x"] * 20),
        "VisualizationDemo parallel": lambda: tdemo.VisualizationDemo(
            cfg, zs, ["x"] * 20, parallel=True),
        "Predictor.setup": lambda: predict_api.Predictor().setup(),
        "compute_proj_indices": lambda: trobot.compute_proj_indices(
            np.ones((4, 4), np.float32), np.zeros(5, np.float32), 1.0),
        "robot_demo.main": lambda: trobot.main(
            ["--data-dir", str(tmp_path)]),
        "demo.main": lambda: tdemo.main(["--input", "x.png"]),
        "server.main": lambda: server.main(["--port", "0"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
