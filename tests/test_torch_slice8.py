"""Slice 8 of the port on the CPU, part 1: the data layer, the evaluator,
the config surface, the prefetcher and the memory snapshot, each against
the JAX package.

  * dataset: the port's `EpisodeDataset` against the JAX one on the same
    `generate_synthetic_dataset` root (64x96, 1 scene x 2 chunks x 4
    frames, an 8 x 8 map): every `EpisodeChunk` field equal exactly under
    test_type default, episodic and longterm, memory_type semantic_gt,
    map_gt (semmap dialects lvis and smnet) and explicit_map, the semmap
    snapshot route, a missing JPEG and `load_jpeg=False`; the port's
    generator writes the JAX generator's arrays and JPEG bytes for the
    same seed, and `SyntheticEpisodes` holds the chunks `EpisodeDataset`
    reads from them; `sort_episode_files` and `parse_detection_record` on
    the JAX package's test cases;
  * evaluator: the port's `COCOEvaluator` against the JAX one on seeded
    random GT and detections (first_ann_id 0 and 1, image subsets, the
    federated mode): AP dicts equal exactly; the port's native core equal
    to its numpy path;
  * config: `apply_opts`, `parity_config` and `validate_config` against
    the JAX ones: every shared field equal, the same errors; the JAX
    fields no path reads are no port fields, and `apply_opts` takes them
    only at their pinned values;
  * `semmap_classes` against JAX's: class ids equal but on near-tied
    logits (counted); `save_memory_h5` read back by the JAX dataset;
  * the prefetcher's order, and its synchronous form with no workers.
"""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_object_detection_tpu import config as jcfg
from embodied_object_detection_tpu.data import episode_dataset as jds
from embodied_object_detection_tpu.data.synthetic import (
    generate_synthetic_dataset as jax_generate)
from embodied_object_detection_tpu.engine.eval import (
    chunk_to_frame_inputs as jax_chunk_to_frame_inputs)
from embodied_object_detection_tpu.evaluation import coco_eval as jcoco
from embodied_object_detection_tpu.ops.memory_ops import (
    semmap_classes as jax_semmap_classes)

from embodied_object_detection_tpu_torch import config as tcfg
from embodied_object_detection_tpu_torch import native
from embodied_object_detection_tpu_torch.data import episode_dataset as tds
from embodied_object_detection_tpu_torch.data.prefetch import (
    prefetch_iterator)
from embodied_object_detection_tpu_torch.data.synthetic import (
    SyntheticEpisodes, generate_synthetic_dataset)
from embodied_object_detection_tpu_torch.engine.checkpoint import (
    load_memory_h5, save_memory_h5)
from embodied_object_detection_tpu_torch.engine.eval import (
    chunk_to_frame_inputs)
from embodied_object_detection_tpu_torch.engine.train import (
    chunks_to_train_batch)
from embodied_object_detection_tpu_torch.evaluation import coco_eval as tcoco
from embodied_object_detection_tpu_torch.ops.memory_ops import (
    semmap_classes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "embodied_object_detection_tpu_torch", "data",
                    "metadata", "mp3d_clip.npy")
GEN = dict(num_scenes=1, chunks_per_scene=2, frames=4, height=64, width=96,
           map_h=8, map_w=8, seed=0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synth"))
    jax_generate(path, **GEN)
    return path


def _assert_chunks_equal(got, want):
    for f in dataclasses.fields(jds.EpisodeChunk):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None or isinstance(w, (str, int, list)):
            assert g == w, f.name
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name


def _both(root, **kw):
    return tds.EpisodeDataset(root, **kw), jds.EpisodeDataset(root, **kw)


DATASET_CASES = {
    "default": dict(),
    "episodic": dict(test_type="episodic"),
    "longterm": dict(test_type="longterm"),
    "no_jpeg": dict(load_jpeg=False),
    "semantic_gt": dict(memory_type="semantic_gt", clip_path=CLIP),
    "map_gt_lvis": dict(memory_type="map_gt", clip_path=CLIP,
                        semmap_dialect="lvis"),
    "map_gt_smnet": dict(memory_type="map_gt", clip_path=CLIP,
                         semmap_dialect="smnet"),
    "map_gt_auto": dict(memory_type="map_gt", clip_path=CLIP),
    "explicit_map": dict(memory_type="explicit_map"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_chunks_equal_jax(root, case):
    """Every field of every chunk, exactly (max_gt 3 drops GT boxes with
    the warning, as the JAX reader does)."""
    port, ref = _both(root, max_sequence_length=6, max_gt=3,
                      **DATASET_CASES[case])
    assert port.files == ref.files
    if case == "longterm":
        assert len(port) == 4       # each 50-chunk block replayed
    for i in range(len(ref)):
        _assert_chunks_equal(port[i], ref[i])


def test_dataset_missing_jpeg_reads_the_h5_row(root, tmp_path):
    """A frame whose JPEG is missing reads the h5 `rgb` row (lossless,
    where its neighbours decode a lossy JPEG)."""
    copy = str(tmp_path / "copy")
    shutil.copytree(root, copy)
    os.remove(os.path.join(copy, "JPEGImages", "scene0000_lvl0_1_2.jpg"))
    port, ref = _both(copy, max_sequence_length=4)
    for i in range(2):
        _assert_chunks_equal(port[i], ref[i])
    import h5py
    with h5py.File(os.path.join(copy, "sensor_data",
                                "scene0000_lvl0_1.h5"), "r") as f:
        assert np.array_equal(port[1].images[2], f["rgb"][2])
        assert not np.array_equal(port[1].images[1], f["rgb"][1])


def test_dataset_semmap_snapshot_route(root, tmp_path):
    """Snapshots written by the port's `save_memory_h5` are read by both
    readers: the memory, its observations and (map_gt) the snapshot's
    class map + 1 as the pixels' table ids."""
    rng = np.random.RandomState(4)
    snap = str(tmp_path / "snap")
    written = {}
    for k in range(2):
        seq = f"scene0000_lvl0_{k}.h5"
        semmap = rng.randint(-1, 20, 64).astype(np.int32)
        feats = rng.randn(64, 512).astype(np.float32)
        obs = rng.randint(0, 4, 64).astype(np.float32)
        path = save_memory_h5(snap, seq, semmap, feats, obs)
        written[seq] = (semmap, feats, obs)
        got = load_memory_h5(path)
        assert got[0].dtype == np.int32 and got[1].dtype == np.float32
        for g, w in zip(got, written[seq]):
            assert np.array_equal(g, w)
    mem_dir = os.path.join(snap, "memory")
    for kw in (dict(), dict(memory_type="map_gt", clip_path=CLIP)):
        port, ref = _both(root, max_sequence_length=4, semmap_path=mem_dir,
                          **kw)
        for i in range(2):
            _assert_chunks_equal(port[i], ref[i])
            semmap, feats, obs = written[ref[i].sequence_name]
            if not kw:
                assert np.array_equal(port[i].memory_features, feats)
                assert np.array_equal(port[i].observations, obs)
                assert port[i].num_cells == 64


def test_generator_writes_the_jax_arrays(root, tmp_path):
    import h5py
    mine = str(tmp_path / "port")
    generate_synthetic_dataset(mine, **GEN)
    for sub in ("memory_data", "sensor_data", "JPEGImages"):
        assert sorted(os.listdir(os.path.join(mine, sub))) == \
            sorted(os.listdir(os.path.join(root, sub)))
    for sub in ("memory_data", "sensor_data"):
        for name in os.listdir(os.path.join(root, sub)):
            with h5py.File(os.path.join(mine, sub, name), "r") as a, \
                    h5py.File(os.path.join(root, sub, name), "r") as b:
                assert sorted(a) == sorted(b)
                for key in b:
                    assert a[key].dtype == b[key].dtype, key
                    assert np.array_equal(a[key][()], b[key][()]), key
                    assert dict(a[key].attrs) == dict(b[key].attrs), key
    for name in os.listdir(os.path.join(root, "JPEGImages")):
        with open(os.path.join(mine, "JPEGImages", name), "rb") as a, \
                open(os.path.join(root, "JPEGImages", name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("test_type", ["default", "episodic"])
def test_synthetic_episodes_equal_the_files(root, test_type):
    """The in-memory episodes are the chunks `EpisodeDataset` reads from
    the generator's files with the h5 rows (no JPEG)."""
    mem = SyntheticEpisodes(test_type=test_type, max_sequence_length=6,
                            max_gt=8, **GEN)
    files = tds.EpisodeDataset(root, test_type=test_type,
                               max_sequence_length=6, max_gt=8,
                               load_jpeg=False)
    assert len(mem) == len(files)
    for i in range(len(files)):
        _assert_chunks_equal(mem[i], files[i])


def test_episode_chunk_feeds_the_training_batch(root):
    """An `EpisodeChunk` has the fields `engine/train.py:ChunkRecord`
    reads: two chunks make a training batch."""
    ds = tds.EpisodeDataset(root, max_sequence_length=4, max_gt=8)
    cfg = tcfg.DetectorConfig()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory, max_cells=64))
    batch = chunks_to_train_batch([ds[0], ds[1]], cfg)
    assert batch.image.shape == (8, 64, 96, 3)
    assert np.array_equal(batch.proj_indices[4:], ds[1].proj_indices)


def test_chunk_to_frame_inputs_vs_jax(root):
    chunk = tds.EpisodeDataset(root, max_sequence_length=6)[1]
    got = chunk_to_frame_inputs(chunk, 64, "cpu")
    want = jax_chunk_to_frame_inputs(chunk, 64)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    hi = int(chunk.proj_indices.max())
    with pytest.raises(ValueError, match="max_cells"):
        chunk_to_frame_inputs(chunk, hi, "cpu")


SORT_CASES = [
    (["sceneB_lvl0_2.h5", "sceneA_lvl0_10.h5", "sceneA_lvl0_2.h5",
      "sceneA_lvl0_0.h5", "sceneB_lvl0_0.h5"],
     ["sceneA_lvl0_0.h5", "sceneA_lvl0_2.h5", "sceneA_lvl0_10.h5",
      "sceneB_lvl0_0.h5", "sceneB_lvl0_2.h5"]),
    (["x_100.h5", "x_50.h5", "x_9.h5"], ["x_9.h5", "x_50.h5", "x_100.h5"]),
]
RECORDS = [
    str({"file_name": "img_0.jpg", "image": 0,
         "gt_boxes": [[10.0, 20.0, 30.0, 40.0], [5.0, 5.0, 10.0, 10.0]],
         "gt_classes": [0, 1]}),
    str({"file_name": "a_b_3.jpg", "image": 0, "gt_boxes": [],
         "gt_classes": []}).encode(),
    str({"file_name": "c.jpg", "image": 0,
         "gt_boxes": [[1.5, 2.5, 3.0, 4.0], [0, 0, 9, 9], [7, 7, 1, 1]],
         "gt_classes": [19, 2, 1]}),
]


@pytest.mark.parametrize("case", range(len(SORT_CASES) + len(RECORDS)))
def test_sort_and_parse_vs_jax(case):
    if case < len(SORT_CASES):
        files, want = SORT_CASES[case]
        assert tds.sort_episode_files(files) == want == \
            jds.sort_episode_files(files)
        return
    rec = RECORDS[case - len(SORT_CASES)]
    got, want = tds.parse_detection_record(rec), \
        jds.parse_detection_record(rec)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if case == len(SORT_CASES):     # the JAX package's own case
        assert got[0] == "img_0.jpg" and list(got[2]) == [0]
        np.testing.assert_allclose(got[1][0], [10, 20, 40, 60])


# ------------------------------------------------------------- evaluator

def _random_eval(rng, ev_cls, n_imgs=12, n_cats=4, **kw):
    ev = ev_cls(list(range(n_cats)), **kw)
    federated = kw.get("federated", False)
    for img in range(n_imgs):
        ng, nd = rng.randint(0, 6), rng.randint(0, 14)
        gxy = rng.uniform(0, 300, (ng, 2))
        gt = np.concatenate([gxy, gxy + rng.uniform(8, 120, (ng, 2))], 1)
        gc = rng.randint(0, n_cats, ng)
        # half the detections near a GT box, so that most thresholds match
        dxy = rng.uniform(0, 300, (nd, 2))
        dt = np.concatenate([dxy, dxy + rng.uniform(8, 120, (nd, 2))], 1)
        near = rng.rand(nd) < 0.5
        if ng:
            pick = rng.randint(0, ng, nd)
            dt[near] = gt[pick[near]] + rng.randn(int(near.sum()), 4) * 4
        dc = np.where(near & (ng > 0), gc[pick] if ng else 0,
                      rng.randint(0, n_cats, nd))
        scores = np.round(rng.rand(nd), 2)       # ties on purpose
        neg = list(rng.choice(n_cats, 1)) if federated else []
        ev.add_image(img, neg_category_ids=neg) if federated \
            else ev.add_image(img)
        ev.add_ground_truth(img, gt, gc,
                            areas=np.zeros(ng) if rng.rand() < 0.5 else None)
        ev.add_detections(img, dt, scores, dc)
    return ev


EVAL_CASES = {
    "ann_id_0": dict(first_ann_id=0),
    "ann_id_1": dict(first_ann_id=1),
    "federated": dict(federated=True, max_dets=300),
    "max_dets_5": dict(max_dets=5, first_ann_id=0),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
@pytest.mark.parametrize("subset", [None, "quartile"])
def test_evaluator_equals_jax(case, subset):
    kw = EVAL_CASES[case]
    got = _random_eval(np.random.RandomState(7), tcoco.COCOEvaluator, **kw)
    want = _random_eval(np.random.RandomState(7), jcoco.COCOEvaluator, **kw)
    ids = [1, 3, 4, 8, 11] if subset else None
    a, b = got.evaluate(ids), want.evaluate(ids)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k
    assert np.isfinite(a["AP"]) and a["AP"] > 0


def test_native_core_equals_numpy_path(monkeypatch):
    core = native.load_eval_core()
    if core is None:
        pytest.skip("no g++ to build the eval core")
    assert os.path.dirname(str(native.build.library_path())) == \
        os.path.join(REPO, "build")
    results = []
    for impl in (core, None):
        monkeypatch.setattr(tcoco, "_native_core", lambda impl=impl: impl)
        ev = _random_eval(np.random.RandomState(3), tcoco.COCOEvaluator,
                          first_ann_id=0)
        results.append((ev.evaluate(), ev.evaluate([0, 2, 5, 9])))
    for a, b in zip(*results):
        assert a.keys() == b.keys()
        for k in b:
            assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k


def test_coco_ap_vs_jax():
    rng = np.random.RandomState(5)
    gt, dt = {}, {}
    for img in range(4):
        xy = rng.uniform(0, 200, (3, 2))
        b = np.concatenate([xy, xy + 50], 1)
        gt[img] = (b, rng.randint(0, 2, 3))
        dt[img + 1] = (b + rng.randn(3, 4), rng.rand(3), rng.randint(0, 2, 3))
    assert tcoco.coco_ap(gt, dt, [0, 1]) == jcoco.coco_ap(gt, dt, [0, 1])


# ---------------------------------------------------------------- config

def _shared_fields_equal(a, b, path=""):
    for f in dataclasses.fields(a):
        if not hasattr(b, f.name):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _shared_fields_equal(x, y, f"{path}{f.name}.")
        else:
            assert x == y, f"{path}{f.name}: {x!r} != {y!r}"


OPTS = [
    ["memory.map_feature_weight=5", "roi.num_classes=20"],
    ["memory.memory_type=image_only", "memory.test_type=longterm",
     "input.score_every=2", "compute_dtype=float32"],
    ["roi.cascade_ious=(0.5,0.6,0.7)",
     "roi.cascade_bbox_reg_weights=((1,1,1,1),(2,2,2,2),(3,3,3,3))",
     "backbone.depths=1,1,1,1", "memory.save_semmap=true"],
    ["centernet.sizes_of_interest=[[0,64],[32,128]]",
     "memory.semmap_dialect=smnet", "semmap_path=/tmp/x",
     "memory.obs_score_thresh=0.25"],
    # pinned knobs named at their pinned values set nothing
    ["centernet.only_proposal=true", "backbone.freeze_at=0",
     "roi.mask_weight=1", "centernet.loc_loss_type=giou",
     "input.format=RGB", "memory.memory_feature_weight=100"],
]
BAD_OPTS = [
    (["centernet.only_proposal=false"], NotImplementedError),
    (["roi.cls_agnostic_mask=0"], NotImplementedError),
    (["centernet.loc_loss_type=iou"], NotImplementedError),
    (["backbone.freeze_at=2"], NotImplementedError),
    (["memory.test_type=weekly"], ValueError),
    (["roi.num_classes=many"], ValueError),
]


@pytest.mark.parametrize("case", range(len(OPTS) + len(BAD_OPTS) + 5))
def test_config_surface_vs_jax(case):
    """`apply_opts` on the same opts, the four presets and an unknown
    one: every shared field equal, the same errors raised."""
    if case < len(OPTS):
        got = tcfg.apply_opts(tcfg.DetectorConfig(), OPTS[case])
        want = jcfg.apply_opts(jcfg.DetectorConfig(), OPTS[case])
        _shared_fields_equal(got, want)
        _shared_fields_equal(want, got)
        return
    case -= len(OPTS)
    if case < len(BAD_OPTS):
        opts, err = BAD_OPTS[case]
        for module in (tcfg, jcfg):
            with pytest.raises(err):
                module.apply_opts(module.DetectorConfig(), opts)
        return
    case -= len(BAD_OPTS)
    names = ("pretrained", "vanilla_training", "detic_finetuned",
             "implicit_object_memory", "golden")
    if names[case] == "golden":
        for module in (tcfg, jcfg):
            with pytest.raises(ValueError, match="unknown parity config"):
                module.parity_config("golden")
        return
    got, want = tcfg.parity_config(names[case]), \
        jcfg.parity_config(names[case])
    _shared_fields_equal(got, want)
    tcfg.check_slice_config(got)


def test_port_config_fields_exist_in_jax():
    """Every field of the port's config is a JAX config field of the same
    default, so a config carries across field by field; the one section
    the JAX config lacks, `detr` (the JAX package builds its
    Deformable-DETR from constructor arguments), holds the JAX
    constructors' own defaults."""
    _shared_fields_equal(tcfg.DetectorConfig(), jcfg.DetectorConfig())

    def names(cfg, prefix=""):
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if dataclasses.is_dataclass(v):
                yield from names(v, f"{prefix}{f.name}.")
            else:
                yield prefix + f.name

    port = {n for n in names(tcfg.DetectorConfig())
            if not n.startswith("detr.")}
    assert port <= set(names(jcfg.DetectorConfig()))
    import inspect
    from embodied_object_detection_tpu.models import deformable_detr as jd
    from embodied_object_detection_tpu_torch.models import (
        deformable_detr as td)
    detr, det = jd.DeformableDETR, jd.DeformableDetrDetector
    d = tcfg.DetectorConfig().detr
    assert (d.hidden_dim, d.heads, d.enc_layers, d.dec_layers,
            d.ffn_dim) == (detr.hidden_dim, detr.heads, detr.enc_layers,
                           detr.dec_layers, detr.ffn)
    # the levels and the points a level: constants of both models
    sig = inspect.signature(td.DeformableDETR.__init__).parameters
    assert (sig["levels"].default, sig["points"].default) == (
        detr.levels, detr.points)
    assert (d.num_queries, d.use_zeroshot, d.with_box_refine,
            d.two_stage) == (det.num_queries, det.use_zeroshot,
                             det.with_box_refine, det.two_stage)
    assert d.test_topk == \
        inspect.signature(jd.detr_inference).parameters["topk"].default


@pytest.mark.parametrize("key", sorted(tcfg.PINNED_OPTS))
def test_pinned_opts_are_jax_defaults_and_no_port_fields(key):
    """Each pinned knob is a JAX config field whose default is its pinned
    value, the port's config has no such field, and `apply_opts` raises
    `NotImplementedError` on any other value (also for `input.format` and
    `memory.memory_feature_weight`, which the JAX package stores and never
    reads)."""
    section, name = key.split(".")
    required, _ = tcfg.PINNED_OPTS[key]
    assert getattr(getattr(jcfg.DetectorConfig(), section), name) == required
    assert not hasattr(getattr(tcfg.DetectorConfig(), section), name)
    other = {bool: "false", int: "3", float: "0.5", str: "BGR",
             tuple: "(4, 8, 16)"}[type(required)]
    with pytest.raises(NotImplementedError, match=key):
        tcfg.apply_opts(tcfg.DetectorConfig(), [f"{key}={other}"])


def test_check_slice_config_validates():
    """A config built in code meets `validate_config` where the model is
    built: an unknown protocol raises there too."""
    cfg = tcfg.DetectorConfig()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                 test_type="weekly"))
    with pytest.raises(ValueError, match="test_type"):
        tcfg.check_slice_config(cfg)


def test_check_slice_config_rejects_res5():
    """`check_slice_config` rejects only what the JAX package rejects: the
    Res5 heads, the Swin-B trunk and every ROIAlign impl pass, as JAX's
    `validate_config` lets them; an impl that is none of the four raises."""
    for opts in (["roi.head_type=res5"], ["backbone.name=swin_b",
                                         "backbone.drop_path_rate=0.3"],
                 ["roi.align_impl=v2"], ["roi.align_impl=v3"]):
        cfg = tcfg.apply_opts(tcfg.DetectorConfig(), opts)
        assert tcfg.check_slice_config(cfg) is cfg
        jcfg.validate_config(jcfg.apply_opts(jcfg.DetectorConfig(), opts))
    cfg = tcfg.apply_opts(tcfg.DetectorConfig(), ["roi.align_impl=v5"])
    with pytest.raises(ValueError, match="align_impl"):
        tcfg.check_slice_config(cfg)


# ----------------------------------------------------------------- semmap

def test_semmap_classes_vs_jax():
    """Class ids equal to JAX's on 512 cells, except where a cell's top
    two logits lie within 1e-5 relative (counted; the f32 products sum
    in another order). Unobserved and weak cells get -1 in both."""
    rng = np.random.RandomState(2)
    cells, d, c = 512, 512, 20
    feats = rng.randn(cells, d).astype(np.float32) * \
        rng.uniform(0, 3, (cells, 1)).astype(np.float32)
    feats[:40] = 0.0
    obs = rng.randint(0, 5, cells).astype(np.float32)
    emb = np.load(CLIP).astype(np.float32)
    zs = np.concatenate([emb.T, np.zeros((d, 1), np.float32)], 1)
    zs /= np.maximum(np.linalg.norm(zs, axis=0, keepdims=True), 1e-12)
    # a cell tied exactly between two classes
    feats[50] = zs[:, 3] + zs[:, 7]
    got = semmap_classes(torch.from_numpy(feats), torch.from_numpy(obs),
                         torch.from_numpy(zs), 0.4).numpy()
    want = np.asarray(jax_semmap_classes(jnp.asarray(feats),
                                         jnp.asarray(obs), jnp.asarray(zs),
                                         0.4))
    assert got.dtype == np.int32 and got.shape == (cells,)
    logits = (50.0 * feats / np.maximum(
        np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)) @ zs[:, :c]
    top2 = -np.sort(-logits, axis=1)[:, :2]
    near = np.abs(top2[:, 0] - top2[:, 1]) <= 1e-5 * np.abs(top2[:, 0])
    differ = got != want
    assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
    # the zero cells (all logits 0, classed -1) and the one made tied
    assert near[:40].all() and near[50] and near[51:].sum() < 4
    assert (got[:40] == -1).all() and (got >= 0).sum() > 100


def test_save_memory_h5_read_by_jax_dataset(root, tmp_path):
    """The snapshot schema: the JAX reader takes the port's file (map_gt
    through the generated-semmap route)."""
    rng = np.random.RandomState(9)
    semmap = rng.randint(-1, 20, 64).astype(np.int32)
    feats = rng.randn(64, 512).astype(np.float32)
    obs = rng.randint(0, 3, 64).astype(np.float32)
    for k in range(2):
        save_memory_h5(str(tmp_path), f"scene0000_lvl0_{k}.h5", semmap,
                       feats, obs)
    ds = jds.EpisodeDataset(root, max_sequence_length=4,
                            semmap_path=str(tmp_path / "memory"),
                            memory_type="map_gt", clip_path=CLIP)
    chunk = ds[0]
    import h5py
    with h5py.File(os.path.join(root, "memory_data", "scene0000_lvl0_0.h5"),
                   "r") as f:
        raw = np.array(f["proj_indices"])[..., 0]
    assert np.array_equal(chunk.proj_indices[:4], (semmap + 1)[raw])
    plain = jds.EpisodeDataset(root, max_sequence_length=4,
                               semmap_path=str(tmp_path / "memory"))[1]
    assert np.array_equal(plain.memory_features, feats)
    assert np.array_equal(plain.observations, obs)


# --------------------------------------------------------------- prefetch

@pytest.mark.parametrize("workers", [1, 3, 8])
def test_prefetch_keeps_order(workers):
    """Items that finish out of order are yielded in order, with more
    workers than items too; every fetch runs once."""
    calls = []
    lock = threading.Lock()

    def fetch(i):
        time.sleep(0.002 * ((7 * i) % 5))
        with lock:
            calls.append(i)
        return i * i

    got = list(prefetch_iterator(fetch, range(6), num_workers=workers,
                                 buffer=3))
    assert got == [i * i for i in range(6)]
    assert sorted(calls) == list(range(6))


def test_prefetch_without_workers_is_synchronous():
    """With no workers each item is fetched in the caller's thread when it
    is asked for, not before."""
    seen = []

    def fetch(i):
        seen.append((i, threading.current_thread() is
                     threading.main_thread()))
        return i

    it = prefetch_iterator(fetch, range(3), num_workers=0)
    assert seen == []
    assert next(it) == 0 and seen == [(0, True)]
    assert next(it) == 1 and seen == [(0, True), (1, True)]
    assert list(it) == [2]
