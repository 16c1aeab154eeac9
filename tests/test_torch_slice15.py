"""Slice 15's host side against the JAX package, on the CPU: the
single-frame and multi-source data path, the OID evaluator, the CLI's
COCO training batches, and the co-training losses.

No JAX model is built; the losses run through JAX op by op. Checked, each
at its stated tolerance:

  * exact: catalog items (a PNG at the target size, a JPEG turned by its
    EXIF orientation and resized, a smaller PNG resized, crowd and
    overflowing annotations, captions and pos / neg category ids, raw and
    remapped ids), the registered entry left as it was, the built-in
    registrations, repeat factors (box and tag-only), the sampler's
    draws, the resize-crop and the mapper for the same RandomState, tar
    indexes and payloads (PAX and GNU long names, a gzip member, a broken
    member), every case of tests/test_oid_eval.py, `items_to_train_batch`,
    `multi_source_train_batches` over 12 draws of the four ann types, and
    the CLI's epoch-sampler batches and label-space guard with both
    packages' steps replaced by recorders
  * rtol 1e-6: `image_label_loss` in every variant, with ties in area and
    in score, its selected rows equal to the JAX formulas' (first index
    on ties)
  * rtol 1e-5: `caption_loss` with padding rows masked
"""

import dataclasses
import gzip
import io
import json
import tarfile
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu import run as jrun
from embodied_object_detection_tpu.data import augment as jaug
from embodied_object_detection_tpu.data import catalog as jcat
from embodied_object_detection_tpu.data import tar_dataset as jtar
from embodied_object_detection_tpu.engine import coco as jcoco
from embodied_object_detection_tpu.engine import train as jtrain
from embodied_object_detection_tpu.evaluation import oid_eval as joid
from embodied_object_detection_tpu.models import losses as jlosses

from embodied_object_detection_tpu_torch import run as trun
from embodied_object_detection_tpu_torch.data import augment as taug
from embodied_object_detection_tpu_torch.data import catalog as tcat
from embodied_object_detection_tpu_torch.data import tar_dataset as ttar
from embodied_object_detection_tpu_torch.engine import coco as tcoco
from embodied_object_detection_tpu_torch.engine import train as ttrain
from embodied_object_detection_tpu_torch.evaluation import oid_eval as toid
from embodied_object_detection_tpu_torch.models import losses as tlosses
from embodied_object_detection_tpu_torch.parallel.train_step import (
    TrainState)

from test_torch_frame import _jax_config, _port_config

H, W = 64, 96


def stand_in_caption_embedding(captions, dim: int = 512) -> np.ndarray:
    """[B, dim] f32: a cheap seeded caption embedder for the data-path
    tests, in place of the CLIP text tower: one unit vector a caption,
    drawn from a RandomState seeded by the caption's CRC-32, so that a
    caption embeds alike in every process."""
    out = np.zeros((len(captions), dim), np.float32)
    for i, c in enumerate(captions):
        v = np.random.RandomState(zlib.crc32(c.encode())).randn(dim)
        out[i] = v / np.linalg.norm(v)
    return out


embed = stand_in_caption_embedding


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def _save_png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """Five images: a PNG at 64x96, a JPEG 40x60 stored turned (EXIF
    orientation 6: its decode is 60x40, then resized), a PNG 50x80
    (resized to 60x96), an image without annotations that carries tags and
    captions, and one with more annotations than max_gt; category ids 3,
    7, 11 (1-based, non-contiguous), one crowd annotation."""
    from PIL import Image
    root = tmp_path_factory.mktemp("coco15")
    img = root / "img"
    img.mkdir()
    rng = np.random.RandomState(0)
    _save_png(img / "a.png", rng.randint(0, 255, (64, 96, 3), np.uint8))
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(rng.randint(0, 255, (40, 60, 3), np.uint8)).save(
        img / "b.jpg", exif=exif)
    _save_png(img / "c.png", rng.randint(0, 255, (50, 80, 3), np.uint8))
    _save_png(img / "d.png", rng.randint(0, 255, (30, 30, 3), np.uint8))
    _save_png(img / "e.png", rng.randint(0, 255, (64, 96, 3), np.uint8))
    images = [
        dict(id=1, file_name="a.png", height=64, width=96),
        dict(id=2, file_name="b.jpg", height=60, width=40,
             neg_category_ids=[11]),
        dict(id=3, file_name="c.png", height=50, width=80,
             captions=["a red chair", "a chair by a wall"]),
        dict(id=4, file_name="d.png", height=30, width=30,
             pos_category_ids=[7, 3], captions=["two things"]),
        dict(id=5, file_name="e.png", height=64, width=96)]
    anns, aid = [], 1
    for im_id, boxes in ((1, [[4.5, 6, 30, 20, 3], [50, 10, 20.25, 30, 7]]),
                         (2, [[2, 3, 20, 30, 11]]),
                         (3, [[10, 10, 40, 20, 7], [0, 0, 80, 50, 3]]),
                         (5, [[i, i, 10, 10, (3, 7, 11)[i % 3]]
                              for i in range(10)])):
        for x, y, w, h, c in boxes:
            anns.append(dict(id=aid, image_id=im_id, category_id=c,
                             bbox=[x, y, w, h], iscrowd=0, area=w * h))
            aid += 1
    anns.append(dict(id=aid, image_id=1, category_id=11, bbox=[0, 0, 5, 5],
                     iscrowd=1, area=25))
    cats = [dict(id=c, name=n) for c, n in ((11, "lamp"), (3, "chair"),
                                            (7, "table"))]
    path = root / "ann.json"
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=cats)))
    tags = root / "tags.json"
    tags.write_text(json.dumps(dict(
        images=[dict(id=i, file_name=f, height=30, width=30,
                     pos_category_ids=p, captions=[f"cap {i}"])
                for i, (f, p) in enumerate([("d.png", [3]),
                                            ("d.png", [3, 7]),
                                            ("d.png", [11]),
                                            ("d.png", [])])],
        annotations=[], categories=cats)))
    return str(path), str(img), str(tags)


@pytest.mark.parametrize("remap", [True, False])
def test_coco_dataset_items_vs_jax(coco_root, remap, capsys):
    path, img, _ = coco_root
    kw = dict(height=H, width=W, max_gt=8, remap_ids=remap)
    j = jcat.CocoDetectionDataset(jcat.DatasetEntry(path, img), **kw)
    t = tcat.CocoDetectionDataset(tcat.DatasetEntry(path, img), **kw)
    assert t.ids == j.ids and len(t) == 5
    assert t.entry.id_map == j.entry.id_map
    assert t.entry.thing_classes == j.entry.thing_classes
    assert t.entry.class_image_count == j.entry.class_image_count
    for i in range(len(j)):
        want = j[i]
        want_log = capsys.readouterr().out
        got = t[i]
        assert capsys.readouterr().out == want_log
        _assert_items_equal(got, want)
    assert "annotations exceed max_gt=8" in want_log
    assert t[1]["orig_hw"] == (60, 40) and t[2]["scale"] == 1.2


def test_registered_entry_is_not_mutated(coco_root):
    path, img, _ = coco_root
    for cat in (jcat, tcat):
        vendored = cat.DatasetEntry(path, img, thing_classes=["x", "y", "z"],
                                    id_map={0: 0}, class_image_count={0: 9})
        cat.register_dataset("slice15_vendored", vendored)
        empty = cat.DatasetEntry(path, img)
        cat.register_dataset("slice15_empty", empty)
        for name in ("slice15_vendored", "slice15_empty"):
            cat.CocoDetectionDataset(name, height=H, width=W)
        assert vendored.thing_classes == ["x", "y", "z"]
        assert vendored.id_map == {0: 0}
        assert vendored.class_image_count == {0: 9}
        assert empty.thing_classes == ["chair", "table", "lamp"]
        assert empty.id_map == {}


def test_builtin_registrations_vs_jax():
    jcat.register_builtin_datasets("datasets")
    tcat.register_builtin_datasets("datasets")
    names = jcat.list_datasets()
    assert set(names) <= set(tcat.list_datasets())
    for name in names:
        if name.startswith("slice15") or name == "unit_coco":
            continue
        assert dataclasses.asdict(tcat.get_dataset(name)) == \
            dataclasses.asdict(jcat.get_dataset(name)), name
    assert len(tcat.get_dataset("lvis_v1_val").thing_classes) == 1203


def test_repeat_factors_and_sampler_vs_jax(coco_root):
    path, img, tags = coco_root
    pairs = []
    for js in (path, tags):
        pairs.append((jcat.CocoDetectionDataset(jcat.DatasetEntry(js, img),
                                                height=H, width=W),
                      tcat.CocoDetectionDataset(tcat.DatasetEntry(js, img),
                                                height=H, width=W)))
    for thresh in (0.9, 0.5, 0.001):
        for j, t in pairs:
            got = t.class_repeat_factors(thresh)
            np.testing.assert_array_equal(got, j.class_repeat_factors(thresh))
    # the tag-only dataset's factors come from pos_category_ids
    assert pairs[1][1].class_repeat_factors(0.9).max() > 1.0
    for use_rfs in (None, [True, True], [False, True]):
        js = jcat.MultiDatasetSampler([p[0] for p in pairs], [3.0, 1.0],
                                      use_rfs=use_rfs, repeat_thresh=0.9,
                                      seed=4)
        ts = tcat.MultiDatasetSampler([p[1] for p in pairs], [3.0, 1.0],
                                      use_rfs=use_rfs, repeat_thresh=0.9,
                                      seed=4)
        assert ts.sample(40) == js.sample(40)
        for _ in range(5):
            d = ts.sample_source()
            assert d == js.sample_source()
            assert ts.sample_items(d, 3) == js.sample_items(d, 3)


def test_resize_crop_vs_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(0, 300, (6, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    for seed, hw, size, scale in ((0, (240, 320), 128, (0.1, 2.0)),
                                  (1, (90, 60), 96, (1.5, 2.0)),
                                  (2, (320, 240), 64, (0.5, 0.5))):
        pj = jaug.sample_efficientdet_resize_crop(
            hw, size, scale, np.random.RandomState(seed))
        pt = taug.sample_efficientdet_resize_crop(
            hw, size, scale, np.random.RandomState(seed))
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        image = rng.randint(0, 255, hw + (3,), np.uint8)
        for nearest in (False, True):
            np.testing.assert_array_equal(
                taug.apply_resize_crop_image(image, pt, nearest),
                jaug.apply_resize_crop_image(image, pj, nearest))
        fwd = taug.apply_resize_crop_boxes(boxes, pt)
        np.testing.assert_array_equal(fwd,
                                      jaug.apply_resize_crop_boxes(boxes, pj))
        np.testing.assert_array_equal(
            taug.inverse_apply_resize_crop_boxes(fwd, pt),
            jaug.inverse_apply_resize_crop_boxes(fwd, pj))


def _make_tar(path, values, fmt, long_names=False, gzip_last=False,
              broken=False):
    from PIL import Image
    with tarfile.open(path, "w", format=fmt) as tf:
        for i, v in enumerate(values):
            buf = io.BytesIO()
            Image.fromarray(np.full((16, 24, 3), v, np.uint8)).save(
                buf, format="JPEG")
            data = buf.getvalue()
            if gzip_last and i == len(values) - 1:
                data = gzip.compress(data)
            if broken and i == 0:
                data = b"not an image"
            name = ("n" * 120 if long_names else "syn") + f"/img_{i}.JPEG"
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("fmt", [tarfile.PAX_FORMAT, tarfile.GNU_FORMAT])
def test_tar_dataset_vs_jax(tmp_path, fmt):
    tars = []
    for s, kw in enumerate([dict(long_names=True), dict(gzip_last=True),
                            dict(), dict(broken=True)]):
        p = str(tmp_path / f"syn{s}.tar")
        _make_tar(p, [30 * s + 10 * i for i in range(s + 1 if s != 2
                                                      else 0)] or [5], fmt,
                  **kw)
        tars.append(p)
    listing = str(tmp_path / "tars.npy")
    np.save(listing, np.asarray(tars))
    for i, p in enumerate(tars):
        jn, jo = jtar.build_tar_index(p, str(tmp_path / "j"))
        tn, to = ttar.build_tar_index(p, str(tmp_path / "t"))
        np.testing.assert_array_equal(np.load(tn), np.load(jn))
        np.testing.assert_array_equal(np.load(to), np.load(jo))
        data = np.fromfile(p, np.uint8)
        for ofs in np.load(to)[:-1]:
            assert ttar.tar_member_payload(data[ofs * 512:]) == \
                jtar.tar_member_payload(data[ofs * 512:])
    j = jtar.DiskTarDataset(listing, str(tmp_path / "j"))
    t = ttar.DiskTarDataset(listing, str(tmp_path / "t"))
    assert len(t) == len(j) and repr(t) == repr(j)
    labels = []
    for i in range(len(j)):
        gi, gl, gx = t[i]
        wi, wl, wx = j[i]
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        assert (gl, gx) == (wl, wx)
        labels.append(gl)
    assert -1 in labels and labels.count(0) == 1


def _box(x, y, w, h):
    return [x, y, x + w, y + h]


def _oid_perfect(m):
    ev = m.OIDEvaluator([0, 1])
    ev.add_image(0, pos_category_ids=[0])
    ev.add_ground_truth(0, np.array([_box(0, 0, 10, 10)]), np.array([0]))
    ev.add_detections(0, np.array([_box(0, 0, 10, 10)]), np.array([0.9]),
                      np.array([0]))
    return ev.evaluate()


def _oid_unverified(m):
    ev = m.OIDEvaluator([0, 1])
    ev.add_image(0, pos_category_ids=[0], neg_category_ids=[])
    ev.add_ground_truth(0, np.array([_box(0, 0, 10, 10)]), np.array([0]))
    ev.add_detections(0, np.array([_box(0, 0, 10, 10), _box(50, 50, 10, 10)]),
                      np.array([0.9, 0.95]), np.array([0, 1]))
    return ev.evaluate()


def _oid_negative(m):
    ev = m.OIDEvaluator([0, 1])
    ev.add_image(0, pos_category_ids=[0], neg_category_ids=[1])
    ev.add_ground_truth(0, np.array([_box(0, 0, 10, 10)]), np.array([0]))
    ev.add_image(1, pos_category_ids=[1])
    ev.add_ground_truth(1, np.array([_box(0, 0, 10, 10)]), np.array([1]))
    ev.add_detections(0, np.array([_box(0, 0, 10, 10), _box(5, 5, 10, 10)]),
                      np.array([0.9, 0.95]), np.array([0, 1]))
    ev.add_detections(1, np.array([_box(0, 0, 10, 10)]), np.array([0.5]),
                      np.array([1]))
    return ev.evaluate()


def _oid_group_of(m):
    ev = m.OIDEvaluator([0])
    ev.add_image(0, pos_category_ids=[0])
    ev.add_ground_truth(0, np.array([_box(0, 0, 100, 100)]), np.array([0]),
                        group_of=np.array([True]))
    ev.add_detections(0, np.array([_box(10, 10, 20, 20),
                                   _box(50, 50, 20, 20)]),
                      np.array([0.8, 0.7]), np.array([0]))
    return ev.evaluate()


def _oid_hierarchy(m):
    hierarchy = {"LabelName": "root", "Subcategory": [
        {"LabelName": "/m/animal", "Subcategory": [
            {"LabelName": "/m/dog"}]}]}
    parents = m.hierarchy_parent_map(hierarchy, {"/m/animal": 1,
                                                 "/m/dog": 2, "root": 0})
    ev = m.OIDEvaluator([1, 2], hierarchy_parents=parents,
                        expand_pred_label=True)
    ev.add_image(0, pos_category_ids=[1, 2])
    ev.add_ground_truth(0, np.array([_box(0, 0, 10, 10),
                                     _box(0, 0, 10, 10)]), np.array([1, 2]))
    ev.add_detections(0, np.array([_box(0, 0, 10, 10)]), np.array([0.9]),
                      np.array([2]))
    return {"parents": parents, **ev.evaluate()}


def _oid_order(m):
    out = {}
    for dets_first in (True, False):
        ev = m.OIDEvaluator([0])
        box = np.array([_box(10, 10, 40, 40)])
        if dets_first:
            ev.add_detections(0, box, np.array([0.9]), np.array([0]))
            ev.add_image(0, pos_category_ids=[0])
        else:
            ev.add_image(0, pos_category_ids=[0])
            ev.add_detections(0, box, np.array([0.9]), np.array([0]))
        ev.add_ground_truth(0, box, np.array([0]))
        out[dets_first] = ev.evaluate()
    return out


def _oid_union(m):
    ev = m.OIDEvaluator([0, 1])
    ev.add_image(0, pos_category_ids=[0])
    ev.add_image(0, pos_category_ids=[1], neg_category_ids=[])
    box = np.array([_box(10, 10, 40, 40)])
    ev.add_ground_truth(0, box, np.array([0]))
    ev.add_detections(0, box, np.array([0.9]), np.array([0]))
    return {"pos": ev._pos, **ev.evaluate()}


def _oid_voc(m):
    return {"ap": m.voc_average_precision(np.array([1.0, 1.0]),
                                          np.array([0.5, 1.0])),
            "empty": m.voc_average_precision(np.zeros(0), np.zeros(0)),
            "ragged": m.voc_average_precision(np.array([1.0, 0.5, 0.67]),
                                              np.array([0.3, 0.3, 0.6]))}


def _oid_random(m):
    """Many images, classes, groups and negatives at once."""
    rng = np.random.RandomState(8)
    ev = m.OIDEvaluator(list(range(4)), category_names=list("abcd"))
    for img in range(6):
        ev.add_image(img, pos_category_ids=list(rng.choice(4, 2, False)),
                     neg_category_ids=[int(rng.randint(4))])
        g = rng.uniform(0, 50, (5, 2))
        gt = np.concatenate([g, g + rng.uniform(5, 40, (5, 2))], 1)
        ev.add_ground_truth(img, gt, rng.randint(0, 4, 5),
                            group_of=rng.rand(5) < 0.3)
        d = gt[rng.randint(0, 5, 8)] + rng.normal(0, 4, (8, 4))
        ev.add_detections(img, d, rng.rand(8), rng.randint(0, 4, 8))
    return ev.evaluate()


OID_CASES = {f.__name__[5:]: f for f in (
    _oid_voc, _oid_perfect, _oid_unverified, _oid_negative, _oid_group_of,
    _oid_hierarchy, _oid_order, _oid_union, _oid_random)}


@pytest.mark.parametrize("case", sorted(OID_CASES))
def test_oid_eval_vs_jax(case):
    assert OID_CASES[case](toid) == OID_CASES[case](joid)


def test_items_to_train_batch_vs_jax(coco_root):
    path, img, _ = coco_root
    cfg = _jax_config()
    j = jcat.CocoDetectionDataset(jcat.DatasetEntry(path, img), height=H,
                                  width=W, max_gt=8)
    t = tcat.CocoDetectionDataset(tcat.DatasetEntry(path, img), height=H,
                                  width=W, max_gt=8)
    for idx, pad in (([0, 1, 2], 1), ([3, 4], 4)):
        want = jcoco.items_to_train_batch([j[i] for i in idx], cfg, pad)
        got = tcoco.items_to_train_batch([t[i] for i in idx],
                                         _port_config(cfg), pad)
        for field in want._fields:
            w, g = getattr(want, field), getattr(got, field)
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


class _Items:
    """A dataset of prepared items (the mapper's or the catalog's)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _sources(coco_root, mapper_module, cat):
    """Four sources, one of each ann type: catalog box items, mapper
    image-label items (fixed labels), catalog caption items and catalog
    caption + tag items (ragged pos_category_ids, a caption-less one)."""
    path, img, tags = coco_root
    box = cat.CocoDetectionDataset(cat.DatasetEntry(path, img), height=H,
                                   width=W, max_gt=8)
    tagged = cat.CocoDetectionDataset(cat.DatasetEntry(tags, img),
                                      height=H, width=W, max_gt=8)
    mapper = mapper_module.MultiSourceMapper(
        [(0.8, 1.2)], [H], ["image"], max_gt=8, max_labels=3, seed=2)
    rng = np.random.RandomState(1)
    image = _Items([mapper(dict(image=rng.randint(0, 255, (50, 70, 3),
                                                   np.uint8),
                                pos_category_ids=[1, 2, 0][:k + 1]), 0)
                    for k in range(3)])
    caption = _Items([dict(box[i], image=box[i]["image"]) for i in (2, 3)])
    captiontag = _Items([dict(tagged[i], captions=tagged[i]["captions"]
                              if i else []) for i in range(4)])
    return [box, image, caption, captiontag]


def test_multi_source_batches_vs_jax(coco_root):
    cfg = _jax_config()
    # the mapper's images are square (size H): the image source's batches
    # carry them as they are
    kinds = ["box", "image", "caption", "captiontag"]
    streams = []
    for mapper_module, cat, coco in ((jaug, jcat, jcoco),
                                     (taug, tcat, tcoco)):
        srcs = _sources(coco_root, mapper_module, cat)
        sampler = cat.MultiDatasetSampler(srcs, [1.0, 1.0, 1.0, 1.0], seed=5)
        streams.append(coco.multi_source_train_batches(
            sampler, srcs, kinds, cfg if coco is jcoco else _port_config(cfg),
            batch_size=2, embed_fn=embed, seed=7))
    seen = set()
    for _ in range(12):
        (kj, bj), (kt, bt) = next(streams[0]), next(streams[1])
        assert kt == kj
        seen.add(kt)
        for w, g in zip(bj, bt):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert seen == set(kinds)


def test_caption_items_to_batch_vs_jax(coco_root):
    srcs = _sources(coco_root, taug, tcat)
    items = [srcs[3][i] for i in range(4)]
    got = tcoco.caption_items_to_batch(items, embed,
                                       np.random.RandomState(3))
    want = jcoco.caption_items_to_batch(items, embed,
                                        np.random.RandomState(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].tolist() == [0.0, 1.0, 1.0, 1.0]
    assert np.array_equal(embed(["x"]), embed(["x"]))


CLI_OPTS = ["compute_dtype=float32", "backbone.depths=(1,1,1,1)",
            "input.height=64", "input.width=96", "input.max_gt_boxes=8",
            "roi.num_classes=12", "memory.max_cells=64",
            "solver.ims_per_batch=2", "solver.checkpoint_period=100"]


def _cli_batches(monkeypatch, tmp_path, argv, iters):
    """The training batches both CLIs feed their steps over `iters`
    iterations, both steps and checkpoints replaced by recorders and the
    JAX model by nothing."""
    seen_j, seen_t = [], []

    class NoCheckpoints:
        def __init__(self, *a):
            pass

        def step(self, it, state):
            pass

    def jax_step(state, batch, zs):
        seen_j.append(jax.tree_util.tree_map(np.asarray, batch))
        return state, {"total_loss": 0.0}

    monkeypatch.setattr("embodied_object_detection_tpu.models.detector."
                        "build_detector", lambda cfg, key: (None, {}))
    real_mesh = jtrain.make_mesh
    monkeypatch.setattr(jtrain, "make_mesh", lambda p: real_mesh(
        p, devices=jax.devices()[:1]))
    monkeypatch.setattr(jtrain, "make_train_step", lambda m, c, **k: (
        lambda params: ({"step": 0}, None), None))
    monkeypatch.setattr(jtrain, "jit_train_step", lambda fn, mesh: jax_step)
    monkeypatch.setattr(jtrain, "PeriodicCheckpointer", NoCheckpoints)
    common = argv + ["--zs-weight", "random", "--max-iter", str(iters)]
    jrun.main(common + ["--output-dir", str(tmp_path / "jax"), "--opts"] +
              CLI_OPTS)

    class Opt:
        def lr(self, it):
            return 0.0

    def port_step(state, batch, zs):
        seen_t.append(batch)
        return state._replace(step=state.step + 1), {
            "total_loss": torch.zeros(())}

    monkeypatch.setattr(ttrain, "make_train_step", lambda m, c, **k: (
        lambda: TrainState(model=m, optimizer=Opt(), step=0), port_step))
    monkeypatch.setattr(ttrain, "PeriodicCheckpointer", NoCheckpoints)
    trun.main(["--device", "cpu", "--output-dir", str(tmp_path / "port")] +
              common + ["--opts"] + CLI_OPTS)
    return seen_j, seen_t


@pytest.mark.parametrize("lvis", [False, True])
def test_cli_coco_batches_vs_jax(coco_root, tmp_path, monkeypatch, lvis):
    """`run.py --coco-json` feeds `engine/train.py:train` the JAX CLI's
    batches bit for bit over 6 iterations: epochs of 2 batches of 2 out
    of 5 images, each epoch's own permutation (raw ids 3-11 fit the 12
    classes; with --lvis-eval they are remapped to 0-2)."""
    path, img, _ = coco_root
    argv = ["--coco-json", path, "--image-root", img] + \
        (["--lvis-eval"] if lvis else [])
    seen_j, seen_t = _cli_batches(monkeypatch, tmp_path, argv, 6)
    assert len(seen_j) == len(seen_t) == 6
    for bj, bt in zip(seen_j, seen_t):
        for field in bt._fields:
            if getattr(bj, field) is None:
                assert getattr(bt, field) is None
                continue
            np.testing.assert_array_equal(getattr(bt, field).numpy(),
                                          getattr(bj, field), err_msg=field)
    classes = np.concatenate([b.gt_classes[b.gt_valid] for b in seen_j])
    assert classes.max() == (2 if lvis else 11)
    assert trun.coco_epoch_indices(0, 5, 2, None).tolist() == \
        np.random.RandomState(np.random.SeedSequence([0x5EED, 0]).
                              generate_state(1)[0]).permutation(5)[:2].tolist()


def test_cli_coco_label_space_guard(coco_root, tmp_path, monkeypatch):
    """Raw ids beyond roi.num_classes stop both CLIs before a step."""
    path, img, _ = coco_root
    argv = ["--coco-json", path, "--image-root", img, "--zs-weight",
            "random", "--max-iter", "1"]
    opts = [o for o in CLI_OPTS if not o.startswith("roi.num_classes")] + \
        ["roi.num_classes=5"]
    monkeypatch.setattr("embodied_object_detection_tpu.models.detector."
                        "build_detector", lambda cfg, key: (None, {}))
    with pytest.raises(SystemExit, match="max category id 11"):
        jrun.main(argv + ["--output-dir", str(tmp_path / "j"), "--opts"] +
                  opts)
    with pytest.raises(SystemExit, match="max category id 11"):
        trun.main(["--device", "cpu", "--output-dir", str(tmp_path / "t")] +
                  argv + ["--opts"] + opts)


# ------------------------------------------------------------------ losses

def _label_case(variant, rng):
    """12 proposals (the last the whole-image box) of 6 classes, two
    invalid rows; rows 2 and 5 tie in area (the largest), rows 1 and 4
    tie in every logit, class 3's the largest; labels 3, 0, 5, a padded one, 3."""
    r, c = 12, 5
    logits = rng.randn(r, c + 1).astype(np.float32) * 3
    logits[1, 3] = 9.0
    logits[4] = logits[1]
    boxes = rng.uniform(0, 40, (r, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(1, 30, (r, 2))
    boxes[2] = [0, 0, 50, 40]
    boxes[5] = [10, 5, 50, 55]
    boxes[-1] = [0, 0, 96, 64]
    valid = np.ones(r, bool)
    valid[[7, 9]] = False
    labels = np.array([3, 0, 5, 1, 3], np.int32)
    lv = np.array([True, True, True, False, True])
    prop = rng.randn(r, c + 1).astype(np.float32)
    return logits, boxes, valid, labels, lv, prop, c


def _want_selection(variant, logits, boxes, valid, labels, c):
    """The JAX formulas' rows in numpy (np.argmax / argmin take the first
    of ties, as jnp's)."""
    r = logits.shape[0]
    if variant == "max_size":
        area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
            np.maximum(boxes[:, 3] - boxes[:, 1], 0)
        area = np.where(valid, area, -1.0)
        area[r - 1] = -1.0
        return np.full(len(labels), np.argmax(area))
    if variant == "max_score":
        return np.argmax(np.where(valid[:, None], logits[:, labels], -1e10),
                         axis=0)
    if variant == "first":
        return np.zeros(len(labels), int)
    if variant == "image":
        return np.full(len(labels), r - 1)
    t = np.eye(c + 1)[labels][:, None]
    x = logits[None].astype(np.float64)
    bce = np.maximum(x, 0) - x * t + np.log1p(np.exp(-np.abs(x)))
    return np.argmin(np.where(valid[None], bce.sum(-1), 1e10), axis=1)


@pytest.mark.parametrize("variant", tlosses.IMAGE_LABEL_VARIANTS)
def test_image_label_loss_vs_jax(variant):
    rng = np.random.RandomState(11)
    logits, boxes, valid, labels, lv, prop, c = _label_case(variant, rng)
    args = (logits, boxes, valid, labels, lv)
    want = float(jlosses.image_label_loss(
        *map(jnp.asarray, args), c, variant=variant, image_loss_weight=0.3,
        prop_logits=jnp.asarray(prop)))
    t_args = [torch.from_numpy(a) for a in args]
    got = tlosses.image_label_loss(*t_args, c, variant=variant,
                                   image_loss_weight=0.3,
                                   prop_logits=torch.from_numpy(prop))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    if variant not in ("wsddn", "wsod"):
        sel = tlosses.image_label_selection(t_args[0], t_args[1], t_args[2],
                                            t_args[3], c, variant)
        np.testing.assert_array_equal(
            sel.numpy(), _want_selection(variant, logits, boxes, valid,
                                         labels, c))
        if variant == "max_size":
            assert int(sel[0]) == 2          # the first of the tied areas
        if variant == "max_score":
            assert int(sel[0]) == int(sel[4]) == 1   # the first of the tie


def test_image_label_loss_rejects_unknown_variant():
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="variant"):
        tlosses.image_label_loss(x, torch.zeros((2, 4)),
                                 torch.ones(2, dtype=torch.bool),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.bool), 2,
                                 variant="max")
    with pytest.raises(ValueError, match="softmax-prop"):
        tlosses.image_label_loss(x, torch.zeros((2, 4)),
                                 torch.ones(2, dtype=torch.bool),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.bool), 2,
                                 variant="wsddn")


@pytest.mark.parametrize("index", [0, 2, 3])
def test_caption_loss_vs_jax(index):
    rng = np.random.RandomState(index)
    regions = rng.randn(5, 16).astype(np.float32)
    caps = rng.randn(4, 16).astype(np.float32)
    cv = np.array([True, False, True, True])
    for valid in (None, cv):
        want = float(jlosses.caption_loss(
            jnp.asarray(regions), jnp.asarray(caps), index, 50.0, 0.125,
            caption_valid=None if valid is None else jnp.asarray(valid)))
        got = float(tlosses.caption_loss(
            torch.from_numpy(regions), torch.from_numpy(caps), index, 50.0,
            0.125, caption_valid=None if valid is None
            else torch.from_numpy(valid)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
