"""Slice 19's dataset-prep tools against the repository's
`tools/dataset_prep.py`, on the CPU.

Every subcommand of `embodied_object_detection_tpu_torch.tools.dataset_prep`
runs on the same inputs as the JAX package's tool and must give an equal
json or `.npy` (exactly: both are host code over the same vendored
tables), as a function and through its CLI:

  * cat-info on tests/test_dataset_prep.py's counts and a seeded table
  * merge-lvis-coco on that file's three cases and a seeded pair of jsons
    over real COCO synsets, both reading the vendored synset table
  * imagenet-tar-json on two tar directories (the jsons and the written
    member indexes equal)
  * cc-tags on that file's captions, flags and the COCO-style table that
    takes its synonyms from the vendored synset and LVIS tables
  * remove-rare and coco-zeroshot-oriorder
  * clip-features: a seeded CLIP checkpoint at CLIP-B's shapes (the JAX
    tower has no other) and a merges table learned from the LVIS names,
    through each package's `load_default_text_encoder` and
    `clip_features`, within 1e-5 of the largest element
  * the CLI's subcommands and flags equal the tool's, plus `--device`
"""

import contextlib
import importlib.util
import io
import json
import re
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_slice16_text import _perturbed_sd

from embodied_object_detection_tpu_torch.tools import dataset_prep as tprep

REPO = Path(__file__).resolve().parents[1]


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_dataset_prep", REPO / "tools" / "dataset_prep.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jprep = _load_jax_tool()
SUBCOMMANDS = ("cat-info", "clip-features", "merge-lvis-coco",
               "imagenet-tar-json", "cc-tags", "remove-rare",
               "coco-zeroshot-oriorder")


def _read(path):
    return json.loads(Path(path).read_text())


def _write(path, obj):
    Path(path).write_text(json.dumps(obj))
    return str(path)


def _run_both(tmp_path, argv_of):
    """Each package's CLI on `argv_of(side)` with side "jax" / "port", in
    a directory of its own; returns the two directories."""
    dirs = {}
    for side, main in (("jax", jprep.main), ("port", tprep.main)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv_of(d)) == 0
        dirs[side] = d
    return dirs["jax"], dirs["port"]


# ----------------------------------------------------------------- cat-info

def _cat_ann(seed=None):
    if seed is None:        # tests/test_dataset_prep.py:18
        return {"categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"},
                               {"id": 3, "name": "c"}],
                "annotations": ([{"category_id": 1, "image_id": i}
                                 for i in range(200)]
                                + [{"category_id": 2, "image_id": i}
                                   for i in range(50)]
                                + [{"category_id": 3, "image_id": 0},
                                   {"category_id": 3, "image_id": 0}])}
    rng = np.random.RandomState(seed)
    cats = [{"id": int(i), "name": f"c{i}"} for i in range(1, 41)]
    anns = [{"category_id": int(rng.randint(1, 41)),
             "image_id": int(rng.randint(0, 300))}
            for _ in range(int(rng.randint(500, 3000)))]
    return {"categories": cats, "annotations": anns}


@pytest.mark.parametrize("seed", [None, 1])
@pytest.mark.parametrize("add_freq,r,c", [(True, 10, 100), (False, 10, 100),
                                          (True, 3, 40)])
def test_cat_info_vs_jax(tmp_path, seed, add_freq, r, c):
    ann = _cat_ann(seed)
    want = jprep.cat_info(_write(tmp_path / "j.json", ann), add_freq, r, c)
    got = tprep.cat_info(_write(tmp_path / "p.json", ann), add_freq, r, c)
    assert got == want
    assert _read(tmp_path / "p_cat_info.json") == \
        _read(tmp_path / "j_cat_info.json")


def test_cat_info_cli_vs_jax(tmp_path):
    ann = _cat_ann(2)
    jdir, pdir = _run_both(tmp_path, lambda d: [
        "cat-info", "--ann", _write(d / "ann.json", ann), "--add-freq",
        "--r-thresh", "4", "--c-thresh", "30", "--out", str(d / "out.json")])
    assert _read(pdir / "out.json") == _read(jdir / "out.json")


# ---------------------------------------------------------- merge-lvis-coco

def _merge_cases():
    """tests/test_dataset_prep.py's three merges (:90 and the two after
    it); each reads the vendored synset table."""
    lvis = {"categories": [{"id": 100, "name": "person",
                            "synset": "person.n.01"},
                           {"id": 200, "name": "cat", "synset": "cat.n.01"}],
            "images": [{"id": 1, "coco_url": "http://x/000000000001.jpg",
                        "neg_category_ids": [200]}],
            "annotations": [{"id": 1, "image_id": 1, "category_id": 100,
                             "bbox": [10, 10, 20, 20]}]}
    coco = {"categories": [{"id": 1, "name": "person"},
                           {"id": 17, "name": "cat"}],
            "images": [{"id": 5, "file_name": "000000000001.jpg"}],
            "annotations": [{"id": 9, "image_id": 5, "category_id": 1,
                             "bbox": [10, 10, 20, 20]},
                            {"id": 10, "image_id": 5, "category_id": 1,
                             "bbox": [100, 100, 30, 30]},
                            {"id": 11, "image_id": 5, "category_id": 17,
                             "bbox": [50, 50, 10, 10]}]}
    no_pos = {"categories": lvis["categories"][:1],
              "images": [dict(lvis["images"][0], neg_category_ids=[])],
              "annotations": []}
    cross = dict(no_pos, categories=lvis["categories"],
                 annotations=[{"id": 1, "image_id": 1, "category_id": 200,
                               "bbox": [10, 10, 20, 20]}])
    coco1 = dict(coco, annotations=coco["annotations"][:1])
    return {"basic": (coco, lvis), "no_positives": (coco1, no_pos),
            "cross_category": (coco1, cross)}


def _seeded_merge(seed=3, n_images=30):
    """LVIS and COCO jsons over 12 real COCO synsets of the vendored table
    (LVIS ids shuffled), images matched by file name, boxes jittered from
    shared ones so that both duplicates and cross-category overlaps
    occur."""
    rng = np.random.RandomState(seed)
    table = json.loads((REPO / "embodied_object_detection_tpu_torch" / "data"
                        / "metadata" / "coco_synset_categories.json")
                       .read_text())[:12]
    lvis_ids = rng.permutation(np.arange(500, 512)).tolist()
    lvis_cats = [{"id": int(i), "name": t["synset"], "synset": t["synset"]}
                 for i, t in zip(lvis_ids, table)]
    coco_cats = [{"id": t["coco_cat_id"], "name": t["synset"]}
                 for t in table]
    lvis = {"categories": lvis_cats, "images": [], "annotations": []}
    coco = {"categories": coco_cats, "images": [], "annotations": []}
    for i in range(n_images):
        name = f"{i:012d}.jpg"
        lvis["images"].append({
            "id": 1000 + i, "file_name": f"train2017/{name}",
            "neg_category_ids": rng.choice(lvis_ids, 2, False).tolist()})
        coco["images"].append({"id": 7 + i, "file_name": name})
        base = rng.uniform(0, 300, (4, 2))
        for k in range(rng.randint(0, 5)):
            j = rng.randint(4)
            box = np.r_[base[j] + rng.randn(2), rng.uniform(10, 80, 2)]
            lvis["annotations"].append({
                "id": len(lvis["annotations"]) + 1, "image_id": 1000 + i,
                "category_id": int(rng.choice(lvis_ids)),
                "bbox": box.round(2).tolist()})
        for k in range(rng.randint(0, 6)):
            j = rng.randint(4)
            box = np.r_[base[j] + rng.randn(2) * 3, rng.uniform(10, 80, 2)]
            coco["annotations"].append({
                "id": 90 + len(coco["annotations"]), "image_id": 7 + i,
                "category_id": int(rng.choice([c["id"] for c in coco_cats])),
                "bbox": box.round(2).tolist()})
    return coco, lvis


@pytest.mark.parametrize("case", ["basic", "no_positives", "cross_category",
                                  "seeded"])
@pytest.mark.parametrize("thresh", [0.7, 0.3])
def test_merge_lvis_coco_vs_jax(case, thresh):
    coco, lvis = _seeded_merge() if case == "seeded" else \
        _merge_cases()[case]
    want = jprep.merge_coco_into_lvis(coco, lvis, iou_thresh=thresh)
    got = tprep.merge_coco_into_lvis(coco, lvis, iou_thresh=thresh)
    assert got == want
    if case == "seeded":    # the case merges, drops and keeps overlaps
        assert len(lvis["annotations"]) < len(got["annotations"]) < \
            len(lvis["annotations"]) + len(coco["annotations"])


def test_merge_lvis_coco_cli_vs_jax(tmp_path):
    coco, lvis = _seeded_merge(4)
    jdir, pdir = _run_both(tmp_path, lambda d: [
        "merge-lvis-coco", "--coco", _write(d / "coco.json", coco),
        "--lvis", _write(d / "lvis.json", lvis), "--out",
        str(d / "merged.json"), "--iou-thresh", "0.5"])
    assert _read(pdir / "merged.json") == _read(jdir / "merged.json")


# -------------------------------------------------------- imagenet-tar-json

def _tar_dir(root, members):
    """tests/test_dataset_prep.py:127's layout: one tar a wnid."""
    root.mkdir(parents=True)
    for wnid, n in members:
        with tarfile.open(root / f"{wnid}.tar", "w") as tf:
            for i in range(n):
                data = b"\xff\xd8fakejpeg" + bytes([i]) * i
                info = tarfile.TarInfo(f"{wnid}_{i}.jpg")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    return root


@pytest.mark.parametrize("members", [(("n001", 3), ("n002", 2)),
                                     (("n0b", 1), ("n0a", 4), ("n0c", 0))])
def test_imagenet_tar_json_vs_jax(tmp_path, members):
    jdir = _tar_dir(tmp_path / "j", members)
    pdir = _tar_dir(tmp_path / "p", members)
    want = jprep.imagenet_tar_json(str(jdir), str(tmp_path / "j.json"))
    got = tprep.imagenet_tar_json(str(pdir), str(tmp_path / "p.json"))
    assert got == want
    assert _read(tmp_path / "p.json") == _read(tmp_path / "j.json")
    written = sorted(p.name for p in pdir.glob("*.npy"))
    assert written == sorted(p.name for p in jdir.glob("*.npy"))
    assert len(written) == 2 * len(members)
    for name in written:
        np.testing.assert_array_equal(np.load(pdir / name),
                                      np.load(jdir / name))


def test_imagenet_tar_json_cli_vs_jax(tmp_path):
    jdir, pdir = _run_both(tmp_path, lambda d: [
        "imagenet-tar-json", "--tar-dir",
        str(_tar_dir(d / "tars", (("n1", 2), ("n2", 3)))),
        "--out", str(d / "ds.json")])
    assert _read(pdir / "ds.json") == _read(jdir / "ds.json")


# ------------------------------------------------------------------ cc-tags

CC = {"images": [{"id": 1, "file_name": "a.jpg",
                  "captions": ["a red sports car on the road"]},
                 {"id": 2, "file_name": "b.jpg",
                  "captions": ["sunset over the ocean"]},
                 {"id": 3, "file_name": "c.jpg",
                  "captions": ["the automobile is parked", "a car again"]},
                 {"id": 4, "file_name": "d.jpg",
                  "captions": ["an old tv set and a dog bed", "dog"]},
                 {"id": 5, "file_name": "e.jpg",
                  "captions": ["a glass", "car in a tv show"]}],
      "categories": [{"id": 7, "name": "car",
                      "synonyms": ["car", "automobile"]},
                     {"id": 9, "name": "dog", "synonyms": ["dog"]}],
      "annotations": []}
# COCO-style: no synonyms, so each takes its synset's LVIS synonyms
COCO_STYLE = [{"id": i, "name": n} for i, n in
              ((72, "tv"), (18, "dog"), (3, "car"), (62, "chair"),
               (1, "person"), (44, "bottle"))]


@pytest.mark.parametrize("case", ["own", "own_allcaps", "own_keep",
                                  "coco_style", "coco_style_allcaps"])
def test_cc_tags_vs_jax(case):
    cats = COCO_STYLE if case.startswith("coco_style") else None
    kw = dict(allcaps=case.endswith("allcaps"),
              keep_images=case.endswith("keep"))
    want = jprep.cc_tags(CC, cats, **kw)
    got = tprep.cc_tags(CC, cats, **kw)
    assert got == want
    if cats:        # the synonyms come from the vendored tables
        assert "television_set" in got["categories"][0]["synonyms"]
        assert any(72 in x["pos_category_ids"] for x in got["images"])


def test_cc_tags_lvis_default_and_map_tag_name():
    """Without categories both read the vendored LVIS v1 table."""
    cc = {"images": CC["images"]}
    assert tprep.cc_tags(cc) == jprep.cc_tags(cc)
    for s in ("aerosol_can", "flip-flop_(sandal)", "Web_Cam (x)", "tv"):
        assert tprep.map_tag_name(s) == jprep.map_tag_name(s)


def test_cc_tags_cli_vs_jax(tmp_path):
    jdir, pdir = _run_both(tmp_path, lambda d: [
        "cc-tags", "--cc-ann", _write(d / "cc.json", CC), "--out",
        str(d / "tags.json"), "--cat-path",
        _write(d / "cats.json", {"categories": COCO_STYLE}), "--allcaps"])
    assert _read(pdir / "tags.json") == _read(jdir / "tags.json")


# ------------------------------------- remove-rare, coco-zeroshot-oriorder

LVIS_FREQ = {"categories": [{"id": 1, "frequency": "r"},
                            {"id": 2, "frequency": "f"},
                            {"id": 3, "frequency": "c"}, {"id": 4}],
             "annotations": [{"id": 10, "category_id": 1},
                             {"id": 11, "category_id": 2},
                             {"id": 12, "category_id": 3},
                             {"id": 13, "category_id": 4}],
             "images": []}


@pytest.mark.parametrize("exclude", [("r",), ("r", "c")])
def test_remove_rare_and_oriorder_vs_jax(exclude):
    assert tprep.remove_rare(LVIS_FREQ, exclude) == \
        jprep.remove_rare(LVIS_FREQ, exclude)
    zs = {"categories": [{"id": 2}], "annotations": [], "images": []}
    full = [{"id": 1}, {"id": 2}, {"id": 3}]
    assert tprep.coco_zeroshot_oriorder(zs, full) == \
        jprep.coco_zeroshot_oriorder(zs, full)


def test_remove_rare_and_oriorder_cli_vs_jax(tmp_path):
    zs = {"categories": [{"id": 2}], "annotations": [{"id": 1}],
          "images": []}
    jdir, pdir = _run_both(tmp_path, lambda d: [
        "remove-rare", "--ann", _write(d / "lvis.json", LVIS_FREQ)])
    assert _read(pdir / "lvis_norare.json") == \
        _read(jdir / "lvis_norare.json")
    jdir, pdir = _run_both(tmp_path, lambda d: [
        "coco-zeroshot-oriorder", "--data-path", _write(d / "zs.json", zs),
        "--cat-path", _write(d / "full.json", {"categories": [{"id": 3}]})])
    assert _read(pdir / "zs_oriorder.json") == \
        _read(jdir / "zs_oriorder.json")


# ------------------------------------------------------------ clip-features

NAMES = ["cup", "web_cam", "aerosol_can", "traffic light", "teddy bear",
         "person's dog"]


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """A seeded CLIP checkpoint at CLIP-B's shapes (512 wide, 12 layers:
    the JAX tower has no other) and a merges table learned from the LVIS
    names, as tests/test_torch_slice16_text.py writes them."""
    d = tmp_path_factory.mktemp("clip")
    sd = _perturbed_sd(512, 12, seed=19)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               d / "clip.pth")
    bpe = chip_smoke.write_merges(
        d / "merges.txt.gz",
        [n.replace("_", " ") for n in chip_smoke.lvis_names()])
    want = jprep.clip_features(NAMES, str(d / "jax.npy"),
                               clip_weights=str(d / "clip.pth"),
                               bpe_path=str(bpe))
    return d, str(bpe), np.asarray(want)


def test_clip_features_vs_jax(clip_files):
    """Both packages' `load_default_text_encoder` + `clip_features` on the
    same checkpoint and merges: within 1e-5 of the largest element."""
    d, bpe, want = clip_files
    got = tprep.clip_features(NAMES, str(d / "port.npy"),
                              clip_weights=str(d / "clip.pth"),
                              bpe_path=bpe, device="cpu")
    saved = np.load(d / "port.npy")
    assert saved.dtype == np.float32 and saved.shape == (len(NAMES), 512)
    np.testing.assert_array_equal(saved, got)
    assert np.abs(saved - np.load(d / "jax.npy")).max() <= \
        1e-5 * np.abs(want).max()


def test_clip_features_cli_and_stub(clip_files, tmp_path, monkeypatch):
    """The CLI on the CPU (merges from CLIP_BPE_PATH, as the JAX tool
    reads them) saves the same embeddings; a stub encoder gets the
    prompts as the JAX tool gives them; without a card the default
    device raises rather than falling back to the CPU."""
    d, bpe, want = clip_files
    monkeypatch.setenv("CLIP_BPE_PATH", bpe)
    names = _write(tmp_path / "names.json", NAMES)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tprep.main(["clip-features", "--names", names,
                           "--clip-params", str(d / "clip.pth"), "--out",
                           str(tmp_path / "zs.npy"), "--device", "cpu"]) == 0
    assert "(6, 512)" in out.getvalue()
    got = np.load(tmp_path / "zs.npy")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    calls = {}

    def stub(texts):
        calls.setdefault("texts", []).append(texts)
        return np.ones((len(texts), 512), np.float64)

    for mod in (jprep, tprep):
        emb = mod.clip_features(["chair", "table"], str(tmp_path / "s.npy"),
                                prompt="a photo of {}", encoder=stub)
        assert np.load(tmp_path / "s.npy").dtype == np.float32
        assert emb.shape == (2, 512)
    assert calls["texts"][0] == calls["texts"][1] == \
        ["a photo of chair", "a photo of table"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprep.clip_features(["chair"], str(tmp_path / "x.npy"),
                                clip_weights=str(d / "clip.pth"),
                                bpe_path=bpe)


# ---------------------------------------------------------------- the CLI

def _help(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(argv + ["--help"])
    return out.getvalue()


def _usage_flags(text):
    usage = text.split("\n\n")[0]
    return set(re.findall(r"--[a-z][a-z-]*", usage))


def test_cli_subcommands_and_flags_vs_jax():
    top = _help(tprep.main, [])
    choices = re.search(r"\{([a-z,-]+)\}", top).group(1).split(",")
    assert tuple(choices) == SUBCOMMANDS
    assert re.search(r"\{([a-z,-]+)\}", _help(jprep.main, [])).group(1) \
        .split(",") == choices
    for cmd in SUBCOMMANDS:
        got = _usage_flags(_help(tprep.main, [cmd]))
        want = _usage_flags(_help(jprep.main, [cmd]))
        extra = {"--device"} if cmd == "clip-features" else set()
        assert got == want | extra, cmd
