"""Slice 16's CLIP text tower and the visualizer's debug drawings against
the JAX package, on the CPU.

  * the BPE tokenizer's ids equal JAX's on a merges table learned from
    the LVIS names and written with gzip (chip_smoke.py's `write_merges`),
    over prompts with punctuation, digits, HTML entities and text beyond
    the 77-token context
  * `convert_clip_text_weights` on tests/test_text_encoder.py's fake
    openai state dict equals JAX's converter carried by
    `load_jax_params`, leaf for leaf
  * the tower (width 64, 2 layers) against JAX within 1e-5 of the
    largest, with unit norms and distinct rows
  * `get_clip_embeddings` end to end at full width (512, 12 layers, 8
    heads) through `load_default_text_encoder` on a saved checkpoint and
    the written merges table, against JAX's `CLIPTextEncoder`
  * the co-training batches embed their captions with the tower
  * the missing-file errors: `FileNotFoundError` naming the missing path
    or variable, as JAX's; a custom vocabulary raises it too
  * every debug drawing of `demo/visualizer.py` equal to JAX's pixel for
    pixel (the saved dumps file for file)
"""

import os

import numpy as np
import pytest
import torch

import jax

from embodied_object_detection_tpu.demo import predictor as jpred
from embodied_object_detection_tpu.demo import visualizer as jvis
from embodied_object_detection_tpu.models import text_encoder as jtext
from embodied_object_detection_tpu.structures import Detections as JaxDets

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.demo import demo as tdemo
from embodied_object_detection_tpu_torch.demo import predictor as tpred
from embodied_object_detection_tpu_torch.demo import visualizer as tvis
from embodied_object_detection_tpu_torch.models import text_encoder as ttext
from embodied_object_detection_tpu_torch.structures import Detections

import chip_smoke
from test_text_encoder import _fake_clip_sd

def lvis_names():
    return [n.replace("_", " ") for n in chip_smoke.lvis_names()]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    return str(chip_smoke.write_merges(
        tmp_path_factory.mktemp("bpe") / "merges.txt.gz", lvis_names()))


TEXTS = ["a aerosol can", "a person's &amp; dog's toy", "room 101, 2nd floor!",
         "", "  many   spaces\there ", "a " + "very long " * 60 + "end",
         "WEB_CAM (type of camera)"]


def _perturbed_sd(width, layers, seed=1):
    sd = _fake_clip_sd(width, layers)
    rng = np.random.RandomState(seed)
    for k in sd:
        if k.endswith("bias") or "ln_" in k:
            sd[k] = sd[k] + rng.randn(*sd[k].shape).astype(np.float32) * 0.1
    return sd


def test_tokenizer_vs_jax(bpe):
    got = ttext.SimpleTokenizer(bpe)
    want = jtext.SimpleTokenizer(bpe)
    assert got.encoder == want.encoder and got.bpe_ranks == want.bpe_ranks
    texts = TEXTS + ["a " + n for n in lvis_names()[::50]]
    ids = got.tokenize(texts)
    np.testing.assert_array_equal(ids, want.tokenize(texts))
    assert ids.dtype == np.int32 and ids.shape == (len(texts), 77)
    # the end token is each row's largest id, where the tower reads
    eot = got.encoder["<|endoftext|>"]
    assert (ids.max(1) == eot).all()
    assert ttext.bytes_to_unicode() == jtext.bytes_to_unicode()
    assert ttext.get_pairs(("a", "b", "c")) == jtext.get_pairs(("a", "b", "c"))


def test_convert_clip_text_weights():
    sd = _fake_clip_sd(64, 2)
    got = ttext.convert_clip_text_weights(sd)
    want = load_jax_params(jtext.convert_clip_text_weights(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tower = ttext.TextTransformer(**ttext.text_tower_shape(got))
    tower.load_state_dict(got)
    assert ttext.text_tower_shape(got) == dict(width=64, layers=2)


def test_tower_vs_jax():
    width, layers = 64, 2
    sd = _perturbed_sd(width, layers)
    params = jtext.convert_clip_text_weights(sd)
    model = jtext._make_model(width=width, layers=layers, heads=8)
    rng = np.random.RandomState(2)
    tokens = np.zeros((3, 77), np.int32)
    tokens[:, 0] = 49406
    tokens[0, 1:4] = [320, 1000, 49407]
    tokens[1, 1] = 49407
    tokens[2, 1:76] = rng.randint(1, 49000, 75)
    tokens[2, 76] = 49407
    want = np.asarray(jax.jit(model.apply)(params, tokens))
    tower = ttext.TextTransformer(width, layers)
    tower.load_state_dict(ttext.convert_clip_text_weights(sd))
    with torch.no_grad():
        got = tower(torch.from_numpy(tokens)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert not np.allclose(got[0], got[1])


def test_get_clip_embeddings_end_to_end(bpe, tmp_path):
    """The full-width tower from a checkpoint file: the names of a custom
    vocabulary (underscores as spaces, prompt "a ") against JAX's encoder
    on the same weights and merges, within 1e-5 of the largest."""
    sd = _perturbed_sd(512, 12, seed=3)
    path = str(tmp_path / "clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    enc = ttext.load_default_text_encoder(path, bpe, device="cpu")
    assert enc.model.layers == 12
    names = ["cup", "web_cam", "aerosol_can", "traffic light"]
    got = tpred.get_clip_embeddings(names, text_encoder=enc)
    want = jpred.get_clip_embeddings(
        names, text_encoder=jtext.CLIPTextEncoder(
            jtext.convert_clip_text_weights(sd), bpe))
    assert got.dtype == np.float32 and got.shape == (4, 512)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    zs = tpred.build_zs_weight(got)
    assert zs.shape == (512, 5)


def test_captions_embedded_by_the_tower(bpe):
    """The co-training batches take the tower as their caption embedder
    (the package keeps no stand-in): each caption's row is the tower's
    embedding of it, and an image without a caption weighs 0."""
    from embodied_object_detection_tpu_torch.engine import coco as tcoco
    assert not hasattr(tcoco, "stand_in_caption_embedding")
    enc = ttext.CLIPTextEncoder(
        ttext.convert_clip_text_weights(_perturbed_sd(64, 2)), bpe,
        device="cpu")
    items = [dict(image=np.zeros((4, 6, 3), np.uint8), caption=c)
             for c in ("a chair by a desk", "", "two lamps")]
    images, feats, weight = tcoco.caption_items_to_batch(items, enc)
    np.testing.assert_array_equal(feats, enc([it["caption"]
                                              for it in items]))
    assert feats.shape == (3, 64) and list(weight) == [1.0, 0.0, 1.0]


def test_tf32_off_only_inside_the_tower(bpe):
    """The tower turns TF32 off for its own forward and restores the
    caller's setting: building an encoder and embedding leave the global
    flag as they found it."""
    before = torch.backends.cuda.matmul.allow_tf32
    seen = []
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        enc = ttext.CLIPTextEncoder(
            ttext.convert_clip_text_weights(_perturbed_sd(64, 2)), bpe,
            device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
        enc.model.ln_final.register_forward_hook(
            lambda *_: seen.append(torch.backends.cuda.matmul.allow_tf32))
        enc(["a chair"])
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_missing_files_raise(tmp_path, monkeypatch):
    monkeypatch.delenv("CLIP_TEXT_WEIGHTS", raising=False)
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    missing = str(tmp_path / "nope.txt.gz")
    for module in (ttext, jtext):
        with pytest.raises(FileNotFoundError, match="nope.txt.gz"):
            module.SimpleTokenizer(missing)
        with pytest.raises(FileNotFoundError, match="CLIP_TEXT_WEIGHTS"):
            module.load_default_text_encoder()
    with pytest.raises(FileNotFoundError, match="clip.pth"):
        ttext.load_default_text_encoder(str(tmp_path / "clip.pth"))
    for fn in (lambda: tpred.get_clip_embeddings(["cup"]),
               lambda: tdemo.resolve_vocabulary("custom", "cup,webcam")):
        with pytest.raises(FileNotFoundError, match="CLIP_TEXT_WEIGHTS"):
            fn()


# ----------------------------------------------------------- visualizer

def _drawing_inputs(rng):
    h, w = 48, 64
    img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    boxes = np.array([[4, 4, 30, 40], [20, 10, 60, 44], [-5, 30, 80, 60],
                      [10, 10, 12, 12]], np.float32)
    classes = np.array([0, 2, 1, 3], np.int32)
    valid = np.array([True, True, False, True])
    masks = np.zeros((4, h, w), bool)
    masks[0, 6:30, 6:28] = True
    masks[1, 12:40, 22:58] = True
    masks[1, 20:25, 30:40] = False
    masks[3, 10:12, 10:12] = True
    scores = np.array([0.9, 0.5, 0.8, 0.2], np.float32)
    return img, boxes, classes, valid, masks, scores


def test_debug_drawings_vs_jax(rng, tmp_path):
    img, boxes, classes, valid, masks, scores = _drawing_inputs(rng)
    names = ["chair", "table", "lamp", "cup"]
    tv, jv = tvis.Visualizer(names), jvis.Visualizer(names)
    dets = Detections(boxes, scores, classes, valid)
    jdets = JaxDets(boxes, scores, classes, valid)
    pairs = [
        (tv.draw_ground_truth(img, boxes, classes, valid),
         jv.draw_ground_truth(img, boxes, classes, valid)),
        (tv.draw_ground_truth(img, boxes, classes),
         jv.draw_ground_truth(img, boxes, classes)),
        (tv.draw_mask_boundaries(img, masks, classes, valid, 2),
         jv.draw_mask_boundaries(img, masks, classes, valid, 2)),
        (tv.draw_mask_boundaries(img, masks),
         jv.draw_mask_boundaries(img, masks)),
        (tv.draw_detections(img, dets, 0.3, masks=masks),
         jv.draw_detections(img, jdets, 0.3, masks=masks)),
        (tvis.legend_strip(names, 100, 80), jvis.legend_strip(names, 100, 80)),
    ]
    hm = rng.rand(12, 16).astype(np.float32) * 1.4 - 0.2
    pairs += [(tvis.heatmap_color_image(hm), jvis.heatmap_color_image(hm)),
              (tvis.blend_heatmap(img, hm), jvis.blend_heatmap(img, hm)),
              (tvis.blend_heatmap(img, hm, 0.3),
               jvis.blend_heatmap(img, hm, 0.3))]
    for k, (got, want) in enumerate(pairs):
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=str(k))
    assert not np.array_equal(pairs[0][0], img)

    hms = [rng.rand(12, 16, 1).astype(np.float32),
           rng.rand(6, 8).astype(np.float32)]
    from PIL import Image
    for name, tfn, jfn in (
            ("train", lambda d: tvis.debug_train_dump(
                img, hms, boxes, classes, valid, names, d),
             lambda d: jvis.debug_train_dump(
                 img, hms, boxes, classes, valid, names, d)),
            ("test", lambda d: tvis.debug_test_dump(img, hms, dets, names, d),
             lambda d: jvis.debug_test_dump(img, hms, jdets, names, d))):
        got = tfn(str(tmp_path / f"port_{name}"))
        want = jfn(str(tmp_path / f"jax_{name}"))
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                          np.asarray(Image.open(w)))
