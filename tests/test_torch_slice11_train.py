"""Slice 11 of the torch port against the JAX package, on the CPU: the rest
of training (ROADMAP queue 1 item 9). The CLI's training branch over an h5
episode root with `--semmap-path` snapshots, `--resume` and `--max-iter`;
the TensorBoard mirror; the federated loss and `ignore_zero_cats`;
MORE_POS; `backbone.train_remat` and `roi.train_stage_remat`.

The CLI's batches are held to the JAX CLI's with both packages' train
steps replaced by recorders (numpy and h5 only: no JAX model is built or
compiled); the steps themselves are `engine/train.py:train`'s, which
tests/test_torch_train*.py hold to JAX. A torch generator cannot give
`jax.random.uniform`'s numbers, so the federated mask takes its uniform
draw as an input and the parity test feeds JAX's; the port's own draw is
held to torch.multinomial's distribution.

Tolerances are stated per test.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu import config as jcfg
from embodied_object_detection_tpu import run as jrun
from embodied_object_detection_tpu.data.catalog import (
    load_class_freq as jax_load_class_freq)
from embodied_object_detection_tpu.engine import train as jtrain
from embodied_object_detection_tpu.models import losses as jl
from embodied_object_detection_tpu.structures import GroundTruth as JaxGT
from embodied_object_detection_tpu.utils import tb_writer as jtb

from embodied_object_detection_tpu_torch import config as tcfg
from embodied_object_detection_tpu_torch import run as trun
from embodied_object_detection_tpu_torch.data import (
    generate_synthetic_dataset)
from embodied_object_detection_tpu_torch.data.catalog import load_class_freq
from embodied_object_detection_tpu_torch.data.synthetic import (
    synthetic_train_batch)
from embodied_object_detection_tpu_torch.engine import train as ttrain
from embodied_object_detection_tpu_torch.engine.checkpoint import (
    save_memory_h5)
from embodied_object_detection_tpu_torch.models import losses as tl
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector)
from embodied_object_detection_tpu_torch.parallel.train_step import (
    TrainState, batch_losses, batch_to_device)
from embodied_object_detection_tpu_torch.structures import GroundTruth
from embodied_object_detection_tpu_torch.utils import tb_writer as ttb


def _t(x):
    return torch.from_numpy(np.array(x))


def mini_config(**roi):
    """The 64x96 f32 miniature of the port's train tests."""
    cfg = tcfg.DetectorConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=8),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                batch_size_per_image=16, **roi),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=4))


# ------------------------------------------------------------ tensorboard

def test_tb_writer_copy_reads_back(tmp_path):
    """The port's hand-encoded TFRecord writer: its file reads back with
    its own `read_events` and with the JAX package's, the same steps and
    scalars (f32 values exactly); `MetricsWriter` mirrors each
    metrics.json line into tb/."""
    with ttb.SummaryWriter(str(tmp_path / "a")) as w:
        w.add_scalar("loss/total", 1.5, 0)
        w.add_scalars({"loss/total": 0.75, "lr": 1e-4,
                       "AP-" + "x" * 150: 3.25}, 10)
        path = w.path
    mine = list(ttb.read_events(path))
    assert mine == list(jtb.read_events(path))
    assert [s for s, _ in mine] == [0, 10]
    assert mine[1][1]["lr"] == np.float32(1e-4)
    assert ttb._crc32c(b"123456789") == 0xE3069283
    mw = ttrain.MetricsWriter(str(tmp_path / "m"))
    mw.write(3, {"total_loss": 2.0})
    mw.close()
    files = glob.glob(str(tmp_path / "m" / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1
    assert list(jtb.read_events(files[0])) == [(3, {"total_loss": 2.0})]


# --------------------------------------------------- federated loss, izc

def test_class_freq_table_and_loading_rules(tmp_path):
    """The copied LVIS table gives the JAX package's frequencies exactly;
    `load_fed_freq_weight` follows the JAX rules: None with both knobs
    off, a short table zero-padded, a longer one or too few positive
    classes raise."""
    np.testing.assert_array_equal(load_class_freq(), jax_load_class_freq())
    assert load_class_freq().shape == (1203,)
    cat_info = [dict(id=i + 1, image_count=c) for i, c in
                enumerate([4, 9, 0])]
    p = tmp_path / "cat_info.json"
    p.write_text(json.dumps(cat_info))
    for use_fed, izc, n, num_cat in ((False, True, 5, 50), (True, True, 1203,
                                                            50),
                                     (True, False, 5, 2)):
        roi = dict(use_fed_loss=use_fed, ignore_zero_cats=izc,
                   num_classes=n, fed_loss_num_cat=num_cat,
                   cat_freq_path="" if n == 1203 else str(p))
        got = ttrain.load_fed_freq_weight(mini_config(**roi))
        jc = jcfg.DetectorConfig()
        want = jtrain.load_fed_freq_weight(jc.replace(
            roi=dataclasses.replace(jc.roi, **roi)))
        np.testing.assert_array_equal(got, want)
    assert ttrain.load_fed_freq_weight(mini_config()) is None
    for roi in (dict(use_fed_loss=True, fed_loss_num_cat=4,
                     cat_freq_path=str(p), num_classes=5),
                dict(use_fed_loss=True, num_classes=20)):
        with pytest.raises(ValueError, match="positive-frequency|classes"):
            ttrain.load_fed_freq_weight(mini_config(**roi))


FED_CASES = {
    # (classes of the matched rows (c = background), valid, freq, k)
    "with_background": ([2, 5, 5, 7, 20, 20], [1, 1, 1, 0, 1, 1],
                        "lvis", 6),
    "appeared_fill_slots": (list(range(8)), [1] * 8, "ones", 4),
    "zero_frequency": ([0, 20], [1, 1], "sparse", 4),
    "all_invalid": ([3, 4], [0, 0], "lvis", 5),
}


@pytest.mark.parametrize("case", sorted(FED_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fed_loss_class_weight_vs_jax(case, seed):
    """The [C] mask equals JAX's `fed_loss_class_weight` exactly, given
    the uniform draw JAX makes from the same key."""
    classes, valid, freq_kind, k = FED_CASES[case]
    c = 20
    freq = {"lvis": jax_load_class_freq()[:c],
            "ones": np.ones(c, np.float32),
            "sparse": np.r_[[3.0, 1.0, 2.0, 5.0],
                            np.zeros(c - 4)].astype(np.float32)}[freq_kind]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jl.fed_loss_class_weight(
        jnp.asarray(classes, jnp.int32), jnp.asarray(valid, bool),
        jnp.asarray(freq), k, c, key))
    uniform = np.asarray(jax.random.uniform(key, (c,), minval=1e-10,
                                            maxval=1.0))
    got = tl.fed_loss_class_weight(
        torch.tensor(classes, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.bool), _t(freq), k, c, _t(uniform))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fed_sampler_is_multinomial_without_replacement():
    """The port's draw (`fed_uniform` from a torch generator): per-class
    selection frequencies of the extras equal torch.multinomial's without
    replacement over the frequencies with the appeared classes zeroed,
    within 0.04 over 4000 draws (binomial std ~0.008); appeared classes
    always in, zero-frequency classes never."""
    c, k, trials = 16, 6, 4000
    classes = torch.tensor([0, 1, c], dtype=torch.int32)
    valid = torch.ones(3, dtype=torch.bool)
    freq = (torch.arange(c, dtype=torch.float32) + 1.0) ** 1.5
    freq[-1] = 0.0
    gen = torch.Generator().manual_seed(7)
    got = torch.zeros(c)
    for _ in range(trials):
        got += tl.fed_loss_class_weight(classes, valid, freq, k, c,
                                        tl.fed_uniform(c, gen, "cpu"))
    want = torch.zeros(c)
    prob = freq.clone()
    prob[:2] = 0.0
    ref = torch.Generator().manual_seed(8)
    for _ in range(trials):
        want[torch.multinomial(prob, k - 3, replacement=False,
                               generator=ref)] += 1
    want[:2] = trials
    assert got[0] == trials and got[1] == trials and got[-1] == 0
    assert got.sum() == want.sum() == trials * (k - 1)
    np.testing.assert_allclose(got[2:].numpy() / trials,
                               want[2:].numpy() / trials, atol=0.04)


def _matched(rng, n, c):
    classes = rng.randint(0, c + 1, n).astype(np.int32)
    classes[rng.rand(n) < 0.5] = c
    valid = rng.rand(n) > 0.1
    boxes = rng.rand(n, 4).astype(np.float32) * 30
    boxes[:, 2:] += boxes[:, :2] + 1.0
    gt_boxes = boxes + rng.randn(n, 4).astype(np.float32)
    port = tl.MatchedProposals(_t(boxes), _t(gt_boxes), _t(classes),
                               _t(valid))
    jax_m = jl.MatchedProposals(*(jnp.asarray(a) for a in
                                  (boxes, gt_boxes, classes, valid)))
    return port, jax_m


@pytest.mark.parametrize("sigmoid", [True, False])
@pytest.mark.parametrize("weight", ["fed", "zero_cats", "both"])
def test_stage_losses_class_weight_vs_jax(sigmoid, weight):
    """`stage_losses` with a class weight (the federated mask, the
    zero-category mask or their product) in the sigmoid and softmax
    branches: loss_cls and loss_box_reg within rtol 1e-6 of JAX's."""
    rng = np.random.RandomState(40 + sigmoid)
    n, c = 48, 12
    port_m, jax_m = _matched(rng, n, c)
    logits = rng.randn(n, c + 1).astype(np.float32)
    deltas = (rng.randn(n, 4) * 0.1).astype(np.float32)
    fed = (rng.rand(c) > 0.5).astype(np.float32)
    zero = (rng.rand(c) > 0.3).astype(np.float32)
    cw = {"fed": fed, "zero_cats": zero, "both": fed * zero}[weight]
    want = jl.stage_losses(jnp.asarray(logits), jnp.asarray(deltas), jax_m,
                           (10.0, 10.0, 5.0, 5.0), c,
                           class_weight=jnp.asarray(cw),
                           use_sigmoid_ce=sigmoid)
    got = tl.stage_losses(_t(logits), _t(deltas), port_m,
                          (10.0, 10.0, 5.0, 5.0), c, use_sigmoid_ce=sigmoid,
                          class_weight=_t(cw))
    for name in ("loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-6)


# ------------------------------------------------------------- MORE_POS

def _one_level(**kw):
    return dict(dict(strides=(8,), sizes_of_interest=((0, 10000),),
                     more_pos_thresh=0.2, more_pos_topk=9), **kw)


def _more_pos_case(name):
    """(centernet fields, boxes, classes, valid, reg_pred, shapes): the
    JAX tests' three cases (tests/test_more_pos_and_weak_variants.py) and
    random GTs on the five default levels."""
    if name == "random_levels":
        rng = np.random.RandomState(9)
        g = 6
        xy = rng.rand(g, 2) * [80, 56]
        wh = 4 + rng.rand(g, 2) * [90, 70]
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
        m = sum(h * w for h, w in shapes)
        reg = np.abs(rng.randn(m, 4) * 2).astype(np.float32)
        return ({}, boxes, rng.randint(0, 5, g).astype(np.int32),
                np.array([1, 1, 1, 1, 1, 0], bool), reg, shapes)
    boxes = np.zeros((2, 4), np.float32)
    boxes[0] = [8, 8, 40, 40]
    reg = np.zeros((64, 4), np.float32)
    base = np.array([2.5, 2.5, 1.5, 1.5], np.float32)
    if name == "hand_computed":
        reg[27] = base
        reg[26] = base + [-1, 0, 1, 0]
        reg[19] = base + [0, -1, 0, 1]
        return (_one_level(), boxes, np.array([2, 0], np.int32),
                np.array([True, False]), reg, [(8, 8)])
    if name == "invalid_gt":
        return (_one_level(), boxes, np.zeros(2, np.int32),
                np.zeros(2, bool), reg, [(8, 8)])
    return (_one_level(more_pos_thresh=1e-6), boxes[:1],
            np.zeros(1, np.int32), np.array([True]),
            np.full((64, 4), 0.7, np.float32), [(8, 8)])


@pytest.mark.parametrize("name", ["hand_computed", "invalid_gt",
                                  "loose_threshold", "random_levels"])
def test_more_pos_vs_jax(name):
    """`add_more_pos` equals JAX's (indices, validity, labels exactly) on
    the JAX tests' cases and on six GTs over five levels; the indexed
    focal loss and the CenterNet raw losses with it within rtol 1e-6."""
    fields, boxes, classes, valid, reg, shapes = _more_pos_case(name)
    fields = dict(fields, more_pos=True)
    jc = dataclasses.replace(jcfg.CenterNetConfig(), **fields)
    tc = dataclasses.replace(tcfg.CenterNetConfig(), **fields)
    want = jl.add_more_pos(jnp.asarray(reg), JaxGT(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)),
        shapes, jc)
    gt = GroundTruth(_t(boxes), _t(classes), _t(valid))
    got = tl.add_more_pos(_t(reg), gt, shapes, tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name == "hand_computed":
        assert set(got.pos_inds[got.pos_valid].tolist()) == {27, 26, 19}
    rng = np.random.RandomState(12)
    m = reg.shape[0]
    logits = rng.randn(m).astype(np.float32)
    hm = rng.rand(m).astype(np.float32)
    jpos, jneg = jl.binary_heatmap_focal_loss_indexed(
        jnp.asarray(logits), jnp.asarray(hm), want.pos_inds, want.pos_valid,
        jc)
    tpos, tneg = tl.binary_heatmap_focal_loss_indexed(
        _t(logits), _t(hm), got.pos_inds, got.pos_valid, tc)
    np.testing.assert_allclose([float(tpos), float(tneg)],
                               [float(jpos), float(jneg)], rtol=1e-6)
    targets = tl.centernet_targets(gt, shapes, tc)
    jtargets = jl.CenterNetTargets(*(jnp.asarray(t.numpy())
                                     for t in targets))
    jraw = jl.centernet_raw_losses(jnp.asarray(logits), jnp.asarray(reg),
                                   jtargets, jc, more_pos=want)
    traw = tl.centernet_raw_losses(_t(logits), _t(reg), targets, tc,
                                   more_pos=got)
    np.testing.assert_allclose([float(v) for v in traw],
                               [float(v) for v in jraw], rtol=1e-6)


# --------------------------------------------------------------- remat

@pytest.fixture(scope="module")
def knob_batch():
    """The miniature, one synthetic frame, and one seeded model for each
    class count (the knobs change no parameter shape)."""
    cfg = mini_config()
    rng = np.random.RandomState(0)
    batch = batch_to_device(synthetic_train_batch(cfg, rng, 1), "cpu")
    models = {c: build_detector(cfg.replace(roi=dataclasses.replace(
        cfg.roi, num_classes=c)), seed=0, device="cpu") for c in (20, 1203)}
    return cfg, batch, models


def _grads(models, cfg, batch, fed=None):
    """(losses, gradients) of one `batch_losses` step of `cfg` on the
    seeded model of its class count (its config swapped in)."""
    classes = cfg.roi.num_classes
    model = models[classes]
    model.cfg = cfg
    model.zero_grad(set_to_none=True)
    zs = _t(np.random.RandomState(1).randn(512, classes + 1).astype(
        np.float32) * 0.05)
    total, losses = batch_losses(model, cfg, batch, zs, 0,
                                 None if fed is None else _t(fed))
    total.backward()
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None})


def test_remat_gradients_equal_the_plain_step(knob_batch):
    """`backbone.train_remat` and `roi.train_stage_remat` (alone and
    together) give the plain step's losses and gradients bit for bit: the
    recomputed regions run the same ops on the same inputs and draw no
    random numbers."""
    cfg, batch, models = knob_batch
    base_losses, base = _grads(models, cfg, batch)
    for bb, st in ((True, False), (False, True), (True, True)):
        c = cfg.replace(
            backbone=dataclasses.replace(cfg.backbone, train_remat=bb),
            roi=dataclasses.replace(cfg.roi, train_stage_remat=st))
        losses, grads = _grads(models, c, batch)
        assert losses == base_losses
        assert grads.keys() == base.keys()
        for n in base:
            assert torch.equal(grads[n], base[n]), n


def test_knobs_reach_the_train_step(knob_batch):
    """Through `batch_losses`: the federated loss and ignore_zero_cats at
    Detic's LVIS setting (1203 classes, the copied table) change each
    stage's loss_cls and nothing else; ignore_zero_cats alone on a table
    with zero-frequency classes changes loss_cls; MORE_POS changes only
    the CenterNet positives' terms or keeps them (here with random
    weights); every loss finite."""
    cfg, batch, models = knob_batch
    lvis = cfg.replace(roi=dataclasses.replace(cfg.roi, num_classes=1203))
    base, _ = _grads(models, lvis, batch)
    fed_cfg = lvis.replace(roi=dataclasses.replace(
        lvis.roi, use_fed_loss=True, ignore_zero_cats=True))
    fed, _ = _grads(models, fed_cfg, batch,
                    ttrain.load_fed_freq_weight(fed_cfg))
    assert all(np.isfinite(v) for v in fed.values())
    for k in base:
        if k.startswith("loss_cls"):
            assert fed[k] < base[k]
        else:
            assert fed[k] == base[k], k
    freq = np.ones(20, np.float32)
    freq[:10] = 0.0
    izc = cfg.replace(roi=dataclasses.replace(cfg.roi,
                                              ignore_zero_cats=True))
    plain, _ = _grads(models, cfg, batch)
    zero, _ = _grads(models, izc, batch, fed=freq)
    assert zero["loss_cls_stage0"] < plain["loss_cls_stage0"]
    mp = cfg.replace(centernet=dataclasses.replace(cfg.centernet,
                                                   more_pos=True))
    more, _ = _grads(models, mp, batch)
    assert all(np.isfinite(v) for v in more.values())
    assert more["loss_centernet_loc"] == plain["loss_centernet_loc"]


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    """A synthetic h5 root (2 scenes x 2 chunks of 4 frames at 64x96, an
    8 x 8-cell map) and memory snapshots for every chunk."""
    td = tmp_path_factory.mktemp("h5")
    root = str(td / "synth")
    generate_synthetic_dataset(root, num_scenes=2, chunks_per_scene=2,
                               frames=4, height=64, width=96, map_h=8,
                               map_w=8)
    rng = np.random.RandomState(4)
    snaps = str(td / "snaps")
    for name in sorted(os.listdir(os.path.join(root, "sensor_data"))):
        save_memory_h5(snaps, name, np.zeros(64, np.int32),
                       rng.randn(64, 512).astype(np.float32),
                       rng.choice([0.0, 1.0, 3.0], 64).astype(np.float32))
    return root, os.path.join(snaps, "memory")


CLI_OPTS = ["compute_dtype=float32", "backbone.depths=(1,1,1,1)",
            "input.height=64", "input.width=96",
            "input.max_sequence_length=4", "input.max_gt_boxes=8",
            "centernet.pre_nms_topk_train=64",
            "centernet.post_nms_topk_train=16", "roi.num_classes=5",
            "roi.batch_size_per_image=16", "memory.max_cells=64",
            "solver.ims_per_batch=2", "solver.checkpoint_period=2"]


def test_cli_feeds_the_jax_clis_batches(h5_root, tmp_path, monkeypatch):
    """`run.py` without --eval-only feeds `engine/train.py:train` the JAX
    CLI's batches, every field bit for bit, over 3 iterations on the h5
    root with snapshots. Both packages' steps and checkpoints are
    replaced by recorders and the JAX model by nothing, so only the CLI,
    the dataset and the loader run."""
    root, snaps = h5_root
    argv = ["--data-path", root, "--semmap-path", snaps, "--zs-weight",
            "random", "--max-iter", "3"]
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
    jrun.main(argv + ["--output-dir", str(tmp_path / "jax"), "--opts"] +
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
    trun.main(["--device", "cpu", "--output-dir", str(tmp_path / "port")]
              + argv + ["--opts"] + CLI_OPTS)
    assert len(seen_j) == len(seen_t) == 3
    for bj, bt in zip(seen_j, seen_t):
        for field in bt._fields:
            got, want = getattr(bt, field).numpy(), getattr(bj, field)
            assert got.shape == want.shape, field
            np.testing.assert_array_equal(got, want, err_msg=field)
        assert bt.mem_features.abs().sum() > 0      # the snapshots' memory


def test_cli_trains_from_an_h5_root(h5_root, tmp_path):
    """The port's CLI trains on the CPU from the h5 root: 1 iteration
    writes ckpt_0000001 and the TensorBoard file; `--resume --max-iter 2`
    continues from it to step 2 (ckpt_0000002); the parameters moved."""
    root, snaps = h5_root
    out = str(tmp_path / "out")
    argv = ["--device", "cpu", "--data-path", root, "--semmap-path", snaps,
            "--zs-weight", "random", "--output-dir", out]
    opts = ["--opts"] + CLI_OPTS + ["solver.ims_per_batch=1",
                                    "solver.checkpoint_period=1"]
    first = trun.main(argv + ["--max-iter", "1"] + opts)
    assert first.step == 1
    assert os.path.exists(os.path.join(out, "ckpt_0000001"))
    assert glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    start = {n: p.detach().clone()
             for n, p in first.model.named_parameters()}
    second = trun.main(argv + ["--max-iter", "2", "--resume"] + opts)
    assert second.step == 2
    assert os.path.exists(os.path.join(out, "ckpt_0000002"))
    moved = [n for n, p in second.model.named_parameters()
             if not torch.equal(p.detach(), start[n])]
    assert moved
