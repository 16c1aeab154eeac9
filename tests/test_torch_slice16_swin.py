"""Slice 16's Swin-B trunk against the JAX package, on the CPU.

  * every case of tests/test_swin.py as a port case: window partition and
    reverse, the relative position index, the shift mask (each equal to
    JAX's), the trunk's shapes, one block through the `.pth` converter
    against the test's torch oracle (its tolerance) and against JAX's
    block, the detector at test_swin's config, stochastic depth in train
    mode only, the per-block rates, and `frame_train` drawing its coins
  * `SwinTransformer` (embed 32, depths (1, 1, 2, 1)) against JAX at
    64x96 (every stage padded, a shifted block) within 1e-5 of each
    output's largest, batched and not
  * the Swin-B `EmbodiedDetector` (JAX hard-codes Swin-B, so full width)
    at the 64x96 f32 miniature: `frame_step` and `frame_step_debug`
    against JAX's `frame_step_debug`; at drop_path_rate 0, `frame_train`,
    `frame_train_weak` and `image_box_embedding` in train mode against
    JAX's (no proposal subsampling, so no random draw enters)
  * stochastic depth: rate 0 equals eval mode, each residual branch has
    its own coin (a kept one scales the branch by 1 / keep, a dropped one
    takes it out, both dropped make the block the identity), the coins'
    joint frequencies those of independent Bernoulli(keep) draws, two
    generators differ, and `backbone.train_remat` on and off give equal
    gradients from one generator

The JAX Swin-B model is never initialised: its parameter tree comes from
`jax.eval_shape` and is filled from the port's seeded weights through the
inverse of `load_jax_params` (`jax_params_from_port`), and its functions
run jitted, so each costs one compile.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.convert.torch_weights import (
    convert_state_dict as jax_convert_state_dict)
from embodied_object_detection_tpu.models import swin as jswin
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector)
from embodied_object_detection_tpu.structures import GroundTruth as JaxGT

from embodied_object_detection_tpu_torch.convert.from_jax import (
    _leaf, load_jax_params)
from embodied_object_detection_tpu_torch.convert.torch_weights import (
    convert_state_dict)
from embodied_object_detection_tpu_torch.models import swin as tswin
from embodied_object_detection_tpu_torch.models.detector import (
    EmbodiedDetector, build_detector)
from embodied_object_detection_tpu_torch.parallel import train_step as tstep
from embodied_object_detection_tpu_torch.structures import GroundTruth

from test_swin import _torch_swin_block
from test_torch_frame import _jax_config, _port_config

T = torch.from_numpy


def jax_params_from_port(shapes, state_dict):
    """The JAX parameter tree of `shapes` (from `jax.eval_shape` of the
    model's init) holding the port's `state_dict`: each leaf is the
    inverse of `load_jax_params`'s layout change, found by sending an
    index array through `_leaf`."""
    def fill(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v, path + (k,))
                continue
            idx = np.arange(int(np.prod(v.shape)), dtype=np.int64).reshape(
                v.shape)
            key, moved = _leaf(path + (k,), idx)
            flat = np.empty(idx.size, np.float32)
            flat[np.asarray(moved).reshape(-1)] = \
                state_dict[".".join(key)].detach().numpy().reshape(-1)
            out[k] = flat.reshape(v.shape)
        return out
    return fill(shapes, ())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _swin_cfg(rate=0.2):
    cfg = _jax_config()
    return cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, name="swin_b",
                                     drop_path_rate=rate),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        memory=dataclasses.replace(cfg.memory, memory_type="image_only"))


def _frame(cfg, seed=0):
    rng = np.random.RandomState(seed)
    h, w = cfg.input.height, cfg.input.width
    g = cfg.input.max_gt_boxes
    boxes = np.zeros((g, 4), np.float32)
    boxes[:3] = [[8, 8, 40, 40], [30, 10, 90, 60], [0, 20, 50, 64]]
    return dict(
        image=rng.randint(0, 255, (h, w, 3)).astype(np.float32),
        zs=rng.randn(cfg.roi.zs_weight_dim,
                     cfg.roi.num_classes + 1).astype(np.float32),
        memf=np.zeros((cfg.memory.max_cells, cfg.memory.memory_dim),
                      np.float32),
        memo=np.zeros((cfg.memory.max_cells,), np.float32),
        proj=np.zeros((h, w), np.int32), outlier=np.zeros((h, w), bool),
        gt_boxes=boxes, gt_classes=np.array([1, 3, 0] + [0] * (g - 3),
                                            np.int32),
        gt_valid=np.arange(g) < 3,
        labels=np.array([1, 3, 0], np.int32),
        labels_valid=np.array([True, True, False]))


@pytest.fixture(scope="module")
def swin_b():
    """The Swin-B detector at the miniature (rate 0.2): the port's seeded
    model and the JAX model and tree holding the same weights."""
    cfg = _swin_cfg()
    port = build_detector(_port_config(cfg), seed=5, device="cpu")
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((h, w, 3)),
        jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)),
        jnp.zeros((cells, d)), jnp.zeros((cells,)),
        jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), bool))
    tree = jax_params_from_port(shapes["params"], port.state_dict())
    return dict(cfg=cfg, port=port, model=model, params={"params": tree})


# ------------------------------------------------ tests/test_swin.py cases

def test_window_partition_roundtrip(rng):
    x = rng.randn(2, 14, 28, 4).astype(np.float32)
    w = tswin.window_partition(T(x), 7)
    assert w.shape == (2 * 2 * 4, 49, 4)
    for b in range(2):
        np.testing.assert_array_equal(
            w[b * 8:(b + 1) * 8].numpy(),
            np.asarray(jswin.window_partition(jnp.asarray(x[b]), 7)))
    np.testing.assert_array_equal(
        tswin.window_reverse(w, 7, 14, 28).numpy(), x)


@pytest.mark.parametrize("ws", [4, 7])
def test_relative_position_index_range(ws):
    idx = tswin.relative_position_index(ws)
    assert idx.shape == (ws * ws, ws * ws)
    assert idx.min() >= 0 and idx.max() < (2 * ws - 1) ** 2
    np.testing.assert_array_equal(idx, jswin.relative_position_index(ws))


@pytest.mark.parametrize("h,w,ws,shift", [(14, 14, 7, 3), (21, 28, 7, 3),
                                          (8, 12, 4, 2)])
def test_shift_mask_blocks(h, w, ws, shift):
    m = tswin.shift_mask(h, w, ws, shift).numpy()
    np.testing.assert_array_equal(m, np.asarray(
        jswin._shift_mask(h, w, ws, shift)))
    assert m.shape == ((h // ws) * (w // ws), ws * ws, ws * ws)
    np.testing.assert_array_equal(m[0], 0.0)
    assert (m < -1).any()


def test_swin_backbone_shapes(rng):
    model = tswin.SwinTransformer(embed_dim=32, depths=(1, 1, 1, 1),
                                  num_heads=(1, 2, 4, 8),
                                  dtype=torch.float32)
    x = T(rng.randn(64, 96, 3).astype(np.float32))
    c3, c4, c5 = model(x)
    assert c3.shape == (8, 12, 64) and c4.shape == (4, 6, 128) and \
        c5.shape == (2, 3, 256)
    assert model.out_channels == (64, 128, 256)
    assert [o.shape for o in model(torch.stack([x, x]))] == [
        (2, 8, 12, 64), (2, 4, 6, 128), (2, 2, 3, 256)]


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_vs_torch_oracle(rng, shift):
    """One block's `.pth` weights through the port's converter against
    test_swin.py's torch oracle (its tolerance: the oracle's LayerNorm
    epsilon is 1e-5, the JAX package's 1e-6) and against JAX's block
    through JAX's converter within 1e-5 of the largest."""
    dim, heads, ws = 32, 4, 4
    h, w = 8, 12
    raw = {
        "norm1.weight": rng.rand(dim).astype(np.float32) + 0.5,
        "norm1.bias": rng.randn(dim).astype(np.float32) * 0.1,
        "attn.qkv.weight": rng.randn(3 * dim, dim).astype(np.float32) * 0.1,
        "attn.qkv.bias": rng.randn(3 * dim).astype(np.float32) * 0.1,
        "attn.proj.weight": rng.randn(dim, dim).astype(np.float32) * 0.1,
        "attn.proj.bias": rng.randn(dim).astype(np.float32) * 0.1,
        "attn.relative_position_bias_table":
            rng.randn((2 * ws - 1) ** 2, heads).astype(np.float32) * 0.1,
        "norm2.weight": rng.rand(dim).astype(np.float32) + 0.5,
        "norm2.bias": rng.randn(dim).astype(np.float32) * 0.1,
        "mlp.fc1.weight": rng.randn(4 * dim, dim).astype(np.float32) * 0.1,
        "mlp.fc1.bias": rng.randn(4 * dim).astype(np.float32) * 0.1,
        "mlp.fc2.weight": rng.randn(dim, 4 * dim).astype(np.float32) * 0.1,
        "mlp.fc2.bias": rng.randn(dim).astype(np.float32) * 0.1,
    }
    x = rng.randn(h, w, dim).astype(np.float32)
    want = _torch_swin_block(x, raw, dim, heads, ws, shift,
                             tswin.relative_position_index(ws))
    sd = {f"backbone.bottom_up.layers.0.blocks.0.{k}": v
          for k, v in raw.items()}
    converted, _ = convert_state_dict(sd)
    assert "_unmapped" not in converted
    prefix = "backbone.stage0_block0."
    blk = tswin.SwinBlock(dim, heads, ws, shift, dtype=torch.float32)
    blk.load_state_dict({k[len(prefix):]: v for k, v in
                         converted["state_dict"].items()})
    mask = tswin.shift_mask(h, w, ws, shift) if shift else None
    got = blk(T(x)[None], mask)[0].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    tree, _ = jax_convert_state_dict(sd)
    jblk = jswin.SwinBlock(dim=dim, num_heads=heads, window_size=ws,
                           shift=shift, dtype=jnp.float32)
    jout = jblk.apply({"params": tree["params"]["backbone"]["stage0_block0"]},
                      jnp.asarray(x))
    assert _rel(got, jout) < 1e-5


def test_swin_transformer_vs_jax(rng):
    """embed 32, depths (1, 1, 2, 1) at 64x96: stages of 16x24, 8x12, 4x6
    and 2x3 tokens, each padded to the 7-token window, stage 2 with a
    shifted block; LayerNorm scales and every bias perturbed."""
    kw = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8))
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jm = jswin.SwinTransformer(dtype=jnp.float32, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x[0])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), params)
    port = tswin.SwinTransformer(dtype=torch.float32, **kw)
    port.load_state_dict(load_jax_params(params))
    with torch.no_grad():
        batched = port(T(x))
        single = port(T(x[1]))
    apply = jax.jit(jm.apply)
    for b in range(2):
        want = apply(params, x[b])
        for got, w in zip(batched, want):
            assert _rel(got[b].numpy(), w) < 1e-5
        if b == 1:
            for got, w in zip(single, want):
                assert _rel(got.numpy(), w) < 1e-5


def test_detector_with_swin(rng):
    """test_swin.py's detector case: the port's Swin-B detector at the
    tiny config (128x160) runs frame_step to its detection capacity."""
    from common import tiny_config
    cfg = tiny_config()
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                   name="swin_b"))
    model = build_detector(_port_config(cfg), seed=0, device="cpu")
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    out = model.frame_step(
        T(rng.randint(0, 255, (h, w, 3)).astype(np.float32)),
        T(rng.randn(512, cfg.roi.num_classes + 1).astype(np.float32)),
        torch.zeros(cells, d), torch.zeros(cells),
        torch.zeros((h, w), dtype=torch.int32),
        torch.zeros((h, w), dtype=torch.bool))
    assert out.detections.boxes.shape == (cfg.roi.detections_per_image, 4)
    assert model.fpn.lateral1.weight.shape[1] == 256
    assert torch.isfinite(out.detections.scores).all()


def test_swin_drop_path_train_only(rng):
    """Eval mode is bit-identical whatever the rate; train mode at rate
    0.5 differs from eval and between two generators; rate 0 draws
    nothing and its train mode is eval."""
    x = T(rng.randn(64, 96, 3).astype(np.float32))
    kw = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
              dtype=torch.float32)
    m0 = tswin.SwinTransformer(drop_path_rate=0.0, **kw)
    m5 = tswin.SwinTransformer(drop_path_rate=0.5, **kw)
    m5.load_state_dict(m0.state_dict())
    with torch.no_grad():
        a = m0(x)
        for ai, bi in zip(a, m5(x)):
            assert torch.equal(ai, bi)
        coins = [m5.draw_coins(1, torch.Generator().manual_seed(s))
                 for s in (1, 2)]
        assert not torch.equal(coins[0], coins[1])
        t1, t2 = (m5(x, c) for c in coins)
        assert max(float((u - v).abs().max()) for u, v in zip(t1, a)) > 0
        assert max(float((u - v).abs().max()) for u, v in zip(t1, t2)) > 0
        assert m0.draw_coins(1, torch.Generator()) is None
        for ai, ti in zip(a, m0(x, torch.ones((1, 4, 2),
                                              dtype=torch.bool))):
            assert torch.equal(ai, ti)


def test_swin_drop_path_linear_decay():
    """The per-block rates are the JAX package's list (and the torch
    Swin's linspace): 0 at the first block, the rate at the last."""
    m = tswin.SwinTransformer(embed_dim=32, depths=(2, 2, 2, 2),
                              num_heads=(1, 2, 4, 8), drop_path_rate=0.35)
    total = 8
    want = [0.35 * i / (total - 1) for i in range(total)]
    assert m.rates == want
    np.testing.assert_allclose(m.rates, np.linspace(0, 0.35, total),
                               atol=1e-9)
    blocks = [getattr(m, f"stage{s}_block{b}").drop_path
              for s in range(4) for b in range(2)]
    assert blocks == want


def test_drop_path_block_scaling(rng):
    """Each residual branch has its own coin, as each of JAX's
    `_drop_path` calls draws its own key: a kept coin scales its branch by
    1 / keep, a dropped one takes its branch out; with both dropped the
    block is the identity. Frames (attention, MLP) kept/kept, kept/
    dropped, dropped/kept and dropped/dropped."""
    dim, ws, p = 16, 4, 0.3
    blk = tswin.SwinBlock(dim, 2, ws, shift=2, drop_path=p,
                          dtype=torch.float32)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape) * 0.2)
    x = T(rng.randn(4, 8, 8, dim).astype(np.float32))
    mask = tswin.shift_mask(8, 8, ws, 2)
    coins = torch.tensor([[True, True], [True, False], [False, True],
                          [False, False]])
    keep = 1.0 - p
    with torch.no_grad():
        out = blk(x, mask, coins)
        y = torch.roll(blk.norm1(x), (-2, -2), dims=(1, 2))
        y = tswin.window_reverse(blk.attn(tswin.window_partition(y, ws),
                                          mask), ws, 8, 8)
        attn = torch.roll(y, (2, 2), dims=(1, 2)) / keep
        for i, (ka, km) in enumerate(coins.tolist()):
            x1 = x[i] + attn[i] if ka else x[i]
            z = torch.nn.functional.gelu(blk.mlp_fc1(blk.norm2(x1)))
            want = x1 + blk.mlp_fc2(z) / keep if km else x1
            if ka or km:
                np.testing.assert_allclose(out[i].numpy(), want.numpy(),
                                           rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(out[i], x[i])
    assert not torch.equal(out[1], out[2])


def test_drop_path_coins_independent_per_branch():
    """`draw_coins` gives each frame, block and branch its own
    Bernoulli(keep) coin: at the last block's rate 0.2 over 40000 frames,
    both branches dropped in 0.04 of them and exactly one in 0.32, each
    branch kept in 0.8 (within 5 standard errors), the two branches
    uncorrelated, and the first block (rate 0) never dropped."""
    m = tswin.SwinTransformer(embed_dim=32, depths=(1, 1, 1, 1),
                              num_heads=(1, 2, 4, 8), drop_path_rate=0.2)
    n = 40000
    coins = m.draw_coins(n, torch.Generator().manual_seed(5))
    assert coins.shape == (n, 4, 2) and coins.dtype == torch.bool
    assert bool(coins[:, 0].all())
    last = coins[:, -1].numpy()

    def near(freq, prob):
        assert abs(freq - prob) <= 5 * np.sqrt(prob * (1 - prob) / n), \
            (freq, prob)

    near(float((~last).all(axis=1).mean()), 0.2 * 0.2)
    near(float((last[:, 0] != last[:, 1]).mean()), 2 * 0.2 * 0.8)
    near(float(last[:, 0].mean()), 0.8)
    near(float(last[:, 1].mean()), 0.8)
    assert abs(np.corrcoef(last[:, 0], last[:, 1])[0, 1]) < 5 / np.sqrt(n)


# ------------------------------------------- the Swin-B detector vs JAX

def test_swin_b_frame_step_vs_jax(swin_b):
    """`frame_step` and `frame_step_debug` at full Swin-B width against
    JAX's `frame_step_debug` (one jit): proposals and each stage's boxes
    within 1e-5 of the largest, region embeddings within 1e-5, sigmoid
    scores within 1e-4 (a logit of ~50 within 2e-6 relative moves its
    sigmoid by up to 1.3e-5), final detections' classes and validity
    equal and boxes and scores within 1e-5."""
    cfg, port = swin_b["cfg"], swin_b["port"]
    f = _frame(cfg)
    args = (f["image"], f["zs"], f["memf"], f["memo"], f["proj"],
            f["outlier"])
    want = jax.jit(lambda p, *a: swin_b["model"].apply(
        p, *a, method=JaxDetector.frame_step_debug))(swin_b["params"], *args)
    got = port.frame_step_debug(*map(T, args))
    step = port.frame_step(*map(T, args))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        elif k.endswith("_scores") and k.startswith("stage"):
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4,
                                       err_msg=k)
        else:
            assert _rel(got[k].numpy(), w) < 1e-5, k
    for name in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(step.detections, name).numpy(),
                                      got[f"final_{name}"].numpy())
    assert int(got["final_valid"].sum()) > 0


def test_swin_b_train_paths_vs_jax_at_rate_0(swin_b):
    """At drop_path_rate 0 the train paths draw nothing, so they are held
    to JAX's: `frame_train` (no proposal subsampling: 16 proposals + 3 GT
    under batch_size_per_image 512), `frame_train_weak` (max_size) and
    `image_box_embedding` in train mode, each within 1e-5 of JAX's
    (losses relative to each, the embedding to its largest)."""
    cfg = swin_b["cfg"].replace(backbone=dataclasses.replace(
        swin_b["cfg"].backbone, drop_path_rate=0.0))
    port = EmbodiedDetector(_port_config(cfg))
    port.load_state_dict(swin_b["port"].state_dict())
    assert not port.drops_paths
    model = JaxDetector(cfg)
    f = _frame(cfg, seed=1)
    gt = (f["gt_boxes"], f["gt_classes"], f["gt_valid"])

    def jax_fn(p):
        losses = model.apply(p, f["image"], f["zs"], f["memf"], f["memo"],
                             f["proj"], JaxGT(*map(jnp.asarray, gt)),
                             method=JaxDetector.frame_train)
        weak = model.apply(p, f["image"], f["zs"], f["labels"],
                           f["labels_valid"], train=True,
                           method=JaxDetector.frame_train_weak)
        emb = model.apply(p, f["image"], train=True,
                          method=JaxDetector.image_box_embedding)
        return losses, weak, emb

    want = jax.jit(jax_fn)(swin_b["params"])
    with torch.no_grad():
        got = (port.frame_train(T(f["image"]), T(f["zs"]), T(f["memf"]),
                                T(f["memo"]), T(f["proj"]),
                                GroundTruth(*map(T, gt))),
               port.frame_train_weak(T(f["image"]), T(f["zs"]),
                                     T(f["labels"]), T(f["labels_valid"]),
                                     train=True),
               port.image_box_embedding(T(f["image"]), train=True))
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert _rel(got[2].numpy(), want[2]) < 1e-5


# ------------------------------------------------- stochastic depth paths

def test_swin_frame_train_applies_drop_path(swin_b):
    """test_swin.py's train-path case: `frame_train` at rate 0.8 on two
    generators' coins gives two losses; at rate 0 no coin is drawn and
    the losses do not depend on the generator; a trunk that drops paths
    refuses train mode without coins."""
    cfg = _swin_cfg(0.8)
    f = _frame(cfg, seed=2)
    gt = GroundTruth(*map(T, (f["gt_boxes"], f["gt_classes"],
                              f["gt_valid"])))

    def loss(model, seed):
        coins = model.drop_path_coins(1, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            out = model.frame_train(T(f["image"]), T(f["zs"]), T(f["memf"]),
                                    T(f["memo"]), T(f["proj"]), gt,
                                    coins=None if coins is None else coins[0])
        return float(sum(out.values()))

    for rate, differ in ((0.8, True), (0.0, False)):
        model = EmbodiedDetector(_port_config(cfg.replace(
            backbone=dataclasses.replace(cfg.backbone,
                                         drop_path_rate=rate))))
        model.load_state_dict(swin_b["port"].state_dict())
        assert (loss(model, 10) != loss(model, 20)) == differ
    with pytest.raises(ValueError, match="drop_path_coins"):
        swin_b["port"].backbone_raw(T(f["image"]), train=True)


def test_swin_train_remat_equal_gradients(swin_b):
    """The flagship step's batch loss at B = 2 with `backbone.train_remat`
    off and on, the coins drawn from one generator seed: the same losses
    and gradients, bit for bit (the recomputed trunk sees the drawn
    coins); and two seeds give other coins."""
    cfg = swin_b["cfg"]
    f = [_frame(cfg, seed=s) for s in (3, 4)]
    batch = tstep.TrainBatch(*[T(np.stack([x[k] for x in f])) for k in (
        "image", "proj", "memf", "memo", "gt_boxes", "gt_classes",
        "gt_valid")], weight=torch.ones(2))
    zs = T(f[0]["zs"])
    runs = []
    for remat in (False, True):
        pcfg = _port_config(cfg.replace(backbone=dataclasses.replace(
            cfg.backbone, train_remat=remat)))
        model = EmbodiedDetector(pcfg)
        model.load_state_dict(swin_b["port"].state_dict())
        total, losses = tstep.batch_losses(
            model, pcfg, batch, zs, 0,
            generator=torch.Generator().manual_seed(7))
        total.backward()
        runs.append((losses, {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None}))
    (l0, g0), (l1, g1) = runs
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    assert sorted(g0) == sorted(g1)
    assert any("stage2_block17" in n for n in g0)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    a, b = (swin_b["port"].drop_path_coins(2, torch.Generator().manual_seed(s))
            for s in (7, 8))
    assert a.shape == (2, 24, 2) and not torch.equal(a, b)
