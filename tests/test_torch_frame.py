"""The torch port's recurrent eval frame against the JAX package, on the CPU.

One JAX model is built per module at the oracle miniature (64x96, ResNet
depths (1, 1, 1, 1), f32); its parameters are carried into the port with
`load_jax_params`. Each module is fed the same inputs in both packages,
then the whole `frame_step` runs a 2-frame recurrence (frame 2 reads what
frame 1 wrote), under both write paths, and the episode runner 4-frame
chunks with a reset and with a padding frame.
Tolerances are those of tests/test_full_frame_oracle.py for whole frames;
per-module checks state their own (f32 both sides, convolutions summed in
another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.config import DetectorConfig as JaxConfig
from embodied_object_detection_tpu.models import centernet as jcn
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector, FrameInputs as JaxFrames,
    make_episode_runner as jax_episode_runner)
from embodied_object_detection_tpu.ops.memory_ops import (
    memory_read as jax_memory_read)
from embodied_object_detection_tpu.structures import (
    Detections as JaxDetections, MemoryState as JaxMemory)

from embodied_object_detection_tpu_torch import config as port_config
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.models import centernet as tcn
from embodied_object_detection_tpu_torch.models.detector import (
    build_detector, frame_inputs, make_episode_runner)
from embodied_object_detection_tpu_torch.structures import (
    Detections, MemoryState)


def _jax_config() -> JaxConfig:
    cfg = JaxConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=8),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=64,
                                      post_nms_topk_test=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=16,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=8,
                                   exact_write_subsample=True))


def _port_config(cfg: JaxConfig) -> port_config.DetectorConfig:
    """The same settings, field by field, in the port's dataclasses (a
    section the JAX config lacks, the port's `detr`, at its defaults)."""
    kw = {}
    for f in dataclasses.fields(port_config.DetectorConfig):
        if not hasattr(cfg, f.name):
            continue
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            cls = type(getattr(port_config.DetectorConfig(), f.name))
            value = cls(**{g.name: getattr(value, g.name)
                           for g in dataclasses.fields(cls)})
        kw[f.name] = value
    return port_config.DetectorConfig(**kw)


def _blocky_proj(rng, h, w, cells):
    proj = np.zeros((h, w), np.int32)
    for i in range(8):
        for j in range(8):
            proj[i * h // 8:(i + 1) * h // 8, j * w // 8:(j + 1) * w // 8] = \
                rng.randint(0, cells)
    return proj


@pytest.fixture(scope="module")
def fx():
    cfg = _jax_config()
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    model = JaxDetector(cfg)
    dummy = dict(
        image=jnp.zeros((h, w, 3)),
        zs_weight=jnp.zeros((cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)),
        mem_features=jnp.zeros((cells, d)), mem_obs=jnp.zeros((cells,)),
        proj_indices=jnp.zeros((h, w), jnp.int32),
        outlier_mask=jnp.zeros((h, w), bool))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), **dummy)
    tree = jax.tree_util.tree_map(np.asarray, params)

    port = build_detector(_port_config(cfg), seed=1, device="cpu")
    port.load_state_dict(load_jax_params(tree))

    rng = np.random.RandomState(11)
    images = rng.randint(0, 255, (4, h, w, 3)).astype(np.float32)
    projs = np.stack([_blocky_proj(rng, h, w, cells) for _ in range(4)])
    zs = rng.randn(cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1)
    zs = zs.astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    memf = (rng.randn(cells, d) * 5).astype(np.float32)
    memo = rng.randint(0, 3, cells).astype(np.float32)
    frame_step = jax.jit(lambda p, *a: model.apply(
        p, *a, method=JaxDetector.frame_step))
    return dict(cfg=cfg, model=model, params=params, tree=tree, port=port,
                images=images, projs=projs, zs=zs, memf=memf, memo=memo,
                frame_step=frame_step)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel, atol=1e-6):
    """max |got - want| <= rel * max |want| + atol."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * np.abs(want).max() + atol, (err, np.abs(want).max())


def _jax_apply(fx, fn, *args):
    return fx["model"].apply(fx["params"], *args, method=fn)


def _jax_p(fx, image, ego):
    def fn(m, im, e):
        return m.fpn(*m.backbone_raw(im), e)
    return _jax_apply(fx, fn, jnp.asarray(image), jnp.asarray(ego))


def test_load_jax_params_maps_every_parameter(fx):
    sd = load_jax_params(fx["tree"])
    port_sd = fx["port"].state_dict()
    assert set(sd) == set(port_sd)
    tree = fx["tree"]["params"]
    conv = tree["backbone"]["layer2_0"]["conv2"]["kernel"]       # HWIO
    assert np.array_equal(sd["backbone.layer2_0.conv2.weight"].numpy(),
                          conv.transpose(3, 2, 0, 1))
    fc = tree["roi_heads"]["box_head1"]["fc1"]["kernel"]         # [in, out]
    assert np.array_equal(sd["roi_heads.box_head1.fc1.weight"].numpy(), fc.T)
    dk = tree["roi_heads"]["mask_head"]["deconv_kernel"]         # [2,2,C,D]
    assert np.array_equal(sd["roi_heads.mask_head.deconv.weight"].numpy(),
                          dk.transpose(2, 3, 0, 1))
    gn = tree["centernet"]["bbox_tower_gn2"]["scale"]
    assert np.array_equal(sd["centernet.bbox_tower_gn2.weight"].numpy(), gn)


def test_trunk_c3_c4_c5_vs_jax(fx):
    image = fx["images"][0]
    want = _jax_apply(fx, JaxDetector.backbone_raw, jnp.asarray(image))
    got = fx["port"].backbone_raw(_t(image))
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w, rel=1e-5)
    # the batched trunk over a chunk equals the per-frame trunk
    batched = fx["port"].backbone_raw(_t(fx["images"][:2]))
    for g, b in zip(got, batched):
        _close(b[0].detach().numpy(), g.detach().numpy(), rel=1e-5)


def test_fpn_with_nonzero_memory_vs_jax(fx):
    image, proj = fx["images"][0], fx["projs"][0]
    ego = np.asarray(jax_memory_read(jnp.asarray(fx["memf"]),
                                     jnp.asarray(fx["memo"]),
                                     jnp.asarray(proj)))
    assert np.abs(ego).max() > 0
    want = _jax_p(fx, image, ego)
    port = fx["port"]
    with torch.no_grad():
        got = port.fpn(*port.backbone_raw(_t(image)), _t(ego))
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(g.numpy(), w, rel=1e-5)
    # the memory term matters: zero memory gives other p3
    with torch.no_grad():
        p3_zero = port.fpn(*port.backbone_raw(_t(image)),
                           torch.zeros_like(_t(ego)))[0]
    assert not torch.allclose(p3_zero, got[0])


def test_centernet_proposals_vs_jax(fx):
    cfg = fx["cfg"]
    ego = np.asarray(jax_memory_read(jnp.asarray(fx["memf"]),
                                     jnp.asarray(fx["memo"]),
                                     jnp.asarray(fx["projs"][0])))
    ps = [np.asarray(p) for p in _jax_p(fx, fx["images"][0], ego)]
    hms_w, regs_w = _jax_apply(fx, lambda m, f: m.centernet(f),
                               [jnp.asarray(p) for p in ps])
    with torch.no_grad():
        hms, regs = fx["port"].centernet([_t(p) for p in ps])
    for g, w in zip(hms + regs, list(hms_w) + list(regs_w)):
        _close(g.numpy(), w, rel=1e-5)
    # decode: fed the same head outputs, the proposals agree exactly
    hms_np = [np.asarray(x) for x in hms_w]
    regs_np = [np.asarray(x) for x in regs_w]
    want = jcn.decode_proposals([jnp.asarray(x) for x in hms_np],
                                [jnp.asarray(x) for x in regs_np],
                                cfg.centernet)
    got = tcn.decode_proposals([_t(x) for x in hms_np],
                               [_t(x) for x in regs_np],
                               fx["port"].cfg.centernet)
    assert int(got.valid.sum()) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_cascade_vs_jax(fx):
    cfg = fx["cfg"]
    ego = np.asarray(jax_memory_read(jnp.asarray(fx["memf"]),
                                     jnp.asarray(fx["memo"]),
                                     jnp.asarray(fx["projs"][0])))
    ps = [np.asarray(p) for p in _jax_p(fx, fx["images"][0], ego)]
    hms, regs = _jax_apply(fx, lambda m, f: m.centernet(f),
                           [jnp.asarray(p) for p in ps])
    props = jcn.decode_proposals(hms, regs, cfg.centernet)
    props_np = [np.asarray(x) for x in props]
    hw = (cfg.input.height, cfg.input.width)
    want = _jax_apply(
        fx, lambda m, f, pr, zs: m.roi_heads.run_cascade(f, pr, zs, hw),
        [jnp.asarray(p) for p in ps[:3]],
        JaxDetections(*[jnp.asarray(x) for x in props_np]),
        jnp.asarray(fx["zs"]))
    with torch.no_grad():
        got = fx["port"].roi_heads.run_cascade(
            [_t(p) for p in ps[:3]], Detections(*[_t(x) for x in props_np]),
            _t(fx["zs"]), hw)
    _close(got.final_boxes.numpy(), want.final_boxes, rel=1e-5, atol=1e-4)
    _close(got.mean_scores.numpy(), want.mean_scores, rel=1e-5)
    for gs, ws in zip(got.stages, want.stages):
        _close(gs.clip_feats.numpy(), ws.clip_feats, rel=1e-5)
        _close(gs.logits.numpy(), ws.logits, rel=1e-5)
    # the mask head on the stage-0 boxes
    boxes = np.asarray(want.stages[0].boxes)[:8]
    want_m = _jax_apply(fx, lambda m, f, b: m.roi_heads.mask_logits(f, b),
                        [jnp.asarray(p) for p in ps[:3]], jnp.asarray(boxes))
    with torch.no_grad():
        got_m = fx["port"].roi_heads.mask_logits([_t(p) for p in ps[:3]],
                                                 _t(boxes))
    assert got_m.shape == (8, 28, 28)
    _close(got_m.numpy(), want_m, rel=1e-5)


def _sorted_valid(det):
    v = np.asarray(det.valid)
    b, s, c = (np.asarray(x)[v] for x in (det.boxes, det.scores, det.classes))
    o = np.argsort(-s, kind="stable")
    return b[o], s[o], c[o]


def _check_detections(got, want, score_tol, box_atol):
    gb, gs, gc = _sorted_valid(Detections(*[x.numpy() for x in got]))
    wb, ws, wc = _sorted_valid(want)
    assert len(gs) == len(ws)
    np.testing.assert_allclose(gs, ws, rtol=score_tol[0], atol=score_tol[1])
    np.testing.assert_allclose(gb, wb, rtol=1e-3, atol=box_atol)
    assert (gc == wc).all()


def test_frame_step_two_frame_recurrence_vs_jax(fx):
    cfg = fx["cfg"]
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    image, proj, zs = fx["images"][0], fx["projs"][0], fx["zs"]
    outlier = np.zeros((h, w), bool)
    port = fx["port"]

    memf = np.zeros((cells, d), np.float32)
    memo = np.zeros((cells,), np.float32)
    want = fx["frame_step"](fx["params"], image, zs, memf, memo, proj,
                            outlier)
    got = port.frame_step(_t(image), _t(zs), _t(memf), _t(memo), _t(proj),
                          _t(outlier))
    _check_detections(got.proposals, want.proposals, (1e-4, 1e-5), 5e-3)
    _check_detections(got.detections, want.detections, (1e-4, 1e-5), 5e-3)
    assert np.array_equal(got.write_valid.numpy(),
                          np.asarray(want.write_valid))
    np.testing.assert_allclose(got.write_boxes.numpy(),
                               np.asarray(want.write_boxes), rtol=1e-3,
                               atol=5e-3)
    upd = np.asarray(want.write.features_update)
    np.testing.assert_allclose(got.write.features_update.numpy(), upd,
                               rtol=1e-3, atol=1e-3)
    assert np.array_equal(got.write.obs_update.numpy(),
                          np.asarray(want.write.obs_update))
    assert np.abs(upd).max() > 0, "frame 1 wrote nothing: weak fixture"

    # frame 2 reads what frame 1 wrote
    memf2 = memf + upd
    memo2 = memo + np.asarray(want.write.obs_update)
    want2 = fx["frame_step"](fx["params"], image, zs, memf2, memo2, proj,
                             outlier)
    got2 = port.frame_step(
        _t(image), _t(zs), _t(memf) + got.write.features_update,
        _t(memo) + got.write.obs_update, _t(proj), _t(outlier))
    _check_detections(got2.detections, want2.detections, (1e-3, 1e-4), 1e-2)
    np.testing.assert_allclose(got2.write.features_update.numpy(),
                               np.asarray(want2.write.features_update),
                               rtol=1e-3, atol=1e-3)
    assert np.array_equal(got2.write.obs_update.numpy(),
                          np.asarray(want2.write.obs_update))


@pytest.mark.parametrize("resets,valid", [
    ([True, False, True, False], None),             # reset mid-chunk
    ([True, False, False, True], [True, True, True, False]),  # padding
])
def test_episode_chunk_vs_jax(fx, resets, valid):
    """A 4-frame chunk through both episode runners. A padding frame
    (frame_valid False) neither resets nor writes, even with its reset
    flag set."""
    cfg = fx["cfg"]
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    images, projs, zs = fx["images"], fx["projs"], fx["zs"]
    resets = np.array(resets)
    valid = None if valid is None else np.array(valid)
    frames = frame_inputs(images, projs, resets, cells, "cpu",
                          frame_valid=valid)
    got = make_episode_runner(fx["port"], fx["port"].cfg)(
        frames, _t(zs), MemoryState.zeros(cells, d, "cpu"))

    jframes = JaxFrames(
        image=jnp.asarray(images), proj_indices=jnp.asarray(projs),
        outlier_mask=jnp.zeros(projs.shape, bool),
        obs_visibility=jnp.asarray(frames.obs_visibility.numpy()),
        memory_reset=jnp.asarray(resets), episode_start=jnp.asarray(resets),
        frame_valid=None if valid is None else jnp.asarray(valid))
    want = jax.jit(jax_episode_runner(fx["model"], cfg))(
        fx["params"], jframes, jnp.asarray(zs), JaxMemory.zeros(cells, d))

    assert np.array_equal(got.any_detection.numpy(),
                          np.asarray(want.any_detection))
    assert got.any_detection.numpy()[:2].any(), "no write before the reset"
    for t in range(len(resets)):
        _check_detections(Detections(*[x[t] for x in got.detections]),
                          JaxDetections(*[x[t] for x in want.detections]),
                          (1e-3, 1e-4), 1e-2)
    for g, w in ((got.memory, want.memory),
                 (got.first_memory, want.first_memory)):
        np.testing.assert_allclose(g.features.numpy(),
                                   np.asarray(w.features), rtol=1e-3,
                                   atol=1e-3)
        assert np.array_equal(g.obs_count.numpy(), np.asarray(w.obs_count))
    if valid is not None:
        assert float(got.memory.obs_count.max()) >= 2, \
            "the padding frame's reset flag wiped the memory"


def test_frame_step_strided_write_vs_jax(fx):
    """The legacy strided write (exact_write_subsample=False): the same
    weights under the other write path."""
    cfg = fx["cfg"]
    cfg2 = cfg.replace(memory=dataclasses.replace(
        cfg.memory, exact_write_subsample=False))
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    image, proj, zs = fx["images"][1], fx["projs"][1], fx["zs"]
    memf, memo = fx["memf"], fx["memo"]
    outlier = np.zeros((h, w), bool)
    model2 = JaxDetector(cfg2)
    want = jax.jit(lambda p, *a: model2.apply(
        p, *a, method=JaxDetector.frame_step))(
        fx["params"], image, zs, memf, memo, proj, outlier)
    port2 = build_detector(_port_config(cfg2), seed=1, device="cpu")
    port2.load_state_dict(fx["port"].state_dict())
    got = port2.frame_step(_t(image), _t(zs), _t(memf), _t(memo), _t(proj),
                           _t(outlier))
    _check_detections(got.detections, want.detections, (1e-3, 1e-4), 1e-2)
    upd = np.asarray(want.write.features_update)
    assert np.abs(upd).max() > 0
    np.testing.assert_allclose(got.write.features_update.numpy(), upd,
                               rtol=1e-3, atol=1e-3)
    assert np.array_equal(got.write.obs_update.numpy(),
                          np.asarray(want.write.obs_update))


def test_bf16_frame_runs_on_cpu(fx):
    """The compute dtype the card runs (bf16 trunk, FPN and heads; f32
    sites stay f32), at the miniature on the CPU: finite, same shapes.
    Parameters stay f32, as in the JAX package; bf16 layers cast them at
    each use."""
    cfg = _port_config(fx["cfg"]).replace(compute_dtype="bfloat16")
    model = build_detector(cfg, seed=1, device="cpu")
    model.load_state_dict(fx["port"].state_dict())
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.backbone.dtype == torch.bfloat16
    assert model.roi_heads.box_head0.dtype == torch.bfloat16
    assert torch.equal(model.backbone.conv1.weight,
                       fx["port"].backbone.conv1.weight)
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    frames = frame_inputs(fx["images"][:2], fx["projs"][:2],
                          np.array([True, False]), cells, "cpu")
    out = make_episode_runner(model, cfg)(frames, _t(fx["zs"]),
                                          MemoryState.zeros(cells, d, "cpu"))
    assert out.detections.boxes.shape == (2, 16, 4)
    assert out.detections.boxes.dtype == torch.float32
    assert bool(torch.isfinite(out.detections.scores).all())
    assert bool(torch.isfinite(out.memory.features).all())
    assert bool(out.any_detection.any())
