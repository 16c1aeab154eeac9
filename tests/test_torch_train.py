"""The torch port's training step against the JAX package, on the CPU.

One JAX model is built at the training oracle's miniature (64x96, ResNet
depths (1, 1, 1, 1), f32, train top-k 64 -> 16, 5 classes, 64 cells,
max_gt_boxes 4; tests/test_train_loss_oracle.py) and carried into the port
with `load_jax_params`. `batch_size_per_image` (512) is above the 16 + 4
proposal rows, so the proposal sampler is the identity in both packages.
Checked here, each at its stated tolerance:

  * `frame_train`: every loss entry (rtol 1e-4) and the gradient of their
    sum with respect to every parameter (max |diff| <= 1e-3 max |grad| per
    tensor), against `jax.grad` through the same parameter mapping
  * three `make_train_step` steps at B = 2 with one padding row (weight
    0), at base_lr 1e-3: at each step the losses (rtol 1e-4) and the batch
    gradient (1e-3 max |grad| per tensor) against JAX's, and the update
    against optax's on the same gradients (rtol 1e-5); every parameter
    with a gradient moves beyond the tolerance
  * the optimizer alone on the same gradients (rtol 1e-5), for AdamW and
    SGD, value and full-model clipping, and frozen groups; every
    parameter's label; `lr_schedule` at steps 0, 1, warmup and max
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from embodied_object_detection_tpu.config import DetectorConfig as JaxConfig
from embodied_object_detection_tpu.engine import solver as jsolver
from embodied_object_detection_tpu.models.detector import (
    EmbodiedDetector as JaxDetector)
from embodied_object_detection_tpu.parallel.train_step import (
    TrainBatch as JaxBatch, make_train_step as jax_make_train_step)
from embodied_object_detection_tpu.structures import GroundTruth as JaxGT

from embodied_object_detection_tpu_torch import config as port_config
from embodied_object_detection_tpu_torch.convert.from_jax import (
    _leaf, load_jax_params)
from embodied_object_detection_tpu_torch.data.synthetic import (
    synthetic_train_batch)
from embodied_object_detection_tpu_torch.engine import solver as tsolver
from embodied_object_detection_tpu_torch.models.detector import build_detector
from embodied_object_detection_tpu_torch.parallel.train_step import (
    batch_to_device, make_train_step)
from embodied_object_detection_tpu_torch.structures import GroundTruth

T = torch.from_numpy


def _jax_config() -> JaxConfig:
    cfg = JaxConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=4),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=4))


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


def _port_model(fx):
    port = build_detector(_port_config(fx["cfg"]), seed=1, device="cpu")
    port.load_state_dict(load_jax_params(fx["tree"]))
    return port


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

    rng = np.random.RandomState(5)
    zs = rng.randn(cfg.roi.zs_weight_dim,
                   cfg.roi.num_classes + 1).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    frame = dict(
        image=rng.randint(0, 255, (h, w, 3)).astype(np.float32),
        proj=rng.randint(0, cells, (h, w)).astype(np.int32),
        memf=(rng.randn(cells, d) * 2).astype(np.float32),
        memo=rng.randint(0, 4, (cells,)).astype(np.float32))
    g = cfg.input.max_gt_boxes
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_boxes[0] = [12, 10, 52, 46]
    gt_boxes[1] = [60, 20, 90, 58]
    gt_classes = np.array([1, 3, 0, 0], np.int32)
    gt_valid = np.array([True, True, False, False])
    return dict(cfg=cfg, model=model, params=params, tree=tree, zs=zs,
                frame=frame, gt=(gt_boxes, gt_classes, gt_valid))


def _jax_frame_train(fx, params):
    f, (gb, gc, gv) = fx["frame"], fx["gt"]
    return fx["model"].apply(
        params, jnp.asarray(f["image"]), jnp.asarray(fx["zs"]),
        jnp.asarray(f["memf"]), jnp.asarray(f["memo"]),
        jnp.asarray(f["proj"]),
        JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv)),
        method=JaxDetector.frame_train)


def _port_frame_train(fx, port):
    f, gt = fx["frame"], fx["gt"]
    return port.frame_train(T(f["image"]), T(fx["zs"]), T(f["memf"]),
                            T(f["memo"]), T(f["proj"]),
                            GroundTruth(*[T(x) for x in gt]))


def test_frame_train_losses_vs_jax(fx):
    want = jax.jit(lambda p: _jax_frame_train(fx, p))(fx["params"])
    got = _port_frame_train(fx, _port_model(fx))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    # non-degenerate: positives exist and the cascade sees foreground
    assert float(want["loss_centernet_agn_pos"]) > 0
    assert float(want["loss_box_reg_stage0"]) > 0


def test_frame_train_gradients_vs_jax(fx):
    grads = jax.jit(jax.grad(
        lambda p: sum(_jax_frame_train(fx, p).values())))(fx["params"])
    want = load_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    port = _port_model(fx)
    sum(_port_frame_train(fx, port).values()).backward()
    named = dict(port.named_parameters())
    assert set(named) <= set(want)
    nonzero = 0
    for name, p in named.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert p.grad is None or p.grad.dtype == torch.float32
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-3 * scale, (name, scale)
        nonzero += scale > 0
    # the training losses never reach the mask head; at this miniature the
    # p6/p7 convs and the regression scales of levels with no regression
    # target get zero gradients in both packages too
    assert all(p.grad is None for n, p in named.items() if "mask_head" in n)
    assert nonzero >= 80


def _batch(cfg, seed):
    return synthetic_train_batch(_port_config(cfg),
                                 np.random.RandomState(seed), frames=2,
                                 valid_frames=1)


def test_three_train_steps_vs_optax(fx):
    """Three `make_train_step` steps at a learning rate the updates can be
    seen at (base_lr 1e-3 after a 2-step warmup), beside JAX's step (its
    `loss_fn` gradient, then optax). At every step:

      * the losses against JAX's (rtol 1e-4)
      * the batch gradient against JAX's (max |diff| <= 1e-3 max |grad|
        per tensor)
      * the updated parameters against optax's chain applied to the same
        parameters and the port's own gradients (rtol 1e-5): the clip,
        the moments, the bias correction and the schedule's step

    The parameters of the two runs are not compared element by element:
    AdamW's direction g / (|g| + eps) flips sign wherever the packages'
    gradients differ in sign near 0, a lr-sized step. Every trainable
    parameter with a gradient must move by more than 10 times the update
    check's tolerance, so a step that does not update cannot pass."""
    cfg = fx["cfg"].replace(solver=dataclasses.replace(
        fx["cfg"].solver, base_lr=1e-3, warmup_iters=2, max_iter=10))
    batches = [_batch(cfg, s) for s in (31, 32, 33)]
    init_state, step_fn = jax_make_train_step(fx["model"], cfg)
    state, tx = init_state(fx["params"])
    grad_fn = jax.jit(jax.value_and_grad(step_fn.loss_fn, has_aux=True))
    update = jax.jit(tx.update)
    port = _port_model(fx)
    t_init, t_step = make_train_step(port, _port_config(cfg))
    t_state = t_init()
    named = dict(port.named_parameters())
    leaves = [(keys, name) for keys, name, _ in _flax_leaves(fx["params"])
              if name in named]

    def port_tree(values):
        """The port's tensors under their flax paths (the optimizer is
        elementwise, so the port's layout serves)."""
        return _nested((keys, jnp.asarray(values[name].numpy()))
                       for keys, name in leaves)

    start = {n: p.detach().clone() for n, p in named.items()}
    # the same chain over the port's parameters (FrozenBN is buffers there)
    port_tx = jsolver.build_optimizer(port_tree(start), cfg.solver)
    port_update = jax.jit(port_tx.update)
    port_opt = port_tx.init(port_tree(start))
    zs = jnp.asarray(fx["zs"])
    for i, b in enumerate(batches):
        jb = JaxBatch(**{k: jnp.asarray(v) for k, v in b._asdict().items()
                         if v is not None})
        (total, want), grads = grad_fn(state.params, jb, zs, state.step)
        want["total_loss"] = total
        upd, opt_state = update(grads, state.opt_state, state.params)
        state = state._replace(params=optax.apply_updates(state.params, upd),
                               opt_state=opt_state, step=state.step + 1)
        before = {n: p.detach().clone() for n, p in named.items()}
        t_state, got = t_step(t_state, batch_to_device(b, "cpu"),
                              T(fx["zs"]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        jgrads = load_jax_params(jax.tree_util.tree_map(np.asarray, grads))
        pgrads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in named.items()}
        for n, g in pgrads.items():
            scale = float(jgrads[n].abs().max())
            assert float((g - jgrads[n]).abs().max()) <= 1e-3 * scale, \
                (i, n, scale)
        upd, port_opt = port_update(port_tree(pgrads), port_opt,
                                    port_tree(before))
        expect = optax.apply_updates(port_tree(before), upd)
        for keys, n in leaves:
            node = expect["params"]
            for k in keys:
                node = node[k]
            np.testing.assert_allclose(named[n].detach().numpy(),
                                       np.asarray(node), rtol=1e-5,
                                       atol=1e-8, err_msg=f"step {i} {n}")
    assert t_state.step == 3 and int(state.step) == 3
    assert t_state.optimizer.lr(2) > 5e-4
    moved = 0
    for n, p in named.items():
        if p.grad is None or not bool(p.grad.abs().max() > 0):
            continue
        tol = 1e-8 + 1e-5 * start[n].abs()     # the update check's
        assert float(((p.detach() - start[n]).abs() / tol).max()) > 10, n
        moved += 1
    assert moved >= 80


def _flax_leaves(tree):
    """[(flax path, port name, value)] of every leaf of a params tree."""
    out = []
    for path, value in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", k)) for k in path)
        if keys[0] == "params":
            keys = keys[1:]
        name = ".".join(_leaf(keys, np.asarray(value))[0])
        out.append((keys, name, np.asarray(value)))
    return out


SOLVERS = {
    "adamw": {},
    "adamw_full_model_frozen": dict(clip_type="full_model", clip_value=2.0,
                                    freeze_backbone=True),
    "sgd_nesterov": dict(optimizer="sgd", nesterov=True,
                         backbone_multiplier=0.5),
    "adamw_no_clip": dict(clip_gradients=False, custom_multiplier=3.0),
}


# a leaf of every group: trunk, FrozenBN, FPN lateral and map_merge,
# CenterNet, box head and predictor
SUBSET = ("backbone.layer1_0.conv2.weight", "backbone.layer1_0.bn2.weight",
          "fpn.lateral1.bias", "fpn.map_merge_projection2.weight",
          "centernet.bbox_tower_gn0.weight", "centernet.scale0.scale",
          "roi_heads.box_head1.fc2.weight",
          "roi_heads.box_predictor2.bbox_fc2.bias")


def _nested(items):
    tree = {}
    for keys, value in items:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return {"params": tree}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_optimizer_and_labels_vs_optax(fx, name):
    """Every parameter's label as its flax path's; then three updates of
    a leaf of each group on the same random gradients, some beyond the
    clip value, against optax (rtol 1e-5)."""
    solver = dataclasses.replace(JaxConfig().solver, base_lr=1e-3,
                                 warmup_iters=2, max_iter=10,
                                 **SOLVERS[name])
    port_solver = port_config.SolverConfig(
        **{f.name: getattr(solver, f.name)
           for f in dataclasses.fields(port_config.SolverConfig)})
    leaves = _flax_leaves(fx["params"])
    named = tsolver.param_labels(_port_model(fx).named_parameters(),
                                 port_solver)
    labels = jax.tree_util.tree_leaves(
        jsolver.param_labels(fx["params"], solver))
    for (keys, pname, _), label in zip(leaves, labels):
        if pname in named:
            assert named[pname] == label, pname
        else:
            assert label == "frozen", keys      # FrozenBN: port buffers
    assert len(set(labels)) >= 3

    chosen = [(keys, pname, v) for keys, pname, v in leaves
              if pname in SUBSET]
    assert len(chosen) == len(SUBSET)
    params = _nested((keys, jnp.asarray(v)) for keys, _, v in chosen)
    tx = jsolver.build_optimizer(params, solver)
    opt_state = tx.init(params)
    port_params = [(pname, T(np.array(v)).requires_grad_(True))
                   for _, pname, v in chosen if pname in named]
    opt = tsolver.GroupedOptimizer(port_params, port_solver)
    rng = np.random.RandomState(40)
    for _ in range(3):
        grads = [(rng.randn(*v.shape) * 0.8).astype(np.float32)
                 for _, _, v in chosen]
        updates, opt_state = tx.update(
            _nested((k, jnp.asarray(g)) for (k, _, _), g in
                    zip(chosen, grads)), opt_state, params)
        params = optax.apply_updates(params, updates)
        by_name = {pname: g for (_, pname, _), g in zip(chosen, grads)}
        for pname, p in port_params:
            p.grad = T(by_name[pname])
        opt.step()
    new = {pname: np.asarray(v) for _, pname, v in _flax_leaves(params)}
    for pname, p in port_params:
        np.testing.assert_allclose(p.detach().numpy(), new[pname], rtol=1e-5,
                                   atol=1e-8, err_msg=pname)
        frozen = tsolver.param_label(pname, port_solver) == "frozen"
        start = dict((n, v) for _, n, v in chosen)[pname]
        assert np.array_equal(new[pname], start) == frozen, pname


@pytest.mark.parametrize("kind", ["warmup_cosine", "warmup_multistep"])
def test_lr_schedule_vs_jax(kind):
    solver = dataclasses.replace(JaxConfig().solver, lr_scheduler=kind,
                                 max_iter=500, warmup_iters=100,
                                 steps=(200, 400))
    port_solver = port_config.SolverConfig(
        **{f.name: getattr(solver, f.name)
           for f in dataclasses.fields(port_config.SolverConfig)})
    want = jsolver.lr_schedule(solver)
    got = tsolver.lr_schedule(port_solver)
    for step in (0, 1, 50, 100, 250, 400, 500):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))
