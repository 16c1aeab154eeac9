"""Slice 17 of the port on the CPU: the parallel paths on
`torch.distributed` (gloo), at the 64x96 f32 miniature.

This file is also the child script of its own two-process runs (`python
tests/test_torch_slice17_parallel.py JOB RANK PORT OUT`): three launches
of two ranks each (`JOBS`), started together when the module's first
test runs, each child on one thread with a 60 s rendezvous timeout; the
parent waits with a timeout, so a hung rendezvous fails and does not
hang. Each child writes {check: {"ok": bool, ...}} to OUT/JOB_RANK.json
and the parametrised tests read the checks:

  * "train": the data-parallel flagship step at world 2 against the plain
    step on the concatenated batch (losses at rtol 1e-5, each gradient
    within 1e-4 of its tensor's largest), two steps, one with the
    reference's normaliser rows and a padding frame; the caption step's
    negatives over the global batch (rtol 2e-4, the counterpart of
    tests/test_multihost.py:151-192); the captiontag (max_size) and
    image-label (wsddn, the prop heads within 1e-3) steps; after every
    step the parameters bit-equal on the two ranks (sha256 of each);
    a Swin trunk's coins at world 2 equal to world 1's; the zs_weight
    model axis on a 1 x 2 mesh at LVIS width (C = 1203, D = 512, R = 256)
    against replication (loss rtol 1e-6, gradients rtol 1e-5 / atol
    1e-6, the counterpart of tests/test_multihost.py:220-272); the
    training loop at world 2 (one metrics.json, rank 0's, its losses
    those of the loop at world 1 at rtol 1e-4). The ranks share the
    world-1 reference work: one computes it while the other waits at its
    next collective;
  * "eval": the sharded runner at world 2 (each rank's lanes bit-equal
    to their single runs: the CPU trunk on one thread is batch-invariant,
    as tests/test_torch_slice7.py holds the batched runner), and
    `evaluate_dataset_sharded` over 2 streams, implicit memory (with the
    semmap snapshots) and semantic_gt, each rank's AP and per-image
    detections recorded for the parent to hold to the serial protocol;
  * "cli": `run.py --coordinator --eval-only --eval-streams 2` in two
    processes with torchrun's RANK / WORLD_SIZE, their AP against the
    serial CLI's.

In this process: `mesh_shape` against the JAX package's `make_mesh` over
the conftest's virtual CPU devices, `pad_streams` and the lane partition
against JAX's, the renamed data axis's error, the sharded runner at
world 1 against single runs and against JAX's
`make_sharded_episode_runner` on a 2-device CPU mesh (tests/
test_torch_slice7.py's tolerances), `evaluate_dataset_sharded` at world
1, `ZeroShotPredictor`'s logits against JAX's on the same zs_weight, and
the CLI's `--eval-streams 2` at world 1. JAX is imported only inside the
oracle tests, so the children never import it.
"""

import dataclasses
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # a child: the repository on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from embodied_object_detection_tpu_torch import run as trun  # noqa: E402
from embodied_object_detection_tpu_torch.config import (DetectorConfig,
                                                        ParallelConfig)
from embodied_object_detection_tpu_torch.data import (
    EpisodeDataset, generate_synthetic_dataset)
from embodied_object_detection_tpu_torch.engine import eval as teval
from embodied_object_detection_tpu_torch.models import detector as tdet
from embodied_object_detection_tpu_torch.models.roi_heads import (
    ZeroShotPredictor)
from embodied_object_detection_tpu_torch.parallel import eval_step as tes
from embodied_object_detection_tpu_torch.parallel import mesh as tmesh
from embodied_object_detection_tpu_torch.parallel import train_step as tstep
from embodied_object_detection_tpu_torch.structures import MemoryState

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
F32 = np.float32
T = torch.from_numpy
CHILD_TIMEOUT_S = 420


# ------------------------------------------------------------ shared set-up

def _miniature() -> DetectorConfig:
    cfg = DetectorConfig()
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_sequence_length=4, score_every=2,
                                  max_gt_boxes=8),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=32,
                                      post_nms_topk_test=8,
                                      pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                num_classes=5, batch_size_per_image=12),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=4,
                                   cls_score_thresh=0.05),
        solver=dataclasses.replace(cfg.solver, base_lr=1e-3,
                                   warmup_iters=0, ims_per_batch=2))


def _train_config() -> DetectorConfig:
    """The miniature with 64-wide FPN, box and mask heads (9.6M
    parameters in place of 64M): the collectives do not depend on the
    widths, and single-threaded AdamW steps and broadcasts of the full
    width would take most of the children's time."""
    cfg = _miniature()
    return cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, fpn_channels=64),
        roi=dataclasses.replace(cfg.roi, fc_dim=64, mask_channels=64))


def _weak_config() -> DetectorConfig:
    cfg = _train_config()
    return cfg.replace(
        centernet=dataclasses.replace(cfg.centernet, post_nms_topk_train=24),
        roi=dataclasses.replace(cfg.roi, with_softmax_prop=True),
        memory=dataclasses.replace(cfg.memory, memory_type="image_only",
                                   write_memory=False))


def _zs(cfg, seed=3):
    zs = np.random.RandomState(seed).randn(
        cfg.roi.zs_weight_dim, cfg.roi.num_classes + 1).astype(F32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    return zs


def _synth_root(root):
    """3 scenes, the first cut to one chunk: 2 streams then have a padded
    lane step."""
    generate_synthetic_dataset(root, num_scenes=3, chunks_per_scene=2,
                               frames=4, height=64, width=96, map_h=8,
                               map_w=8)
    for sub in ("memory_data", "sensor_data"):
        os.remove(os.path.join(root, sub, "scene0000_lvl0_1.h5"))


def _clip_table(path, cfg):
    np.save(path, np.random.RandomState(7).randn(
        cfg.roi.num_classes, cfg.memory.memory_dim).astype(F32))
    return path


def _streams(cfg, b, t, seed=5):
    """[b, t] frames; the even streams reset at frame 0 (and stream 2
    again at frame 1), the odd ones start from a random memory."""
    rng = np.random.RandomState(seed)
    h, w, cells = cfg.input.height, cfg.input.width, cfg.memory.max_cells
    images = rng.randint(0, 255, (b, t, h, w, 3)).astype(F32)
    blocks = rng.randint(0, cells, (b, t, h // 16, w // 16))
    projs = np.repeat(np.repeat(blocks, 16, axis=2), 16,
                      axis=3).astype(np.int32)
    resets = np.zeros((b, t), bool)
    resets[0::2, 0] = True
    if b > 2:
        resets[2, 1] = True
    frames = tdet.frame_inputs(images, projs, resets, cells, "cpu",
                               episode_start=resets)
    feats = np.zeros((b, cells, cfg.memory.memory_dim), F32)
    obs = np.zeros((b, cells), F32)
    feats[1::2] = rng.randn(*feats[1::2].shape) * 5
    obs[1::2] = rng.randint(0, 3, obs[1::2].shape)
    return frames, MemoryState(T(feats), T(obs)), (images, projs, resets)


def _lane(x, i):
    return type(x)(*(None if v is None else v[i] for v in x))


def _episode_check(got, want, exact):
    """(ok, detail): one lane of a batched run against its single run,
    bit for bit where `exact` (the CPU trunk, over B x T frames or over a
    chunk's T, gives the same bits), else (against the
    JAX package) at tests/test_torch_slice7.py's tolerances: scores rtol
    1e-3 atol 1e-4, boxes atol 1e-2, memory rtol/atol 1e-3, counts
    exact."""
    if exact:
        same = all(torch.equal(a, b) for a, b in zip(
            list(got.detections) + list(got.memory) +
            list(got.first_memory) + [got.any_detection],
            list(want.detections) + list(want.memory) +
            list(want.first_memory) + [want.any_detection]))
        return same, "bit-equal" if same else "differs"
    gd, wd = got.detections, want.detections
    if not torch.equal(got.any_detection, want.any_detection):
        return False, "any_detection"
    for t in range(gd.boxes.shape[0]):
        gv, wv = gd.valid[t], wd.valid[t]
        if int(gv.sum()) != int(wv.sum()):
            return False, f"frame {t}: detection counts"
        gs, go = gd.scores[t][gv].sort(descending=True)
        ws, wo = wd.scores[t][wv].sort(descending=True)
        if not torch.allclose(gs, ws, rtol=1e-3, atol=1e-4):
            return False, f"frame {t}: scores"
        if not torch.allclose(gd.boxes[t][gv][go], wd.boxes[t][wv][wo],
                              rtol=1e-3, atol=1e-2):
            return False, f"frame {t}: boxes"
    for g, w in ((got.memory, want.memory),
                 (got.first_memory, want.first_memory)):
        if not torch.allclose(g.features, w.features, rtol=1e-3, atol=1e-3):
            return False, "memory"
        if not torch.equal(g.obs_count, w.obs_count):
            return False, "observation counts"
    return True, "within tolerance"


class RecordingEvaluator(teval.COCOEvaluator):
    """The evaluator, keeping each image's detections as fed."""
    log = {}

    def add_detections(self, image_id, boxes, scores, classes):
        RecordingEvaluator.log[int(image_id)] = dict(
            boxes=np.asarray(boxes, np.float64).tolist(),
            scores=np.asarray(scores, np.float64).tolist(),
            classes=np.asarray(classes).astype(int).tolist())
        return super().add_detections(image_id, boxes, scores, classes)


def _recorded_eval(fn):
    """(EvalResults, {image id: detections}) of fn() with the evaluator
    recording."""
    RecordingEvaluator.log = {}
    orig = teval.COCOEvaluator
    teval.COCOEvaluator = RecordingEvaluator
    try:
        res = fn()
    finally:
        teval.COCOEvaluator = orig
    return res, dict(RecordingEvaluator.log)


def _summary(res, dets):
    return dict(overall=res.overall, quartiles=res.quartiles,
                num_images=res.num_images, timing=res.timing,
                dets={str(k): v for k, v in dets.items()})


def _eval_cfg(out_dir, memory_type=""):
    cfg = _miniature().replace(output_dir=str(out_dir))
    if memory_type:
        cfg = cfg.replace(memory=dataclasses.replace(
            cfg.memory, memory_type=memory_type))
    return cfg


def _datasets(root, clip_path, memory_type=""):
    return EpisodeDataset(root, max_sequence_length=4, max_gt=8,
                          memory_type=memory_type or "implicit_object_memory",
                          clip_path=clip_path if memory_type else "")


class _one_thread:
    """Run on one thread, as the children do: the CPU trunk's sums (and
    so the detections and the AP) depend on the thread count."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _serial(out, memory_type):
    cfg = _eval_cfg(os.path.join(out, f"serial{memory_type}"), memory_type)
    if not memory_type:
        cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                     save_semmap=True))
    model = tdet.build_detector(cfg, seed=0, device="cpu")
    ds = _datasets(os.path.join(out, "root"),
                   os.path.join(out, "table.npy"), memory_type)
    res, dets = _recorded_eval(lambda: teval.evaluate_dataset(
        model, cfg, ds, _zs(cfg), verbose=False, num_workers=0))
    return cfg, model, ds, _summary(res, dets)


def _hold_to_serial(got, want):
    assert got["num_images"] == want["num_images"] > 0
    assert set(got["overall"]) == set(want["overall"])
    for k, v in want["overall"].items():
        assert got["overall"][k] == pytest.approx(v, abs=1e-6), k
    for qg, qw in zip(got["quartiles"], want["quartiles"]):
        assert set(qg) == set(qw)
        for k in qw:
            assert qg[k] == pytest.approx(qw[k], abs=1e-6), k
    # each lane's trunk runs over its own chunk, so the per-image
    # detections are the serial protocol's, bit for bit
    assert got["dets"] == want["dets"]



# ------------------------------------------------------------ the children

def _hashes(model):
    return [hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
            for p in model.parameters()]


def _equal_across_ranks(model):
    import torch.distributed as dist
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, _hashes(model))
    return dict(ok=all(g == got[0] for g in got))


def _grad_check(got, want, rel=1e-4, prop_rel=1e-3):
    """Each gradient within `rel` (the wsddn prop heads' within
    `prop_rel`) of its tensor's largest magnitude plus 1e-6 of the largest
    of any tensor, the floor of gradients that are 0 in exact arithmetic;
    the prop heads' fc2 bias (no gradient in exact arithmetic: the
    softmax over proposals is shift-invariant) skipped, as
    tests/test_torch_slice15_weak.py skips it; at least 10 tensors with a
    gradient."""
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    worst, bad, nonzero = 0.0, [], 0
    for name, w in want.items():
        if name.startswith("prop_score") and name.endswith("fc2.bias"):
            continue
        g = got[name]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        tol = prop_rel if name.startswith("prop_score") else rel
        if err > tol * scale + floor:
            bad.append(name)
        worst = max(worst, err / max(scale, 1e-30))
        nonzero += scale > floor
    return dict(ok=not bad and set(got) == set(want) and nonzero >= 10,
                worst_rel=worst, bad=bad[:5], nonzero=nonzero)


def _grads(model):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for n, p in model.named_parameters()}


def _loss_check(got, want, rtol):
    rel = {k: abs(float(got[k]) - float(want[k])) /
           max(abs(float(want[k])), 1e-30) for k in want}
    return dict(ok=set(got) == set(want) and max(rel.values()) <= rtol,
                worst_rel=max(rel.values()),
                losses={k: float(v) for k, v in got.items()})


def _step_pair(res, label, model, mesh, make_loss_fn, inputs, local_inputs,
               ref_model, start, check_rank, rank, loss_rtol, weak=False):
    """One step of `make_loss_fn(model, mesh)` at world 2 on this rank's
    `local_inputs` from the state dict `start`; on rank `check_rank` the
    same step at world 1 on the global `inputs` from `start`, the losses
    and gradients compared; the parameters compared across the ranks."""
    model.load_state_dict(start)
    fn = make_loss_fn(model, mesh)
    init, step_fn = tstep.make_loss_step(
        model, model.cfg, lambda st, *x: fn(st, *x), mesh=mesh)
    state = tstep.replicate_state(mesh, init())
    state, losses = step_fn(state, *local_inputs)
    grads = _grads(model)
    res[f"{label}_params_equal_across_ranks"] = _equal_across_ranks(model)
    if rank == check_rank:
        ref_model.load_state_dict(start)
        rfn = make_loss_fn(ref_model, None)
        rinit, rstep = tstep.make_loss_step(
            ref_model, ref_model.cfg, lambda st, *x: rfn(st, *x))
        _, want = rstep(rinit(), *inputs)
        res[f"{label}_losses"] = _loss_check(losses, want, loss_rtol)
        res[f"{label}_grads"] = _grad_check(
            grads, _grads(ref_model), prop_rel=1e-3 if weak else 1e-4)
    return state


def _job_train(rank, out, res):
    import copy
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch_fn, synthetic_train_batch)
    from embodied_object_detection_tpu_torch.engine.train import train
    from embodied_object_detection_tpu_torch.models.swin import (
        SwinTransformer)

    cfg = _train_config()
    mesh = tmesh.make_mesh(cfg.parallel)
    assert (mesh.data_size, mesh.model_size, mesh.data_index) == (2, 1, rank)
    zs = T(_zs(cfg))
    model = tdet.build_detector(cfg, seed=0, device="cpu")
    ref = tdet.build_detector(cfg, seed=0, device="cpu")
    start = copy.deepcopy(model.state_dict())

    # the flagship step, twice: the reference normaliser and a padding
    # frame (rank 1 holds one real frame and the pad), then without; the
    # plain step of the concatenated batch from the same state on rank k
    # (the ranks share the reference work: the other waits at the next
    # collective)
    init, step_fn = tstep.make_train_step(model, cfg, mesh=mesh)
    state = tstep.replicate_state(mesh, init())
    rinit, rstep = tstep.make_train_step(ref, cfg)
    rstate = rinit()
    for k, seed in enumerate((11, 12)):
        batch = synthetic_train_batch(cfg, np.random.RandomState(seed), 4,
                                      3 if k == 0 else 4)
        if k == 0:
            batch = batch._replace(loss_norm=np.full(4, 3.0, F32))
        local = tstep.batch_to_device(tmesh.shard_batch(mesh, batch), "cpu")
        before = copy.deepcopy(model.state_dict())
        opt_before = copy.deepcopy(state.optimizer.state_dict())
        state, losses = step_fn(state, local, zs)
        grads = _grads(model)
        res[f"flagship_step{k + 1}_params_equal_across_ranks"] = \
            _equal_across_ranks(model)
        if rank == k:
            ref.load_state_dict(before)
            rstate.optimizer.load_state_dict(opt_before)
            rstate, want = rstep(rstate._replace(step=k),
                                 tstep.batch_to_device(batch, "cpu"), zs)
            res[f"flagship_step{k + 1}_losses"] = _loss_check(losses, want,
                                                              1e-5)
            res[f"flagship_step{k + 1}_grads"] = _grad_check(
                grads, _grads(ref))

    # the caption step: negatives over the global batch
    rng = np.random.RandomState(13)
    h, w = cfg.input.height, cfg.input.width
    images = T(rng.randint(0, 255, (4, h, w, 3)).astype(F32))
    caps = rng.randn(4, cfg.roi.zs_weight_dim).astype(F32)
    caps = T(caps / np.linalg.norm(caps, axis=1, keepdims=True))
    cap_w = T(np.array([1.0, 1.0, 0.0, 1.0], F32))
    sl = slice(2 * rank, 2 * rank + 2)

    def caption(m, mesh_):
        fn = tstep.make_caption_train_step(m, m.cfg, mesh=mesh_)
        return lambda st, im, c, wt: fn(im, c, wt, step=st)

    _step_pair(res, "caption", model, mesh, caption, (images, caps, cap_w),
               (images[sl], caps[sl], cap_w[sl]), ref, start, 0, rank, 2e-4)
    del model, ref

    # the weak steps at the image_only single-frame config
    wcfg = _weak_config()
    wmodel = tdet.build_detector(wcfg, seed=1, device="cpu")
    wref = tdet.build_detector(wcfg, seed=1, device="cpu")
    wstart = copy.deepcopy(wmodel.state_dict())
    labels = T(np.array([[1, 3, 0], [4, 0, 0], [2, 2, 1], [0, 1, 4]],
                        np.int32))
    lv = T(np.array([[1, 1, 0], [1, 0, 0], [1, 0, 0], [1, 1, 1]], bool))
    fvalid = T(np.array([True, True, True, False]))

    def captiontag(m, mesh_):
        fn = tstep.make_captiontag_train_step(m, m.cfg, mesh=mesh_)
        return lambda st, im, c, wt, lab, v, fv: fn(
            im, c, wt, lab, v, zs, frame_valid=fv, step=st)

    def image_label(m, mesh_):
        fn = tstep.make_image_label_train_step(m, m.cfg, variant="wsddn",
                                               mesh=mesh_)
        return lambda st, im, lab, v: fn(im, lab, v, zs, step=st)

    _step_pair(res, "captiontag", wmodel, mesh, captiontag,
               (images, caps, cap_w, labels, lv, fvalid),
               (images[sl], caps[sl], cap_w[sl], labels[sl], lv[sl],
                fvalid[sl]), wref, wstart, 1, rank, 1e-5, weak=True)
    _step_pair(res, "image_label_wsddn", wmodel, mesh, image_label,
               (images, labels, lv), (images[sl], labels[sl], lv[sl]),
               wref, wstart, 0, rank, 1e-5, weak=True)
    del wmodel, wref

    # a Swin trunk's coins: drawn for the global batch, each rank its rows
    swin = SwinTransformer(embed_dim=8, depths=(2, 2, 2, 2),
                           num_heads=(1, 1, 1, 1), drop_path_rate=0.3,
                           dtype=torch.float32)
    stub = types.SimpleNamespace(drops_paths=True,
                                 drop_path_coins=swin.draw_coins)
    for kind in tstep.DROP_PATH_SEEDS:
        for st in (0, 5):
            mine = tstep.train_coins(stub, 2, kind, st, None,
                                     torch.device("cpu"), mesh)
            every = tmesh.gather_into(mine.to(torch.uint8), mesh.data_group,
                                      2)
            want = tstep.train_coins(stub, 4, kind, st, None,
                                     torch.device("cpu"))
            res[f"swin_coins_{kind}_step{st}"] = dict(
                ok=bool(torch.equal(every.bool(), want)) and
                bool(want.any()) and not bool(want.all()))

    # the zs_weight model axis on a 1 x 2 mesh, at LVIS width
    mmesh = tmesh.make_mesh(ParallelConfig(data_parallel=1,
                                           model_parallel=2))
    res["zs_model_axis"] = _zs_model_axis(mmesh)

    # the training loop at world 2: rank 0's metrics.json only; rank 1
    # then runs the loop at world 1 for the parent to compare
    lcfg = cfg.replace(output_dir=os.path.join(out, f"loop_rank{rank}"),
                       solver=dataclasses.replace(cfg.solver,
                                                  checkpoint_period=0))
    lmodel = tdet.build_detector(lcfg, seed=0, device="cpu")
    train(lmodel, lcfg, None, _zs(cfg), max_iter=2, log_period=1, seed=5,
          verbose=False, batch_fn=synthetic_batch_fn(lcfg, 4, 3))
    metrics = os.path.join(lcfg.output_dir, "metrics.json")
    lines = [json.loads(x) for x in open(metrics)] \
        if os.path.exists(metrics) else []
    res["loop_metrics_on_rank0_only"] = dict(
        ok=(len(lines) == 2) if rank == 0 else not os.path.exists(metrics),
        lines=lines)
    res["loop_params_equal_across_ranks"] = _equal_across_ranks(lmodel)
    if rank == 1:
        one = lcfg.replace(output_dir=os.path.join(out, "loop_world1"))
        with _no_process_group():
            train(tdet.build_detector(one, seed=0, device="cpu"), one, None,
                  _zs(cfg), max_iter=2, log_period=1, seed=5, verbose=False,
                  batch_fn=synthetic_batch_fn(one, 4, 3))
        with open(os.path.join(one.output_dir, "metrics.json")) as f:
            res["loop_world1"] = dict(ok=True, lines=[json.loads(x)
                                                       for x in f])


class _no_process_group:
    """Hide the process group, so that `make_mesh` makes a world of
    one."""

    def __enter__(self):
        self.orig = tmesh.dist.is_initialized
        tmesh.dist.is_initialized = lambda: False

    def __exit__(self, *exc):
        tmesh.dist.is_initialized = self.orig


def _zs_model_axis(mesh):
    """ZeroShotPredictor's loss (sigmoid BCE over C + 1 columns) and
    gradients with zs_weight sharded over the model axis against
    replicated, on each rank; C = 1203, D = 512, R = 256."""
    c, d, fc, r = 1203, 512, 64, 256
    rng = np.random.RandomState(0)
    zs = rng.randn(d, c + 1).astype(F32)
    zs[:, -1] = 0.0
    zs /= np.maximum(np.linalg.norm(zs, axis=0, keepdims=True), 1e-6)
    x = T(rng.randn(r, fc).astype(F32))
    onehot = torch.zeros(r, c + 1)
    onehot[torch.arange(r), T(rng.randint(0, c + 1, (r,)))] = 1.0
    torch.manual_seed(1)
    pred = ZeroShotPredictor(fc, d)

    def loss_grads(zsw):
        pred.zero_grad(set_to_none=True)
        logits, _, _ = pred(x, zsw)
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            logits, onehot)
        loss.backward()
        return float(loss), {n: p.grad.clone() for n, p in
                             pred.named_parameters() if p.grad is not None}

    shard = tmesh.shard_zs_weight(mesh, T(zs))
    l_tp, g_tp = loss_grads(shard)
    l_rep, g_rep = loss_grads(T(zs))
    loss_rel = abs(l_tp - l_rep) / abs(l_rep)
    grad_ok = set(g_tp) == set(g_rep) == {"cls_linear.weight",
                                          "cls_linear.bias"} and all(
        torch.allclose(g_tp[k], g_rep[k], rtol=1e-5, atol=1e-6)
        for k in g_rep)
    return dict(ok=isinstance(shard, tmesh.ColumnShard) and
                shard.block.shape == (d, (c + 1) // 2) and
                loss_rel <= 1e-6 and grad_ok, loss_rel=loss_rel)


def _job_eval(rank, out, res):
    cfg = _miniature()
    mesh = tmesh.make_mesh(cfg.parallel)
    model = tdet.build_detector(cfg, seed=0, device="cpu")
    zs = T(_zs(cfg))
    frames, mem, _ = _streams(cfg, 4, 3)
    run = tes.make_sharded_episode_runner(model, cfg, mesh)
    out_l = run(frames, zs, mem)
    lanes = list(run.lanes(4))
    single = tdet.make_episode_runner(model, cfg)
    for k, g in enumerate(lanes):
        ok, how = _episode_check(
            types.SimpleNamespace(
                detections=_lane(out_l.detections, k),
                memory=_lane(out_l.memory, k),
                first_memory=_lane(out_l.first_memory, k),
                any_detection=out_l.any_detection[k]),
            single(_lane(frames, g), zs, _lane(mem, g)), True)
        res[f"runner_lane{g}"] = dict(ok=ok, how=how, lanes=lanes)
    # a memory given as this rank's lanes (as the runner returns it)
    again = run(frames, zs, tmesh.shard_batch(mesh, mem))
    res[f"runner_local_memory_rank{rank}"] = dict(ok=all(
        torch.equal(a, b) for a, b in zip(again.memory, out_l.memory)))

    root = os.path.join(out, "root")
    clip = os.path.join(out, "table.npy")
    for mt in ("", "semantic_gt"):
        ecfg = _eval_cfg(os.path.join(out, f"sharded{mt}"), mt)
        if not mt:
            ecfg = ecfg.replace(memory=dataclasses.replace(
                ecfg.memory, save_semmap=True))
        emodel = tdet.build_detector(ecfg, seed=0, device="cpu")
        ds = _datasets(root, clip, mt)
        result, dets = _recorded_eval(lambda: teval.evaluate_dataset_sharded(
            emodel, ecfg, ds, _zs(cfg), streams=2, verbose=False,
            num_workers=0))
        res[f"sharded_{mt or 'implicit'}"] = dict(ok=True,
                                                  **_summary(result, dets))
    # the serial protocol on this thread count, for the parent to hold
    # both ranks to: rank 0 the implicit memory's, rank 1 semantic_gt's
    mt = ("", "semantic_gt")[rank]
    res[f"serial_{mt or 'implicit'}"] = dict(ok=True,
                                             **_serial(out, mt)[3])


def _job_cli(rank, out, res, port):
    res["cli"] = dict(ok=True, ap=_cli_ap(
        os.path.join(out, "root"), os.path.join(out, "cli"),
        ["--coordinator", f"127.0.0.1:{port}", "--eval-streams", "2"]))


def _cli_ap(root, out_dir, extra):
    results = trun.main(
        ["--device", "cpu", "--eval-only", "--data-path", root,
         "--output-dir", out_dir, "--zs-weight", "random"] + extra +
        ["--opts", "compute_dtype=float32", "backbone.depths=(1,1,1,1)",
         "input.height=64", "input.width=96",
         "input.max_sequence_length=4", "input.score_every=2",
         "input.max_gt_boxes=8", "centernet.pre_nms_topk_test=32",
         "centernet.post_nms_topk_test=8", "roi.detections_per_image=8",
         "roi.num_classes=5", "memory.max_cells=64", "memory.write_topk=4"])
    return dict(overall=results.overall, num_images=results.num_images,
                streams=results.timing.get("streams", 1.0))


def _child(job, rank, port, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    res = {}
    if job == "cli":
        _job_cli(rank, out, res, port)
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=2, timeout=datetime.timedelta(seconds=60))
        {"train": _job_train, "eval": _job_eval}[job](rank, out, res)
    with open(os.path.join(out, f"{job}_{rank}.json"), "w") as f:
        json.dump(res, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------------ the parent

JOBS = ("train", "eval", "cli")
TRAIN_CHECKS = (
    [f"flagship_step{k}_{c}" for k in (1, 2)
     for c in ("losses", "grads", "params_equal_across_ranks")] +
    [f"{s}_{c}" for s in ("caption", "captiontag", "image_label_wsddn")
     for c in ("losses", "grads", "params_equal_across_ranks")] +
    [f"swin_coins_{k}_step{s}" for k in ("box", "caption", "weak")
     for s in (0, 5)] +
    ["zs_model_axis", "loop_metrics_on_rank0_only",
     "loop_params_equal_across_ranks"])


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The three two-process launches, started at the module's first
    test; their inputs (an h5 root, a class table) made first."""
    out = str(tmp_path_factory.mktemp("slice17"))
    _synth_root(os.path.join(out, "root"))
    _clip_table(os.path.join(out, "table.npy"), _miniature())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for job in JOBS:
        port = str(_free_port())
        procs[job] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(r), port,
             out], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    yield out, procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def results(launched):
    """{job: [rank 0's checks, rank 1's]}; a child that fails or outlasts
    its timeout fails here with its output."""
    out, procs = launched
    got = {}
    for job, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                text = p.communicate(timeout=CHILD_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise AssertionError(f"{job} rank {r}: timed out")
            assert p.returncode == 0, f"{job} rank {r}:\n{text[-4000:]}"
        got[job] = [json.load(open(os.path.join(out, f"{job}_{r}.json")))
                    for r in (0, 1)]
    return got


@pytest.fixture(scope="module", autouse=True)
def _start_children(launched):
    """Start the children before the first test, so that they run while
    this process runs the oracle tests; this process runs on one thread
    meanwhile, as they do (the trunk's sums depend on the thread count,
    and the children's references are taken on one)."""
    with _one_thread():
        yield


# ------------------------------------------------------------ in-process

@pytest.mark.parametrize("world,cfg", [
    (8, dict()), (8, dict(model_parallel=2)), (8, dict(data_parallel=2,
                                                      model_parallel=4)),
    (4, dict(model_parallel=4)), (2, dict()), (1, dict()),
    (8, dict(data_parallel=3)), (8, dict(model_parallel=3)),
    (6, dict(data_parallel=4, model_parallel=2))])
def test_mesh_shape_vs_jax_make_mesh(world, cfg):
    import jax
    from embodied_object_detection_tpu.config import (
        ParallelConfig as JaxParallel)
    from embodied_object_detection_tpu.parallel.mesh import make_mesh
    try:
        want = make_mesh(JaxParallel(**cfg), devices=jax.devices()[:world])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_shape(ParallelConfig(**cfg), world)
        assert str(got.value) == str(e)
        return
    assert tmesh.mesh_shape(ParallelConfig(**cfg), world) == \
        (want.shape["data"], want.shape["model"])


@pytest.mark.parametrize("opts", [
    ["parallel.data_parallel=2", "parallel.model_parallel=4"],
    ["parallel.data_axis=streams", "parallel.model_axis=tp"],
    ["parallel.data_parallel=-1"]])
def test_parallel_opts_parse_as_jax(opts):
    from embodied_object_detection_tpu.config import (
        DetectorConfig as JaxConfig, apply_opts as jax_apply_opts)
    from embodied_object_detection_tpu_torch.config import apply_opts
    got = apply_opts(DetectorConfig(), opts).parallel
    want = jax_apply_opts(JaxConfig(), opts).parallel
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got != ParallelConfig() or opts == ["parallel.data_parallel=-1"]


def test_make_mesh_without_a_process_group():
    mesh = tmesh.make_mesh(ParallelConfig(data_axis="streams"))
    assert mesh == tmesh.Mesh("streams", "model", 1, 1, 0, 0, None, None)
    assert mesh.shape == {"streams": 1, "model": 1} and mesh.rank == 0
    with pytest.raises(ValueError, match="world_size=2"):
        tmesh.make_mesh(world_size=2)
    with pytest.raises(ValueError, match="do not factor"):
        tmesh.make_mesh(ParallelConfig(model_parallel=2))
    # without a group every collective is the identity
    x = torch.arange(6.0).reshape(3, 2)
    assert tmesh.all_reduce_sum(x, None) is x
    assert tmesh.gather_rows(mesh, x, "streams") is x
    assert tmesh.replicate(mesh, [x])[0] is x
    assert tmesh.shard_zs_weight(mesh, x) is x


def test_shard_batch_rows():
    mesh = tmesh.Mesh(data_size=2, data_index=1, model_size=3,
                      model_index=2)
    batch = tstep.TrainBatch(*(np.arange(4 * (i + 1)).reshape(4, -1)
                               for i in range(8)), loss_norm=None)
    got = tmesh.shard_batch(mesh, batch)
    assert got.loss_norm is None
    for g, b in zip(got[:8], batch[:8]):
        np.testing.assert_array_equal(g, b[2:])
    assert mesh.rank == 5
    np.testing.assert_array_equal(
        tmesh.shard_batch(mesh, np.arange(6), "model"), [4, 5])
    with pytest.raises(ValueError, match="multiple of the 'data'"):
        tmesh.shard_batch(mesh, np.arange(3))
    assert tmesh.shard_batch(mesh, {"a": torch.arange(4)})["a"].tolist() \
        == [2, 3]


@pytest.mark.parametrize("cols", [1204, 1203])
def test_shard_zs_weight_blocks(cols):
    mesh = tmesh.Mesh(model_size=2, model_index=1, model_group="g")
    zs = torch.randn(8, cols)
    got = tmesh.shard_zs_weight(mesh, zs)
    if cols % 2:
        assert got is zs
    else:
        assert isinstance(got, tmesh.ColumnShard)
        assert torch.equal(got.block, zs[:, cols // 2:])
        assert got.shape == (8, cols) and (got.size, got.index) == (2, 1)


def test_zero_shot_predictor_vs_jax():
    """The predictor's logits on the same zs_weight as JAX's (LVIS width),
    the port's weights through the converter's layout."""
    import jax
    import jax.numpy as jnp
    from embodied_object_detection_tpu.models.roi_heads import (
        ZeroShotPredictor as JaxPredictor)
    c, d, fc, r = 1203, 512, 64, 256
    rng = np.random.RandomState(0)
    zs = rng.randn(d, c + 1).astype(F32)
    zs[:, -1] = 0.0
    zs /= np.maximum(np.linalg.norm(zs, axis=0, keepdims=True), 1e-6)
    x = rng.randn(r, fc).astype(F32)
    jp = JaxPredictor(zs_dim=d, dtype=jnp.float32)
    params = jax.jit(jp.init)(jax.random.PRNGKey(1), jnp.asarray(x),
                              jnp.asarray(zs))
    want = jp.apply(params, jnp.asarray(x), jnp.asarray(zs))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    port = ZeroShotPredictor(fc, d)
    assert set(p) == {"cls_linear", "bbox_fc1", "bbox_fc2"}
    with torch.no_grad():
        for name in p:
            mod = getattr(port, name)
            mod.weight.copy_(T(p[name]["kernel"].T.copy()))
            mod.bias.copy_(T(p[name]["bias"]))
    got = port(T(x), T(zs))
    np.testing.assert_allclose(got[0].detach().numpy(),
                               np.asarray(want[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[2].detach().numpy(),
                               np.asarray(want[2]), rtol=1e-5, atol=1e-5)


def _jax_partition(root, streams):
    """The lanes of the JAX package's `evaluate_dataset_sharded` over
    `root`: its runner replaced by a recorder of each step's valid lanes,
    its dataset by one that logs the chunks it reads."""
    import jax.numpy as jnp
    from embodied_object_detection_tpu.data.episode_dataset import (
        EpisodeDataset as JaxDataset)
    from embodied_object_detection_tpu.engine import eval as jeval
    from embodied_object_detection_tpu.models.detector import EpisodeOutputs
    from embodied_object_detection_tpu.parallel import eval_step as jes
    from embodied_object_detection_tpu.parallel.mesh import make_mesh
    from embodied_object_detection_tpu.structures import (Detections,
                                                          MemoryState as JM)
    from embodied_object_detection_tpu.config import (
        DetectorConfig as JaxConfig, ParallelConfig as JaxParallel)
    import jax

    inner = JaxDataset(root, max_sequence_length=4, max_gt=8)
    reads, steps = [], []

    class Logged:
        files = inner.files

        def __len__(self):
            return len(inner)

        def __getitem__(self, i):
            reads.append(i)
            return inner[i]

    def fake_runner(model, cfg, mesh, data_axis="data"):
        def run(params, frames, zs, memory):
            valid = np.asarray(frames.frame_valid).any(axis=1)
            steps.append(valid.tolist())
            b, t = frames.frame_valid.shape
            n = 2
            dets = Detections(boxes=jnp.zeros((b, t, n, 4)),
                              scores=jnp.zeros((b, t, n)),
                              classes=jnp.zeros((b, t, n), jnp.int32),
                              valid=jnp.zeros((b, t, n), bool))
            return EpisodeOutputs(detections=dets, memory=memory,
                                  any_detection=jnp.zeros((b, t), bool),
                                  first_memory=memory)
        return run

    cfg = JaxConfig()
    cfg = cfg.replace(input=dataclasses.replace(cfg.input, height=64,
                                                width=96, score_every=2),
                      roi=dataclasses.replace(cfg.roi, num_classes=5),
                      memory=dataclasses.replace(cfg.memory, max_cells=64))
    orig = jes.make_sharded_episode_runner
    jes.make_sharded_episode_runner = fake_runner
    try:
        mesh = make_mesh(JaxParallel(data_parallel=1),
                         devices=jax.devices()[:1])
        jeval.evaluate_dataset_sharded(None, None, cfg, Logged(),
                                       np.zeros((512, 6), F32), mesh=mesh,
                                       streams=streams, verbose=False,
                                       num_workers=0)
    finally:
        jes.make_sharded_episode_runner = orig
    lanes = [[] for _ in range(streams)]
    it = iter(reads)
    for valid in steps:
        for lane, v in enumerate(valid):
            if v:
                lanes[lane].append(next(it))
    return inner.files, lanes


@pytest.mark.parametrize("streams", [2, 3, 4])
def test_lane_partition_vs_jax(tmp_path, streams):
    root = str(tmp_path / "root")
    generate_synthetic_dataset(root, num_scenes=4, chunks_per_scene=3,
                               frames=2, height=32, width=32, map_h=4,
                               map_w=4)
    for name in ("scene0001_lvl0_2.h5", "scene0003_lvl0_1.h5",
                 "scene0003_lvl0_2.h5"):
        for sub in ("memory_data", "sensor_data"):
            os.remove(os.path.join(root, sub, name))
    files, want = _jax_partition(root, streams)
    assert teval.partition_lanes(files, streams) == want
    assert sum(map(len, want)) == len(files)
    assert teval.scene_of("scene0003_lvl0_10.h5") == "scene0003_lvl0"


@pytest.mark.parametrize("test_type", ["default", "episodic"])
def test_ground_truth_read_is_the_chunks_gt(launched, test_type):
    """What a rank reads of the other ranks' lanes (the detection records
    only) is what scoring reads of the whole chunk."""
    out, _ = launched
    ds = EpisodeDataset(os.path.join(out, "root"), test_type=test_type,
                        max_sequence_length=4, max_gt=8)
    for i in range(len(ds)):
        whole, gt = ds[i], ds.ground_truth(i)
        assert gt.images.shape[1:3] == (0, 0) and gt.memory_features is None
        for name in ("sequence_name", "file_names", "gt_boxes", "gt_classes",
                     "gt_valid", "memory_reset", "episode_start",
                     "frame_valid"):
            np.testing.assert_array_equal(getattr(gt, name),
                                          getattr(whole, name), err_msg=name)


@pytest.mark.parametrize("n,multiple", [(3, 2), (4, 2), (5, 4), (1, 8)])
def test_pad_streams_vs_jax(n, multiple):
    from embodied_object_detection_tpu.parallel.eval_step import (
        pad_streams as jax_pad)
    from embodied_object_detection_tpu.structures import MemoryState as JM
    cfg = _miniature()
    frames, mem, _ = _streams(cfg, n, 2)
    jframes = type(frames)(*(None if x is None else x.numpy()
                             for x in frames))
    jmem = JM(*(x.numpy() for x in mem))
    want_f, want_m, want_n = jax_pad(jframes, jmem, n, multiple)
    for arg_f, arg_m in ((frames, mem), (jframes, mem._replace(
            features=mem.features.numpy(), obs_count=mem.obs_count.numpy()))):
        got_f, got_m, got_n = tes.pad_streams(arg_f, arg_m, n, multiple)
        assert got_n == want_n == n
        for g, w in zip(list(got_f) + list(got_m),
                        list(want_f) + list(want_m)):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_renamed_data_axis_error():
    """A renamed `parallel.data_axis` reaches the runner's error, as
    tests/test_sharded_eval.py:206-227 holds JAX's."""
    cfg = _miniature().replace(parallel=ParallelConfig(data_axis="streams"))
    model = tdet.build_detector(cfg, seed=0, device="cpu")
    mesh = tmesh.Mesh("streams", "model", data_size=2)
    run = tes.make_sharded_episode_runner(model, cfg, mesh,
                                          data_axis=cfg.parallel.data_axis)
    frames, mem, _ = _streams(cfg, 3, 2)
    with pytest.raises(ValueError, match="'streams' axis size 2"):
        run(frames, T(_zs(cfg)), mem)
    assert list(run.lanes(4)) == [0, 1]


@pytest.fixture(scope="module")
def runner_fx():
    # the mask probabilities of seeded weights sit at sigmoid(0) = 0.5:
    # a paste threshold of 0.3 keeps the written pixels off the
    # threshold, so that the packages' memories can be held to each other
    # (as tests/test_sharded_eval.py sets it)
    cfg = _miniature()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                 mask_thresh=0.3))
    model = tdet.build_detector(cfg, seed=0, device="cpu")
    frames, mem, raw = _streams(cfg, 2, 3)
    out = tes.make_sharded_episode_runner(
        model, cfg, tmesh.make_mesh(cfg.parallel))(frames, T(_zs(cfg)), mem)
    return dict(cfg=cfg, model=model, frames=frames, mem=mem, raw=raw,
                out=out)


@pytest.mark.parametrize("lane", [0, 1])
def test_sharded_runner_world_1_vs_single_runs(runner_fx, lane):
    fx = runner_fx
    got = fx["out"]
    one = tdet.make_episode_runner(fx["model"], fx["cfg"])(
        _lane(fx["frames"], lane), T(_zs(fx["cfg"])), _lane(fx["mem"], lane))
    ok, how = _episode_check(
        types.SimpleNamespace(
            detections=_lane(got.detections, lane),
            memory=_lane(got.memory, lane),
            first_memory=_lane(got.first_memory, lane),
            any_detection=got.any_detection[lane]),
        one, True)
    assert ok, how
    assert bool(got.any_detection[lane].any())


def test_sharded_runner_vs_jax_on_a_2_device_mesh(runner_fx):
    """The world-1 runner's two lanes against JAX's
    `make_sharded_episode_runner` over a 2-device CPU mesh on the same
    weights, at tests/test_torch_slice7.py's tolerances."""
    import jax
    import jax.numpy as jnp
    from embodied_object_detection_tpu.models.detector import (
        EmbodiedDetector as JaxDetector, FrameInputs as JaxFrames)
    from embodied_object_detection_tpu.parallel.eval_step import (
        make_sharded_episode_runner)
    from embodied_object_detection_tpu.parallel.mesh import make_mesh
    from embodied_object_detection_tpu.config import (
        DetectorConfig as JaxConfig, ParallelConfig as JaxParallel)
    from embodied_object_detection_tpu.structures import (
        MemoryState as JaxMemory)
    from test_torch_slice16_swin import jax_params_from_port

    fx = runner_fx
    jcfg = JaxConfig()
    for f in dataclasses.fields(fx["cfg"]):
        if not hasattr(jcfg, f.name):       # the port's own `detr` section
            continue
        value = getattr(fx["cfg"], f.name)
        if dataclasses.is_dataclass(value):
            value = dataclasses.replace(getattr(jcfg, f.name), **{
                g.name: getattr(value, g.name)
                for g in dataclasses.fields(value)})
        jcfg = jcfg.replace(**{f.name: value})
    model = JaxDetector(jcfg)
    h, w, cells = 64, 96, 64
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((h, w, 3)),
        jnp.zeros((512, 6)), jnp.zeros((cells, 512)), jnp.zeros((cells,)),
        jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), bool))
    params = {"params": jax_params_from_port(shapes["params"],
                                             fx["model"].state_dict())}
    images, projs, resets = fx["raw"]
    jframes = JaxFrames(
        image=jnp.asarray(images), proj_indices=jnp.asarray(projs),
        outlier_mask=jnp.zeros(projs.shape, bool),
        obs_visibility=jnp.asarray(fx["frames"].obs_visibility.numpy()),
        memory_reset=jnp.asarray(resets), episode_start=jnp.asarray(resets))
    mesh = make_mesh(JaxParallel(data_parallel=2),
                     devices=jax.devices()[:2])
    want = make_sharded_episode_runner(model, jcfg, mesh)(
        params, jframes, jnp.asarray(_zs(fx["cfg"])),
        JaxMemory(*(jnp.asarray(x.numpy()) for x in fx["mem"])))
    got = fx["out"]
    for b in range(2):
        ok, how = _episode_check(
            types.SimpleNamespace(
                detections=_lane(got.detections, b),
                memory=_lane(got.memory, b),
                first_memory=_lane(got.first_memory, b),
                any_detection=got.any_detection[b]),
            types.SimpleNamespace(
                detections=type(got.detections)(*(
                    T(np.asarray(x[b])) for x in want.detections)),
                memory=MemoryState(*(T(np.asarray(x[b]))
                                     for x in want.memory)),
                first_memory=MemoryState(*(T(np.asarray(x[b]))
                                           for x in want.first_memory)),
                any_detection=T(np.asarray(want.any_detection[b]))),
            exact=False)
        assert ok, (b, how)


# ------------------------------------------------------------ the children's checks

@pytest.mark.parametrize("check", TRAIN_CHECKS)
def test_data_parallel_train_at_world_2(results, check):
    """A check of the train job: the world-1 comparisons on the rank that
    made them, the others on both ranks."""
    recs = [r[check] for r in results["train"] if check in r]
    assert len(recs) == (1 if check.endswith(("_losses", "_grads"))
                         else 2), check
    for rec in recs:
        assert rec["ok"], rec


def test_train_loop_world_2_losses_vs_world_1(results):
    """The loop's logged losses at world 2 (rank 0's metrics.json) are
    the loop's at world 1 on the same batches, at rtol 1e-4 (the second
    step starts from parameters that moved by gradients summed in
    another order)."""
    got = results["train"][0]["loop_metrics_on_rank0_only"]["lines"]
    want = results["train"][1]["loop_world1"]["lines"]
    assert len(got) == len(want) == 2
    keys = [k for k in want[0] if k.startswith("loss") or k == "total_loss"]
    assert len(keys) > 5
    for g, w in zip(got, want):
        assert g["iteration"] == w["iteration"]
        for k in keys:
            assert g[k] == pytest.approx(w[k], rel=1e-4), k


@pytest.mark.parametrize("lane", range(4))
def test_sharded_runner_lanes_at_world_2(results, lane):
    recs = [r[f"runner_lane{lane}"] for r in results["eval"]
            if f"runner_lane{lane}" in r]
    assert len(recs) == 1 and recs[0]["ok"], recs
    assert lane in recs[0]["lanes"] and len(recs[0]["lanes"]) == 2
    assert all(results["eval"][r][f"runner_local_memory_rank{r}"]["ok"]
               for r in (0, 1))


@pytest.mark.parametrize("memory_type", ["", "semantic_gt"])
def test_evaluate_dataset_sharded_world_2_vs_serial(launched, results,
                                                    memory_type):
    """Both ranks' AP, quartiles and per-image detections against the
    serial protocol's, run by one of the children on its one thread."""
    out, _ = launched
    name = memory_type or "implicit"
    want = [r[f"serial_{name}"] for r in results["eval"]
            if f"serial_{name}" in r]
    assert len(want) == 1
    want = want[0]
    for r in (0, 1):
        got = results["eval"][r][f"sharded_{memory_type or 'implicit'}"]
        _hold_to_serial(got, want)
        assert got["timing"]["streams"] == 2.0
    if not memory_type:
        # each lane's semmap snapshots, written by the rank that ran it
        import h5py
        a = os.path.join(out, "serial", "memory")
        b = os.path.join(out, "sharded", "memory")
        assert sorted(os.listdir(a)) == sorted(os.listdir(b)) and \
            len(os.listdir(a)) == 5
        for fn in os.listdir(a):
            with h5py.File(os.path.join(a, fn)) as x, \
                    h5py.File(os.path.join(b, fn)) as y:
                for key in ("semmap", "impicit_memory", "observations"):
                    np.testing.assert_array_equal(x[key][()], y[key][()])


@pytest.mark.parametrize("memory_type", ["", "semantic_gt"])
def test_evaluate_dataset_sharded_world_1_vs_serial(launched, memory_type,
                                                    tmp_path):
    out, _ = launched
    cfg, model, ds, want = _serial(out, memory_type)
    cfg = cfg.replace(output_dir=str(tmp_path), memory=dataclasses.replace(
        cfg.memory, save_semmap=False))
    res, dets = _recorded_eval(lambda: teval.evaluate_dataset_sharded(
        model, cfg, ds, _zs(cfg), streams=2, verbose=False, num_workers=0))
    _hold_to_serial(_summary(res, dets), want)
    assert res.timing["streams"] == 2.0
    assert set(res.timing) == {"data_s_per_chunk", "compute_s_per_chunk",
                               "eval_s_per_chunk", "total_s",
                               "frames_per_s", "streams"}
    with pytest.raises(ValueError, match="multiple of the data axis"):
        teval.evaluate_dataset_sharded(
            model, cfg, ds, _zs(cfg), streams=3, verbose=False,
            num_workers=0, mesh=tmesh.Mesh(data_size=2))


def test_cli_coordinator_two_processes_vs_serial_cli(launched, results):
    """The two processes' `--coordinator --eval-streams 2` AP and this
    process's `--eval-streams 2` AP against the serial CLI's, each on one
    thread."""
    out, _ = launched
    with _one_thread():
        want = _cli_ap(os.path.join(out, "root"),
                       os.path.join(out, "cli1"), [])
        one = _cli_ap(os.path.join(out, "root"), os.path.join(out, "cli2"),
                      ["--eval-streams", "2"])
    for got in [one] + [results["cli"][r]["cli"]["ap"] for r in (0, 1)]:
        assert got["num_images"] == want["num_images"] == 10
        assert got["streams"] == 2.0
        for k, v in want["overall"].items():
            assert got["overall"][k] == pytest.approx(v, abs=1e-6), k


def test_cli_warns_on_ignored_flags(launched, capsys):
    out, _ = launched
    _cli_ap(os.path.join(out, "root"), os.path.join(out, "cli3"),
            ["--eval-streams", "2", "--max-chunks", "1", "--profile-dir",
             os.path.join(out, "prof")])
    text = capsys.readouterr().out
    assert "--max-chunks is ignored" in text
    # --profile-dir traces the sharded loop, the port's spans included
    assert "--profile-dir is ignored" not in text
    with open(os.path.join(out, "prof", "eval_trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"eodt.eval.compute", "eodt.stream_step", "eodt.frame",
            "eodt.frame.cascade"} <= names
