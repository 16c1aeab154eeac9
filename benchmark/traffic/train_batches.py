"""Traffic kind `train_batches`: the training step of `run.py`'s training
branch (`engine/train.py:train`) at the published batch, a closed loop of
steps.

A batch is `chunks` chunks of `frames` frames (ims_per_batch x
max_sequence_length, what `train` pads to). Each frame carries its
chunk's memory snapshot (the [cells, D] f32 feature sums and the
observation counts the chunk started from), 1 to max_gt_boxes GT boxes
and the chunk's cell ids from the same walking camera as the episode
streams. A pool of distinct batches is made on the card from the seed in
set-up and held pinned on the host; step k takes batch k mod pool, copies
it in with `parallel/train_step.py:batch_to_device`, runs the step
function of `make_train_step` (AdamW from `engine/solver.py` at the
configuration's schedule) and reads the losses back once, as `train`
does.

The first `checked_steps` steps run in set-up through that same call on
distinct batches; their losses, the first gradient (from the optimizer's
first moment after one step) and the parameters after them are what the
reference is held to.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..common import (Trace, device_info, metric, process_age_s, profile,
                      rng, span, torch_seed)
from ..detector import (build_program, build_reference, make_zs,
                        program_config, reference_config)
from .episode_streams import Streams

ADAM_B1 = 0.9


def make_batch(p: dict, cfg, streams: Streams, seed: int, index: int,
               device: str) -> dict:
    """One batch of the pool, as pinned host tensors (the fields of the
    port's TrainBatch)."""
    c, t = p["chunks"], p["frames"]
    n = c * t
    h, w = cfg.input.height, cfg.input.width
    cells, d = cfg.memory.max_cells, cfg.memory.memory_dim
    g = cfg.input.max_gt_boxes
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 11, index))
    image = torch.randint(0, 256, (n, h, w, 3), generator=gen,
                          device=device).float()
    mem = (torch.rand((c, cells, d), generator=gen, device=device) - 0.5) * 8
    obs = torch.tensor([0.0, 1.0, 2.0, 5.0], device=device)[torch.randint(
        0, 4, (c, cells), generator=gen, device=device)]
    proj = np.concatenate([streams.chunk(index * c + k, 0).proj_indices
                           for k in range(c)])
    r = rng(seed, 12, index)
    boxes = np.zeros((n, g, 4), np.float32)
    classes = np.zeros((n, g), np.int32)
    valid = np.zeros((n, g), bool)
    for b in range(n):
        k = int(r.integers(1, g + 1))
        bw, bh = r.uniform(16, w / 2, k), r.uniform(16, h / 2, k)
        x0, y0 = r.uniform(0, w - bw), r.uniform(0, h - bh)
        boxes[b, :k] = np.stack([x0, y0, x0 + bw, y0 + bh], 1)
        classes[b, :k] = r.integers(0, cfg.roi.num_classes, k)
        valid[b, :k] = True
    pin = device == "cuda"

    def host(x):
        x = x.cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        return x.pin_memory() if pin else x

    return {"image": host(image), "proj_indices": host(proj),
            "mem_features": host(mem.repeat_interleave(t, 0)),
            "mem_obs": host(obs.repeat_interleave(t, 0)),
            "gt_boxes": host(boxes), "gt_classes": host(classes),
            "gt_valid": host(valid),
            "weight": host(np.ones(n, np.float32))}


def _params(model, names):
    own = dict(model.named_parameters())
    return [own[n].detach().clone() for n in names]


def run(cell, seed: int, seconds: float, traced: bool,
        control: bool = False, device: str = "cuda"):
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        TrainBatch, batch_to_device, make_train_step)
    p = cell.traffic
    limits = cell["checks_file"]["limits"]
    checked = cell["checks_file"]["checked_steps"]
    clock: dict = {}
    cfg = program_config(cell.config)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, weights = build_program(cfg, seed, device)
    zs = make_zs(cfg.roi.zs_weight_dim, cfg.roi.num_classes, seed, device)
    streams = Streams(p, cfg.input.height, cfg.input.width,
                      cfg.memory.max_cells, seed, device)
    pool = [make_batch(p, cfg, streams, seed, i, device)
            for i in range(p["pool_batches"])]
    init_state, step_fn = make_train_step(model, cfg)
    state = init_state()
    pin = device == "cuda"

    def unit(k, clock=clock, traced_unit=False):
        nonlocal state
        with span("unit", clock, traced_unit):
            with span("h2d", clock, traced_unit):
                batch = batch_to_device(TrainBatch(**pool[k % len(pool)]),
                                        device, pin=pin)
            state, losses = step_fn(state, batch, zs)
            values = dict(zip(losses, torch.stack(
                list(losses.values())).tolist()))
        return values

    # the checked steps: the window's own call, on distinct batches
    got_losses = []
    for k in range(checked):
        got_losses.append(unit(k))
        if k == 0:
            got_grad = [m / (1 - ADAM_B1) for m in
                        state.optimizer.state["mu"]]
            names = state.optimizer.names
    got_params = _params(model, names)
    frames_per_step = p["chunks"] * p["frames"]
    extra = {}
    if traced:
        from ..bounds.flops import CountFlops
        from ..bounds.kernels import RecordBounds
        from embodied_object_detection_tpu_torch.parallel.train_step import \
            batch_losses
        # the traced step's own batch
        b = batch_to_device(TrainBatch(**pool[(checked + 1) % len(pool)]),
                            device, pin=pin)
        with CountFlops() as fl:
            total, _ = batch_losses(model, cfg, b, zs, state.step)
            total.backward()
        model.zero_grad(set_to_none=True)
        with RecordBounds(backward=True) as rec:
            with torch.no_grad():
                batch_losses(model, cfg, b, zs, state.step)
        del b, total
        extra["setup_s"] = process_age_s()
        # one step without the profiler: the host time that the readers
        # of time set the trace's device work against
        plain_clock: dict = {}
        t0 = time.perf_counter()
        unit(checked, plain_clock)
        plain_s = time.perf_counter() - t0
        _wrap_trunk(model)
        clock.clear()
        t0 = time.perf_counter()
        _, events = profile(lambda: unit(checked + 1, clock, True), device)
        window = time.perf_counter() - t0
        steps = 1
        extra.update(trace=Trace(events), clock=dict(clock),
                     frames=frames_per_step, flops=fl.total,
                     f32_share=fl.f32_share(), bounds=rec.totals(),
                     plain_s=plain_s, plain_clock=plain_clock)
    else:
        extra["setup_s"] = process_age_s()
        t0 = time.perf_counter()
        steps, ends = 0, []
        while True:
            unit(checked + steps)
            steps += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        extra["unit_s"] = np.diff([0.0] + ends).tolist()
        window = time.perf_counter() - t0
    frames = steps * frames_per_step
    dev = device_info(1, device)
    result = {"correct": None, "attempted": frames, "failed": 0,
              "device": dev}
    extra.update(rate=frames / window, steps=steps, frames=frames)
    # the check, with the port's state freed
    del unit, state, step_fn, init_state, model
    got_grad = [x.cpu() for x in got_grad]
    got_params = [x.cpu() for x in got_params]
    if device == "cuda":
        torch.cuda.empty_cache()
    ref_cfg = reference_config(cell.config)
    want = follow(ref_cfg, weights, pool[:checked], zs, names, device)
    readings = gaps(got_losses, got_grad, got_params, want, weights, names)
    if control:
        from ..reference.detic_plain.models.layers import fp8_at_use
        with fp8_at_use():
            low = follow(ref_cfg, weights, pool[:checked], zs, names,
                         device)
        extra["control"] = gaps(low[0], low[1], low[2], want, weights, names)
    extra["worst_leaves"] = readings.pop("_worst")
    extra["readings"] = readings
    checks = {k: (readings[k], lim) for k, lim in limits.items()}
    result["correct"] = all(v <= lim for v, lim in checks.values())
    return result, checks, extra


def _wrap_trunk(model):
    trunk = model.backbone_raw

    def backbone_raw(*a, **k):
        with torch.profiler.record_function("bench.trunk"):
            return trunk(*a, **k)

    model.backbone_raw = backbone_raw


def follow(ref_cfg, weights, batches, zs, names, device):
    """The reference's (losses a step, first gradient, parameters after
    the steps) from the initial weights over the checked batches."""
    from ..reference import train_plain
    from ..reference.detic_plain.engine.solver import build_optimizer
    ref = build_reference(ref_cfg, weights, device)
    opt = build_optimizer(ref, ref_cfg.solver)
    losses, grad = [], None
    for k, b in enumerate(batches):
        dev = {n: v.to(device) for n, v in b.items()}
        losses.append(train_plain.step(ref, ref_cfg, opt, dev, zs, k))
        if k == 0:
            grad = [(m / (1 - ADAM_B1)).cpu() for m in opt.state["mu"]]
    if list(opt.names) != list(names):
        raise AssertionError("the reference optimizes other leaves")
    return losses, grad, _params(ref, names)


def gaps(got_losses, got_grad, got_params, want, weights, names):
    """The numbers compared: the worst step's relative gap of the total
    loss, the worst leaf's gap of the first gradient's norm and of the
    parameters' change over the steps, each leaf against the larger of
    its reference norm and the median leaf's. Leaves whose reference
    gradient norm is under a thousandth of the median leaf's are left out
    of the change (they move by round-off alone under Adam). The worst
    leaves are named under "_worst"."""
    from ..reference.train_plain import leaf_gaps
    want_losses, want_grad, want_params = want
    loss = max(abs(g["total_loss"] - w["total_loss"]) / abs(w["total_loss"])
               for g, w in zip(got_losses, want_losses))
    norms = torch.stack([x.float().norm() for x in want_grad])
    moved = (norms >= 1e-3 * norms.median()).tolist()
    init = [weights[n].cpu() for n in names]
    got_params = [x.cpu() for x in got_params]
    want_params = [x.cpu() for x in want_params]
    grad = leaf_gaps(got_grad, want_grad, [True] * len(names))
    update = leaf_gaps([g - i for g, i in zip(got_params, init)],
                       [w - i for w, i in zip(want_params, init)], moved)
    return {"loss_gap": loss, "grad_norm_gap": float(grad.max()),
            "update_norm_gap": float(update.max()),
            "_worst": [names[int(grad.argmax())], names[int(update.argmax())],
                       sum(moved), len(moved)]}


def report(result, extra, cell):
    return {"train_frames_per_s": metric(extra["rate"], "frames/s")}
