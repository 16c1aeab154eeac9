"""Traffic kind `episode_streams`: B scene streams evaluated in lockstep
chunk-steps through the port's lane runner, as `run.py --eval-streams B`
runs them on one card.

Each stream plays scenes one after another; a scene is a seeded number of
T-frame chunks, and its first frame resets the stream's memory. A frame
is a 480x640 RGB image from a pool made on the card from the seed, and
its pixels' memory cells come from a camera that walks and turns over a
top-down grid of the memory's cells: each pixel's ray meets the floor (or
a far wall) at a point whose cell it reads and writes, so a frame covers
a wedge of neighbouring cells and consecutive frames overlap. Every seed
gives the same sizes; only the content, the scene lengths and the paths
differ. The frames' content repeats every `pool_steps` chunk-steps
(step k shows step k mod pool_steps's images and cell ids), while the
scenes' starts, and so the memory's resets, follow the seeded scene
lengths.

The `pool_steps` distinct chunk-steps are staged in set-up through the
engine's `engine/eval.py:host_frame_inputs`, stacked in pinned memory as
`evaluate_dataset_sharded` does, so that no host thread but the one that
dispatches runs in the window. A chunk-step is copied by
`frames_to_device`, run by
`models/detector.py:make_batched_episode_runner`, and ends when the
scored frames' detections (`engine/eval.py:pack_scored`) are on the host.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..checks import detections as dcheck
from ..common import (Trace, device_info, metric, process_age_s, profile,
                      rng, span, sync, torch_seed)
from ..detector import (build_program, build_reference, make_zs,
                        program_config, reference_config)


class Chunk(NamedTuple):
    """One stream's chunk on the host, with the fields the engine's
    `host_frame_inputs` reads."""
    images: np.ndarray          # [T, H, W, 3] uint8
    proj_indices: np.ndarray    # [T, H, W] int32
    memory_reset: np.ndarray    # [T] bool
    episode_start: np.ndarray   # [T] bool
    frame_valid: np.ndarray     # [T] bool


class Streams:
    """The traffic of one seed: chunk(step, stream) -> Chunk."""

    def __init__(self, p: dict, height: int, width: int, cells: int,
                 seed: int, device: str = "cuda"):
        self.p, self.h, self.w, self.seed = p, height, width, seed
        self.device = device
        self.t = p["frames"]
        self.period = p.get("pool_steps")
        gh, gw = p["grid"]
        if gh * gw != cells:
            raise ValueError(f"grid {gh}x{gw} is not the memory's {cells} "
                             f"cells")
        self.grid = (gh, gw)
        self.images = self._image_pool(p["pool_images"], p["rectangles"])
        lo, hi = p["chunks_per_scene"]
        r = rng(seed, 2)
        # scene lengths of each stream, far more than any run reaches
        lengths = r.integers(lo, hi + 1, size=(p["streams"], 4096))
        self.scene_start = np.concatenate(
            [np.zeros((p["streams"], 1), np.int64),
             np.cumsum(lengths, axis=1)], axis=1)
        # the floor point (forward, lateral, metres) of each pixel of a
        # 4x4 block grid; rays above the horizon meet the far wall
        s = p["block"]
        f = (width / 2) / math.tan(math.radians(p["hfov_deg"]) / 2)
        v = (np.arange(height // s) * s + s / 2)[:, None]
        u = (np.arange(width // s) * s + s / 2)[None, :]
        below = v - height / 2
        depth = np.where(below > 0, p["camera_height_m"] * f /
                         np.maximum(below, 1e-6), np.inf)
        self.fwd = np.minimum(depth, p["max_depth_m"]) * np.ones_like(u)
        self.lat = (u - width / 2) * self.fwd / f

    def _image_pool(self, n: int, rects: int) -> np.ndarray:
        """[n, H, W, 3] uint8 drawn on the card: grey noise with coloured
        rectangles."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(torch_seed(self.seed, 1))
        h, w = self.h, self.w
        imgs = torch.randint(40, 90, (n, h, w, 3), generator=gen,
                             device=dev, dtype=torch.uint8)
        geo = torch.rand((n, rects, 4), generator=gen, device=dev)
        colour = torch.randint(0, 256, (n, rects, 3), generator=gen,
                               device=dev, dtype=torch.uint8)
        geo = geo.cpu().numpy()
        for i in range(n):
            for k in range(rects):
                x0, y0 = int(geo[i, k, 0] * w * 0.8), int(geo[i, k, 1] * h * 0.8)
                x1 = min(w, x0 + 16 + int(geo[i, k, 2] * w / 3))
                y1 = min(h, y0 + 16 + int(geo[i, k, 3] * h / 3))
                imgs[i, y0:y1, x0:x1] = colour[i, k]
        return imgs.cpu().numpy()

    def locate(self, step: int, stream: int):
        """(scene, chunk of the scene) of a stream's chunk-step."""
        starts = self.scene_start[stream]
        scene = int(np.searchsorted(starts, step, side="right")) - 1
        return scene, step - int(starts[scene])

    def starts(self, step: int, stream: int) -> np.ndarray:
        """[T] bool: the chunk's first frame starts a scene."""
        start = np.zeros(self.t, bool)
        start[0] = self.locate(step, stream)[1] == 0
        return start

    def chunk(self, step: int, stream: int) -> Chunk:
        """The frames of a stream's chunk-step: the content of step
        `step mod pool_steps`, the scene starts of `step`."""
        p, t = self.p, self.t
        scene, j = self.locate(step % self.period if self.period else step,
                               stream)
        r = rng(self.seed, 3, stream, scene)
        gh, gw = self.grid
        cell = p["cell_m"]
        x0, y0 = r.uniform(0, gw * cell), r.uniform(0, gh * cell)
        heading0 = r.uniform(0, 2 * math.pi)
        turn = math.radians(r.uniform(-p["turn_deg"], p["turn_deg"]))
        first_image = int(r.integers(len(self.images)))
        k = np.arange((j + 1) * t)
        heading = heading0 + turn * k
        x = x0 + p["step_m"] * np.concatenate([[0], np.cumsum(np.cos(
            heading[:-1]))])
        y = y0 + p["step_m"] * np.concatenate([[0], np.cumsum(np.sin(
            heading[:-1]))])
        s = p["block"]
        proj = np.empty((t, self.h, self.w), np.int32)
        for i, kk in enumerate(range(j * t, (j + 1) * t)):
            c, sn = math.cos(heading[kk]), math.sin(heading[kk])
            wx = x[kk] + self.fwd * c - self.lat * sn
            wy = y[kk] + self.fwd * sn + self.lat * c
            ids = (np.floor(wy / cell).astype(np.int64) % gh) * gw + \
                np.floor(wx / cell).astype(np.int64) % gw
            proj[i] = np.repeat(np.repeat(ids.astype(np.int32), s, 0), s, 1)
        images = self.images[(first_image + np.arange(j * t, (j + 1) * t)) %
                             len(self.images)]
        start = self.starts(step, stream)
        return Chunk(images, proj, start, start.copy(), np.ones(t, bool))


def stack_pinned(frames, pin: bool):
    """Stack the streams' host frames and pin them for the card, as the
    engine's sharded loop does."""
    def stack(xs):
        t = torch.stack(list(xs))
        return t.pin_memory() if pin else t
    return type(frames[0])(*(stack(x) for x in zip(*frames)))


class Run:
    """The port's side of one run: model, runner, the staged traffic and
    the carried memory."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        from embodied_object_detection_tpu_torch.engine.eval import \
            host_frame_inputs
        from embodied_object_detection_tpu_torch.models.detector import (
            make_batched_episode_runner)
        from embodied_object_detection_tpu_torch.structures import \
            MemoryState
        p = cell.traffic
        self.cfg = cfg = program_config(cell.config)
        self.device = device
        self.model, self.weights = build_program(cfg, seed, device)
        self.zs = make_zs(cfg.roi.zs_weight_dim, cfg.roi.num_classes, seed,
                          device)
        self.streams = Streams(p, cfg.input.height, cfg.input.width,
                               cfg.memory.max_cells, seed, device)
        self.runner = make_batched_episode_runner(self.model, cfg)
        self.b = b = p["streams"]
        self.pool = [stack_pinned([host_frame_inputs(
            self.streams.chunk(s, i), cfg.memory.max_cells)
            for i in range(b)], device == "cuda")
            for s in range(p["pool_steps"])]
        self.memory = MemoryState(
            torch.zeros((b, cfg.memory.max_cells, cfg.memory.memory_dim),
                        device=device),
            torch.zeros((b, cfg.memory.max_cells), device=device))
        self.frames_per_step = b * p["frames"]
        self.watch, self.writes, self.calls = set(), {}, 0
        _tap_writes(self)

    def tap(self, args, kwargs):
        """The port's memory write was called: the runner steps frame by
        frame, each stream in turn, so its first B calls of a chunk-step
        are the streams' frame-0 writes. Those of the watched streams are
        kept, their inputs (the port's own masks, features and flags)
        with it."""
        if self.calls in self.watch:
            self.writes[self.calls] = (args, kwargs)
        self.calls += 1

    def fetch(self, step: int):
        """Step `step`'s staged host frames: the pool's content, the
        step's own scene starts."""
        host = self.pool[step % len(self.pool)]
        starts = torch.from_numpy(np.stack([
            self.streams.starts(step, i) for i in range(self.b)]))
        if self.device == "cuda":
            starts = starts.pin_memory()
        return host._replace(memory_reset=starts, episode_start=starts)

    def step(self, host, clock, traced):
        """One chunk-step from its staged host frames; returns the scored
        frames' detections on the host."""
        from embodied_object_detection_tpu_torch.engine.eval import (
            frames_to_device, pack_scored)
        self.writes, self.calls = {}, 0
        with span("runner", clock, traced):
            frames = frames_to_device(host, self.device)
            out = self.runner(frames, self.zs, self.memory)
        self.memory, self.first = out.memory, out.first_memory
        with span("readback", clock, traced):
            packed = pack_scored(out.detections,
                                 self.cfg.input.score_every).cpu()
        return packed


_TAPPED: dict = {}


def _tap_writes(run) -> None:
    """Route the port's `memory_write` calls (the name `models/detector.py`
    calls) through `run.tap`, which sees their inputs; the hook passes
    every call through unchanged. It is put in once a process, again
    only over a function that replaced it, and a call that reaches a
    second hook inside the first is seen once."""
    from embodied_object_detection_tpu_torch.models import detector
    _TAPPED["run"] = run
    if getattr(detector.memory_write, "bench_tap", False):
        return
    write = detector.memory_write

    def tapped(*args, **kwargs):
        if _TAPPED.get("inside"):
            return write(*args, **kwargs)
        _TAPPED["inside"] = True
        try:
            _TAPPED["run"].tap(args, kwargs)
            return write(*args, **kwargs)
        finally:
            _TAPPED["inside"] = False
    tapped.bench_tap = True
    detector.memory_write = tapped


def _wrap_spans(model):
    """In a traced run, the trunk and frame calls of the model instance
    run inside bench.trunk and bench.frame ranges."""
    trunk, frame = model.backbone_raw, model.frame_step

    def backbone_raw(*a, **k):
        with torch.profiler.record_function("bench.trunk"):
            return trunk(*a, **k)

    def frame_step(*a, **k):
        with torch.profiler.record_function("bench.frame"):
            return frame(*a, **k)

    model.backbone_raw, model.frame_step = backbone_raw, frame_step


def count_flops(run) -> tuple:
    """(FLOPs of one chunk-step, f32 share): the trunk over one frame and
    one frame step, each counted by PyTorch's formulas, times the frames
    of a chunk-step (the trunk is per frame: FrozenBN or LayerNorm)."""
    from ..bounds.flops import CountFlops
    from embodied_object_detection_tpu_torch.engine.eval import \
        frames_to_device
    frames = frames_to_device(run.fetch(0), run.device)
    one = frames.image[0, :1]
    with torch.no_grad():
        with CountFlops() as trunk:
            feats = run.model.backbone_raw(one)
        with CountFlops() as frame:
            run.model.frame_step(
                frames.image[0, 0], run.zs, run.memory.features[0],
                run.memory.obs_count[0], frames.proj_indices[0, 0],
                frames.outlier_mask[0, 0], frames.obs_visibility[0, 0],
                backbone_feats=tuple(f[0] for f in feats))
    n = run.frames_per_step
    total = (trunk.total + frame.total) * n
    f32 = (trunk.by_dtype.get("float32", 0) +
           frame.by_dtype.get("float32", 0)) * n
    return total, f32 / max(total, 1)


def run(cell, seed: int, seconds: float, traced: bool,
        control: bool = False, device: str = "cuda"):
    """One run of an episode cell: set-up, the window (or, traced, one
    chunk-step timed without the profiler, one profiled chunk-step and
    its replay under the bounds' recorder), the check against the
    reference. Returns (result, checks, extra)."""
    p = cell.traffic
    limits = cell["checks_file"]["limits"]
    clock: dict = {}
    r = Run(cell, seed, device)
    b = p["streams"]
    # the streams kept a step: one from each half of the streams
    pick = rng(seed, 5).integers(b // 2, size=(100000, 2))
    watch = pick + [0, b // 2]
    kept = {}          # (step, stream) -> what the check reads of it
    # the checked chunk-steps are drawn from the window's first ones
    last_kept = p["warmup_steps"] + 2 * cell["checks_file"]["checked_steps"]

    def keep(step, start, packed):
        for i in map(int, watch[step]):
            args, kwargs = r.writes[i]
            kept[step, i] = {
                "stream": i, "start": tuple(x[i].clone() for x in start),
                "first": tuple(x[i].clone() for x in r.first),
                "end": tuple(x[i].clone() for x in r.memory),
                "write_in": (tuple(map(_own, args)),
                             {k: _own(v) for k, v in kwargs.items()}),
                "packed": packed[i]}

    def unit(step, clock, traced_unit=False):
        r.watch = set(map(int, watch[step])) if step < last_kept else set()
        with span("unit", clock, traced_unit):
            host = r.fetch(step)
            start = r.memory
            packed = r.step(host, clock, traced_unit)
        if r.watch:
            keep(step, start, packed)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for step in range(p["warmup_steps"]):
        unit(step, clock)
    sync(device)
    kept.clear()
    extra = {}
    first = p["warmup_steps"]
    if traced:
        flops, f32_share = count_flops(r)
        extra["setup_s"] = process_age_s()
        # one chunk-step without the profiler: the host time that the
        # readers of time set the trace's device work against
        plain_clock: dict = {}
        t0 = time.perf_counter()
        unit(first, plain_clock)
        plain_s = time.perf_counter() - t0
        _wrap_spans(r.model)
        replay_memory = r.memory
        replay_host = r.fetch(first + 1)
        r.watch = set(map(int, watch[first + 1]))

        def traced_step():
            with span("unit", clock, True):
                packed = r.step(replay_host, clock, True)
            return packed

        clock.clear()
        t0 = time.perf_counter()
        packed, events = profile(traced_step, device)
        window = time.perf_counter() - t0
        steps, frames = 1, r.frames_per_step
        keep(first + 1, replay_memory, packed)
        # the same chunk-step again, from the same memory, under the
        # bounds' recorder (not timed)
        from ..bounds.kernels import RecordBounds
        from embodied_object_detection_tpu_torch.engine.eval import \
            frames_to_device
        with RecordBounds() as rec:
            r.runner(frames_to_device(replay_host, device), r.zs,
                     replay_memory)
        sync(device)
        extra.update(trace=Trace(events), clock=dict(clock), frames=frames,
                     flops=flops, f32_share=f32_share, bounds=rec.totals(),
                     plain_s=plain_s, plain_clock=plain_clock)
    else:
        extra["setup_s"] = process_age_s()
        t0 = time.perf_counter()
        steps, ends = 0, []
        while True:
            unit(first + steps, clock)
            steps += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        extra["unit_s"] = np.diff([0.0] + ends).tolist()
        window = time.perf_counter() - t0
        frames = steps * r.frames_per_step
    dev = device_info(1, device)
    result = {"correct": None, "attempted": frames, "failed": 0,
              "window_s": window, "device": dev}
    extra.update(rate=frames / window, steps=steps)
    # the check, after the window, with the port's state freed
    cfg = r.cfg
    weights = {k: v.cpu() for k, v in r.weights.items()}
    zs = r.zs
    streams = r.streams
    del r
    if device == "cuda":
        torch.cuda.empty_cache()
    steps_done = sorted({k[0] for k in kept})
    n_check = min(cell["checks_file"]["checked_steps"], len(steps_done))
    picked = rng(seed, 6).choice(steps_done, n_check, replace=False)
    chosen = [k for k in sorted(kept) if k[0] in set(picked.tolist())]
    ref_cfg = reference_config(cell.config)
    ref = build_reference(ref_cfg, weights, device)
    readings = compare(ref, ref_cfg, streams, zs, kept, chosen,
                       cfg.input.score_every, device)
    if control:
        from ..reference.detic_plain.models.layers import fp8_at_use
        extra["control"] = compare_control(ref, ref_cfg, streams, zs, kept,
                                           chosen, cfg.input.score_every,
                                           fp8_at_use, device)
    extra["readings"] = readings
    checks = {k: (readings[k], lim) for k, lim in limits.items()}
    result["correct"] = all(v <= lim for v, lim in checks.values())
    return result, checks, extra


def _own(x):
    """A tensor that is a view of a larger one (the chunk's cell ids)
    copied, so that keeping it keeps no more than it."""
    return x.clone() if isinstance(x, torch.Tensor) and x._base is not None \
        else x


def _reference_trunk(ref, streams, step, device):
    """The reference trunk's (C3, C4, C5) over every stream's frames of a
    chunk-step, in one batch as the port's lane runner runs its trunk:
    cuDNN picks its bf16 algorithms by batch size, and a trunk over other
    batches rounds otherwise."""
    images = np.concatenate([streams.chunk(step, i).images
                             for i in range(streams.p["streams"])])
    with torch.no_grad():
        return ref.backbone_raw(torch.as_tensor(images, dtype=torch.float32,
                                                device=device))


def _reference_chunk(ref, ref_cfg, streams, zs, step, stream, start,
                     score_every, device, trunk, write_in, tf32=False):
    """The reference's scored detections [S, N, 7], its memory after frame
    0 and after the chunk, for one stream's chunk from `start`, on the
    chunk-step's trunk features `trunk`; and, under "held", the memory
    after frame 0 when the reference's write (write selection,
    segment-sum, the features' mean) runs on the port's own inputs of
    frame 0's write `write_in` (its masks, features and flags). With
    `tf32` the held write's f32 matmul runs in TF32."""
    from ..reference.detic_plain.models.detector import (
        frame_inputs, make_episode_runner)
    from ..reference.detic_plain.ops.memory_ops import memory_write
    from ..reference.detic_plain.structures import MemoryState
    c = streams.chunk(step, stream)
    frames = frame_inputs(c.images, c.proj_indices, c.memory_reset,
                          ref_cfg.memory.max_cells, device,
                          frame_valid=c.frame_valid,
                          episode_start=c.episode_start)
    t = streams.t
    start = MemoryState(start[0].to(device), start[1].to(device))
    runner = make_episode_runner(ref, ref_cfg, precompute_backbone="external")
    out = runner(frames, zs, start,
                 tuple(f[stream * t:(stream + 1) * t] for f in trunk))
    d = out.detections
    sl = slice(0, None, score_every)
    packed = torch.cat([d.boxes[sl].float(), d.scores[sl, :, None].float(),
                        d.classes[sl, :, None].float(),
                        d.valid[sl, :, None].float()], -1)
    base = MemoryState(*(torch.zeros_like(x) for x in start)) \
        if c.memory_reset[0] else start
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        write = memory_write(*write_in[0], **write_in[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    held = (base.features + write.features_update,
            base.obs_count + write.obs_update)
    return {"packed": packed.cpu().numpy(),
            "first": tuple(x.cpu().numpy() for x in out.first_memory),
            "end": tuple(x.cpu().numpy() for x in out.memory),
            "held": tuple(x.cpu().numpy() for x in held),
            "base": tuple(x.cpu().numpy() for x in base)}


def _gaps(got, want):
    """The numbers of one chunk: `got` the port's (or the control's),
    `want` the reference's. PERF.md says which are compared and why; the
    last three (the write of frame 0 from each side's own masks, the
    whole chunk's unmatched share, the whole memory's gap) part between
    two runs of the port itself and are printed only."""
    g, w = got["packed"], want["packed"]
    score0, box0 = dcheck.pair_gaps(g[:1], w[:1])
    score90, box90 = dcheck.pair_gaps(g[:1], w[:1], 90)
    return {"frame0_score_gap": score0, "frame0_box_gap": box0,
            "frame0_score_gap_p90": score90, "frame0_box_gap_p90": box90,
            "frame0_unmatched_share": dcheck.unmatched_share(g[:1], w[:1]),
            "det_score_gap_p10": dcheck.pair_gaps(g, w, 10)[0],
            "held_write_gap_max": dcheck.held_write_gap(
                got["held"][0], want["held"][0], want["base"][0]),
            "count_gap": max(dcheck.count_gap(got["first"][1],
                                              want["first"][1]),
                             dcheck.count_gap(got["held"][1],
                                              want["held"][1]),
                             dcheck.count_gap(got["end"][1],
                                              want["end"][1])),
            "write_gap_p1": dcheck.write_gap(
                got["first"][0], want["first"][0], want["base"][0], 1),
            "det_unmatched_share": dcheck.unmatched_share(g, w),
            "memory_gap": dcheck.memory_gap(got["end"][0], want["end"][0])}


def _host(rec):
    """What the port's timed path returned for a kept stream-chunk; its
    memory after frame 0 is also what its write, held, is judged by."""
    first = tuple(x.cpu().numpy() for x in rec["first"])
    return {"packed": rec["packed"].numpy(), "first": first, "held": first,
            "end": tuple(x.cpu().numpy() for x in rec["end"])}


def _worst(rows):
    return {k: max(r[k] for r in rows) for k in rows[0]}


def compare(ref, ref_cfg, streams, zs, kept, chosen, score_every, device):
    """The worst gaps over the checked chunks between what the port's
    timed path returned and the reference from the same start memory."""
    rows, trunks = [], {}
    for key in chosen:
        rec = kept[key]
        if key[0] not in trunks:
            trunks = {key[0]: _reference_trunk(ref, streams, key[0], device)}
        want = _reference_chunk(ref, ref_cfg, streams, zs, key[0],
                                rec["stream"], rec["start"], score_every,
                                device, trunks[key[0]], rec["write_in"])
        rows.append(_gaps(_host(rec), want))
    return _worst(rows)


def compare_control(ref, ref_cfg, streams, zs, kept, chosen, score_every,
                    fp8_at_use, device):
    """The same gaps between the control in the port's place (the
    reference one precision down: its bf16 convolutions and linear
    layers at fp8 at use, the held write's f32 matmul in TF32) and the
    reference."""
    rows = []
    for key in chosen:
        rec = kept[key]
        args = (ref, ref_cfg, streams, zs, key[0], rec["stream"],
                rec["start"], score_every, device)
        want = _reference_chunk(*args, _reference_trunk(ref, streams, key[0],
                                                        device),
                                rec["write_in"])
        with fp8_at_use():
            got = _reference_chunk(*args, _reference_trunk(
                ref, streams, key[0], device), rec["write_in"], tf32=True)
        rows.append(_gaps(got, want))
    return _worst(rows)


def report(result, extra, cell):
    """The cell's end-to-end metrics of a window."""
    return {"eval_frames_per_s": metric(extra["rate"], "frames/s")}
