"""Traffic kind `frame_batches`: single-frame detection over closed-loop
batches of frames, as `run.py --coco-json --eval-only` evaluates a set
(`engine/coco.py:evaluate_coco`), for the Deformable-DETR family.

A frame is one of the episodes' 480x640 frames under the published test
transform: a pool of `pool_images` images (grey noise with coloured
rectangles) drawn on the card from the seed at `source_hw` and resized
bilinearly to the cell's `height` x `width`, then staged in pinned host
memory in set-up, each batch's frames contiguous; batch k is the pool's
batch k mod (pool_images / batch). One unit is one batch: the copy to the
card, the family's `detect` from `engine/coco.py:make_detect` (the trunk over
the batch, the transformer a frame at a time, one top-k over the batch)
and one copy of the batch's detections to the host
(`engine/eval.py:scored_detections`).

`correct` holds what the timed path itself returned for `checked_frames`
frames, drawn from the window's first `from_batches` batches, to the
plain reference (`reference/detr_plain.py`) on the same weights, a frame
at a time; the numbers are `_gaps`'. `--control 1` reads the same numbers
for the reference with TF32 on (one precision below the configuration's
f32) in the program's place.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..common import (Trace, device_info, metric, process_age_s, profile,
                      rng, span, sync, torch_seed)
from ..detector import full_f32, make_zs, program_config
from ..reference import detr_plain as ref

# unprofiled batches a traced run times, whose mean host time is the
# unit's (`plain_s`): one batch's time moves by a fifth from run to run
PLAIN_BATCHES = 6


def image_pool(p: dict, seed: int, device: str) -> torch.Tensor:
    """[n / batch, batch, H, W, 3] uint8 on the host (pinned on the card's
    machine): the pool drawn on the card at `source_hw` and resized to the
    cell's size, in batches of `batch`."""
    n, (sh, sw) = p["pool_images"], p["source_hw"]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 1))
    imgs = torch.randint(40, 90, (n, sh, sw, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    rects = p["rectangles"]
    geo = torch.rand((n, rects, 4), generator=gen, device=device).cpu()
    colour = torch.randint(0, 256, (n, rects, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    for i in range(n):
        for k in range(rects):
            x0, y0 = int(geo[i, k, 0] * sw * 0.8), int(geo[i, k, 1] * sh * 0.8)
            x1 = min(sw, x0 + 16 + int(geo[i, k, 2] * sw / 3))
            y1 = min(sh, y0 + 16 + int(geo[i, k, 3] * sh / 3))
            imgs[i, y0:y1, x0:x1] = colour[i, k]
    big = F.interpolate(imgs.permute(0, 3, 1, 2).float(),
                        size=(p["height"], p["width"]), mode="bilinear",
                        align_corners=False)
    out = big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    out = out.contiguous().cpu().view(n // p["batch"], p["batch"],
                                      *out.shape[1:])
    return out.pin_memory() if device == "cuda" else out


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int, init: dict,
                 zs: torch.Tensor) -> dict:
    """{name: f32 tensor on the model's device} of the model's state from
    `seed`, drawn in one normal draw on the device: fan-in normal for
    every convolution and linear kernel, zero biases, norms at identity,
    normal(1) level embeddings; the sampling-offset kernels at
    normal(init["offset_kernel_std"]) with Deformable-DETR's biases (each
    head's direction, points 1 to P cells out), the attention-weight
    kernels at normal(init["attention_kernel_std"]). The two-stage head's
    embedding bias is a prior against class 0 of the classifier `zs`,
    -init["enc_class_prior"] zs[:, 0]: a token with no features (the
    border tokens, zeroed before the head) scores the floor,
    -temperature, as upstream's prior bias -log(99) scores it low, so the
    decoder is seeded from the tokens the encoder saw on every seed."""
    state = {k: v.detach().float().clone()
             for k, v in model.state_dict().items()}
    device = next(iter(state.values())).device
    draws = []                  # (name, std)
    for name, mod in model.named_modules():
        if not isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            continue
        leaf = name.rsplit(".", 1)[-1]
        std = {"sampling_offsets": init["offset_kernel_std"],
               "attention_weights": init["attention_kernel_std"]}.get(
            leaf, math.sqrt(1.0 / mod.weight[0].numel()))
        draws.append((f"{name}.weight", std))
        if mod.bias is not None:
            state[f"{name}.bias"].zero_()
            if leaf == "sampling_offsets":
                state[f"{name}.bias"] = offset_bias(model.get_submodule(
                    name.rsplit(".", 1)[0])).to(device)
    draws += [(k, 1.0) for k in state
              if k.rsplit(".", 1)[-1].startswith("level_embed")]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 101))
    flat = torch.randn(sum(state[k].numel() for k, _ in draws),
                       generator=gen, device=device)
    at = 0
    for k, std in draws:
        n = state[k].numel()
        state[k] = flat[at:at + n].view(state[k].shape) * std
        at += n
    detr = model.detr
    if detr.two_stage and detr.use_zeroshot:
        k_enc = detr.dec_layers if detr.with_box_refine else 0
        state[f"detr.cls_embed{k_enc}.bias"] = \
            -init["enc_class_prior"] * zs[:, 0].float()
    return state


def offset_bias(attn) -> torch.Tensor:
    """Deformable-DETR's `MSDeformAttn._reset_parameters` bias of the
    sampling-offset layer of a deformable attention [M * L * P * 2]: head
    m's direction (cos, sin of 2 pi m / M, scaled to a largest coordinate
    of 1) times p + 1 for point p, on every level."""
    heads, levels, points = attn.heads, attn.levels, attn.points
    theta = torch.arange(heads, dtype=torch.float32) * (2 * math.pi / heads)
    grid = torch.stack([theta.cos(), theta.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid[:, None, None, :] * torch.arange(
        1, points + 1, dtype=torch.float32)[None, None, :, None]
    return grid.expand(heads, levels, points, 2).reshape(-1)


def spec_of(cfg) -> ref.Spec:
    d = cfg.detr
    return ref.Spec(depths=tuple(cfg.backbone.depths), hidden=d.hidden_dim,
                    heads=d.heads, enc_layers=d.enc_layers,
                    dec_layers=d.dec_layers, num_queries=d.num_queries,
                    num_classes=cfg.roi.num_classes,
                    temperature=cfg.roi.norm_temperature, topk=d.test_topk,
                    pixel_mean=tuple(cfg.input.pixel_mean),
                    pixel_std=tuple(cfg.input.pixel_std))


class Run:
    """The port's side of one run: the model from the configuration's
    overrides, its seeded weights, the classifier, the staged pool and the
    batch detector; with a pass-through on the transformer that keeps the
    watched frames' own outputs."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        from embodied_object_detection_tpu_torch.engine.coco import \
            make_detect
        from embodied_object_detection_tpu_torch.models.detector import \
            build_detector
        p = cell.traffic
        self.cfg = cfg = program_config(cell.config)
        if (cfg.input.height, cfg.input.width) != (p["height"], p["width"]):
            raise ValueError("the traffic's frames are not the "
                             "configuration's input size")
        self.device = device
        self.model = build_detector(cfg, seed=0, device=device)
        self.zs = make_zs(cfg.roi.zs_weight_dim, cfg.roi.num_classes, seed,
                          device)
        self.weights = make_weights(self.model, seed, cell.config["init"],
                                    self.zs)
        self.model.load_state_dict(self.weights)
        self.pool = image_pool(p, seed, device)
        self.b = p["batch"]
        self.detect = make_detect(self.model, cfg, self.zs)
        self.watch, self.outs, self.calls = set(), {}, 0
        forward = self.model.detr.forward

        def tapped(features, zs_weight=None):
            """The transformer, with the watched frames' outputs kept (the
            batch's frames run in order, a call each)."""
            out = forward(features, zs_weight)
            if self.calls in self.watch:
                self.outs[self.calls] = {
                    "enc0": out.enc_logits[:, 0].clone(),
                    "topk_idx": out.topk_idx.clone(),
                    "logits": out.logits[-1].clone(),
                    "boxes": out.boxes_cxcywh[-1].clone()}
            self.calls += 1
            return out
        self.model.detr.forward = tapped

    def frames(self, step: int) -> torch.Tensor:
        """The pool indices of batch `step`'s frames."""
        return (step % len(self.pool)) * self.b + torch.arange(self.b)

    def host(self, step: int) -> torch.Tensor:
        """Batch `step`'s staged frames, [B, H, W, 3] uint8."""
        return self.pool[step % len(self.pool)]

    def step(self, step: int, clock, traced: bool) -> np.ndarray:
        """One unit from the staged pool; returns the batch's detections
        on the host, [B, K, 7] (box, score, class, valid)."""
        from embodied_object_detection_tpu_torch.engine.eval import \
            scored_detections
        self.calls = 0
        with span("unit", clock, traced):
            images = self.host(step).to(self.device,
                                        non_blocking=True).float()
            with torch.no_grad():
                dets = self.detect(images)
            boxes, scores, classes, valid = scored_detections(dets, 1)
        return np.concatenate([boxes, scores[..., None],
                               classes[..., None].astype(np.float32),
                               valid[..., None].astype(np.float32)], -1)


def count_flops(r: Run) -> tuple:
    """(FLOPs of one unit, f32 share): the batch detector over one batch,
    every op counted by PyTorch's formulas."""
    from ..bounds.flops import CountFlops
    images = r.host(0).to(r.device).float()
    with torch.no_grad(), CountFlops() as c:
        r.detect(images)
    return c.total, c.f32_share()


def run(cell, seed: int, seconds: float, traced: bool,
        control: bool = False, device: str = "cuda"):
    """One run of a frame-batch cell: set-up (model, weights, pool, warm-up
    batches), the window (or, traced, `PLAIN_BATCHES` batches timed
    without the profiler, one profiled batch and its replay under the
    bounds' recorder), the check against the reference. Returns (result,
    checks, extra)."""
    p = cell.traffic
    checks_file = cell["checks_file"]
    limits = checks_file["limits"]
    clock: dict = {}
    r = Run(cell, seed, device)
    b = r.b
    # the checked frames: (batch of the window, frame of the batch)
    n_check = checks_file["checked_frames"]
    picks = rng(seed, 5).choice(checks_file["from_batches"] * b, n_check,
                                replace=False)
    watched = {}
    for i in sorted(picks.tolist()):
        watched.setdefault(i // b, set()).add(i % b)
    kept = {}               # (pool index) -> the port's outputs, detections

    def unit(k, step, clock, traced_unit=False):
        r.watch, r.outs = watched.get(k, set()), {}
        dets = r.step(step, clock, traced_unit)
        frames = r.frames(step)
        for f in r.watch:
            kept[int(frames[f])] = {**r.outs[f], "dets": dets[f]}

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    first = p["warmup_batches"]
    for step in range(first):
        unit(-1, step, clock)
    sync(device)
    extra = {}
    if traced:
        flops, f32_share = count_flops(r)
        extra["setup_s"] = process_age_s()
        plain_clock: dict = {}
        t0 = time.perf_counter()
        for j in range(PLAIN_BATCHES):
            unit(0 if j == 0 else -1, first + j, plain_clock)
        plain_s = (time.perf_counter() - t0) / PLAIN_BATCHES
        plain_clock = {k: v / PLAIN_BATCHES for k, v in plain_clock.items()}
        clock.clear()
        traced_step = first + PLAIN_BATCHES
        t0 = time.perf_counter()
        _, events = profile(lambda: unit(1, traced_step, clock, True),
                            device)
        window = time.perf_counter() - t0
        steps, frames = 1, b
        from ..bounds.ms_deform_attn import RecordBounds
        with RecordBounds() as rec, torch.no_grad():
            r.detect(r.host(traced_step).to(device).float())
        sync(device)
        extra.update(trace=Trace(events), clock=dict(clock), frames=frames,
                     flops=flops, f32_share=f32_share, bounds=rec.totals(),
                     plain_s=plain_s, plain_clock=plain_clock)
    else:
        extra["setup_s"] = process_age_s()
        t0 = time.perf_counter()
        steps, ends = 0, []
        while True:
            unit(steps, first + steps, clock)
            steps += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        extra["unit_s"] = np.diff([0.0] + ends).tolist()
        window = time.perf_counter() - t0
        frames = steps * b
    result = {"correct": None, "attempted": frames, "failed": 0,
              "window_s": window, "device": device_info(1, device)}
    extra.update(rate=frames / window, steps=steps)
    # the check, after the window, with the port's model freed
    cfg, weights, zs, pool = r.cfg, r.weights, r.zs, r.pool
    del r
    if device == "cuda":
        torch.cuda.empty_cache()
    spec = spec_of(cfg)
    hw = (cfg.input.height, cfg.input.width)
    rows, ctrl = [], []
    for idx in sorted(kept):
        image = pool.flatten(0, 1)[idx].to(device)
        want = _reference(weights, spec, image, zs)
        got = kept[idx]
        rows.append(_gaps(got, want, _held(weights, spec, image, zs, got),
                          hw))
        if control:
            c = _control(weights, spec, image, zs, hw)
            ctrl.append(_gaps(c, want,
                              _held(weights, spec, image, zs, c), hw))
    readings = _worst(rows)
    extra["readings"] = readings
    if control:
        extra["control"] = _worst(ctrl)
    checks = {k: (readings[k], lim) for k, lim in limits.items()}
    result["correct"] = all(v <= lim for v, lim in checks.values())
    return result, checks, extra


def _reference(weights, spec, image, zs, tf32: bool = False) -> dict:
    """The reference's own run of one frame, with its detections; with
    `tf32` its matmuls and convolutions in TF32."""
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            out = ref.forward(weights, spec, image, zs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = allow
    return out


def _held(weights, spec, image, zs, got) -> dict:
    """The reference's decoder seeded with `got`'s own proposal tokens."""
    full_f32()
    with torch.no_grad():
        return ref.forward(weights, spec, image, zs,
                           seed_idx=got["topk_idx"].to(image.device))


def _control(weights, spec, image, zs, hw) -> dict:
    """The reference in TF32 in the program's place: its outputs and
    detections as the program's are kept."""
    out = _reference(weights, spec, image, zs, tf32=True)
    boxes, scores, classes, _ = ref.inference(out["logits"][-1],
                                              out["boxes"][-1], hw,
                                              spec.topk)
    dets = torch.cat([boxes, scores[:, None], classes[:, None].float(),
                      torch.ones_like(scores)[:, None]], -1)
    return {"enc0": out["enc_logits"][:, 0], "topk_idx": out["topk_idx"],
            "logits": out["logits"][-1], "boxes": out["boxes"][-1],
            "dets": dets.cpu().numpy()}


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() /
                 want.double().abs().max())


def queries_of(boxes_cxcywh: np.ndarray, det_boxes: np.ndarray, hw):
    """The query each detection came from: the one whose last-layer box,
    in pixels, lies nearest the detection's (the same arithmetic gives
    the same box)."""
    h, w = hw
    b = boxes_cxcywh.astype(np.float32)
    xyxy = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2],
                    -1) * np.array([w, h, w, h], np.float32)
    return np.abs(xyxy[None] - det_boxes[:, None, :4]).sum(-1).argmin(1)


def _gaps(got: dict, want: dict, held: dict, hw) -> dict:
    """The numbers of one frame; `got` the program's (or the control's),
    `want` the reference's own run, `held` the reference's decoder from
    `got`'s proposal tokens. PERF.md gives each one's reason."""
    enc0 = want["enc_logits"][:, 0]
    g_idx = set(got["topk_idx"].tolist())
    w_idx = set(want["topk_idx"].tolist())
    logits, boxes = held["logits"][-1], held["boxes"][-1]
    dets = got["dets"]
    q = queries_of(got["boxes"].cpu().numpy(), dets, hw)
    c = dets[:, 5].astype(np.int64)
    ref_scores = torch.sigmoid(logits).cpu().numpy()[q, c]
    gap = np.abs(dets[:, 4] - ref_scores) / np.maximum(ref_scores, 1e-12)
    ref_boxes = ref.pixel_boxes(boxes, hw).cpu().numpy()[q]
    return {"enc_score_gap_max": _rel_max(got["enc0"], enc0),
            "topk_mismatch_share": len(g_idx - w_idx) / len(w_idx),
            "held_logit_gap_max": _rel_max(got["logits"], logits),
            "held_box_gap_max": float((got["boxes"].double() -
                                       boxes.double()).abs().max()),
            "det_score_gap_p90": float(np.percentile(gap, 90)),
            "det_box_gap_max": float(np.abs(dets[:, :4].astype(np.float64) -
                                            ref_boxes).max())}


def _worst(rows):
    return {k: max(r[k] for r in rows) for k in rows[0]}


def report(result, extra, cell):
    """The cell's end-to-end metrics of a window."""
    return {"eval_frames_per_s": metric(extra["rate"], "frames/s")}
