#!/usr/bin/env python3
"""Drive the torch port on one CUDA card, end to end, and check it.

Run from the repository root:

    python3 chip_smoke.py                  # needs one card
    python3 chip_smoke.py --profile DIR    # also profile one chunk into DIR

Phases (each prints its own lines; any failure exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions
  2. build every kernel from csrc/, one nvcc per source, all at once
  3. the segment-sum kernel against its plain version at the memory
     write's shapes, with out-of-range ids and a one-cell worst case
  4. the memory-read kernel against its plain version at the read's shapes
  5. the main path: the default config (480x640, ResNet-50, 8192 x 512
     memory, 300 detections, write top-100, bf16) with seeded weights,
     one chunk of frames through `make_episode_runner` with the memory
     carried; kernel launch counts are zeroed just before that run and
     read just after it
  6. the card against the plain CPU path on a small config
  7. each kernel's device time beside its plain version, the PyTorch
     library call where one exists, and its bound

It then prints one JSON line of kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a card, or without the rest of
the repository beside it, it exits non-zero before printing a result.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
T_FRAMES = 4
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call: `reps` calls captured in a CUDA graph
    (no host launch overhead in the timing), replayed `replays` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(n: int, text: str) -> None:
    print(f"[phase {n}] {text}", flush=True)


# ------------------------------------------------------------------ phases

def build_kernels():
    from embodied_object_detection_tpu_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    for name, (secs, log) in report.items():
        print(f"  built {name} in {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    phase(2, f"kernels ready in {time.perf_counter() - t0:.1f} s "
             f"({len(report)} compiled, {len(build.ENTRY_POINTS)} total)")


def segment_sum_inputs(rng, one_cell=False):
    """Weights-plus-count rows like the memory write's: each selected pixel
    is covered by 1-3 of the 100 masks (weight 1/c each) and carries a
    count of 1; unselected slots carry id -1."""
    rows, n, cells = 480 * 80, 100, 8192
    w = np.zeros((rows, n + 1), np.float32)
    cover = rng.randint(1, 4, rows)
    lanes = np.argsort(rng.rand(rows, n), axis=1)[:, :3]   # distinct masks
    for c in (1, 2, 3):
        r = np.flatnonzero(cover == c)
        w[r[:, None], lanes[r, :c]] = 1.0 / c
    w[:, n] = 1.0
    idx = (np.zeros(rows) + 5 if one_cell
           else rng.randint(0, cells, rows)).astype(np.int32)
    idx[rng.rand(rows) < 0.1] = -1
    idx[rng.rand(rows) < 0.02] = cells + 7
    return (torch.from_numpy(w).cuda(), torch.from_numpy(idx).cuda(), cells)


def check_segment_sum(rng):
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss
    worst = 0.0
    for one_cell in (False, True):
        w, idx, cells = segment_sum_inputs(rng, one_cell)
        got = ss.segment_sum(w, idx, cells)
        want = ss.segment_sum_plain(w, idx, cells)
        torch.cuda.synchronize()
        keep = (idx >= 0) & (idx < cells)
        rows_in_cell = torch.bincount(idx[keep].long(), minlength=cells)
        abs_sum = ss.segment_sum_plain(w.abs(), idx, cells)
        bound = rows_in_cell[:, None] * 2.0 ** -24 * abs_sum + 1e-7
        err = (got - want).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"segment_sum disagrees: max err "
                                 f"{float(err.max())} (one_cell={one_cell})")
        if not torch.equal(got[:, -1], rows_in_cell.float()):
            raise AssertionError("segment_sum count lane is not exact")
        worst = max(worst, float(err.max()))
        print(f"  one_cell={one_cell}: max |kernel - plain| = "
              f"{float(err.max()):.3e}, count lane exact")
    phase(3, "segment_sum agrees with its plain version (tolerance: rows "
             "in the cell * 2^-24 * sum|w| per entry; count lane exact)")
    return worst


def memory_read_inputs(rng):
    feats = torch.from_numpy(
        (rng.randn(8192, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(
        rng.choice([0.0, 1.0, 2.0, 5.0], 8192).astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    return feats, obs, proj


def check_memory_read(rng):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats, obs, proj = memory_read_inputs(rng)
    got = memory_ops.memory_read(feats, obs, proj)
    want = memory_ops.memory_read_plain(feats, obs, proj)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    phase(4, f"memory_read agrees with its plain version: max err "
             f"{err:.3e} (tolerance rtol 1e-6, atol 1e-6)")
    return err


def run_main_path(profile_dir):
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.ops import memory_ops
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss
    from embodied_object_detection_tpu_torch.structures import MemoryState

    cfg = DetectorConfig()
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=0, device="cuda")
    print(f"  built the default-config model in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters())} parameters)")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (T_FRAMES, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, cells, (T_FRAMES, h, w)).astype(np.int32)
    resets = np.array([True] + [False] * (T_FRAMES - 1))
    frames = frame_inputs(images, projs, resets, cells, "cuda")
    zs = torch.from_numpy(rng.randn(cfg.roi.zs_weight_dim,
                                    cfg.roi.num_classes + 1)
                          .astype(np.float32)).cuda()
    init = MemoryState.zeros(cells, dim, "cuda")
    run = make_episode_runner(model, cfg)

    t0 = time.perf_counter()
    run(frames, zs, init)
    torch.cuda.synchronize()
    print(f"  warm-up chunk: {time.perf_counter() - t0:.2f} s")

    ss.segment_sum.launches = 0
    memory_ops.memory_read.launches = 0
    t0 = time.perf_counter()
    out = run(frames, zs, init)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = {"segment_sum": ss.segment_sum.launches,
                "memory_read": memory_ops.memory_read.launches}
    print(f"  launches in the main-path run: {launches}")

    chunk_s = [counted_s]
    for _ in range(3):
        t0 = time.perf_counter()
        run(frames, zs, out.memory)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    per_frame = [s / T_FRAMES * 1e3 for s in chunk_s]
    print("  per-frame ms over chunks of %d frames: %s" % (
        T_FRAMES, ", ".join(f"{x:.2f}" for x in per_frame)))

    t0 = time.perf_counter()
    model.backbone_raw(frames.image)
    torch.cuda.synchronize()
    print(f"  batched trunk alone: "
          f"{(time.perf_counter() - t0) / T_FRAMES * 1e3:.2f} ms/frame")

    det = out.detections
    shapes = {"boxes": (T_FRAMES, cfg.roi.detections_per_image, 4),
              "scores": (T_FRAMES, cfg.roi.detections_per_image),
              "features": (cells, dim)}
    got_shapes = {"boxes": tuple(det.boxes.shape),
                  "scores": tuple(det.scores.shape),
                  "features": tuple(out.memory.features.shape)}
    if got_shapes != shapes:
        raise AssertionError(f"shapes {got_shapes} != {shapes}")
    for name, t in (("boxes", det.boxes), ("scores", det.scores),
                    ("memory", out.memory.features),
                    ("obs", out.memory.obs_count)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite {name}")
    any_det = out.any_detection.tolist()
    n_det = det.valid.sum(dim=1).tolist()
    print(f"  detections per frame: {n_det}; frames that wrote: {any_det}")
    if not any_det[0]:
        raise AssertionError("frame 0 wrote nothing to the memory")
    first = out.first_memory
    ego1 = memory_ops.memory_read_plain(first.features, first.obs_count,
                                        frames.proj_indices[1])
    if not float(ego1.abs().max()) > 0:
        raise AssertionError("frame 1 read an all-zero memory")
    for name, n in launches.items():
        if n != T_FRAMES:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{T_FRAMES} frames, expected one a frame")
    print(f"  memory after the chunk: {int((out.memory.obs_count > 0).sum())}"
          f" cells observed, max |feature| "
          f"{float(out.memory.features.abs().max()):.3f}; frame 1 read "
          f"max |ego| {float(ego1.abs().max()):.3f}")

    if profile_dir:
        profile_chunk(run, frames, zs, init, Path(profile_dir))
    phase(5, f"main path ran {T_FRAMES} frames at 480x640: "
             f"{min(per_frame):.2f} ms/frame (best chunk), every kernel "
             "launched once a frame, frame 0 wrote, frame 1 read it")
    return launches, per_frame


def profile_chunk(run, frames, zs, init, out_dir):
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(frames, zs, init)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    (out_dir / "chunk_ops.txt").write_text(table)
    trace = out_dir / "chunk_trace.json"
    prof.export_chrome_trace(str(trace))
    print("\n".join(table.splitlines()[:30]))
    trace_events = json.loads(trace.read_text())["traceEvents"]
    waits = {name: sum(1 for e in trace_events if e.get("name") == name)
             for name in ("cudaStreamSynchronize", "cudaMemcpyAsync")}
    print(f"  host calls in the chunk: {waits}")
    # device busy time = union of kernel / copy / set intervals
    events = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in trace_events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"))
    busy, cur = 0.0, list(events[0])
    for s, e in events[1:]:
        if s > cur[1]:
            busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    span = max(e for _, e in events) - events[0][0]
    print(f"  profiled chunk: {len(events)} device ops, device busy "
          f"{busy / 1e3:.2f} ms of a {span / 1e3:.2f} ms span "
          f"({busy / 1e3 / T_FRAMES:.2f} ms/frame busy; idle share "
          f"{1 - busy / span:.3f} under the profiler)")


def check_against_cpu():
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    cfg = DetectorConfig()
    cfg = cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=64,
                                      post_nms_topk_test=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=16,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=8))
    rng = np.random.RandomState(1)
    h, w = cfg.input.height, cfg.input.width
    images = rng.randint(0, 255, (2, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, 64, (2, h, w)).astype(np.int32)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_detector(cfg, seed=3, device=dev)
        frames = frame_inputs(images, projs, np.array([True, False]), 64, dev)
        outs[dev] = make_episode_runner(model, cfg)(
            frames, torch.from_numpy(zs).to(dev),
            MemoryState.zeros(64, 512, dev))
    cpu, card = outs["cpu"], outs["cuda"]
    if not torch.equal(cpu.any_detection, card.any_detection.cpu()):
        raise AssertionError("the card and the CPU disagree on writes")
    for t in range(2):
        v_c, v_g = cpu.detections.valid[t], card.detections.valid[t].cpu()
        if int(v_c.sum()) != int(v_g.sum()):
            raise AssertionError(f"frame {t}: detection counts differ")
        s_c = cpu.detections.scores[t][v_c].sort(descending=True).values
        s_g = card.detections.scores[t].cpu()[v_g].sort(
            descending=True).values
        torch.testing.assert_close(s_g, s_c, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(card.memory.features.cpu(), cpu.memory.features,
                               rtol=1e-3, atol=1e-3)
    if not torch.equal(card.memory.obs_count.cpu(), cpu.memory.obs_count):
        raise AssertionError("observation counts differ")
    phase(6, "small config (64x96, f32): the card matches the plain CPU path "
             "over 2 frames (scores rtol 1e-4, memory rtol/atol 1e-3, "
             f"{int(cpu.detections.valid.sum())} detections)")


def time_kernels(rng, launches, errs):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss

    w, idx, cells = segment_sum_inputs(rng)
    rows, lanes = w.shape
    routed = torch.where((idx >= 0) & (idx < cells), idx.long(),
                         torch.full_like(idx, cells).long())
    ms = graph_ms(lambda: ss.segment_sum(w, idx, cells))
    plain_ms = graph_ms(lambda: ss.segment_sum_plain(w, idx, cells))
    lib_ms = graph_ms(lambda: torch.zeros((cells + 1, lanes),
                                          device="cuda").index_add_(
                                              0, routed, w))
    added = int(((w != 0) & ((idx >= 0) & (idx < cells))[:, None]).sum())
    b_ms, b_by = bound_ms(rows * lanes * 4 + rows * 4 + cells * lanes * 4,
                          added)
    seg = {"name": "segment_sum", "route": "cuda",
           "source": "embodied_object_detection_tpu_torch/csrc/segment_sum.cu",
           "replaces": "embodied_object_detection_tpu/ops/pallas_scatter.py:60",
           "launches": launches["segment_sum"], "max_abs_err": errs[0],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}

    feats, obs, proj = memory_read_inputs(rng)
    ms = graph_ms(lambda: memory_ops.memory_read(feats, obs, proj))
    plain_ms = graph_ms(lambda: memory_ops.memory_read_plain(feats, obs,
                                                             proj))
    h, wd = proj.shape
    d = feats.shape[1]
    rows_read = int(torch.unique(proj).numel())
    out_elems = (h // 4) * (wd // 4) * d
    b_ms, b_by = bound_ms(rows_read * d * 4 + obs.numel() * 4 +
                          proj.numel() * 4 + out_elems * 4,
                          out_elems * (16 * 2 + 1))
    read = {"name": "memory_read", "route": "cuda",
            "source": "embodied_object_detection_tpu_torch/csrc/memory_read.cu",
            "replaces": "embodied_object_detection_tpu/ops/memory_ops.py:43",
            "launches": launches["memory_read"], "max_abs_err": errs[1],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
    for k in (seg, read):
        print(f"  {k['name']}: {k['ms'] * 1e3:.1f} us kernel, "
              f"{k['plain_ms'] * 1e3:.1f} us plain, bound "
              f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}), library "
              f"{'-' if k['library_ms'] is None else '%.1f us' % (k['library_ms'] * 1e3)}")
    phase(7, "kernel device times from CUDA graphs of 20 calls x 10 "
             "replays, inputs L2-warm")
    return [seg, read]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one main-path chunk into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import embodied_object_detection_tpu_torch  # noqa: F401  fails alone

    card = smi("name,power.limit")
    print(card)
    phase(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"{torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} card(s)")
    build_kernels()
    rng = np.random.RandomState(123)
    errs = (check_segment_sum(rng), check_memory_read(rng))
    launches, _ = run_main_path(args.profile)
    check_against_cpu()
    kernels = time_kernels(rng, launches, errs)
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
