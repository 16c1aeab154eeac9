"""Evaluation engine: the serial recurrent-episode protocol, and the
external GT-memory table.

Counterpart of the JAX package's `engine/eval.py` (the reference's
mp3d_inference_on_dataset, ref: Detic/train_mp3d.py:85-363):
  * episode chunks stream in the dataset's sorted order, and the memory
    carries across chunks (reset flags come from the dataset)
  * every `input.score_every`-th valid frame is scored (:187-188)
  * COCO GT is rebuilt on the fly from the streamed annotations (:229-239)
  * images fall into temporal quartiles by the chunk's serial index
    (`min(3, (idx % 100) // 25)`, :210-217)
  * overall and per-quartile bbox AP (:300-358)
  * a data / compute / eval timing split with the first chunks excluded
    as warm-up (:135-284), taken by the spans `eodt.eval.data`,
    `eodt.eval.compute` and `eodt.eval.score` on a clock

The chunk runs on the model's device through `make_episode_runner`. Host
work (reading the chunk, the cell-id guard, the cell visibility, pinned
staging) runs on the prefetch threads; the loop issues the host-to-device
copies without blocking, ends each chunk's compute with one
`torch.cuda.synchronize()` on the card, and copies only the scored
frames' detections to the host, once a chunk. `external_memory_state` is
the fixed table the GT-memory baselines (`memory.memory_type`
"semantic_gt", "map_gt", "explicit_map") read instead of a recurrent
memory. `evaluate_dataset_sharded` is the episode-parallel protocol:
the scenes partitioned over lanes, the lanes over the ranks of the
process mesh's data axis, the detections gathered to every rank and
scored in serial order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import DetectorConfig
from ..data.episode_dataset import EpisodeChunk, OBJECT_LVIS
from ..data.prefetch import prefetch_iterator
from ..evaluation.coco_eval import COCOEvaluator
from ..models.detector import (EmbodiedDetector, FrameInputs,
                               make_episode_runner, resolve_device)
from ..ops.memory_ops import (check_proj_indices, obs_visibility_host,
                              semmap_classes)
from ..structures import MemoryState
from ..utils.tracing import span
from .checkpoint import save_memory_h5

# the eval loops' chunk timers: spans on the loop's clock
DATA, COMPUTE, SCORE = "eodt.eval.data", "eodt.eval.compute", "eodt.eval.score"


@dataclass
class EvalResults:
    overall: Dict[str, float]
    quartiles: List[Dict[str, float]] = field(default_factory=list)
    timing: Dict[str, float] = field(default_factory=dict)
    num_images: int = 0


def external_memory_state(table, cfg: DetectorConfig,
                          observations: Optional[np.ndarray] = None,
                          device: "torch.device | str" = "cuda"
                          ) -> MemoryState:
    """The fixed GT-memory table, padded to [max_cells, D] with zero rows
    (the CLIP class table with a zero row 0, or a precomputed map; the
    episode runner never resets or writes it).

    `table` is the [cells, D] table as an array, with `observations` its
    per-cell observation counts, or an object that carries both as
    `memory_features` and `observations`, as an episode chunk does.
    Observations default to 1 for every row of the table."""
    if hasattr(table, "memory_features"):          # an episode chunk
        table, observations = table.memory_features, table.observations
    if table is None:
        raise ValueError(
            f"memory_type={cfg.memory.memory_type!r} needs the dataset to "
            "carry the external table: construct EpisodeDataset with "
            "memory_type= and clip_path= (run.py wires these when "
            "memory.memory_type is a GT baseline)")
    feats = np.asarray(table, np.float32)
    if feats.ndim != 2 or feats.shape[0] > cfg.memory.max_cells or \
            feats.shape[1] != cfg.memory.memory_dim:
        raise ValueError(
            f"external memory table {feats.shape} does not fit "
            f"[{cfg.memory.max_cells}, {cfg.memory.memory_dim}]")
    obs = (np.asarray(observations, np.float32)
           if observations is not None
           else np.ones((feats.shape[0],), np.float32))
    if obs.shape != (feats.shape[0],):
        raise ValueError(f"observations {obs.shape} do not match the "
                         f"table's {feats.shape[0]} rows")
    pad = cfg.memory.max_cells - feats.shape[0]
    device = resolve_device(device)
    return MemoryState(
        features=torch.from_numpy(np.pad(feats, ((0, pad), (0, 0)))).to(
            device),
        obs_count=torch.from_numpy(np.pad(obs, (0, pad))).to(device))


class HostFrames(NamedTuple):
    """A chunk's frame inputs on the host, pinned when bound for the
    card: images stay uint8 until they are on the device."""
    image: torch.Tensor           # [T, H, W, 3] uint8
    proj_indices: torch.Tensor    # [T, H, W] int32
    obs_visibility: torch.Tensor  # [T, max_cells] float32
    memory_reset: torch.Tensor    # [T] bool
    episode_start: torch.Tensor   # [T] bool
    frame_valid: torch.Tensor     # [T] bool


def host_frame_inputs(chunk: EpisodeChunk, max_cells: int,
                      pin: bool = False) -> HostFrames:
    """The host half of `chunk_to_frame_inputs`: the cell-id guard (a
    scene whose map has more cells than the memory must fail here, not
    corrupt the memory), the cell visibility, and the staging tensors."""
    check_proj_indices(chunk.proj_indices, max_cells)

    def host(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype))
        return t.pin_memory() if pin else t

    return HostFrames(
        image=host(chunk.images, np.uint8),
        proj_indices=host(chunk.proj_indices, np.int32),
        obs_visibility=host(obs_visibility_host(chunk.proj_indices,
                                                max_cells), np.float32),
        memory_reset=host(chunk.memory_reset, bool),
        episode_start=host(chunk.episode_start, bool),
        frame_valid=host(chunk.frame_valid, bool))


def frames_to_device(host: HostFrames,
                     device: "torch.device | str") -> FrameInputs:
    """The device half: copies that do not block the host (from pinned
    memory on the card), issued on the current stream."""
    def to(t):
        return t.to(device, non_blocking=True)

    with span("eodt.to_device"):
        proj = to(host.proj_indices)
        return FrameInputs(
            image=to(host.image).float(), proj_indices=proj,
            outlier_mask=torch.zeros(proj.shape, dtype=torch.bool,
                                     device=proj.device),
            obs_visibility=to(host.obs_visibility),
            memory_reset=to(host.memory_reset),
            episode_start=to(host.episode_start),
            frame_valid=to(host.frame_valid))


def chunk_to_frame_inputs(chunk: EpisodeChunk, max_cells: int,
                          device: "torch.device | str" = "cuda"
                          ) -> FrameInputs:
    """A chunk's `FrameInputs` on `device`."""
    device = resolve_device(device)
    return frames_to_device(
        host_frame_inputs(chunk, max_cells, pin=device.type == "cuda"),
        device)


def _save_memory_snapshot(cfg: DetectorConfig, zs: torch.Tensor,
                          features: torch.Tensor, obs_count: torch.Tensor,
                          chunk: EpisodeChunk) -> str:
    """Write the memory snapshot of one chunk (ref: custom_rcnn.py:518-530:
    the semmap classes, the accumulated features and the observation
    counts after the chunk's frame 0). The device tensors are sliced to
    the scene's cells before the copy to the host."""
    feats = features[:chunk.num_cells]
    obs = obs_count[:chunk.num_cells]
    semmap = semmap_classes(feats, obs, zs, cfg.memory.obs_score_thresh,
                            cfg.roi.norm_temperature)
    return save_memory_h5(cfg.output_dir, chunk.sequence_name,
                          semmap.cpu().numpy(), feats.cpu().numpy(),
                          obs.cpu().numpy())


def _score_chunk_frames(evaluator: COCOEvaluator,
                        quartile_ids: List[List[int]], chunk: EpisodeChunk,
                        serial_idx: int, det_boxes, det_scores, det_classes,
                        det_valid, im_id: int, score_every: int) -> int:
    """Feed one chunk's every-`score_every`-th valid frame to the
    evaluator (ref: train_mp3d.py:187-239): quartile bucket by the chunk's
    serial index (:210-217); GT integer-truncated in xywh space with
    area=0 (:237; truncation in xywh, not per xyxy corner). det_* are the
    chunk's host arrays already sliced to the scored frames (row j = frame
    j * score_every). Returns the next image id."""
    t_len = chunk.images.shape[0]
    for i in range(0, t_len, score_every):
        if not chunk.frame_valid[i]:
            continue
        q = min(3, (serial_idx % 100) // 25)
        quartile_ids[q].append(im_id)
        evaluator.add_image(im_id)
        gv = chunk.gt_valid[i]
        b = chunk.gt_boxes[i][gv].astype(np.float64)
        gx = np.trunc(b[:, 0])
        gy = np.trunc(b[:, 1])
        gw = np.trunc(b[:, 2] - b[:, 0])
        gh = np.trunc(b[:, 3] - b[:, 1])
        gb = np.stack([gx, gy, gx + gw, gy + gh], axis=1) if len(b) else b
        evaluator.add_ground_truth(im_id, gb, chunk.gt_classes[i][gv],
                                   areas=np.zeros(int(gv.sum())))
        j = i // score_every
        v = det_valid[j]
        evaluator.add_detections(im_id, det_boxes[j][v], det_scores[j][v],
                                 det_classes[j][v])
        im_id += 1
    return im_id


def pack_scored(detections, score_every: int) -> torch.Tensor:
    """The scored frames' detections packed into one f32 tensor on their
    device, [..., S, N, 7] (box, score, class, valid; class ids are exact
    in f32), S = ceil(T / score_every), from detections [..., T, N, ...]."""
    sl = slice(0, None, score_every)
    return torch.cat([detections.boxes[..., sl, :, :].float(),
                      detections.scores[..., sl, :].float()[..., None],
                      detections.classes[..., sl, :].float()[..., None],
                      detections.valid[..., sl, :].float()[..., None]],
                     dim=-1)


def unpack_scored(host: np.ndarray):
    """(boxes, scores, classes, valid) of `pack_scored`'s array."""
    return (host[..., :4], host[..., 4], host[..., 5].astype(np.int32),
            host[..., 6] > 0)


def scored_detections(detections, score_every: int):
    """The scored frames' detections on the host, in one copy: (boxes,
    scores, classes, valid) as numpy [S, N, ...], S = ceil(T /
    score_every)."""
    return unpack_scored(pack_scored(detections, score_every).cpu().numpy())


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], on_card: bool, name: str):
    """A torch.profiler chrome trace of the block (host ops, the port's
    spans and, on the card, its kernels) written to profile_dir/name;
    nothing without `profile_dir`."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, name))


def _results(evaluator: COCOEvaluator, quartile_ids: List[List[int]],
             im_id: int, clock: Dict[str, float], n_timed: int,
             total_s: float, frames: int, verbose: bool, label: str = "",
             **timing: float) -> EvalResults:
    """The AP of the evaluator and the timing of the loop's timed chunks
    from its clock; printed when `verbose`."""
    compute = clock.get(COMPUTE, 0.0)
    results = EvalResults(
        overall=evaluator.evaluate(),
        quartiles=[evaluator.evaluate(q) if q else {} for q in quartile_ids],
        timing=dict(
            data_s_per_chunk=clock.get(DATA, 0.0) / n_timed,
            compute_s_per_chunk=compute / n_timed,
            eval_s_per_chunk=clock.get(SCORE, 0.0) / n_timed,
            total_s=total_s,
            frames_per_s=frames / max(compute, 1e-9),
            **timing,
        ),
        num_images=im_id,
    )
    if verbose:
        print(f"{label}AP (overall):", {k: round(v, 2)
                                        for k, v in results.overall.items()
                                        if not k.startswith("AP-")})
        print("timing:", {k: round(v, 4) for k, v in results.timing.items()})
    return results


def evaluate_dataset(model: EmbodiedDetector, cfg: DetectorConfig,
                     dataset, zs_weight: np.ndarray,
                     max_chunks: Optional[int] = None,
                     verbose: bool = True, num_workers: int = 2,
                     profile_dir: Optional[str] = None) -> EvalResults:
    """Evaluate `model` (on its device) over `dataset`'s chunks in order.
    `dataset` is an `EpisodeDataset` or any sequence of `EpisodeChunk`s;
    `zs_weight` the [D, C+1] classifier. `profile_dir` writes a
    torch.profiler chrome trace of the whole loop there
    (`eval_trace.json`)."""
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    runner = make_episode_runner(model, cfg)
    zs = torch.from_numpy(np.asarray(zs_weight, np.float32)).to(device)

    # first_ann_id=0: the reference's on-the-fly GT starts annotation ids
    # at 0 (train_mp3d.py:149), which makes pycocotools score the
    # detection matched to annotation 0 as a false positive; reproduced
    evaluator = COCOEvaluator(list(range(cfg.roi.num_classes)),
                              OBJECT_LVIS[:cfg.roi.num_classes],
                              first_ann_id=0)
    quartile_ids: List[List[int]] = [[], [], [], []]
    score_every = cfg.input.score_every
    max_cells = cfg.memory.max_cells

    external = cfg.memory.external_memory()
    memory = MemoryState.zeros(max_cells, cfg.memory.memory_dim, device)
    im_id = 0
    clock: Dict[str, float] = {}
    n_chunks = len(dataset) if max_chunks is None else min(max_chunks,
                                                           len(dataset))
    t_total0 = time.perf_counter()
    total_frames = 0

    def fetch(i):
        chunk = dataset[i]
        return chunk, host_frame_inputs(chunk, max_cells, pin=on_card)

    chunk_iter = prefetch_iterator(fetch, range(n_chunks),
                                   num_workers=num_workers)
    # warm-up exclusion (train_mp3d.py:135, 179-183): the clock resets at
    # the top of iteration num_warmup, so the boundary chunk's time lands
    # on the warm-up side and the timed sums cover exactly the chunks
    # counted
    num_warmup = min(5, n_chunks - 1)
    warm_chunks = warm_frames = 0
    # the external table is chunk-invariant for semantic_gt / map_gt:
    # its padded device copy is cached by the source array's identity (a
    # distinct sentinel, so that a missing table still raises)
    unset = object()
    ext_cache = (unset, None)
    with _profiled(profile_dir, on_card, "eval_trace.json"):
        for idx in range(n_chunks):
            if idx == num_warmup:
                clock.clear()
                t_total0 = time.perf_counter()
                warm_chunks = idx
                warm_frames = total_frames
            with span(DATA, clock):
                chunk, host = next(chunk_iter)
                frames = frames_to_device(host, device)
                if external:
                    # the GT-memory baselines read a fixed table, never
                    # zeros
                    if ext_cache[0] is not chunk.memory_features:
                        ext_cache = (chunk.memory_features,
                                     external_memory_state(chunk, cfg,
                                                           device=device))
                    memory = ext_cache[1]

            with span(COMPUTE, clock):
                out = runner(frames, zs, memory)
                memory = out.memory
                if on_card:
                    torch.cuda.synchronize(device)

            if cfg.memory.save_semmap:
                _save_memory_snapshot(cfg, zs, out.first_memory.features,
                                      out.first_memory.obs_count, chunk)

            with span(SCORE, clock):
                im_id = _score_chunk_frames(
                    evaluator, quartile_ids, chunk, idx,
                    *scored_detections(out.detections, score_every), im_id,
                    score_every)
                total_frames += int(chunk.frame_valid.sum())
            if verbose and (idx + 1) % 10 == 0:
                done = idx + 1 - warm_chunks
                print(f"inference {idx + 1}/{n_chunks} "
                      f"data {clock.get(DATA, 0.0) / done:.3f}s/it "
                      f"compute {clock.get(COMPUTE, 0.0) / done:.3f}s/it "
                      f"eval {clock.get(SCORE, 0.0) / done:.3f}s/it")

    return _results(evaluator, quartile_ids, im_id, clock,
                    max(n_chunks - warm_chunks, 1),
                    time.perf_counter() - t_total0,
                    total_frames - warm_frames, verbose)


def scene_of(chunk_file: str) -> str:
    """'scene0000_lvl0_3.h5' -> 'scene0000_lvl0' (the loader's file
    convention)."""
    return chunk_file.rsplit("_", 1)[0]


def partition_lanes(files: List[str], streams: int) -> List[List[int]]:
    """The chunk indices of each of `streams` lanes: the chunks grouped by
    scene in their serial order, the scenes (most chunks first, ties in
    name order) each given to the lane with the fewest chunks so far."""
    scene_chunks: Dict[str, List[int]] = {}
    for i, f in enumerate(files):
        scene_chunks.setdefault(scene_of(f), []).append(i)
    lanes: List[List[int]] = [[] for _ in range(streams)]
    for _, idxs in sorted(scene_chunks.items(), key=lambda kv: -len(kv[1])):
        min(lanes, key=len).extend(idxs)
    return lanes


def _slim(chunk: EpisodeChunk) -> EpisodeChunk:
    """The chunk without what scoring does not read: frames, ids, memory."""
    return dataclasses.replace(chunk, images=chunk.images[:, :0, :0],
                               proj_indices=chunk.proj_indices[:, :0, :0],
                               memory_features=None, observations=None)


def _scoring_chunk(dataset, index: int) -> EpisodeChunk:
    """Chunk `index` as scoring reads it, through the dataset's
    `ground_truth` where it has one (an h5 root's reads only the
    detection records)."""
    gt = getattr(dataset, "ground_truth", None)
    return _slim(gt(index) if gt is not None else dataset[index])


def _stack_host(frames: List[HostFrames], pin: bool) -> HostFrames:
    def stack(xs):
        t = torch.stack(xs)
        return t.pin_memory() if pin else t
    return HostFrames(*(stack(list(x)) for x in zip(*frames)))


def evaluate_dataset_sharded(model: EmbodiedDetector, cfg: DetectorConfig,
                             dataset, zs_weight: np.ndarray, mesh=None,
                             streams: Optional[int] = None,
                             verbose: bool = True,
                             num_workers: int = 2,
                             profile_dir: Optional[str] = None
                             ) -> EvalResults:
    """Episode-parallel evaluation (the JAX package's
    `evaluate_dataset_sharded`): the scenes partitioned over `streams`
    independent lanes (default: the data axis's size), each rank of the
    mesh's data axis running its lanes through the sharded runner.

    The memory binds only within a scene (resets fire at scene starts),
    so the lanes reproduce the serial protocol's per-image detections
    (on the card up to the last bits of the trunk, which runs over the
    rank's lanes in one batch); each chunk keeps its serial index for the
    quartiles. Protocol: scenes balanced greedily by chunk count
    (`partition_lanes`); an exhausted lane replays a chunk of the step
    (its rank's first) with every frame invalid; the first min(5, steps - 1) steps are warm-up; a GT-memory
    table is kept a lane and rebuilt only at the lane's scene boundary;
    `save_semmap` writes each lane's snapshot on the rank that runs it;
    a rank reads only the GT of the other ranks' lanes.
    The scored frames' detections of every lane are gathered to every
    rank (one all-gather a step of the fixed-shape [lanes, frames, N, 7]
    payload over the data group), and every rank feeds the evaluator the
    whole set in serial chunk order (annotation ids start at 0, so the
    order decides which detection is matched to annotation 0). `dataset`
    is an `EpisodeDataset` or a sequence of chunks with `files`.
    `profile_dir` writes a torch.profiler chrome trace of the loop there
    (`eval_trace.json`, `eval_trace.rank<r>.json` on rank r > 0)."""
    from ..parallel.eval_step import make_sharded_episode_runner
    from ..parallel.mesh import gather_into, make_mesh

    if mesh is None:
        mesh = make_mesh(cfg.parallel)
    axis = cfg.parallel.data_axis
    d = mesh.shape[axis]
    s = streams or d
    if s % d != 0:
        raise ValueError(f"streams={s} must be a multiple of the data axis "
                         f"size {d}")
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    files = list(getattr(dataset, "files", None) or
                 [dataset[i].sequence_name for i in range(len(dataset))])
    lanes = partition_lanes(files, s)
    n_steps = max((len(lane) for lane in lanes), default=0)
    if n_steps:
        pad_frac = 1.0 - sum(len(lane) for lane in lanes) / (n_steps * s)
        if verbose and pad_frac > 0:
            print(f"sharded eval: {pad_frac:.1%} of lane steps are "
                  f"padding (scene-length imbalance over {s} streams)")

    runner = make_sharded_episode_runner(model, cfg, mesh, data_axis=axis)
    mine = list(runner.lanes(s))
    zs = torch.from_numpy(np.asarray(zs_weight, np.float32)).to(device)
    evaluator = COCOEvaluator(list(range(cfg.roi.num_classes)),
                              OBJECT_LVIS[:cfg.roi.num_classes],
                              first_ann_id=0)
    quartile_ids: List[List[int]] = [[], [], [], []]
    score_every = cfg.input.score_every
    max_cells = cfg.memory.max_cells

    memory = MemoryState(
        features=torch.zeros((len(mine), max_cells, cfg.memory.memory_dim),
                             device=device),
        obs_count=torch.zeros((len(mine), max_cells), device=device))
    external = cfg.memory.external_memory()
    unset = object()
    ext_rows: List[tuple] = [(unset, None)] * len(mine)
    im_id = 0
    clock: Dict[str, float] = {}
    t_total0 = time.perf_counter()
    total_frames = 0

    def fetch(j):
        # a rank reads its own lanes' chunks whole and only the GT of the
        # others' (every rank scores every lane); an exhausted lane
        # replays a chunk of the step with every frame invalid
        row = [None if j >= len(lane) else dataset[lane[j]] if i in mine
               else _scoring_chunk(dataset, lane[j])
               for i, lane in enumerate(lanes)]
        tmpl = next((row[i] for i in mine if row[i] is not None), None)
        if tmpl is None:
            tmpl = dataset[next(lane[j] for lane in lanes if j < len(lane))]
        host = []
        for i in mine:
            if row[i] is None:
                fi = host_frame_inputs(tmpl, max_cells)
                host.append(fi._replace(
                    frame_valid=torch.zeros_like(fi.frame_valid)))
            else:
                host.append(host_frame_inputs(row[i], max_cells))
        return row, _stack_host(host, on_card)

    fetch_iter = prefetch_iterator(fetch, range(n_steps),
                                   num_workers=num_workers)
    num_warmup = min(5, n_steps - 1)
    warm_steps = warm_frames = 0
    pending: List[tuple] = []
    trace = "eval_trace.json" if mesh.rank == 0 else \
        f"eval_trace.rank{mesh.rank}.json"
    with _profiled(profile_dir, on_card, trace):
        for j in range(n_steps):
            if j == num_warmup:
                clock.clear()
                t_total0 = time.perf_counter()
                warm_steps = j
                warm_frames = total_frames
            with span(DATA, clock):
                row, host = next(fetch_iter)
                frames = frames_to_device(host, device)
                if external:
                    dirty = False
                    for k, i in enumerate(mine):
                        chunk = row[i]
                        if chunk is not None and \
                                ext_rows[k][0] is not chunk.memory_features:
                            ext_rows[k] = (chunk.memory_features,
                                           external_memory_state(
                                               chunk, cfg, device=device))
                            dirty = True
                    if dirty:
                        zero = MemoryState.zeros(
                            max_cells, cfg.memory.memory_dim, device)
                        tables = [r[1] if r[1] is not None else zero
                                  for r in ext_rows]
                        memory = MemoryState(*(torch.stack(x)
                                               for x in zip(*tables)))

            with span(COMPUTE, clock):
                out = runner.local(frames, zs, memory)
                if not external:
                    memory = out.memory
                packed = gather_into(pack_scored(out.detections,
                                                 score_every),
                                     mesh.group(axis), d)
                if on_card:
                    torch.cuda.synchronize(device)

            if cfg.memory.save_semmap:
                for k, i in enumerate(mine):
                    if row[i] is not None:
                        _save_memory_snapshot(cfg, zs,
                                              out.first_memory.features[k],
                                              out.first_memory.obs_count[k],
                                              row[i])

            with span(SCORE, clock):
                boxes, scores, classes, valid = unpack_scored(
                    packed.cpu().numpy())
                for i, chunk in enumerate(row):
                    if chunk is None:
                        continue
                    pending.append((lanes[i][j], _slim(chunk), boxes[i],
                                    scores[i], classes[i], valid[i]))
                    total_frames += int(chunk.frame_valid.sum())

    with span(SCORE, clock):
        pending.sort(key=lambda rec: rec[0])
        for serial_idx, slim, b, sc, cl, v in pending:
            im_id = _score_chunk_frames(evaluator, quartile_ids, slim,
                                        serial_idx, b, sc, cl, v, im_id,
                                        score_every)
    return _results(evaluator, quartile_ids, im_id, clock,
                    max(n_steps - warm_steps, 1),
                    time.perf_counter() - t_total0,
                    total_frames - warm_frames, verbose,
                    label=f"sharded eval ({s} streams) ", streams=float(s))
