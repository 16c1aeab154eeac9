"""The training loop.

Counterpart of the JAX package's `engine/train.py`: IMS_PER_BATCH chunks a
step flattened into a batch of frames (`chunks_to_train_batch`), a
per-iteration numpy stream keyed on (seed, iteration) so a resumed run
samples on where it left off, a one-batch lookahead thread that makes the
next batch (and stages it in pinned memory) while the card runs the step,
the finite-loss assert, `metrics.json` lines of window medians mirrored
into a TensorBoard events file (`utils/tb_writer.py`), and periodic
checkpoints. The chunks come from a sequence of `ChunkRecord`s, such as
the h5 `data.EpisodeDataset` that `run.py` trains from;
`batch_fn(it, rng, dp)` replaces the chunk loader. `load_fed_freq_weight`
reads the class-frequency table of the federated loss.

Over a process mesh (`parallel/mesh.py:make_mesh(cfg.parallel)`: the
running process group, else a world of one), every rank makes the global
batch from the shared per-iteration stream, padded to a multiple of the
data axis, and keeps its rows; the step is the global batch's, and the
logged losses are global. Rank 0's state (fresh, or restored on resume)
is broadcast before the first step; only rank 0 writes `metrics.json`,
the TensorBoard events and the checkpoints.
"""

from __future__ import annotations

import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import DetectorConfig
from ..models.detector import EmbodiedDetector
from ..ops.memory_ops import check_proj_indices
from ..parallel.mesh import make_mesh, shard_batch
from ..parallel.train_step import (TrainBatch, TrainState, batch_to_device,
                                   make_train_step, replicate_state)
from ..utils.tb_writer import SummaryWriter
from ..utils.tracing import span
from .checkpoint import (PeriodicCheckpointer, latest_checkpoint,
                         restore_checkpoint)


class ChunkRecord(NamedTuple):
    """One episode chunk as plain numpy arrays (T frames)."""
    sequence_name: str
    images: np.ndarray            # [T, H, W, 3] uint8 or float
    proj_indices: np.ndarray      # [T, H, W] int
    frame_valid: np.ndarray       # [T] bool
    gt_boxes: np.ndarray          # [T, G, 4]
    gt_classes: np.ndarray        # [T, G]
    gt_valid: np.ndarray          # [T, G] bool
    memory_features: Optional[np.ndarray] = None   # [n, D] precomputed
    observations: Optional[np.ndarray] = None      # [n]


def chunks_to_train_batch(chunks: Sequence[ChunkRecord],
                          cfg: DetectorConfig,
                          frames_per_chunk: Optional[int] = None,
                          rng: Optional[np.random.RandomState] = None,
                          pad_to_multiple: int = 1,
                          pad_to_total: Optional[int] = None) -> TrainBatch:
    """Flatten chunks into a numpy batch of frames with each chunk's
    memory padded to [cells, D], then pad with zero-weight frames to a
    multiple of `pad_to_multiple` and up to `pad_to_total`."""
    cells = cfg.memory.max_cells
    d = cfg.memory.memory_dim
    images, projs, memfs, memos, gbs, gcs, gvs = [], [], [], [], [], [], []
    for ch in chunks:
        t = int(ch.frame_valid.sum())
        ids = range(t)
        if frames_per_chunk is not None and frames_per_chunk < t:
            ids = sorted((rng or np.random).choice(t, frames_per_chunk,
                                                   replace=False))
        hi = int(ch.proj_indices.max())
        if hi >= cells:
            raise ValueError(
                f"{ch.sequence_name}: proj index {hi} >= memory.max_cells="
                f"{cells}; raise memory.max_cells")
        memf = np.zeros((cells, d), np.float32)
        memo = np.zeros((cells,), np.float32)
        if ch.memory_features is not None:
            if ch.memory_features.shape[0] > cells or \
                    ch.memory_features.shape[1] != d:
                raise ValueError(
                    f"{ch.sequence_name}: memory snapshot "
                    f"{ch.memory_features.shape} does not fit [{cells}, {d}]")
            n = ch.memory_features.shape[0]
            memf[:n] = ch.memory_features
            if ch.observations is not None:
                memo[:n] = ch.observations[:n]
        for i in ids:
            images.append(ch.images[i].astype(np.float32))
            projs.append(ch.proj_indices[i])
            memfs.append(memf)
            memos.append(memo)
            gbs.append(ch.gt_boxes[i])
            gcs.append(ch.gt_classes[i])
            gvs.append(ch.gt_valid[i])
    b = len(images)
    if b == 0:
        raise ValueError("no valid frames in the sampled chunks "
                         f"({[ch.sequence_name for ch in chunks]})")
    target = b + (-b) % max(pad_to_multiple, 1)
    if pad_to_total is not None:
        if b > pad_to_total:
            raise ValueError(f"{b} frames exceed pad_to_total={pad_to_total}")
        target = max(target,
                     pad_to_total + (-pad_to_total) % max(pad_to_multiple, 1))
    pad = target - b
    weight = [1.0] * b + [0.0] * pad
    # the reference's normaliser: n_chunks * frames of the FIRST chunk
    t_first = int(chunks[0].frame_valid.sum())
    if frames_per_chunk is not None:
        t_first = min(t_first, frames_per_chunk)
    for rows in (images, projs, memfs, memos, gbs, gcs, gvs):
        rows.extend([np.zeros_like(rows[0])] * pad)
    return TrainBatch(
        image=np.stack(images), proj_indices=np.stack(projs).astype(np.int32),
        mem_features=np.stack(memfs), mem_obs=np.stack(memos),
        gt_boxes=np.stack(gbs).astype(np.float32),
        gt_classes=np.stack(gcs).astype(np.int32),
        gt_valid=np.stack(gvs).astype(bool),
        weight=np.asarray(weight, np.float32),
        loss_norm=np.full(len(weight), len(chunks) * t_first, np.float32))


class MetricsWriter:
    """One JSON line per logging period in <output_dir>/metrics.json,
    mirrored into a TensorBoard events file under <output_dir>/tb/ (the
    reference's JSONWriter and TensorboardXWriter, train_mp3d.py:534-542)."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.json")
        self._tb = SummaryWriter(os.path.join(output_dir, "tb"))

    def write(self, iteration: int, scalars: Dict[str, float]) -> None:
        rec = {"iteration": iteration,
               **{k: float(v) for k, v in scalars.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._tb.add_scalars(
            {k: v for k, v in rec.items() if k != "iteration"}, iteration)

    def close(self) -> None:
        self._tb.close()


def load_fed_freq_weight(cfg: DetectorConfig) -> Optional[np.ndarray]:
    """The [C] class-frequency table of the federated loss and the
    zero-category mask (ref: detic_fast_rcnn.py:85-97), or None when
    neither `roi.use_fed_loss` nor `roi.ignore_zero_cats` is set. A short
    table is zero-padded to `roi.num_classes`; a longer one raises, and so
    does a `roi.fed_loss_num_cat` above the positive-frequency classes
    (torch.multinomial would raise at the first step)."""
    if not (cfg.roi.use_fed_loss or cfg.roi.ignore_zero_cats):
        return None
    from ..data.catalog import load_class_freq
    fed_w = load_class_freq(cfg.roi.cat_freq_path)
    if fed_w.shape[0] < cfg.roi.num_classes:
        fed_w = np.concatenate(
            [fed_w, np.zeros(cfg.roi.num_classes - fed_w.shape[0],
                             fed_w.dtype)])
    elif fed_w.shape[0] > cfg.roi.num_classes:
        raise ValueError(
            f"cat_freq_path table has {fed_w.shape[0]} classes, model "
            f"has only {cfg.roi.num_classes}")
    n_pos = int((fed_w > 0).sum())
    if cfg.roi.use_fed_loss and cfg.roi.fed_loss_num_cat > n_pos:
        raise ValueError(
            f"roi.fed_loss_num_cat={cfg.roi.fed_loss_num_cat} exceeds "
            f"the {n_pos} positive-frequency classes in "
            f"{cfg.roi.cat_freq_path or 'the LVIS v1 table'}")
    return fed_w


def iter_rng(seed: int, it: int) -> np.random.RandomState:
    """The numpy stream of iteration `it`, keyed on (seed, it)."""
    return np.random.RandomState(
        np.random.SeedSequence([seed, it]).generate_state(1)[0])


def train(model: EmbodiedDetector, cfg: DetectorConfig,
          dataset: Optional[Sequence[ChunkRecord]], zs_weight: np.ndarray,
          max_iter: Optional[int] = None, resume: bool = False,
          frames_per_chunk: Optional[int] = None, log_period: int = 20,
          seed: int = 0, verbose: bool = True,
          batch_fn: Optional[Callable] = None) -> TrainState:
    """Train `model` in place on its device for `max_iter` (default
    `solver.max_iter`) iterations. `batch_fn(it, rng, dp) -> TrainBatch`
    of numpy arrays replaces sampling chunks from `dataset` (which may
    then be None); either way a batch holding a cell id outside [0,
    memory.max_cells) raises. Each metrics line holds the window's median losses,
    the learning rate, and the mean seconds a step spent waiting for its
    batch (`data_time`) and in the step up to its host read (`time`).
    Returns the final TrainState."""
    solver = cfg.solver
    max_iter = max_iter if max_iter is not None else solver.max_iter
    device = next(model.parameters()).device
    pin = device.type == "cuda"
    mesh = make_mesh(cfg.parallel)
    lead = mesh.rank == 0
    axis = cfg.parallel.data_axis
    init_state, step_fn = make_train_step(
        model, cfg, fed_freq_weight=load_fed_freq_weight(cfg), mesh=mesh)
    state = init_state()
    if resume and lead:
        ck = latest_checkpoint(cfg.output_dir)
        if ck:
            state = restore_checkpoint(ck, state)
            if verbose:
                print(f"resumed from {ck} @ iter {state.step}")
    state = replicate_state(mesh, state)
    start_iter = state.step

    writer = MetricsWriter(cfg.output_dir) if lead else None
    checkpointer = PeriodicCheckpointer(cfg.output_dir,
                                        solver.checkpoint_period, max_iter)
    zs = torch.as_tensor(np.asarray(zs_weight, np.float32)).to(device)
    dp = mesh.data_size
    pad_total_frames = solver.ims_per_batch * (
        frames_per_chunk or cfg.input.max_sequence_length)

    def load_batch(it: int) -> TrainBatch:
        r = iter_rng(seed, it)
        if batch_fn is not None:
            batch = batch_fn(it, r, dp)
        else:
            idx = r.choice(len(dataset), solver.ims_per_batch,
                           replace=len(dataset) < solver.ims_per_batch)
            batch = chunks_to_train_batch(
                [dataset[int(i)] for i in idx], cfg, frames_per_chunk, r,
                pad_to_multiple=dp, pad_to_total=pad_total_frames)
        # the batched memory read's contract, for batches of either source
        check_proj_indices(batch.proj_indices, cfg.memory.max_cells)
        return batch_to_device(shard_batch(mesh, batch, axis), "cpu",
                               pin=pin)

    window: List[Dict[str, float]] = []
    # the step timers: spans on the loop's clock
    clock: Dict[str, float] = {}
    last_log = start_iter
    t_start = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        pending = pool.submit(load_batch, start_iter)
        for it in range(start_iter, max_iter):
            with span("eodt.train.data", clock):
                batch = pending.result()
                if it + 1 < max_iter:
                    pending = pool.submit(load_batch, it + 1)
                batch = batch_to_device(batch, device, pin=pin)

            with span("eodt.train.step", clock):
                state, losses = step_fn(state, batch, zs)
                # the step's one host read: every loss in one copy
                values = dict(zip(losses, torch.stack(
                    list(losses.values())).tolist()))
                loss_val = values["total_loss"]
            assert math.isfinite(loss_val), values

            window.append(values)
            if (it + 1) % log_period == 0:
                n_win = it + 1 - last_log
                scalars = {k: float(np.median([w[k] for w in window]))
                           for k in window[-1]}
                scalars["lr"] = state.optimizer.lr(it)
                data_t = clock.get("eodt.train.data", 0.0)
                step_t = clock.get("eodt.train.step", 0.0)
                scalars["data_time"] = data_t / n_win
                scalars["time"] = step_t / n_win
                if lead:
                    writer.write(it + 1, scalars)
                if verbose and lead:
                    eta = (max_iter - it - 1) * \
                        (time.perf_counter() - t_start) / \
                        max(it + 1 - start_iter, 1)
                    print(f"iter {it + 1}/{max_iter} total_loss "
                          f"{loss_val:.4f} step {step_t / n_win:.3f}s "
                          f"eta {eta / 60:.1f}m")
                clock.clear()
                window.clear()
                last_log = it + 1
            if lead:
                checkpointer.step(it, state)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        if writer is not None:
            writer.close()
    return state
