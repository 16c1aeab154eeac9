"""Episode-parallel inference over the data axis of the process mesh.

Counterpart of the JAX package's `parallel/eval_step.py` (the reference's
AsyncPredictor, one process per GPU pulling from task queues,
Detic/detic/predictor.py:441-529): B independent scene streams, each
with its own memory, split over the ranks of the data axis. Each rank
runs its B / data_size lanes through the batched runner
(`models/detector.py:make_batched_episode_runner`) on its own card; the
streams never interact, so the runner makes no collective at all.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DetectorConfig
from ..models.detector import (EmbodiedDetector, EpisodeOutputs,
                               make_batched_episode_runner)
from ..structures import MemoryState
from .mesh import Mesh, shard_batch


def make_sharded_episode_runner(model: EmbodiedDetector, cfg: DetectorConfig,
                                mesh: Mesh, data_axis: str = "data"):
    """run(frames, zs_weight, init_memory) -> this rank's EpisodeOutputs.

    `frames` is a FrameInputs with leading [B, T] axes for all B streams
    (on the host or the device); `init_memory` a MemoryState with all B
    streams or only this rank's B / data_size (as a previous call
    returned them). B must be a multiple of the data axis's size: pad
    with `pad_streams`. The outputs hold this rank's lanes, streams
    `run.lanes(B)`. `run.local(frames, zs_weight, memory)` runs lanes
    already cut to this rank's, on the model's device."""
    episode = make_batched_episode_runner(model, cfg)
    device = next(model.parameters()).device
    d = mesh.shape[data_axis]
    index = mesh.index(data_axis)

    def to_device(x):
        return None if x is None else x.to(device, non_blocking=True)

    def run(frames, zs_weight: torch.Tensor,
            init_memory: MemoryState) -> EpisodeOutputs:
        b = frames.image.shape[0]
        if b % d != 0:
            raise ValueError(
                f"stream count {b} must be a multiple of the '{data_axis}' "
                f"axis size {d}; pad with repeated streams and drop "
                f"host-side")
        local = shard_batch(mesh, frames, data_axis)
        local = type(local)(*(to_device(x) for x in local))
        if init_memory.features.shape[0] == b:
            init_memory = shard_batch(mesh, init_memory, data_axis)
        init_memory = MemoryState(*(to_device(x) for x in init_memory))
        return episode(local, zs_weight.to(device), init_memory)

    def lanes(b: int) -> range:
        k = b // d
        return range(index * k, (index + 1) * k)

    run.local = episode
    run.lanes = lanes
    return run


def _repeat_first(x, pad: int):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)


def pad_streams(frames, init_memory: MemoryState, n_streams: int,
                multiple: int):
    """Pad the stream axis to a multiple of `multiple` by repeating stream
    0 (numpy arrays or tensors); returns (frames, init_memory, real
    count). The padded streams' outputs are dropped by the caller."""
    pad = (-n_streams) % multiple
    if pad == 0:
        return frames, init_memory, n_streams
    frames = type(frames)(*(_repeat_first(x, pad) for x in frames))
    init_memory = type(init_memory)(*(_repeat_first(x, pad)
                                      for x in init_memory))
    return frames, init_memory, n_streams
