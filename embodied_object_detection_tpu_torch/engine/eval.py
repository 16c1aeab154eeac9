"""Evaluation engine: for now, the external GT-memory table.

Counterpart of the JAX package's `engine/eval.py`, of which this holds
only `external_memory_state`: the fixed table that the GT-memory baselines
(`memory.memory_type` "semantic_gt", "map_gt", "explicit_map") read
instead of a recurrent memory. The serial evaluation protocol comes with
the port's data layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DetectorConfig
from ..models.detector import resolve_device
from ..structures import MemoryState


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
