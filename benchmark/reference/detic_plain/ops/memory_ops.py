"""Spatial-memory read/write ops, the plain PyTorch versions of the
port's kernels 2, 6, 7 and 1.

  * read  -- gather allocentric map cells into the egocentric frame and
             mean-pool 4x4 (`memory_read`; a batch of frames with their
             own memories, `memory_read_batched`), then 2x2 pyramid pools
             for the FPN levels (`pyramid_pool`)
  * write -- splat detection features through instance masks, keep every
             `subsample`-th observed pixel of the row-major compacted
             observed set (`write_select`), segment-sum the per-detection
             mask weights into cells (`ops/segment_sum.py`) and contract
             them with the detection features in f32

Counterpart of the JAX package's `ops/memory_ops.py`, with its host-side
helpers `obs_visibility_host` and the proj-index guard of
`engine/eval.py:chunk_to_frame_inputs`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .segment_sum import segment_sum


def normalize_memory(features: torch.Tensor,
                     obs_count: torch.Tensor) -> torch.Tensor:
    """Divide accumulated cell sums by the observation count where it is
    above 1 (the reference's strict `obs > 1`)."""
    denom = torch.where(obs_count > 1.0, obs_count,
                        torch.ones_like(obs_count))
    return features / denom[:, None]


def memory_read(features: torch.Tensor, obs_count: torch.Tensor,
                proj_indices: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """Project map memory into the egocentric frame, mean-pooled:
    features [cells, D] f32 sums, obs_count [cells] f32, proj_indices
    [H, W] int32 with ids in [0, cells) -> [H/pool, W/pool, D] f32; a bf16
    row gather of the whole frame, then the f32 mean of each pool x pool
    window."""
    h, w = proj_indices.shape
    d = features.shape[-1]
    mem = normalize_memory(features, obs_count).to(torch.bfloat16)
    idx = proj_indices.long().reshape(h // pool, pool, w // pool, pool)
    idx = idx.permute(0, 2, 1, 3).reshape(-1, pool * pool)
    pooled = mem[idx].float().mean(dim=1)              # [HW/p^2, D]
    return pooled.reshape(h // pool, w // pool, d)


def memory_read_batched(features: torch.Tensor, obs_count: torch.Tensor,
                        proj_indices: torch.Tensor,
                        pool: int = 4) -> torch.Tensor:
    """`memory_read` over a batch of frames, each with its own memory:
    features [B, cells, D], obs_count [B, cells], proj_indices [B, H, W]
    -> [B, H/pool, W/pool, D] f32; one row gather from the flattened
    [B * cells, D] table, frame b's ids offset by b * cells."""
    b, cells, d = features.shape
    h, w = proj_indices.shape[1:]
    mem = normalize_memory(features.reshape(-1, d),
                           obs_count.reshape(-1)).to(torch.bfloat16)
    offset = torch.arange(b, dtype=torch.long,
                          device=proj_indices.device) * cells
    idx = proj_indices.long() + offset[:, None, None]
    idx = idx.reshape(b, h // pool, pool, w // pool, pool)
    idx = idx.permute(0, 1, 3, 2, 4).reshape(-1, pool * pool)
    pooled = mem[idx].float().mean(dim=1)
    return pooled.reshape(b, h // pool, w // pool, d)


def pyramid_pool(ego: torch.Tensor, num_levels: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Successive 2x2 mean pools of an [H, W, D] image, one per level."""
    outs = []
    cur = ego
    for _ in range(num_levels):
        h, w, d = cur.shape
        cur = cur.reshape(h // 2, 2, w // 2, 2, d).mean(dim=(1, 3))
        outs.append(cur)
    return tuple(outs)


def write_select(masks_pm: torch.Tensor, det_valid: torch.Tensor,
                 proj_indices: torch.Tensor, subsample: int,
                 observed: Optional[torch.Tensor] = None,
                 row_counts: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact write's pixel selection: masks_pm [H, W, N] bool
    (pixel-major), det_valid [N] bool, proj_indices [H, W] int32 ->
    (seg_idx [H * J] int32, -1 for an empty slot; aug [H * J, N + 1] f32,
    each selected pixel's mask weights 1/c over its c covering valid masks
    and a count of 1 on lane N), J = ceil(W / subsample) slots a row: a
    per-row inclusive cumsum of the observed flags, the row starts as an
    exclusive cumsum of the row counts, every `subsample`-th pixel of the
    row-major compacted observed set found by `searchsorted`, and its
    mask row.
    `observed` [H, W] and `row_counts` [H, K] (each row summing to the
    row's observed pixels) are taken as given when passed, as the port's
    kernel takes the mask paste's."""
    h, w, n = masks_pm.shape
    device = masks_pm.device
    masks_pm = masks_pm & det_valid[None, None, :]              # [H, W, N]
    s = subsample
    j_cap = -(-w // s)                                          # slots per row
    if observed is None:
        observed = masks_pm.any(dim=-1)                         # [H, W]
    incl = torch.cumsum(observed.long(), dim=1)                 # [H, W]
    row_count = incl[:, -1]
    counted = row_count if row_counts is None else row_counts.long().sum(1)
    row_start = torch.cumsum(counted, dim=0) - counted          # exclusive
    t0 = torch.remainder(-row_start, s)         # first selected local rank
    targets = t0[:, None] + s * torch.arange(j_cap, device=device)[None]
    slot_valid = targets < row_count[:, None]                   # [H, J]
    # the (t+1)-th observed pixel of a row is the first column whose
    # inclusive count reaches t+1
    col = torch.searchsorted(incl, targets + 1).clamp(max=w - 1)
    m_sel = torch.gather(masks_pm, 1, col[..., None].expand(h, j_cap, n))
    m_sel = (m_sel & slot_valid[..., None]).reshape(h * j_cap, n).float()
    c_sel = m_sel.sum(dim=1)
    seg_idx = torch.gather(proj_indices.long(), 1, col).reshape(-1)
    slot_valid = slot_valid.reshape(-1)
    pix_w = m_sel / c_sel.clamp(min=1.0)[:, None]
    seg_idx = torch.where(slot_valid, seg_idx, torch.full_like(seg_idx, -1))
    aug = torch.cat([pix_w, slot_valid.float()[:, None]], dim=1)
    return seg_idx.to(torch.int32), aug


class MemoryWriteResult(NamedTuple):
    features_update: torch.Tensor   # [cells, D] additive update
    obs_update: torch.Tensor        # [cells] 1.0 for every visible cell
    any_detection: torch.Tensor     # [] bool; no update when False


def memory_write(det_features: torch.Tensor, det_masks: torch.Tensor,
                 det_valid: torch.Tensor, proj_indices: torch.Tensor,
                 num_cells: int, subsample: int = 8,
                 exact_subsample: bool = True,
                 obs_proj_indices: Optional[torch.Tensor] = None,
                 obs_visibility: Optional[torch.Tensor] = None,
                 pixel_major: bool = False,
                 observed: Optional[torch.Tensor] = None,
                 row_counts: Optional[torch.Tensor] = None
                 ) -> MemoryWriteResult:
    """Scatter detection features into map cells.

    det_features [N, D] (50 * l2-normalised CLIP features), det_masks
    [N, H, W] bool ([H, W, N] with pixel_major), det_valid [N] bool,
    proj_indices [H, W] int cell ids (outlier pixels carry 0).

    A pixel's feature is the mean of its covering masks' features; with
    `exact_subsample` only every `subsample`-th observed pixel of the
    row-major compacted observed set feeds the write, else observed pixels
    on the static stride-`subsample` grid of the flattened frame. A cell's
    value is the mean over its contributing pixels in f32. The
    per-detection weights and the pixel count ride in one [S, N+1]
    segment-sum; the [cells, N] x [N, D] product follows in f32.
    `obs_update` is 1 for every cell id in the frame: the host-computed
    `obs_visibility` when given, else a device scatter over
    `obs_proj_indices` (default `proj_indices`). On the exact path,
    `observed` and `row_counts` from `paste_masks_observed` go to
    `write_select` as they are.
    """
    if pixel_major:
        h, w, n = det_masks.shape
    else:
        n, h, w = det_masks.shape
    device = det_features.device

    if exact_subsample:
        masks_pm = det_masks if pixel_major else det_masks.permute(1, 2, 0)
        flags = {} if observed is None else dict(observed=observed,
                                                 row_counts=row_counts)
        seg_idx, aug = write_select(masks_pm.contiguous(),
                                    det_valid.contiguous(),
                                    proj_indices.to(torch.int32).contiguous(),
                                    subsample, **flags)
    else:
        masks = det_masks.permute(2, 0, 1) if pixel_major else det_masks
        masks_f = (masks & det_valid[:, None, None]).reshape(n, h * w).float()
        c = masks_f.sum(dim=0)                                  # [P]
        stride = torch.arange(h * w, device=device) % subsample == 0
        slot_valid = (c > 0) & stride
        sel_f = slot_valid.float()
        seg_idx = proj_indices.reshape(-1).long()
        pix_w = torch.where(slot_valid[:, None],
                            masks_f.T / c.clamp(min=1.0)[:, None],
                            torch.zeros((), device=device))
        # rows that select no pixel carry zero weight and zero count: route
        # them past the cells so the segment-sum skips them
        seg_idx = torch.where(slot_valid, seg_idx,
                              torch.full_like(seg_idx, -1)).to(torch.int32)
        aug = torch.cat([pix_w, sel_f[:, None]], dim=1)          # [S, N+1]
    acc = segment_sum(aug.contiguous(), seg_idx.contiguous(), num_cells)
    a, cell_count = acc[:, :-1], acc[:, -1]
    cell_sum = a @ det_features.float()                         # [cells, D]
    features_update = torch.where(
        cell_count[:, None] > 0,
        cell_sum / cell_count.clamp(min=1.0)[:, None],
        torch.zeros((), device=device))

    if obs_visibility is not None:
        obs_update = obs_visibility.float()
    else:
        obs_idx = proj_indices if obs_proj_indices is None \
            else obs_proj_indices
        obs_update = torch.zeros((num_cells,), dtype=torch.float32,
                                 device=device)
        obs_update[obs_idx.reshape(-1).long()] = 1.0

    any_detection = det_valid.any()
    zero = torch.zeros((), device=device)
    return MemoryWriteResult(
        features_update=torch.where(any_detection, features_update, zero),
        obs_update=torch.where(any_detection, obs_update, zero),
        any_detection=any_detection)


def obs_visibility_host(proj_indices: np.ndarray,
                        max_cells: int) -> np.ndarray:
    """[..., H, W] int -> [..., max_cells] float32: 1 where any pixel maps
    to the cell, computed on the host."""
    flat = proj_indices.reshape(
        -1, proj_indices.shape[-2] * proj_indices.shape[-1])
    out = np.zeros((flat.shape[0], max_cells), np.float32)
    for i in range(flat.shape[0]):
        counts = np.bincount(flat[i], minlength=max_cells)
        out[i] = counts[:max_cells] > 0
    return out.reshape(proj_indices.shape[:-2] + (max_cells,))


def check_proj_indices(proj_indices: np.ndarray, max_cells: int) -> None:
    """Host guard: every cell id must lie in [0, max_cells). The memory
    read's kernel takes only such ids, and a scene whose map has more
    cells than the memory must fail here rather than corrupt it."""
    lo, hi = int(proj_indices.min()), int(proj_indices.max())
    if hi >= max_cells:
        raise ValueError(
            f"proj index {hi} >= memory.max_cells={max_cells}: the scene's "
            "map has more cells than the configured memory -- raise "
            "memory.max_cells")
    if lo < 0:
        raise ValueError(f"proj index {lo} < 0: cell ids must be >= 0")
