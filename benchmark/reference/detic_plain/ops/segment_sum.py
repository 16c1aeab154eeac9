"""Segment-sum of weight rows into map cells, the plain PyTorch version
of the port's kernel 1.

    segment_sum(w [S, K] f32, idx [S] int32, num_cells) -> [num_cells, K] f32
    out[c] = sum of w[r] over the rows r with idx[r] == c

Rows whose idx lies outside [0, num_cells) are dropped, as the Pallas
kernel's -1 padding and `jax.ops.segment_sum` drop them. The sums are
accumulated in f32.
"""

from __future__ import annotations

import torch


def segment_sum(w: torch.Tensor, idx: torch.Tensor,
                num_cells: int) -> torch.Tensor:
    """Out-of-range rows are routed to one spare row past the end, which
    is cut off."""
    idx = idx.long()
    keep = (idx >= 0) & (idx < num_cells)
    idx = torch.where(keep, idx, torch.full_like(idx, num_cells))
    out = torch.zeros((num_cells + 1, w.shape[1]), dtype=torch.float32,
                      device=w.device)
    out.index_add_(0, idx, w.float())
    return out[:num_cells]
