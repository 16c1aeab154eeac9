"""Segment-sum of weight rows into map cells (kernel 1 of the port).

    segment_sum(w [S, K] f32, idx [S] int32, num_cells) -> [num_cells, K] f32
    out[c] = sum of w[r] over the rows r with idx[r] == c

Rows whose idx lies outside [0, num_cells) are dropped, as the Pallas
kernel's -1 padding and `jax.ops.segment_sum` drop them.

Replaces `ops/pallas_scatter.py:scatter_sum_pallas` (the segment-sum that
`ops/memory_ops.py:246` computes with `jax.ops.segment_sum` on the JAX
default path). On a CUDA tensor the wrapper launches the hand-written
kernel `csrc/segment_sum.cu` (bytes-bound; its header says why and what
the design does about it: a warp per group of rows, run sums in
registers, one float4 atomic per run and 4 columns); on a CPU tensor it
takes the plain PyTorch version below. Both accumulate in f32.

On the card the sums land in a zero-filled [num_cells, K'] buffer, K'
the multiple of 4 at or above K, so that every vector atomic is 16-byte
aligned; the result is its [:, :K] view (row stride K'), which
`memory_write`'s `acc[:, :-1] @ features` and `acc[:, -1]` read as they
are.

The wrapper is the custom op `eodt::segment_sum` (`torch.library`), with
a fake implementation that gives its output's shape and strides, so that
`serve/export.py` can export a frame that calls it.
"""

from __future__ import annotations

import torch

from ..kernels import build


def segment_sum_plain(w: torch.Tensor, idx: torch.Tensor,
                      num_cells: int) -> torch.Tensor:
    """The plain PyTorch version: out-of-range rows are routed to one
    spare row past the end, which is cut off."""
    idx = idx.long()
    keep = (idx >= 0) & (idx < num_cells)
    idx = torch.where(keep, idx, torch.full_like(idx, num_cells))
    out = torch.zeros((num_cells + 1, w.shape[1]), dtype=torch.float32,
                      device=w.device)
    out.index_add_(0, idx, w.float())
    return out[:num_cells]


@torch.library.custom_op("eodt::segment_sum", mutates_args=())
def _segment_sum_op(w: torch.Tensor, idx: torch.Tensor,
                    num_cells: int) -> torch.Tensor:
    """The wrapper's body: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if not build.on_card(w):
        return segment_sum_plain(w, idx, num_cells)
    if w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"segment_sum: w must be a contiguous 2-D float32 "
                         f"tensor, got {w.dtype} {tuple(w.shape)}")
    if idx.dtype != torch.int32 or idx.shape != (w.shape[0],) or \
            not idx.is_contiguous():
        raise ValueError(f"segment_sum: idx must be a contiguous int32 [S] "
                         f"tensor, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != w.device:
        raise ValueError("segment_sum: w and idx lie on different devices")
    rows, lanes = w.shape
    launch = build.load("segment_sum")
    padded = -(-lanes // 4) * 4
    out = torch.zeros((num_cells, padded), dtype=torch.float32,
                      device=w.device)
    build.check_launch(
        launch(w.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, lanes,
               padded, num_cells, build.stream_handle()), "segment_sum")
    segment_sum.launches += 1
    return out[:, :lanes]


@_segment_sum_op.register_fake
def _(w, idx, num_cells):
    lanes = w.shape[1]
    if w.device.type == "cuda":
        return w.new_empty((num_cells, -(-lanes // 4) * 4),
                           dtype=torch.float32)[:, :lanes]
    return w.new_empty((num_cells + 1, lanes), dtype=torch.float32)[
        :num_cells]


def segment_sum(w: torch.Tensor, idx: torch.Tensor,
                num_cells: int) -> torch.Tensor:
    """[S, K] f32 rows, [S] int32 cell ids -> [num_cells, K] f32 sums,
    through the custom op `eodt::segment_sum` (so that `torch.export`
    records the call and the exported program launches the kernel)."""
    return _segment_sum_op(w, idx, num_cells)


segment_sum.launches = 0
