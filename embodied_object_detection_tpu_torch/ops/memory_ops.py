"""Spatial-memory read/write ops.

  * read  -- gather allocentric map cells into the egocentric frame and
             mean-pool 4x4 (`memory_read`, kernel 2 of the port; a batch of
             frames with their own memories in one launch,
             `memory_read_batched`, kernel 6), then 2x2 pyramid pools for
             the FPN levels (`pyramid_pool`)
  * write -- splat detection features through instance masks, keep every
             `subsample`-th observed pixel of the row-major compacted
             observed set (`write_select`, kernel 7), segment-sum the
             per-detection mask weights into cells (kernel 1,
             `ops/segment_sum.py`) and contract them with the detection
             features in f32
  * snapshot -- the argmax class of each cell (`semmap_classes`), saved
             with the memory by the evaluation's `--save-semmap`

Counterpart of the JAX package's `ops/memory_ops.py`, with its host-side
helpers `obs_visibility_host` and the proj-index guard of
`engine/eval.py:chunk_to_frame_inputs`.

The three kernel wrappers are custom ops (`eodt::memory_read`,
`eodt::memory_read_batched`, `eodt::write_select`; `torch.library`)
whose fake implementations give their output shapes, so that
`serve/export.py` can export a frame that calls them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from .segment_sum import segment_sum


def normalize_memory(features: torch.Tensor,
                     obs_count: torch.Tensor) -> torch.Tensor:
    """Divide accumulated cell sums by the observation count where it is
    above 1 (the reference's strict `obs > 1`)."""
    denom = torch.where(obs_count > 1.0, obs_count,
                        torch.ones_like(obs_count))
    return features / denom[:, None]


def memory_read_plain(features: torch.Tensor, obs_count: torch.Tensor,
                      proj_indices: torch.Tensor,
                      pool: int = 4) -> torch.Tensor:
    """The plain PyTorch version: a bf16 row gather of the whole frame,
    then the f32 mean of each pool x pool window."""
    h, w = proj_indices.shape
    d = features.shape[-1]
    mem = normalize_memory(features, obs_count).to(torch.bfloat16)
    idx = proj_indices.long().reshape(h // pool, pool, w // pool, pool)
    idx = idx.permute(0, 2, 1, 3).reshape(-1, pool * pool)
    pooled = mem[idx].float().mean(dim=1)              # [HW/p^2, D]
    return pooled.reshape(h // pool, w // pool, d)


def memory_read_batched_plain(features: torch.Tensor,
                              obs_count: torch.Tensor,
                              proj_indices: torch.Tensor,
                              pool: int = 4) -> torch.Tensor:
    """The plain version of the batched read: one row gather from the
    flattened [B * cells, D] table, frame b's ids offset by b * cells."""
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


def _read_launch(name, features, obs_count, proj_indices, pool, batch):
    """Check the inputs of the memory-read kernel and launch it over
    `batch` frames: features [B * cells, D], obs_count [B * cells], proj
    [B, H, W] (leading axes as given)."""
    d = features.shape[-1]
    cells = features.shape[-2]
    h, w = proj_indices.shape[-2:]
    if features.dtype != torch.float32 or not features.is_contiguous() or \
            d % 8:
        raise ValueError(f"{name}: features must be contiguous float32 "
                         f"[..., cells, D] with D % 8 == 0, got "
                         f"{features.dtype} {tuple(features.shape)}")
    if obs_count.dtype != torch.float32 or \
            obs_count.shape != features.shape[:-1] or \
            not obs_count.is_contiguous():
        raise ValueError(f"{name}: obs_count must be contiguous float32 "
                         f"{tuple(features.shape[:-1])}, got "
                         f"{obs_count.dtype} {tuple(obs_count.shape)}")
    if proj_indices.dtype != torch.int32 or \
            not proj_indices.is_contiguous() or h % pool or w % pool or \
            pool > 8 or \
            proj_indices.shape[:-2] != features.shape[:-2]:
        raise ValueError(f"{name}: proj_indices must be contiguous int32 "
                         f"{tuple(features.shape[:-2]) + ('H', 'W')} "
                         f"divisible by pool={pool} (pool <= 8), got "
                         f"{proj_indices.dtype} {tuple(proj_indices.shape)}")
    if obs_count.device != features.device or \
            proj_indices.device != features.device:
        raise ValueError(f"{name}: inputs lie on different devices")
    launch = build.load("memory_read")
    if features.data_ptr() % 16:
        raise ValueError(f"{name}: features must start on a 16-byte "
                         f"boundary (the kernel reads float4 vectors)")
    out = torch.empty(proj_indices.shape[:-2] + (h // pool, w // pool, d),
                      dtype=torch.float32, device=features.device)
    # the pre-pass's normalised bf16 table, read back by the gather
    table = torch.empty((batch * cells, d), dtype=torch.bfloat16,
                        device=features.device)
    build.check_launch(
        launch(features.data_ptr(), obs_count.data_ptr(),
               proj_indices.data_ptr(), table.data_ptr(), out.data_ptr(), d,
               h, w, pool, batch, cells, build.stream_handle()), name)
    return out


@torch.library.custom_op("eodt::memory_read", mutates_args=())
def _memory_read_op(features: torch.Tensor, obs_count: torch.Tensor,
                    proj_indices: torch.Tensor, pool: int) -> torch.Tensor:
    if not build.on_card(features):
        return memory_read_plain(features, obs_count, proj_indices, pool)
    if features.dim() != 2 or proj_indices.dim() != 2:
        raise ValueError(f"memory_read: features [cells, D] and proj "
                         f"[H, W], got {tuple(features.shape)} and "
                         f"{tuple(proj_indices.shape)}")
    out = _read_launch("memory_read", features, obs_count, proj_indices,
                       pool, 1)
    memory_read.launches += 1
    return out


@_memory_read_op.register_fake
def _(features, obs_count, proj_indices, pool):
    h, w = proj_indices.shape
    return features.new_empty((h // pool, w // pool, features.shape[-1]),
                              dtype=torch.float32)


def memory_read(features: torch.Tensor, obs_count: torch.Tensor,
                proj_indices: torch.Tensor, pool: int = 4) -> torch.Tensor:
    """Project map memory into the egocentric frame, mean-pooled.

    features [cells, D] f32 sums, obs_count [cells] f32, proj_indices
    [H, W] int32 with ids in [0, cells) -> [H/pool, W/pool, D] f32.
    On the card (`csrc/memory_read.cu`) a pre-pass writes the normalised
    bf16 table once, then a gather takes the mean of 16-byte vectors of
    it; the plain version on a CPU tensor.
    """
    return _memory_read_op(features, obs_count, proj_indices, pool)


memory_read.launches = 0


@torch.library.custom_op("eodt::memory_read_batched", mutates_args=())
def _memory_read_batched_op(features: torch.Tensor, obs_count: torch.Tensor,
                            proj_indices: torch.Tensor,
                            pool: int) -> torch.Tensor:
    if not build.on_card(features):
        return memory_read_batched_plain(features, obs_count, proj_indices,
                                         pool)
    if features.dim() != 3 or proj_indices.dim() != 3:
        raise ValueError(f"memory_read_batched: features [B, cells, D] and "
                         f"proj [B, H, W], got {tuple(features.shape)} and "
                         f"{tuple(proj_indices.shape)}")
    out = _read_launch("memory_read_batched", features, obs_count,
                       proj_indices, pool, features.shape[0])
    memory_read_batched.launches += 1
    return out


@_memory_read_batched_op.register_fake
def _(features, obs_count, proj_indices, pool):
    b, h, w = proj_indices.shape
    return features.new_empty((b, h // pool, w // pool, features.shape[-1]),
                              dtype=torch.float32)


def memory_read_batched(features: torch.Tensor, obs_count: torch.Tensor,
                        proj_indices: torch.Tensor,
                        pool: int = 4) -> torch.Tensor:
    """`memory_read` over a batch of frames, each with its own memory, in
    one launch: features [B, cells, D], obs_count [B, cells], proj_indices
    [B, H, W] -> [B, H/pool, W/pool, D] f32, bit-exact per frame to
    `memory_read` (the training step's read of precomputed memories)."""
    return _memory_read_batched_op(features, obs_count, proj_indices, pool)


memory_read_batched.launches = 0


def memory_read_backward_plain(grad_out: torch.Tensor,
                               features: torch.Tensor,
                               obs_count: torch.Tensor,
                               proj_indices: torch.Tensor,
                               pool: int = 4) -> torch.Tensor:
    """The plain transpose: torch autograd through `memory_read_plain`
    (or `memory_read_batched_plain` for a batch), whose bf16 gather's
    gradient accumulates in bf16 (`index_put_`), as JAX's scatter-add
    does. grad_out [..., H/pool, W/pool, D] -> grad of features."""
    read = memory_read_batched_plain if features.dim() == 3 else \
        memory_read_plain
    with torch.enable_grad():
        leaf = features.detach().requires_grad_()
        out = read(leaf, obs_count, proj_indices, pool)
        return torch.autograd.grad(out, leaf, grad_out)[0]


def read_backward_scratch_bytes(d: int, h: int, w: int, pool: int,
                                batch: int, cells: int) -> int:
    """Bytes of kernel 2b's scratch (`csrc/memory_read.cu:scratch_bytes`):
    the bf16 table of the windows' contributions [windows, D], the keys
    uint32 [windows * pool^2], the row counters int32 [rows + 2], the
    offsets within a scan block int32 [rows + 1] and the 1024-row scan
    blocks' prefixes, each from a 256-byte boundary."""
    def up(n):
        return -(-n // 256) * 256

    windows = batch * (h // pool) * (w // pool)
    entries = windows * pool * pool
    rows = batch * cells
    return (up(windows * d * 2) + up(entries * 4) +
            up((rows + 2) * 4) + up((rows + 1) * 4) +
            up((rows + 1024) // 1024 * 4))


@torch.library.custom_op("eodt::memory_read_backward", mutates_args=())
def _memory_read_backward_op(grad_out: torch.Tensor, obs_count: torch.Tensor,
                             proj_indices: torch.Tensor,
                             pool: int) -> torch.Tensor:
    batch = proj_indices.shape[0] if proj_indices.dim() == 3 else 1
    cells = obs_count.shape[-1]
    h, w = proj_indices.shape[-2:]
    d = grad_out.shape[-1]
    if grad_out.dtype != torch.float32 or not grad_out.is_contiguous() or \
            grad_out.shape != proj_indices.shape[:-2] + (h // pool,
                                                          w // pool, d) or \
            d % 4 or grad_out.data_ptr() % 16:
        raise ValueError(f"memory_read_backward: grad_out must be contiguous "
                         f"float32 [..., H/pool, W/pool, D] with D % 4 == 0 "
                         f"on a 16-byte boundary, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)}")
    if obs_count.dtype != torch.float32 or not obs_count.is_contiguous() or \
            proj_indices.dtype != torch.int32 or \
            not proj_indices.is_contiguous() or h % pool or w % pool or \
            pool > 8 or obs_count.shape[:-1] != proj_indices.shape[:-2] or \
            obs_count.device != grad_out.device or \
            proj_indices.device != grad_out.device:
        raise ValueError(f"memory_read_backward: obs_count [..., cells] f32 "
                         f"and proj [..., H, W] int32 of the read, got "
                         f"{tuple(obs_count.shape)} and "
                         f"{tuple(proj_indices.shape)}")
    launch = build.load("memory_read_backward")
    # every row is written, empty ones as 0: no fill
    grad = torch.empty(obs_count.shape + (d,), dtype=torch.float32,
                       device=grad_out.device)
    scratch = torch.empty(
        read_backward_scratch_bytes(d, h, w, pool, batch, cells),
        dtype=torch.uint8, device=grad_out.device)
    build.check_launch(
        launch(grad_out.data_ptr(), obs_count.data_ptr(),
               proj_indices.data_ptr(), grad.data_ptr(), scratch.data_ptr(),
               scratch.numel(), d, h, w, pool, batch, cells,
               build.stream_handle()), "memory_read_backward")
    memory_read_backward_cuda.launches += 1
    return grad


@_memory_read_backward_op.register_fake
def _(grad_out, obs_count, proj_indices, pool):
    return grad_out.new_empty(obs_count.shape + (grad_out.shape[-1],))


def memory_read_backward_cuda(grad_out: torch.Tensor,
                              obs_count: torch.Tensor,
                              proj_indices: torch.Tensor,
                              pool: int = 4) -> torch.Tensor:
    """The read's transpose on the card (`csrc/memory_read.cu`, kernel
    2b), for `memory_read` (proj [H, W]) and `memory_read_batched` (proj
    [B, H, W]): the gradient in `features`, a gather by row with no
    atomics on the data. Each window's distinct rows become entries,
    bucketed by row with a counting sort; a warp a row adds its entries'
    bf16(g / pool^2) x multiplicity in f32 in window order and rounds to
    bf16 once, so the result is `memory_read_grad_window_order`'s bit for
    bit, from run to run. The bytes of grad_out and the gradient bound
    it."""
    return _memory_read_backward_op(grad_out, obs_count, proj_indices, pool)


memory_read_backward_cuda.launches = 0


def _read_setup(ctx, inputs, output):
    features, obs_count, proj_indices, pool = inputs
    ctx.save_for_backward(features, obs_count, proj_indices)
    ctx.pool = pool


def _read_backward(ctx, grad_out):
    """The gradient in `features` (the kernel on the card, the plain
    autograd on the CPU); `obs_count` and `proj_indices` take none, as in
    JAX."""
    features, obs_count, proj_indices = ctx.saved_tensors
    if build.on_card(grad_out):
        grad = memory_read_backward_cuda(grad_out.contiguous(), obs_count,
                                         proj_indices, ctx.pool)
    else:
        grad = memory_read_backward_plain(grad_out, features, obs_count,
                                          proj_indices, ctx.pool)
    return grad, None, None, None


_memory_read_op.register_autograd(_read_backward, setup_context=_read_setup)
_memory_read_batched_op.register_autograd(_read_backward,
                                          setup_context=_read_setup)


def memory_read_grad_exact(grad_out: torch.Tensor, obs_count: torch.Tensor,
                           proj_indices: torch.Tensor, pool: int = 4
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The read's gradient in `features` from the exact (f64) sum s of its
    n contributions bf16(g / pool^2), divided by the obs denominator:
    (exact [..., cells, D]; the bound that a bf16 sum in any order keeps,
    n x 2^-8 x sum |c| / denominator; the bound of an f32 sum in any order
    rounded once to bf16 and divided in f32, ((2^-8 + 2^-23) |s| +
    (1 + 2^-7) n 2^-24 sum |c|) / denominator; the count n of each row
    [..., cells, 1]). The batched form takes proj [B, H, W] and obs
    [B, cells]."""
    batched = proj_indices.dim() == 3
    proj = proj_indices if batched else proj_indices[None]
    obs = obs_count.reshape(proj.shape[0], -1)
    b, h, w = proj.shape
    cells = obs.shape[1]
    d = grad_out.shape[-1]
    g = grad_out.reshape(b, h // pool, w // pool, d)
    c = (g / float(pool * pool)).to(torch.bfloat16).double()
    c = c[:, :, None, :, None].expand(b, h // pool, pool, w // pool, pool, d)
    idx = proj.long() + (torch.arange(b, device=proj.device) *
                         cells)[:, None, None]
    idx = idx.reshape(-1)
    c = c.reshape(b, h, w, d).reshape(-1, d)
    exact = torch.zeros((b * cells, d), dtype=torch.float64,
                        device=grad_out.device).index_add_(0, idx, c)
    abs_sum = torch.zeros_like(exact).index_add_(0, idx, c.abs())
    count = torch.zeros((b * cells, 1), dtype=torch.float64,
                        device=grad_out.device).index_add_(
        0, idx, torch.ones((idx.numel(), 1), dtype=torch.float64,
                           device=grad_out.device))
    denom = torch.where(obs > 1, obs, torch.ones_like(obs)).reshape(-1, 1)
    denom = denom.double()
    shape = obs_count.shape + (d,)
    f32_sum = count * 2.0 ** -24 * abs_sum
    tight = ((2.0 ** -8 + 2.0 ** -23) * exact.abs() +
             (1 + 2.0 ** -7) * f32_sum) / denom
    return ((exact / denom).reshape(shape),
            (count * 2.0 ** -8 * abs_sum / denom).reshape(shape),
            tight.reshape(shape), count.reshape(obs_count.shape + (1,)))


def read_window_entries(proj_indices: torch.Tensor, cells: int,
                        pool: int = 4
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each pool x pool window's distinct rows, windows in order (frame by
    frame, row-major): (window, row, multiplicity), int64 [E] each, frame
    b's rows offset by b * cells. proj [H, W] or [B, H, W]."""
    proj = proj_indices if proj_indices.dim() == 3 else proj_indices[None]
    b, h, w = proj.shape
    idx = proj.long() + (torch.arange(b, device=proj.device) *
                         cells)[:, None, None]
    idx = idx.reshape(b, h // pool, pool, w // pool, pool).permute(
        0, 1, 3, 2, 4).reshape(-1, pool * pool)
    taps = idx.sort(dim=1).values
    first = torch.ones_like(taps, dtype=torch.bool)
    first[:, 1:] = taps[:, 1:] != taps[:, :-1]
    window = torch.arange(taps.shape[0], device=proj.device)[:, None]
    starts = torch.nonzero(first.reshape(-1)).squeeze(1)
    mult = torch.diff(starts, append=starts.new_tensor([taps.numel()]))
    return window.expand_as(taps)[first], taps[first], mult


def memory_read_grad_window_order(grad_out: torch.Tensor,
                                  obs_count: torch.Tensor,
                                  proj_indices: torch.Tensor,
                                  pool: int = 4) -> torch.Tensor:
    """The read's gradient in `features` with each row's f32 sum taken in
    window order: every window adds bf16(g / pool^2) x its multiplicity of
    the row once, from 0, windows in order; the sum is rounded to bf16
    once and divided by the obs denominator. A checker, as
    `memory_read_grad_exact` is: kernel 2b's arithmetic, bit for bit.
    Step k adds the k-th entry of every row in one `index_add_` (one add
    an element). The batched form takes proj [B, H, W], obs [B, cells]."""
    b = proj_indices.shape[0] if proj_indices.dim() == 3 else 1
    cells = obs_count.shape[-1]
    d = grad_out.shape[-1]
    g = grad_out.reshape(-1, d)
    # a tensor divisor: the card divides by it, not by its reciprocal
    c = (g / torch.full_like(g, float(pool * pool))).to(
        torch.bfloat16).float()
    window, row, mult = read_window_entries(proj_indices, cells, pool)
    acc = torch.zeros((b * cells, d), dtype=torch.float32,
                      device=grad_out.device)
    if row.numel():
        order = torch.sort(row, stable=True).indices
        grouped = row[order]
        pos = torch.arange(row.numel(), device=row.device)
        first = torch.ones_like(grouped, dtype=torch.bool)
        first[1:] = grouped[1:] != grouped[:-1]
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        rank = torch.empty_like(pos)
        rank[order] = pos - start
        for k in range(int(rank.max()) + 1):
            at = torch.nonzero(rank == k).squeeze(1)
            acc.index_add_(0, row[at],
                           c[window[at]] * mult[at, None].float())
    obs = obs_count.reshape(-1, 1)
    denom = torch.where(obs > 1, obs, torch.ones_like(obs))
    return (acc.to(torch.bfloat16).float() / denom).reshape(
        obs_count.shape + (d,))


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


def write_select_plain(masks_pm: torch.Tensor, det_valid: torch.Tensor,
                       proj_indices: torch.Tensor, subsample: int,
                       observed: Optional[torch.Tensor] = None,
                       row_counts: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the exact write's selection: a per-row
    inclusive cumsum of the observed flags, the row starts as an exclusive
    cumsum of the row counts, every `subsample`-th pixel of the row-major
    compacted observed set found by `searchsorted`, and its mask row.
    `observed` [H, W] and `row_counts` [H, K] (each row summing to the
    row's observed pixels) are taken as given when passed, as the kernel
    takes the mask paste's."""
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


@torch.library.custom_op("eodt::write_select", mutates_args=())
def _write_select_op(masks_pm: torch.Tensor, det_valid: torch.Tensor,
                     proj_indices: torch.Tensor, subsample: int,
                     observed: Optional[torch.Tensor],
                     row_counts: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not build.on_card(masks_pm):
        return write_select_plain(masks_pm, det_valid, proj_indices,
                                  subsample, observed, row_counts)
    h, w, n = masks_pm.shape
    if masks_pm.dtype != torch.bool or not masks_pm.is_contiguous():
        raise ValueError(f"write_select: masks must be contiguous bool "
                         f"[H, W, N], got {masks_pm.dtype} "
                         f"{tuple(masks_pm.shape)}")
    if det_valid.dtype != torch.bool or det_valid.shape != (n,) or \
            not det_valid.is_contiguous():
        raise ValueError(f"write_select: det_valid must be contiguous bool "
                         f"[{n}], got {det_valid.dtype} "
                         f"{tuple(det_valid.shape)}")
    if proj_indices.dtype != torch.int32 or proj_indices.shape != (h, w) or \
            not proj_indices.is_contiguous():
        raise ValueError(f"write_select: proj_indices must be contiguous "
                         f"int32 [{h}, {w}], got {proj_indices.dtype} "
                         f"{tuple(proj_indices.shape)}")
    if observed is not None and (
            observed.dtype != torch.bool or observed.shape != (h, w) or
            not observed.is_contiguous() or
            row_counts.dtype != torch.int32 or row_counts.dim() != 2 or
            row_counts.shape[0] != h or row_counts.shape[1] < 1 or
            not row_counts.is_contiguous()):
        raise ValueError(f"write_select: observed must be contiguous bool "
                         f"[{h}, {w}] and row_counts contiguous int32 "
                         f"[{h}, K], got {observed.dtype} "
                         f"{tuple(observed.shape)} and {row_counts.dtype} "
                         f"{tuple(row_counts.shape)}")
    inputs = [det_valid, proj_indices] + \
        ([] if observed is None else [observed, row_counts])
    if any(t.device != masks_pm.device for t in inputs):
        raise ValueError("write_select: inputs lie on different devices")
    if subsample < 1:
        raise ValueError(f"write_select: subsample must be >= 1, got "
                         f"{subsample}")
    launch = build.load("write_select")
    j_cap = -(-w // subsample)
    device = masks_pm.device
    seg_idx = torch.empty((h * j_cap,), dtype=torch.int32, device=device)
    aug = torch.empty((h * j_cap, n + 1), dtype=torch.float32, device=device)
    if h * w == 0:
        return seg_idx, aug
    given = observed is not None
    if not given:       # scratch for the first pass
        observed = torch.empty((h, w), dtype=torch.bool, device=device)
        row_counts = torch.empty((h, 1), dtype=torch.int32, device=device)
    build.check_launch(
        launch(masks_pm.data_ptr(), det_valid.data_ptr(),
               proj_indices.data_ptr(), observed.data_ptr(),
               row_counts.data_ptr(), seg_idx.data_ptr(), aug.data_ptr(), h,
               w, n, subsample, row_counts.shape[1], int(given),
               build.stream_handle()), "write_select")
    write_select.launches += 1
    return seg_idx, aug


@_write_select_op.register_fake
def _(masks_pm, det_valid, proj_indices, subsample, observed, row_counts):
    h, w, n = masks_pm.shape
    j_cap = -(-w // subsample)
    return (masks_pm.new_empty((h * j_cap,), dtype=torch.int32),
            masks_pm.new_empty((h * j_cap, n + 1), dtype=torch.float32))


def write_select(masks_pm: torch.Tensor, det_valid: torch.Tensor,
                 proj_indices: torch.Tensor, subsample: int,
                 observed: Optional[torch.Tensor] = None,
                 row_counts: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact write's pixel selection: masks_pm [H, W, N] bool
    (pixel-major), det_valid [N] bool, proj_indices [H, W] int32 ->
    (seg_idx [H * J] int32, -1 for an empty slot; aug [H * J, N + 1] f32,
    each selected pixel's mask weights 1/c over its c covering valid masks
    and a count of 1 on lane N), J = ceil(W / subsample) slots a row.
    The rows feed the segment-sum as they are. `observed` [H, W] bool and
    `row_counts` [H, K] int32, the flags and counts `paste_masks_observed`
    wrote with the masks, spare the kernel its first pass, which reads
    every mask byte to find them. The row-scan kernel on the card
    (`csrc/write_select.cu`), the plain version on a CPU tensor;
    bit-exact to each other."""
    if (observed is None) != (row_counts is None):
        raise ValueError("write_select: pass observed and row_counts "
                         "together, or neither")
    return _write_select_op(masks_pm, det_valid, proj_indices, subsample,
                            observed, row_counts)


write_select.launches = 0


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


def semmap_classes(features: torch.Tensor, obs_count: torch.Tensor,
                   zs_weight: torch.Tensor, obs_thresh: float,
                   norm_temperature: float = 50.0) -> torch.Tensor:
    """Argmax-class snapshot of the memory, the `semmap` the reference
    saves (ref: visualise_clip_image_features, custom_rcnn.py:938-1017):
    each cell's l2-normalised feature times `norm_temperature` against the
    CLIP class columns of `zs_weight` [D, C+1] in f32 (TF32 off; softmax
    is monotone, so the reference's softmax-then-argmax is the argmax of
    the logits); cells whose mean |feature|, divided by the observation
    count where it is above 1 and min-max normalised over the cells, lies
    below `obs_thresh` get -1. [cells] int32."""
    c = zs_weight.shape[1] - 1
    norm = torch.linalg.vector_norm(features, dim=-1, keepdim=True)
    feats = norm_temperature * features / norm.clamp(min=1e-12)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = torch.matmul(feats, zs_weight.float())[:, :c]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    cls = torch.argmax(logits, dim=-1).to(torch.int32)
    intensity = features.abs().mean(dim=-1)
    intensity = torch.where(obs_count > 1,
                            intensity / obs_count.clamp(min=1.0), intensity)
    lo, hi = intensity.min(), intensity.max()
    intensity = (intensity - lo) / (hi - lo).clamp(min=1e-12)
    return torch.where(intensity < obs_thresh,
                       torch.full_like(cls, -1), cls)


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
