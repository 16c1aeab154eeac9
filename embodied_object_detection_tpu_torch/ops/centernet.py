"""The CenterNet head's levels on one canvas, and its decode (kernels 10,
10b and 10c of the port).

    canvas_layout(shapes)            -> where each level sits on the canvas
    pack_levels(levels, layout, dt)  -> [Hc, Wc, C] canvas in `dt`, zero pads
    group_norm_relu(bands, w, b, layout)
                                     -> a tower convolution's output, a band
                                        at a time -> GroupNorm(32) a level,
                                        affine, cast, ReLU; zero pads
    centernet_decode(hms, regs, ...) -> every position's sort key, box,
                                        score and flag, per-level flat order

They replace no TPU kernel (the JAX package runs the tower level by level
and XLA fuses each level's decode): they cut the stage's launches. Run
level by level, the tower, the heads and the decode launch ~540 kernels a
frame on the card, each a few microseconds of work, and the host's
dispatch sets the stage's time. On the canvas each tower layer is one
convolution a band of rows (two at 480 x 640; `canvas_layout` says why)
and one launch of kernel 10b, and the decode one launch of 10c before one
sort. `csrc/centernet.cu`'s header says what bounds them
(bytes, and at these sizes launch latency) and how they are built.

The canvas puts the first level on top, then one zero row, then the other
levels side by side with one zero column between them, so that a 3x3
convolution with padding 1 reads at every level border the zeros it reads
there level by level (at 480 x 640: 91 x 80 positions for 6 400, 13.75 %
padding). Kernel 10b keeps every pad position at exactly zero, so the
next layer's convolution reads zeros there too.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
takes its plain PyTorch version below, which computes each level apart in
the per-level path's own ops, so that on the CPU the canvas gives the
per-level path's numbers wherever the convolution does. Each wrapper is a
custom op (`torch.ops.eodt.*`) with a fake implementation, so that
`torch.export` and `torch.compile(fullgraph=True)` trace a frame that
calls it, and counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels import build

MAX_LEVELS = 8                 # csrc/centernet.cu's kMaxLevels


class Layout(NamedTuple):
    """The levels' places on a canvas of `height` x `width` positions, in
    bands of whole rows that a convolution takes one at a time."""
    height: int
    width: int
    origins: Tuple[Tuple[int, int], ...]   # (y0, x0) a level
    shapes: Tuple[Tuple[int, int], ...]    # (h, w) a level
    bands: Tuple[Tuple[int, int], ...]     # (first row, end row) a band

    def flat(self) -> List[int]:
        """[y0, x0, h, w] of every level, one list (the ops' argument)."""
        return [v for o, s in zip(self.origins, self.shapes) for v in o + s]

    def band_rows(self) -> List[int]:
        """[first row, end row] of every band, one list."""
        return [v for b in self.bands for v in b]

    def levels(self, canvas: torch.Tensor) -> List[torch.Tensor]:
        """Each level's [h, w, ...] view of a [Hc, Wc, ...] canvas."""
        return [canvas[y0:y0 + h, x0:x0 + w]
                for (y0, x0), (h, w) in zip(self.origins, self.shapes)]


@functools.lru_cache(maxsize=None)
def canvas_layout(shapes: Tuple[Tuple[int, int], ...]) -> Layout:
    """The first level at (0, 0), a band of its own; the others side by
    side in a second band below it, after one zero row, each one zero
    column after the one before. One level is its own canvas.

    Each band is convolved on its own (a contiguous run of rows, so no
    copy): the first level's convolution then has the shape, and so
    cuDNN's algorithm and sums, of that level's convolution alone, and
    the second band's levels sum as they do alone too (at 480 x 640 on
    an H100), so the canvas's bf16 tower rounds as the per-level tower
    does. One convolution over the whole canvas ran another algorithm
    for the first level and rounded 0.03 % of its outputs the other way,
    which the four layers spread to every output."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"canvas_layout: 1 to {MAX_LEVELS} levels, got "
                         f"{len(shapes)}")
    (h0, w0), rest = shapes[0], shapes[1:]
    origins, x = [(0, 0)], 0
    for _, w in rest:
        origins.append((h0 + 1, x))
        x += w + 1
    height = h0 + 1 + max(h for h, _ in rest) if rest else h0
    width = max(w0, x - 1)
    bands = ((0, h0), (h0 + 1, height)) if rest else ((0, h0),)
    return Layout(height, width, tuple(origins), tuple(shapes), bands)


def _band_of(y0: int, band_rows: Sequence[int]) -> int:
    return next(b for b in range(len(band_rows) // 2)
                if band_rows[2 * b] <= y0 < band_rows[2 * b + 1])


def _unflat(flat: Sequence[int]) -> List[Tuple[int, int, int, int]]:
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


def _unflat_pairs(flat: Sequence[int]) -> List[Tuple[int, int]]:
    return [tuple(flat[i:i + 2]) for i in range(0, len(flat), 2)]


def _rect_args(flat: Sequence[int]):
    rects = _unflat(flat)
    n = len(rects)
    return [(ctypes.c_int * n)(*[r[k] for r in rects]) for k in range(4)]


def _check_levels(rects, height, width):
    if not 1 <= len(rects) <= MAX_LEVELS:
        raise ValueError(f"centernet ops: 1 to {MAX_LEVELS} levels, got "
                         f"{len(rects)}")
    for y0, x0, h, w in rects:
        if h < 1 or w < 1 or y0 < 0 or x0 < 0 or y0 + h > height or \
                x0 + w > width:
            raise ValueError(f"centernet ops: level {(y0, x0, h, w)} lies "
                             f"outside the {height} x {width} canvas")


# ---------------------------------------------------------------- kernel 10

def pack_levels_plain(levels: Sequence[torch.Tensor], rects: Sequence[int],
                      height: int, width: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """The plain version: a zero canvas, each level cast and copied in."""
    out = levels[0].new_zeros((height, width, levels[0].shape[-1]),
                              dtype=dtype)
    for lvl, (y0, x0, h, w) in zip(levels, _unflat(rects)):
        out[y0:y0 + h, x0:x0 + w] = lvl.to(dtype)
    return out


@torch.library.custom_op("eodt::centernet_pack", mutates_args=())
def _pack_op(levels: List[torch.Tensor], rects: List[int], height: int,
             width: int, bf16: bool) -> torch.Tensor:
    dtype = torch.bfloat16 if bf16 else torch.float32
    if not build.on_card(levels[0]):
        return pack_levels_plain(levels, rects, height, width, dtype)
    _check_levels(_unflat(rects), height, width)
    c = levels[0].shape[-1]
    levels = [lvl.contiguous() for lvl in levels]
    for lvl, (_, _, h, w) in zip(levels, _unflat(rects)):
        if lvl.shape != (h, w, c) or lvl.dtype != levels[0].dtype or \
                lvl.dtype not in (torch.float32, torch.bfloat16) or \
                lvl.device != levels[0].device:
            raise ValueError(f"centernet_pack: levels must be [H, W, {c}] "
                             f"f32 or bf16 on one card, got {lvl.dtype} "
                             f"{tuple(lvl.shape)} for a {h} x {w} level")
        if c % 8 == 0 and lvl.data_ptr() % 16:
            raise ValueError("centernet_pack: every level must start on a "
                             "16-byte boundary (16-byte vector loads)")
    out = torch.empty((height, width, c), dtype=dtype,
                      device=levels[0].device)
    launch = build.load("centernet_pack")
    n = len(levels)
    ptrs = (ctypes.c_void_p * n)(*[lvl.data_ptr() for lvl in levels])
    build.check_launch(
        launch(ptrs, *_rect_args(rects), n, height, width, c,
               int(levels[0].dtype == torch.bfloat16), int(bf16),
               out.data_ptr(), build.stream_handle()), "centernet_pack")
    pack_levels.launches += 1
    return out


@_pack_op.register_fake
def _(levels, rects, height, width, bf16):
    return levels[0].new_empty(
        (height, width, levels[0].shape[-1]),
        dtype=torch.bfloat16 if bf16 else torch.float32)


def pack_levels(levels: Sequence[torch.Tensor], layout: Layout,
                dtype: torch.dtype) -> torch.Tensor:
    """Per-level [H_l, W_l, C] (f32 or bf16) -> the [Hc, Wc, C] canvas in
    `dtype` (f32 or bf16), zeros outside the levels."""
    return _pack_op(list(levels), layout.flat(), layout.height, layout.width,
                    dtype == torch.bfloat16)


pack_levels.launches = 0


# --------------------------------------------------------------- kernel 10b

def _level_views(bands: Sequence[torch.Tensor], rects: Sequence[int],
                 band_rows: Sequence[int]) -> List[torch.Tensor]:
    """Each level's [h, w, C] view of the band that holds it."""
    out = []
    for y0, x0, h, w in _unflat(rects):
        b = _band_of(y0, band_rows)
        r0 = band_rows[2 * b]
        out.append(bands[b][y0 - r0:y0 - r0 + h, x0:x0 + w])
    return out


def group_norm_relu_plain(bands: Sequence[torch.Tensor],
                          weight: torch.Tensor, bias: torch.Tensor,
                          rects: Sequence[int], band_rows: Sequence[int],
                          height: int, num_groups: int, eps: float,
                          out_f32: bool) -> torch.Tensor:
    """The plain version: `models/layers.py:GroupNorm`'s ops on each
    level's positions, the cast to the bands' type and the ReLU, on a
    canvas of zeros."""
    x = bands[0]
    out = torch.zeros((height,) + tuple(x.shape[1:]),
                      dtype=torch.float32 if out_f32 else x.dtype,
                      device=x.device)
    for (y0, x0, h, w), lvl in zip(_unflat(rects),
                                   _level_views(bands, rects, band_rows)):
        lvl = lvl.permute(2, 0, 1)[None]                  # [1, C, h, w]
        xf = lvl.float().reshape(1, num_groups, -1)
        xc = xf - xf.mean(-1, keepdim=True)
        xn = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
        y = torch.addcmul(bias[:, None, None], xn.view(lvl.shape),
                          weight[:, None, None])
        out[y0:y0 + h, x0:x0 + w] = F.relu(y.to(x.dtype))[0].permute(1, 2, 0)
    return out


@torch.library.custom_op("eodt::group_norm_relu", mutates_args=())
def _group_norm_relu_op(bands: List[torch.Tensor], weight: torch.Tensor,
                        bias: torch.Tensor, rects: List[int],
                        band_rows: List[int], height: int, num_groups: int,
                        eps: float, out_f32: bool) -> torch.Tensor:
    if not build.on_card(bands[0]):
        return group_norm_relu_plain(bands, weight, bias, rects, band_rows,
                                     height, num_groups, eps, out_f32)
    _, width, c = bands[0].shape
    _check_levels(_unflat(rects), height, width)
    x = bands[0]
    if x.dtype not in (torch.float32, torch.bfloat16) or c % num_groups or \
            not 1 <= num_groups <= 512:
        raise ValueError(f"group_norm_relu: bands must be f32 or bf16 "
                         f"[rows, W, C] with C a multiple of {num_groups} "
                         f"(at most 512 groups), got {x.dtype} "
                         f"{tuple(x.shape)}")
    bands = [b.contiguous() for b in bands]
    pairs = _unflat_pairs(band_rows)
    if len(bands) != len(pairs) or not 1 <= len(pairs) <= MAX_LEVELS:
        raise ValueError(f"group_norm_relu: {len(bands)} bands for "
                         f"{len(pairs)} band row ranges")
    for b, (r0, r1) in zip(bands, pairs):
        if b.shape != (r1 - r0, width, c) or b.dtype != x.dtype or \
                b.device != x.device or b.data_ptr() % 16:
            raise ValueError(f"group_norm_relu: band rows {r0}-{r1} must be "
                             f"[{r1 - r0}, {width}, {c}] {x.dtype} on "
                             f"{x.device}, 16-byte aligned, got {b.dtype} "
                             f"{tuple(b.shape)}")
    for p in (weight, bias):
        if p.dtype != torch.float32 or p.shape != (c,) or \
                p.device != x.device:
            raise ValueError(f"group_norm_relu: weight and bias must be f32 "
                             f"[{c}] on {x.device}")
    weight, bias = weight.contiguous(), bias.contiguous()
    n = len(rects) // 4
    out = torch.empty((height, width, c),
                      dtype=torch.float32 if out_f32 else x.dtype,
                      device=x.device)
    launch = build.load("group_norm_relu")
    ptrs = (ctypes.c_void_p * n)(*[
        v.data_ptr() for v in _level_views(bands, rects, band_rows)])
    build.check_launch(
        launch(ptrs, *_rect_args(rects), n, height, width, c, num_groups,
               float(eps), weight.data_ptr(), bias.data_ptr(),
               out.data_ptr(), int(x.dtype == torch.bfloat16), int(out_f32),
               build.stream_handle()), "group_norm_relu")
    group_norm_relu.launches += 1
    return out


@_group_norm_relu_op.register_fake
def _(bands, weight, bias, rects, band_rows, height, num_groups, eps,
      out_f32):
    x = bands[0]
    return x.new_empty((height,) + tuple(x.shape[1:]),
                       dtype=torch.float32 if out_f32 else x.dtype)


def group_norm_relu(bands: Sequence[torch.Tensor], weight: torch.Tensor,
                    bias: torch.Tensor, layout: Layout, num_groups: int = 32,
                    eps: float = 1e-5, out_f32: bool = False) -> torch.Tensor:
    """A tower convolution's output, one [rows, Wc, C] tensor (f32 or
    bf16) a band of `layout` -> the [Hc, Wc, C] canvas of GroupNorm
    (`num_groups`) over each level's own positions in
    `models/layers.py:GroupNorm`'s f32 arithmetic (the mean, then the mean
    of the squared deviations; on the card summed in the order PyTorch
    sums that layer's means), `* weight + bias`, rounded to the bands'
    type, ReLU; in that type, or widened to f32 with `out_f32`; zeros at
    every pad position. One launch on the card."""
    return _group_norm_relu_op(list(bands), weight, bias, layout.flat(),
                               layout.band_rows(), layout.height, num_groups,
                               float(eps), out_f32)


group_norm_relu.launches = 0


# --------------------------------------------------------------- kernel 10c

def level_grid(h: int, w: int, stride: int,
               device: "torch.device | str") -> torch.Tensor:
    """[h * w, 2] grid centres of one level: index * stride + stride // 2."""
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + \
        stride // 2
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + \
        stride // 2
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def centernet_decode_plain(hms: Sequence[torch.Tensor],
                           regs: Sequence[torch.Tensor],
                           scales: Optional[torch.Tensor],
                           strides: Sequence[int], score_thresh: float
                           ) -> Tuple[torch.Tensor, ...]:
    """The plain version, a level at a time in the per-level decode's own
    ops (CPU sigmoids run a level's positions as one flat tensor, whose
    vector and scalar parts round differently)."""
    keys, rows = [], []
    for lvl, (hm, reg, stride) in enumerate(zip(hms, regs, strides)):
        h, w = hm.shape
        s = torch.sigmoid(hm.reshape(-1).float())
        r = reg.reshape(-1, 4).float()
        if scales is not None:
            r = F.relu(r * scales[lvl])
        r = r * stride
        g = level_grid(h, w, stride, hm.device)
        x1 = g[:, 0] - r[:, 0]
        y1 = g[:, 1] - r[:, 1]
        x2 = torch.maximum(g[:, 0] + r[:, 2], x1 + 0.01)
        y2 = torch.maximum(g[:, 1] + r[:, 3], y1 + 0.01)
        ok = s > score_thresh
        keys.append((0x7FFFFFFF - s.view(torch.int32).long()) + (lvl << 32))
        rows.append(torch.stack([x1, y1, x2, y2, torch.sqrt(s),
                                 ok.float()], dim=-1))
    return torch.cat(keys), torch.cat(rows)


@torch.library.custom_op("eodt::centernet_decode", mutates_args=())
def _decode_op(hms: List[torch.Tensor], regs: List[torch.Tensor],
               scales: Optional[torch.Tensor], strides: List[int],
               score_thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if not build.on_card(hms[0]):
        return centernet_decode_plain(hms, regs, scales, strides,
                                      score_thresh)
    n = len(hms)
    if not 1 <= n <= MAX_LEVELS or len(regs) != n or len(strides) < n:
        raise ValueError(f"centernet_decode: 1 to {MAX_LEVELS} levels with a "
                         f"regression and a stride each, got {n}, "
                         f"{len(regs)}, {len(strides)}")
    dev = hms[0].device
    for hm, reg in zip(hms, regs):
        if hm.dim() != 2 or reg.shape != hm.shape + (4,) or \
                hm.dtype != torch.float32 or reg.dtype != torch.float32 or \
                hm.device != dev or reg.device != dev:
            raise ValueError(f"centernet_decode: heatmaps must be f32 [H, W] "
                             f"and regressions f32 [H, W, 4] on one card, got "
                             f"{hm.dtype} {tuple(hm.shape)} and {reg.dtype} "
                             f"{tuple(reg.shape)}")
    if scales is not None and (scales.dtype != torch.float32 or
                               scales.shape != (n,) or
                               not scales.is_contiguous() or
                               scales.device != dev):
        raise ValueError(f"centernet_decode: scales must be contiguous f32 "
                         f"[{n}] on {dev}")
    total = sum(hm.numel() for hm in hms)
    key = torch.empty((total,), dtype=torch.int64, device=dev)
    rows = torch.empty((total, 6), dtype=torch.float32, device=dev)
    launch = build.load("centernet_decode")
    ints = ctypes.c_int
    build.check_launch(
        launch((ctypes.c_void_p * n)(*[t.data_ptr() for t in hms]),
               (ctypes.c_void_p * n)(*[t.data_ptr() for t in regs]),
               (ints * n)(*[t.shape[0] for t in hms]),
               (ints * n)(*[t.shape[1] for t in hms]),
               (ints * (2 * n))(*[v for t in hms for v in t.stride()]),
               (ints * (3 * n))(*[v for t in regs for v in t.stride()]),
               (ints * n)(*strides[:n]), n,
               0 if scales is None else scales.data_ptr(),
               float(score_thresh), key.data_ptr(),
               rows.data_ptr(), build.stream_handle()), "centernet_decode")
    centernet_decode.launches += 1
    return key, rows


@_decode_op.register_fake
def _(hms, regs, scales, strides, score_thresh):
    total = sum(hm.shape[0] * hm.shape[1] for hm in hms)
    f = hms[0]
    return (f.new_empty((total,), dtype=torch.int64),
            f.new_empty((total, 6), dtype=torch.float32))


def centernet_decode(hms: Sequence[torch.Tensor],
                     regs: Sequence[torch.Tensor],
                     scales: Optional[torch.Tensor], strides: Sequence[int],
                     score_thresh: float) -> Tuple[torch.Tensor, ...]:
    """Per level heatmap logits [H, W] and regressions [H, W, 4] (f32, any
    strides: a level of a packed head output, or a per-level head's) ->
    (key int64 [N], rows f32 [N, 6]) over every position of every level in
    per-level flat order; a row is the box x1, y1, x2, y2 (grid -/+ reg *
    stride with at least 0.01 extent), the score sqrt(sigmoid) and the
    flag sigmoid > `score_thresh` as 1.0 or 0.0, so one gather moves a
    candidate whole. With `scales` [L], each level's
    regressions are first scaled and rectified (the head's `Scale` and
    ReLU); without, they already are. A stable ascending sort of `key`
    orders each level's positions by descending score, ties in index
    order, the levels one after another."""
    return _decode_op(list(hms), list(regs), scales, list(strides),
                      float(score_thresh))


centernet_decode.launches = 0
