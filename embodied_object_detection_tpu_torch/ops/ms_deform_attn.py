"""Multi-scale deformable attention, the MSDeformAttn core op (kernel 8 of
the port, and its backward, kernel 8b).

Counterpart of the JAX package's `ops/ms_deform_attn.py`: for each query,
head, level and point, a bilinear zero-padded sample (grid_sample,
align_corners=False) of the level's value map at a location normalised to
[0, 1] per level, weighted by the attention weights and summed.

On a CUDA tensor `ms_deform_attn` launches `csrc/ms_deform_attn.cu` (a
warp per query and head, a lane per point and 4 channels, every corner
row of two levels in flight at once); under autograd the call is
`MSDeformAttnFunction`, whose backward launches the second kernel of the
same source (grad_value by float4 atomics, grad_loc and grad_attn by
sums over each point's lanes). On a CPU tensor it takes `ms_deform_attn_plain`, the JAX package's
gather form, differentiated by torch autograd; it is also the kernels'
yardstick in the tests and on the card. Both wrappers are custom ops
(`torch.ops.eodt.ms_deform_attn`, `torch.ops.eodt.ms_deform_attn_backward`)
with fake implementations, as every kernel of the port is.
`ms_deform_attn_tally` runs the source's counting build once to measure
what the kernels gather and how many REDs they issue.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..kernels import build
from .deform_conv import bilinear_sample_zero_pad

MAX_LEVELS = 8
MAX_POINTS = 8


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """value [S, M, D] (S = sum H_l W_l), spatial_shapes ((H_0, W_0), ...),
    sampling_locations [Q, M, L, P, 2] (x, y) in [0, 1] per level,
    attention_weights [Q, M, L, P] -> [Q, M * D]; the samples summed over
    the levels a point, then over the points, as the JAX package does."""
    q, m, _, _, _ = sampling_locations.shape
    d = value.shape[-1]
    outputs = []
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[offset: offset + h * w]                # [HW, M, D]
        offset += h * w
        v = v.transpose(0, 1).reshape(m, h, w, d)        # [M, H, W, D]
        loc = sampling_locations[:, :, lvl]              # [Q, M, P, 2]
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        sampled = bilinear_sample_zero_pad(
            v, y.transpose(0, 1), x.transpose(0, 1))     # [M, Q, P, D]
        outputs.append(sampled.transpose(0, 1) *
                       attention_weights[:, :, lvl][..., None])
    out = sum(outputs).sum(dim=2)                        # [Q, M, D]
    return out.reshape(q, m * d)


def ms_deform_attn_taps(spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every sample's four corners, in the plain version's (and the
    kernels') f32 arithmetic: (rows [Q, M, L, P, 4] into value's S axis,
    clipped into the level, and weights [Q, M, L, P, 4], the hat weights
    with each corner's validity folded in). The backward's grad_value
    receives (g * a) * weight at each row."""
    rows, weights = [], []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, lvl]              # [Q, M, P, 2]
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        lx, ly = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        r, wt = [], []
        for dy, dx, hat in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                            (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yi, xi = y0i + dy, x0i + dx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            r.append(start + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
            wt.append(hat * ok.to(hat.dtype))
        rows.append(torch.stack(r, -1))
        weights.append(torch.stack(wt, -1))
        start += h * w
    return torch.stack(rows, 2), torch.stack(weights, 2)


def ms_deform_attn_grad_value_exact(
        spatial_shapes: Sequence[Tuple[int, int]], value: torch.Tensor,
        sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
        grad_out: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact (f64) sum of grad_value's f32 contributions (g * a) * w
    [S, M, D], the bound that an f32 sum of them in any order keeps,
    contributions x 2^-24 x sum |contribution| [S, M, D], and the count
    of nonzero-weight contributions on each (row, head) [S, M, 1]."""
    s, m, d = value.shape
    q = sampling_locations.shape[0]
    rows, w = ms_deform_attn_taps(spatial_shapes, sampling_locations)
    ga = grad_out.view(q, m, 1, 1, 1, d) * attention_weights[..., None, None]
    c = (ga * w[..., None]).reshape(-1, d).double()
    idx = (rows * m + torch.arange(m, device=rows.device).view(
        1, m, 1, 1, 1)).reshape(-1)
    exact = torch.zeros((s * m, d), dtype=torch.float64,
                        device=value.device).index_add_(0, idx, c)
    abs_sum = torch.zeros_like(exact).index_add_(0, idx, c.abs())
    count = torch.zeros((s * m, 1), dtype=torch.float64,
                        device=value.device).index_add_(
        0, idx, (w != 0).reshape(-1, 1).double())
    return (exact.view(s, m, d), (count * 2.0 ** -24 * abs_sum).view(s, m, d),
            count.view(s, m, 1))


def _flat_shapes(spatial_shapes) -> List[int]:
    return [int(v) for hw in spatial_shapes for v in hw]


def _levels(shapes: List[int]):
    nl = len(shapes) // 2
    return (nl, (ctypes.c_int * nl)(*shapes[0::2]),
            (ctypes.c_int * nl)(*shapes[1::2]))


def _check(name: str, value, shapes, loc, attn):
    s, m, d = value.shape if value.dim() == 3 else (-1, -1, -1)
    nl = len(shapes) // 2
    tokens = sum(shapes[0::2][i] * shapes[1::2][i] for i in range(nl))
    q = loc.shape[0] if loc.dim() == 5 else -1
    p = loc.shape[3] if loc.dim() == 5 else -1
    if value.dim() != 3 or s != tokens or len(shapes) % 2 or \
            not 1 <= nl <= MAX_LEVELS or min(shapes, default=0) < 1:
        raise ValueError(f"{name}: value must be [S, M, D] with S = sum "
                         f"H_l W_l over 1 to {MAX_LEVELS} levels, got "
                         f"{tuple(value.shape)} over {shapes}")
    if loc.dim() != 5 or loc.shape[1:] != (m, nl, p, 2) or \
            not 1 <= p <= MAX_POINTS or attn.shape != (q, m, nl, p):
        raise ValueError(f"{name}: sampling_locations must be [Q, {m}, {nl}, "
                         f"P, 2] with P <= {MAX_POINTS} and "
                         f"attention_weights [Q, {m}, {nl}, P], got "
                         f"{tuple(loc.shape)} and {tuple(attn.shape)}")
    for t in (value, loc, attn):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != value.device:
            raise ValueError(f"{name}: every tensor must be contiguous "
                             f"float32 on {value.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return q, m, d, p


@torch.library.custom_op("eodt::ms_deform_attn", mutates_args=())
def _ms_deform_attn_op(value: torch.Tensor, spatial_shapes: List[int],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    q, m, d, p = _check("ms_deform_attn", value, spatial_shapes,
                        sampling_locations, attention_weights)
    launch = build.load("ms_deform_attn")
    out = torch.empty((q, m * d), dtype=torch.float32, device=value.device)
    if q == 0:
        return out
    nl, heights, widths = _levels(spatial_shapes)
    build.check_launch(
        launch(value.data_ptr(), heights, widths, nl,
               sampling_locations.data_ptr(), attention_weights.data_ptr(),
               out.data_ptr(), q, m, d, p, build.stream_handle()),
        "ms_deform_attn")
    ms_deform_attn_cuda.launches += 1
    return out


@_ms_deform_attn_op.register_fake
def _(value, spatial_shapes, sampling_locations, attention_weights):
    return value.new_empty((sampling_locations.shape[0],
                            value.shape[1] * value.shape[2]))


def ms_deform_attn_cuda(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """The forward kernel on the card (`csrc/ms_deform_attn.cu`): the
    shapes of `ms_deform_attn_plain`, every tensor contiguous f32."""
    return _ms_deform_attn_op(value, _flat_shapes(spatial_shapes),
                              sampling_locations, attention_weights)


ms_deform_attn_cuda.launches = 0


@torch.library.custom_op("eodt::ms_deform_attn_backward", mutates_args=())
def _ms_deform_attn_backward_op(
        value: torch.Tensor, spatial_shapes: List[int],
        sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
        grad_out: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, m, d, p = _check("ms_deform_attn_backward", value, spatial_shapes,
                        sampling_locations, attention_weights)
    if grad_out.shape != (q, m * d) or grad_out.dtype != torch.float32 or \
            not grad_out.is_contiguous() or grad_out.device != value.device:
        raise ValueError(f"ms_deform_attn_backward: grad_out must be "
                         f"contiguous float32 [{q}, {m * d}], got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)}")
    launch = build.load("ms_deform_attn_backward")
    grad_value = torch.zeros_like(value)
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    if q == 0:
        return grad_value, grad_loc, grad_attn
    nl, heights, widths = _levels(spatial_shapes)
    build.check_launch(
        launch(value.data_ptr(), heights, widths, nl,
               sampling_locations.data_ptr(), attention_weights.data_ptr(),
               grad_out.data_ptr(), grad_value.data_ptr(),
               grad_loc.data_ptr(), grad_attn.data_ptr(), q, m, d, p,
               build.stream_handle()), "ms_deform_attn_backward")
    ms_deform_attn_backward_cuda.launches += 1
    return grad_value, grad_loc, grad_attn


@_ms_deform_attn_backward_op.register_fake
def _(value, spatial_shapes, sampling_locations, attention_weights,
      grad_out):
    return (torch.empty_like(value), torch.empty_like(sampling_locations),
            torch.empty_like(attention_weights))


def ms_deform_attn_backward_cuda(
        grad_out: torch.Tensor, value: torch.Tensor,
        spatial_shapes: Sequence[Tuple[int, int]],
        sampling_locations: torch.Tensor, attention_weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on the card: grad_out [Q, M * D] -> (grad_value
    [S, M, D], grad_loc [Q, M, L, P, 2], grad_attn [Q, M, L, P]).
    grad_value sums its contributions with f32 atomics, in no fixed order;
    the other two are each one warp's sums, the same every run."""
    return _ms_deform_attn_backward_op(value, _flat_shapes(spatial_shapes),
                                       sampling_locations, attention_weights,
                                       grad_out)


ms_deform_attn_backward_cuda.launches = 0


def ms_deform_attn_tally(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor,
                         grad_out: torch.Tensor) -> dict:
    """Both kernels once from the counting build of their source (not the
    wrappers: no launch is counted), on the card: {"forward_bytes": the
    bytes of the corner quads the forward copied, "backward_bytes": those
    the backward loaded, "backward_reds": the REDs it issued into
    grad_value (a float4 RED a quad, or one a channel where D % 4 != 0)}.
    The counts are what the kernels issued, tallied by their lanes."""
    shapes = _flat_shapes(spatial_shapes)
    q, m, d, p = _check("ms_deform_attn_tally", value, shapes,
                        sampling_locations, attention_weights)
    lib = build.library("ms_deform_attn", counting=True)
    fwd, bwd = (getattr(lib, build.ENTRY_POINTS[n][0]) for n in (
        "ms_deform_attn", "ms_deform_attn_backward"))
    fwd.argtypes = build.ENTRY_POINTS["ms_deform_attn"][1]
    bwd.argtypes = build.ENTRY_POINTS["ms_deform_attn_backward"][1]
    tally = lib.ms_deform_attn_tally
    tally.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    counts = (ctypes.c_ulonglong * 2)()
    nl, heights, widths = _levels(shapes)
    out = torch.empty((q, m * d), dtype=torch.float32, device=value.device)
    grads = (torch.zeros_like(value), torch.empty_like(sampling_locations),
             torch.empty_like(attention_weights))
    grad_out = grad_out.contiguous()
    if grad_out.shape != (q, m * d) or grad_out.dtype != torch.float32:
        raise ValueError(f"ms_deform_attn_tally: grad_out must be float32 "
                         f"[{q}, {m * d}], got {tuple(grad_out.shape)}")
    result = {}
    build.check_launch(tally(counts), "ms_deform_attn_tally")   # zeroes
    build.check_launch(
        fwd(value.data_ptr(), heights, widths, nl,
            sampling_locations.data_ptr(), attention_weights.data_ptr(),
            out.data_ptr(), q, m, d, p, build.stream_handle()),
        "ms_deform_attn (counting)")
    build.check_launch(tally(counts), "ms_deform_attn_tally")
    result["forward_bytes"] = int(counts[0])
    build.check_launch(
        bwd(value.data_ptr(), heights, widths, nl,
            sampling_locations.data_ptr(), attention_weights.data_ptr(),
            grad_out.data_ptr(), *(g.data_ptr() for g in grads),
            q, m, d, p, build.stream_handle()),
        "ms_deform_attn_backward (counting)")
    build.check_launch(tally(counts), "ms_deform_attn_tally")
    result["backward_bytes"] = int(counts[0])
    result["backward_reds"] = int(counts[1])
    return result


class MSDeformAttnFunction(torch.autograd.Function):
    """`ms_deform_attn_cuda` with `ms_deform_attn_backward_cuda` as its
    gradient; the spatial shapes take none."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                                   attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        gv, gl, ga = ms_deform_attn_backward_cuda(
            grad_out.contiguous(), value, ctx.spatial_shapes, loc, attn)
        return gv, None, gl, ga


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [S, M, D], spatial_shapes ((H_0, W_0), ...), sampling_locations
    [Q, M, L, P, 2], attention_weights [Q, M, L, P] -> [Q, M * D]: the
    kernels on a CUDA tensor, the plain version on a CPU one."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if build.on_card(value):
        value = value.contiguous()
        sampling_locations = sampling_locations.contiguous()
        attention_weights = attention_weights.contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (value, sampling_locations,
                                          attention_weights)):
            return MSDeformAttnFunction.apply(value, shapes,
                                              sampling_locations,
                                              attention_weights)
        return ms_deform_attn_cuda(value, shapes, sampling_locations,
                                   attention_weights)
    return ms_deform_attn_plain(value, shapes, sampling_locations,
                                attention_weights)
