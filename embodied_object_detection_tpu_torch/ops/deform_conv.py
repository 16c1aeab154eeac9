"""The zero-padded bilinear sampler and the modulated deformable convolution
(DCNv2, kernel 9 of the port, and its backward, kernel 9b).

Counterpart of the JAX package's `ops/deform_conv.py`: the grid_sample-style
sampler `bilinear_sample_zero_pad` (which `ops/ms_deform_attn.py` shares),
`modulated_deform_conv` and `DeformConvBlock`, the DFConv2d analogue (ref:
centernet/modeling/layers/deform_conv.py). Every output pixel samples its
kh x kw taps at `base + dilation * tap + offset`, scales them by the
modulation mask and contracts the tap stack with the weights.

On a CUDA tensor `modulated_deform_conv` launches `csrc/deform_conv.cu`
for the deformable sampling (`eodt::deform_im2col`: the [Ho * Wo, K * Cin]
f32 columns) and contracts the columns with the weights in one f32 matmul;
under autograd the call is `DeformConvFunction`, whose backward takes
grad_weight and the columns' gradient from matmuls and grad_x, grad_offset
and grad_mask from the second kernel (`eodt::deform_im2col_backward`). The
JAX package computes the contraction as an einsum at HIGHEST precision, in
no Pallas kernel; here every matmul of the op runs with TF32 off
(`_matmul_f32` sets `torch.backends.cuda.matmul.allow_tf32` to False around
it, whatever the caller set), so the op is f32 when used alone.
On a CPU tensor it takes `modulated_deform_conv_plain` (the JAX package's
gather form, differentiated by torch autograd), which is also the kernels'
yardstick on the card.
`deform_im2col_backward_tally` runs the backward once from its source's
counting build to measure the bytes it loads and the REDs it issues;
`deform_im2col_backward_design` gives what its design should issue.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import build


def bilinear_sample_zero_pad(img: torch.Tensor, y: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """img [H, W, C]; y, x [...] continuous coords -> [..., C] with zero
    padding outside [0, H-1] x [0, W-1]: the four hat-weight taps, each
    gathered at its index clipped into the image, its validity folded into
    its scalar weight (cheaper than masking the gathered [..., C] rows).
    A batch of images [B, H, W, C] takes y, x [B, ...], the JAX package's
    `vmap` over the leading axis written out, and gives [B, ..., C]."""
    h, w = img.shape[-3:-1]
    if img.dim() == 4:
        batch = torch.arange(img.shape[0], device=img.device).view(
            -1, *([1] * (y.dim() - 1)))
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = y - y0
    lx = x - x0
    y0i = y0.long()
    x0i = x0.long()

    def tap(yi, xi, wgt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        at = (yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        v = img[(batch,) + at] if img.dim() == 4 else img[at]
        return v * (wgt * ok.to(wgt.dtype))[..., None]

    return (tap(y0i, x0i, (1 - ly) * (1 - lx)) +
            tap(y0i, x0i + 1, (1 - ly) * lx) +
            tap(y0i + 1, x0i, ly * (1 - lx)) +
            tap(y0i + 1, x0i + 1, ly * lx))


@contextlib.contextmanager
def _no_tf32():
    allow = torch.backends.cuda.matmul.allow_tf32
    allow_conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow_conv


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 with TF32 off, the JAX package's HIGHEST precision."""
    with _no_tf32():
        return torch.matmul(a, b)


def deform_im2col_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: Optional[torch.Tensor], kernel_h: int,
                        kernel_w: int, stride: int = 1, padding: int = 1,
                        dilation: int = 1) -> torch.Tensor:
    """The deformable columns: x [H, W, Cin], offset [Ho, Wo, 2K] (dy, dx)
    tap-major, mask [Ho, Wo, K] or None -> [Ho * Wo, K * Cin] f32, row
    (i, j), column (tap, channel): x sampled at (i * stride - padding +
    a * dilation + dy, j * stride - padding + b * dilation + dx) for tap
    (a, b), times the tap's mask."""
    ho, wo = offset.shape[:2]
    dev = x.device
    oy = torch.arange(ho, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=torch.float32, device=dev) * stride - padding
    ky = torch.arange(kernel_h, dtype=torch.float32, device=dev) * dilation
    kx = torch.arange(kernel_w, dtype=torch.float32, device=dev) * dilation
    base_y = oy[:, None, None, None] + ky[None, None, :, None]
    base_x = ox[None, :, None, None] + kx[None, None, None, :]
    off = offset.reshape(ho, wo, kernel_h, kernel_w, 2)
    vals = bilinear_sample_zero_pad(x.float(), base_y + off[..., 0],
                                    base_x + off[..., 1])
    if mask is not None:
        vals = vals * mask.reshape(ho, wo, kernel_h, kernel_w)[..., None]
    return vals.reshape(ho * wo, -1)


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                weight: torch.Tensor,
                                bias: Optional[torch.Tensor] = None,
                                stride: int = 1, padding: int = 1,
                                dilation: int = 1) -> torch.Tensor:
    """The plain version: `deform_im2col_plain`, then the columns times
    weight [kh, kw, Cin, Cout] in f32 (+ bias) -> [Ho, Wo, Cout]."""
    kh, kw, cin, cout = weight.shape
    ho, wo = offset.shape[:2]
    cols = deform_im2col_plain(x, offset, mask, kh, kw, stride, padding,
                               dilation)
    out = _matmul_f32(cols, weight.float().reshape(kh * kw * cin, cout))
    if bias is not None:
        out = out + bias
    return out.reshape(ho, wo, cout)


def _check(name, x, offset, mask, kernel_h, kernel_w, stride, dilation):
    if x.dim() != 3 or offset.dim() != 3:
        raise ValueError(f"{name}: x must be [H, W, Cin] and offset "
                         f"[Ho, Wo, 2K], got {tuple(x.shape)} and "
                         f"{tuple(offset.shape)}")
    k = kernel_h * kernel_w
    ho, wo = offset.shape[:2]
    if k < 1 or offset.shape[2] != 2 * k or stride < 1 or dilation < 1:
        raise ValueError(f"{name}: offset must have 2K = {2 * k} channels "
                         f"and stride, dilation >= 1, got "
                         f"{tuple(offset.shape)}, stride {stride}, "
                         f"dilation {dilation}")
    if mask is not None and mask.shape != (ho, wo, k):
        raise ValueError(f"{name}: mask must be [{ho}, {wo}, {k}], got "
                         f"{tuple(mask.shape)}")
    for t in (x, offset) + (() if mask is None else (mask,)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != x.device:
            raise ValueError(f"{name}: every tensor must be contiguous "
                             f"float32 on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return ho, wo, k, x.shape[2]


@torch.library.custom_op("eodt::deform_im2col", mutates_args=())
def _deform_im2col_op(x: torch.Tensor, offset: torch.Tensor,
                      mask: Optional[torch.Tensor], kernel_h: int,
                      kernel_w: int, stride: int, padding: int,
                      dilation: int) -> torch.Tensor:
    ho, wo, k, cin = _check("deform_im2col", x, offset, mask, kernel_h,
                            kernel_w, stride, dilation)
    launch = build.load("deform_im2col")
    cols = torch.empty((ho * wo, k * cin), dtype=torch.float32,
                       device=x.device)
    if cols.numel() == 0:
        return cols
    build.check_launch(
        launch(x.data_ptr(), offset.data_ptr(),
               None if mask is None else mask.data_ptr(), cols.data_ptr(),
               x.shape[0], x.shape[1], cin, ho, wo, kernel_h, kernel_w,
               stride, padding, dilation, build.stream_handle()),
        "deform_im2col")
    deform_im2col_cuda.launches += 1
    return cols


@_deform_im2col_op.register_fake
def _(x, offset, mask, kernel_h, kernel_w, stride, padding, dilation):
    return x.new_empty((offset.shape[0] * offset.shape[1],
                        kernel_h * kernel_w * x.shape[2]))


def deform_im2col_cuda(x: torch.Tensor, offset: torch.Tensor,
                       mask: Optional[torch.Tensor], kernel_h: int,
                       kernel_w: int, stride: int = 1, padding: int = 1,
                       dilation: int = 1) -> torch.Tensor:
    """The forward kernel on the card (`csrc/deform_conv.cu`): the
    columns of `deform_im2col_plain`, every tensor contiguous f32."""
    return _deform_im2col_op(x, offset, mask, kernel_h, kernel_w, stride,
                             padding, dilation)


deform_im2col_cuda.launches = 0


def _check_backward(name, x, offset, mask, grad_columns, kernel_h,
                    kernel_w, stride, dilation):
    ho, wo, k, cin = _check(name, x, offset, mask, kernel_h, kernel_w,
                            stride, dilation)
    if grad_columns.shape != (ho * wo, k * cin) or \
            grad_columns.dtype != torch.float32 or \
            not grad_columns.is_contiguous() or \
            grad_columns.device != x.device:
        raise ValueError(f"{name}: grad_columns must be contiguous float32 "
                         f"[{ho * wo}, {k * cin}], got {grad_columns.dtype} "
                         f"{tuple(grad_columns.shape)}")
    return ho, wo, k, cin


@torch.library.custom_op("eodt::deform_im2col_backward", mutates_args=())
def _deform_im2col_backward_op(
        x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
        grad_columns: torch.Tensor, kernel_h: int, kernel_w: int,
        stride: int, padding: int, dilation: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_backward("deform_im2col_backward", x, offset, mask, grad_columns,
                    kernel_h, kernel_w, stride, dilation)
    launch = build.load("deform_im2col_backward")
    grad_x = torch.zeros_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask) if mask is not None else \
        x.new_empty((0,))
    if grad_columns.numel() == 0:
        return grad_x, grad_offset.zero_(), grad_mask.zero_()
    _launch_backward(launch, "deform_im2col_backward", x, offset, mask,
                     grad_columns, grad_x, grad_offset, grad_mask, kernel_h,
                     kernel_w, stride, padding, dilation)
    deform_im2col_backward_cuda.launches += 1
    return grad_x, grad_offset, grad_mask


def _launch_backward(launch, name, x, offset, mask, grad_columns, grad_x,
                     grad_offset, grad_mask, kernel_h, kernel_w, stride,
                     padding, dilation):
    """One launch of the backward's entry point `launch` (the wrapper's, or
    the counting build's) on the current stream."""
    build.check_launch(
        launch(x.data_ptr(), offset.data_ptr(),
               None if mask is None else mask.data_ptr(),
               grad_columns.data_ptr(), grad_x.data_ptr(),
               grad_offset.data_ptr(),
               None if mask is None else grad_mask.data_ptr(),
               *x.shape, *offset.shape[:2], kernel_h, kernel_w, stride,
               padding, dilation, build.stream_handle()), name)


@_deform_im2col_backward_op.register_fake
def _(x, offset, mask, grad_columns, kernel_h, kernel_w, stride, padding,
      dilation):
    return (torch.empty_like(x), torch.empty_like(offset),
            torch.empty_like(mask) if mask is not None else
            x.new_empty((0,)))


def deform_im2col_backward_cuda(
        grad_columns: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
        mask: Optional[torch.Tensor], kernel_h: int, kernel_w: int,
        stride: int = 1, padding: int = 1, dilation: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel on the card: grad_columns [Ho * Wo, K * Cin] ->
    (grad_x [H, W, Cin], grad_offset [Ho, Wo, 2K], grad_mask [Ho, Wo, K]
    or None). grad_x sums its contributions with f32 atomics (a float4
    RED a valid corner and 4 channels), in no fixed order; grad_offset and
    grad_mask are each one warp's sums over Cin, the same every run."""
    gx, goff, gm = _deform_im2col_backward_op(
        x, offset, mask, grad_columns, kernel_h, kernel_w, stride, padding,
        dilation)
    return gx, goff, (gm if mask is not None else None)


deform_im2col_backward_cuda.launches = 0


def _sample_corners(offset: torch.Tensor, kernel_h: int, kernel_w: int,
                    stride: int, padding: int, dilation: int):
    """Every (pixel, tap)'s top-left corner y0, x0 and fractional parts
    ly, lx [Ho, Wo, K], in the plain version's f32 arithmetic."""
    ho, wo = offset.shape[:2]
    dev = offset.device
    k = kernel_h * kernel_w
    a = torch.arange(k, device=dev) // kernel_w
    b = torch.arange(k, device=dev) % kernel_w
    iy = torch.arange(ho, device=dev)[:, None, None]
    jx = torch.arange(wo, device=dev)[None, :, None]
    off = offset.reshape(ho, wo, k, 2)
    sy = (iy * stride - padding + a * dilation).float() + off[..., 0]
    sx = (jx * stride - padding + b * dilation).float() + off[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    return y0, x0, sy - y0, sx - x0


CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def deform_conv_grad_x_exact(
        x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
        grad_columns: torch.Tensor, kernel_h: int, kernel_w: int,
        stride: int = 1, padding: int = 1, dilation: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact (f64) sum of grad_x's f32 contributions (g * m) * w at
    each valid corner (w the corner's hat weight, m the tap's mask)
    [H, W, Cin], the bound that an f32 sum of them in any order keeps,
    contributions x 2^-24 x sum |contribution|, and the count of
    nonzero-weight contributions at each pixel [H, W, 1]."""
    h, w, cin = x.shape
    ho, wo = offset.shape[:2]
    dev = x.device
    k = kernel_h * kernel_w
    y0, x0, ly, lx = _sample_corners(offset, kernel_h, kernel_w, stride,
                                     padding, dilation)
    g = grad_columns.reshape(ho, wo, k, cin)
    if mask is not None:
        g = g * mask[..., None]
    idx, contrib = [], []
    hats = ((1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx)
    for (dy, dx), hat in zip(CORNERS, hats):
        yi, xi = y0.long() + dy, x0.long() + dx
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        wgt = hat * ok.to(hat.dtype)
        idx.append((yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(-1))
        contrib.append((g * wgt[..., None]).reshape(-1, cin))
    idx = torch.cat(idx)
    c = torch.cat(contrib).double()
    exact = torch.zeros((h * w, cin), dtype=torch.float64,
                        device=dev).index_add_(0, idx, c)
    abs_sum = torch.zeros_like(exact).index_add_(0, idx, c.abs())
    count = torch.zeros((h * w, 1), dtype=torch.float64,
                        device=dev).index_add_(
        0, idx, (c != 0).any(-1, keepdim=True).double())
    return (exact.view(h, w, cin),
            (count * 2.0 ** -24 * abs_sum).view(h, w, cin),
            count.view(h, w, 1))


def deform_im2col_backward_design(x: torch.Tensor, offset: torch.Tensor,
                                  kernel_h: int, kernel_w: int,
                                  stride: int = 1, padding: int = 1,
                                  dilation: int = 1,
                                  quads: bool = True) -> dict:
    """What the backward kernel's design issues on these inputs, in the
    keys of `deform_im2col_backward_tally`: every (pixel, tap) loads its
    Cin x 4 bytes of grad_columns and its four corner rows (clipped into
    the image, valid or not), and issues one RED a valid corner and quad
    of 4 channels (`quads`: Cin % 4 == 0 and x, grad_columns and grad_x on
    16-byte boundaries), else one a valid corner and channel."""
    h, w, cin = x.shape
    y0, x0, _, _ = _sample_corners(offset, kernel_h, kernel_w, stride,
                                   padding, dilation)
    valid = sum(int(((y0 + dy >= 0) & (y0 + dy < h) & (x0 + dx >= 0) &
                     (x0 + dx < w)).sum()) for dy, dx in CORNERS)
    pairs = y0.numel()
    return {"grad_columns_bytes": pairs * cin * 4,
            "corner_bytes": 4 * pairs * cin * 4,
            "reds": valid * (cin // 4 if quads else cin)}


def deform_im2col_backward_tally(
        x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor],
        grad_columns: torch.Tensor, kernel_h: int, kernel_w: int,
        stride: int = 1, padding: int = 1, dilation: int = 1) -> dict:
    """The backward kernel once from the counting build of its source (not
    the wrapper: no launch is counted), on the card: {"grad_columns_bytes",
    "corner_bytes": the bytes of grad_columns and of the corner rows its
    lanes loaded, "reds": the REDs it issued into grad_x}. The counts are
    what the kernel issued, tallied by its lanes."""
    _check_backward("deform_im2col_backward_tally", x, offset, mask,
                    grad_columns, kernel_h, kernel_w, stride, dilation)
    lib = build.library("deform_im2col_backward", counting=True)
    symbol, argtypes = build.ENTRY_POINTS["deform_im2col_backward"]
    launch = getattr(lib, symbol)
    launch.argtypes = argtypes
    tally = lib.deform_conv_tally
    tally.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    counts = (ctypes.c_ulonglong * 3)()
    grad_x = torch.zeros_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask) if mask is not None else None
    build.check_launch(tally(counts), "deform_conv_tally")      # zeroes
    _launch_backward(launch, "deform_im2col_backward (counting)", x, offset,
                     mask, grad_columns, grad_x, grad_offset, grad_mask,
                     kernel_h, kernel_w, stride, padding, dilation)
    build.check_launch(tally(counts), "deform_conv_tally")
    return {"grad_columns_bytes": int(counts[0]),
            "corner_bytes": int(counts[1]), "reds": int(counts[2])}


class DeformConvFunction(torch.autograd.Function):
    """The deformable convolution on the card with its gradient: the
    im2col kernel and an f32 matmul forward; matmuls for grad_weight,
    grad_bias and the columns' gradient, the backward kernel for grad_x,
    grad_offset and grad_mask."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, stride, padding,
                dilation):
        kh, kw, cin, cout = weight.shape
        cols = deform_im2col_cuda(x, offset, mask, kh, kw, stride, padding,
                                  dilation)
        w2 = weight.reshape(kh * kw * cin, cout)
        out = _matmul_f32(cols, w2)
        if bias is not None:
            out = out + bias
        ctx.save_for_backward(x, offset, mask, weight, cols)
        ctx.conf = (stride, padding, dilation, bias is not None)
        return out.reshape(offset.shape[0], offset.shape[1], cout)

    @staticmethod
    def backward(ctx, grad_out):
        x, offset, mask, weight, cols = ctx.saved_tensors
        stride, padding, dilation, has_bias = ctx.conf
        kh, kw, cin, cout = weight.shape
        g = grad_out.reshape(-1, cout).contiguous()
        w2 = weight.reshape(kh * kw * cin, cout)
        grad_weight = _matmul_f32(cols.t(), g).reshape(weight.shape) \
            if ctx.needs_input_grad[3] else None
        grad_bias = g.sum(0) if has_bias and ctx.needs_input_grad[4] \
            else None
        gx = goff = gm = None
        if any(ctx.needs_input_grad[:3]):
            gcols = _matmul_f32(g, w2.t()).contiguous()
            gx, goff, gm = deform_im2col_backward_cuda(
                gcols, x, offset, mask, kh, kw, stride, padding, dilation)
        return gx, goff, gm, grad_weight, grad_bias, None, None, None


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1,
                          dilation: int = 1) -> torch.Tensor:
    """DCNv2: x [H, W, Cin] f32, offset [Ho, Wo, 2K] (dy, dx) tap-major,
    mask [Ho, Wo, K] (post-sigmoid) or None (DCNv1), weight [kh, kw, Cin,
    Cout], bias [Cout] or None -> [Ho, Wo, Cout] f32: the kernels on a
    CUDA tensor, the plain version on a CPU one."""
    if not build.on_card(x):
        return modulated_deform_conv_plain(x, offset, mask, weight, bias,
                                           stride, padding, dilation)
    x = x.float().contiguous()
    offset = offset.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    weight = weight.float().contiguous()
    return DeformConvFunction.apply(x, offset, mask, weight, bias, stride,
                                    padding, dilation)


class _OffsetConv(torch.autograd.Function):
    """conv2d on the card with TF32 off in its forward and its backward
    (cuDNN reads the flag when each runs)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation)
        with _no_tf32():
            return F.conv2d(x, weight, bias, stride, padding, dilation)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        with _no_tf32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]], [stride] * 2,
                [padding] * 2, [dilation] * 2, False, [0, 0], 1,
                list(ctx.needs_input_grad[:3]))
        return gx, gw, gb, None, None, None


class DeformConvBlock(nn.Module):
    """The DFConv2d analogue: an offset conv (zero at init) giving 2K
    offsets and, modulated, K mask logits (through a sigmoid), then
    `modulated_deform_conv` with a He-normal `weight` [k, k, Cin, Cout].
    x [H, W, Cin] -> [H', W', Cout] f32. The parameter names are the JAX
    block's (`offset.weight` / `offset.bias` from its `offset` Conv,
    `weight` and `bias` as they are), so `load_jax_params` carries its
    tree across."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 with_modulated_dcn: bool = True, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.dilation = dilation
        self.with_modulated_dcn = with_modulated_dcn
        self.use_bias = use_bias
        k = kernel_size * kernel_size
        self.padding = dilation * (kernel_size - 1) // 2
        self.offset = nn.Conv2d(in_channels, 3 * k if with_modulated_dcn
                                else 2 * k, kernel_size, stride,
                                self.padding, dilation)
        nn.init.zeros_(self.offset.weight)
        nn.init.zeros_(self.offset.bias)
        # the JAX block's he_normal: a normal truncated at 2 std, of
        # variance 2 / fan_in once truncated
        std = math.sqrt(2.0 / (k * in_channels)) / .87962566103423978
        self.weight = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(kernel_size, kernel_size, in_channels, out_channels),
            std=std, a=-2 * std, b=2 * std, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.float().permute(2, 0, 1)[None]
        conv = self.offset
        if build.on_card(x):
            raw = _OffsetConv.apply(xc, conv.weight, conv.bias, self.stride,
                                    self.padding, self.dilation)
        else:
            raw = conv(xc)
        raw = raw[0].permute(1, 2, 0)
        k2 = 2 * self.kernel_size * self.kernel_size
        if self.with_modulated_dcn:
            offset, mask = raw[..., :k2], torch.sigmoid(raw[..., k2:])
        else:
            offset, mask = raw, None
        return modulated_deform_conv(x, offset, mask, self.weight, self.bias,
                                     self.stride, self.padding,
                                     self.dilation)
