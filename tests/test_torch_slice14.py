"""Slice 14 on the CPU: the redesigned DCNv2 backward kernel (9b), emulated
in torch f32 as `csrc/deform_conv.cu:deform_im2col_bwd` writes it.

A warp a (pixel, tap) does the corner set-up once (slice 11's
`_emulate_corners`); its lanes take the channels' float4 quads lane +
64 i and lane + 64 i + 32 (two a step), or single channels lane + 32 i
where Cin % 4 != 0 or a pointer is off a 16-byte boundary. Each channel
adds its products, each rounded to f32, into the lane's partials of the
four corner sums and the mask's sum, and each valid corner takes one RED
a quad (or a channel) of (g * m) * w. The partials are reduced across the
warp once: the corner sums by the transposing butterfly `corner_sums`, the
mask's by `warp_sum`.

The reference is `jax.grad` of the JAX package's `modulated_deform_conv`
with an identity weight (Cout = K * Cin): its output is then the columns
themselves and the columns' cotangent is the random g exactly, so JAX and
the emulation differentiate the same loss through the same columns.

Tolerances: grad_offset and grad_mask within 1e-5 of the largest of JAX's
(f32 sums over Cin in another order: the lanes' partials and the
butterfly's tree against XLA's reduction); grad_x, the emulation's and
JAX's, within contributions x 2^-24 x sum|contribution| of the exact (f64)
sum of its f32 contributions (`deform_conv_grad_x_exact`), the bound of
an f32 sum of them in any order, since the REDs land in any order; the
emulated RED count and the lane map's coverage exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.ops import deform_conv as jdc

from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.ops import deform_conv as tdc

from test_torch_slice11 import _close, _emulate_corners, _j, _t, dcn_inputs

LANES = np.arange(32)


def corner_sums(s):
    """`corner_sums`: s [32 lanes, 4 corners, ...] of partials -> the four
    corner sums lane 0 reads, [4, ...]."""
    hi = torch.from_numpy(LANES & 16 != 0).view(32, *[1] * (s.dim() - 2))
    mid = torch.from_numpy(LANES & 8 != 0).view_as(hi)
    t0 = torch.where(hi, s[:, 2], s[:, 0]) + \
        torch.where(hi, s[:, 0], s[:, 2])[LANES ^ 16]
    t1 = torch.where(hi, s[:, 3], s[:, 1]) + \
        torch.where(hi, s[:, 1], s[:, 3])[LANES ^ 16]
    u = torch.where(mid, t1, t0) + torch.where(mid, t0, t1)[LANES ^ 8]
    for off in (4, 2, 1):
        u = u + u[LANES ^ off]
    return torch.stack([u[8 * q] for q in range(4)])


def warp_sum(v):
    """`warp_sum`: v [32 lanes, ...] -> lane 0's butterfly sum."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[LANES ^ off]
    return v[0]


def emulate_backward_lanes(x, offset, mask, gcols, kh, kw, stride, padding,
                           dilation, quads):
    """`deform_im2col_bwd<quads>` over every (pixel, tap): (grad_x,
    grad_offset, grad_mask or None, REDs issued). grad_x adds the REDs in
    the order the lanes issue them."""
    pix, wgt, ok, ly, lx = (t.reshape(-1, *t.shape[2:]) for t in
                            _emulate_corners(x, offset, kh, kw, stride,
                                             padding, dilation))
    cin = x.shape[-1]
    rows = x.reshape(-1, cin)
    g = gcols.reshape(-1, cin)
    m = mask.reshape(-1) if mask is not None else None
    pairs = g.shape[0]
    sw = torch.zeros(32, 4, pairs)
    sm = torch.zeros(32, pairs)
    seen = np.zeros(cin, np.int64)
    grad_x = torch.zeros_like(rows)
    reds = 0

    def channel(lane, c):
        """`channel_bwd`: the lane's partials, and the corners' terms."""
        seen[c] += 1
        gc = g[:, c]
        v = [rows[pix[:, q], c] for q in range(4)]
        gs = gc * m if m is not None else gc
        if m is not None:
            s = v[0] * wgt[:, 0]
            for q in (1, 2, 3):
                s = s + v[q] * wgt[:, q]
            sm[lane] = sm[lane] + gc * s
        for q in range(4):
            sw[lane, q] = sw[lane, q] + gs * v[q]
        return torch.stack([gs * wgt[:, q] for q in range(4)], -1)

    def red(chans, terms):
        """One RED a valid corner of each (pixel, tap) into grad_x."""
        nonlocal reds
        for q in range(4):
            live = ok[:, q]
            reds += int(live.sum())
            grad_x[:, chans].index_add_(0, pix[live, q], terms[live, q])

    for lane in range(32):
        if quads:
            for c in range(lane, cin // 4, 64):
                for quad in (c, c + 32):
                    if quad < cin // 4:
                        chans = range(4 * quad, 4 * quad + 4)
                        red(slice(4 * quad, 4 * quad + 4),
                            torch.stack([channel(lane, ch) for ch in chans],
                                        -1))
        else:
            for c in range(lane, cin, 32):
                red(slice(c, c + 1), channel(lane, c)[..., None])
    assert (seen == 1).all(), "the lane map must take each channel once"
    s = corner_sums(sw)
    s = [torch.where(ok[:, q], s[q], 0.0) for q in range(4)]
    gy, gx = 1.0 - ly, 1.0 - lx
    d_ly = -s[0] * gx - s[1] * lx + s[2] * gx + s[3] * lx
    d_lx = -s[0] * gy + s[1] * gy - s[2] * ly + s[3] * ly
    grad_offset = torch.stack([d_ly, d_lx], -1).reshape(offset.shape)
    grad_mask = warp_sum(sm).reshape(mask.shape) if m is not None else None
    return grad_x.reshape(x.shape), grad_offset, grad_mask, reds


def jax_grads(x, off, mask, g, stride, pad, dilation):
    """jax.grad of sum(columns * g) through the JAX package's op with an
    identity weight (Cout = K * Cin): (grad_x, grad_offset, grad_mask or
    None) as numpy."""
    cin = x.shape[-1]
    eye = np.eye(9 * cin, dtype=np.float32).reshape(3, 3, cin, 9 * cin)
    live = (x, off) + ((mask,) if mask is not None else ())

    def loss(xx, oo, mm=None):
        out = jdc.modulated_deform_conv(xx, oo, mm, _j(eye), None, stride,
                                        pad, dilation)
        return jnp.sum(out.reshape(g.shape) * g)

    grads = jax.grad(loss, argnums=tuple(range(len(live))))(*map(_j, live))
    grads = [np.array(t) for t in grads]
    return grads[0], grads[1], grads[2] if mask is not None else None


@pytest.mark.parametrize("cin,quads,stride,dilation,modulated", [
    (40, True, 1, 1, True), (40, False, 2, 2, False),
    (30, False, 2, 2, True), (30, False, 1, 2, False),
    (520, True, 1, 1, True), (520, True, 2, 1, False)])
def test_backward_lane_map_vs_jax(cin, quads, stride, dilation, modulated):
    """The emulated kernel against `jax.grad` of the JAX op, on float4
    lanes (Cin 40; Cin 520: 130 quads, more than 64, so lanes loop) and on
    single channels (Cin 40 with a misaligned pointer, Cin 30), stride and
    dilation 1 and 2, modulated and not: grad_offset and grad_mask within
    1e-5 of JAX's largest, grad_x and JAX's within the atomics bound of
    the exact sum, and one RED a valid corner and quad (or channel), the
    count `deform_im2col_backward_design` gives."""
    rng = np.random.RandomState(1400 + cin + 4 * stride + 2 * dilation +
                                modulated)
    x, off, mask, _, _, pad = dcn_inputs(rng, stride, dilation, modulated,
                                         False, h=6, w=7, cin=cin)
    x_t, off_t, mask_t = _t(x), _t(off), _t(mask)
    y0 = tdc._sample_corners(off_t, 3, 3, stride, pad, dilation)[0]
    assert bool((y0 == -1).any()), "no sample on row -1"
    g = rng.randn(off.shape[0] * off.shape[1], 9 * cin).astype(np.float32)
    gx, goff, gm, reds = emulate_backward_lanes(x_t, off_t, mask_t, _t(g),
                                                3, 3, stride, pad, dilation,
                                                quads)
    want_x, want_off, want_m = jax_grads(x, off, mask, g, stride, pad,
                                         dilation)
    _close(goff.numpy(), want_off, 1e-5, atol=0)
    if modulated:
        _close(gm.numpy(), want_m, 1e-5, atol=0)
    exact, bound, count = tdc.deform_conv_grad_x_exact(
        x_t, off_t, mask_t, _t(g), 3, 3, stride, pad, dilation)
    assert int(count.max()) > 1
    for got in (gx.double(), torch.from_numpy(want_x).double()):
        assert bool(((got - exact).abs() <= bound).all())
    design = tdc.deform_im2col_backward_design(x_t, off_t, 3, 3, stride,
                                               pad, dilation, quads)
    assert reds == design["reds"]
    assert design["grad_columns_bytes"] == g.nbytes
    assert design["corner_bytes"] == 4 * g.nbytes


@pytest.mark.parametrize("reduce", ["corner_sums", "warp_sum"])
def test_warp_reductions_take_each_partial_once(reduce):
    """Each lane's partial reaches its own sum exactly once: one-hot
    partials, one (lane, corner) at a time, give 1 in that corner's sum
    and 0 in the others."""
    if reduce == "corner_sums":
        s = torch.zeros(32, 4, 128)
        for lane in range(32):
            for q in range(4):
                s[lane, q, 4 * lane + q] = 1.0
        want = torch.zeros(4, 128)
        for n in range(128):
            want[n % 4, n] = 1.0
        assert torch.equal(corner_sums(s), want)
    else:
        assert torch.equal(warp_sum(torch.eye(32)), torch.ones(32))


def test_design_counts_the_valid_corners():
    """`deform_im2col_backward_design` against a count by hand: one output
    pixel of a 4 x 5 image at padding 1, whose nine taps sample (a - 1,
    b - 1) + offset; valid corners by tap: tap 0 at (-0.5, -0.5) 1, tap 1
    at (-10, 0) 0, taps 2, 3, 6 on a border pixel's centre 2 each, tap 4 at
    (0.5, 0.5) and taps 5, 7, 8 inside 4 each: 23."""
    x = torch.zeros(4, 5, 8)
    off = torch.zeros(1, 1, 18)
    off[0, 0, 0:2] = torch.tensor([0.5, 0.5])
    off[0, 0, 2:4] = torch.tensor([-9.0, 0.0])
    off[0, 0, 8:10] = torch.tensor([0.5, 0.5])
    assert tdc.deform_im2col_backward_design(x, off, 3, 3, 1, 1, 1) == {
        "grad_columns_bytes": 9 * 8 * 4, "corner_bytes": 4 * 9 * 8 * 4,
        "reds": 23 * 2}
    assert tdc.deform_im2col_backward_design(
        x, off, 3, 3, 1, 1, 1, quads=False)["reds"] == 23 * 8


def test_tally_checks_inputs_before_building(monkeypatch):
    """The counting run raises on inputs the kernel does not take before
    it builds anything."""
    def no_library(*args, **kwargs):
        raise AssertionError("reached the build with bad inputs")

    monkeypatch.setattr(build, "library", no_library)
    x = torch.zeros(4, 5, 8)
    off = torch.zeros(4, 5, 18)
    with pytest.raises(ValueError):
        tdc.deform_im2col_backward_tally(x, off, None, torch.zeros(20, 8),
                                         3, 3)
