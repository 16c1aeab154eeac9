"""Slice 11 of the torch port against the JAX package, on the CPU: the
modulated deformable convolution (kernels 9, 9b) with `DeformConvBlock`,
the memory read's transpose (kernel 2b), and the two faults repaired
first: the Deformable-DETR's `points` field (F1) and the two-pass
GroupNorm (F2).

Inputs are made from a seed with numpy. The CUDA kernels cannot run here;
their arithmetic is emulated in torch (`_emulate_*`, op for op as
`csrc/deform_conv.cu` and `csrc/memory_read.cu` write it) and held to the
plain versions, and the plain versions to the JAX package.

Tolerances: max |port - jax| <= rtol * max |jax| + atol, stated per test
(f32 on both sides, sums in other orders); the read's gradient within the
bound of its arithmetic of the exact (f64) sum: bf16 accumulation for the
plain autograd and JAX, an f32 sum rounded once to bf16 for the kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.models import deformable_detr as jd
from embodied_object_detection_tpu.models.layers import GroupNorm as JaxGN
from embodied_object_detection_tpu.ops import deform_conv as jdc
from embodied_object_detection_tpu.ops.memory_ops import (
    memory_read as jax_read, memory_read_batched as jax_read_batched)

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.models import deformable_detr as td
from embodied_object_detection_tpu_torch.models.layers import GroupNorm
from embodied_object_detection_tpu_torch.ops import deform_conv as tdc
from embodied_object_detection_tpu_torch.ops import memory_ops as tmo


def _close(got, want, rtol, atol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * np.abs(want).max() + atol, \
        f"max err {err:.3e} against max |want| {np.abs(want).max():.3e}"


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ------------------------------------------------------------------ F1, F2

def test_detr_points_field_reaches_no_layer():
    """F1: a `points=2` JAX miniature loads into a `points=2` port model
    (its layers sample 4 points, as JAX's do) and matches it: every
    output within rtol 1e-5 of its largest."""
    kw = dict(num_classes=5, hidden_dim=32, heads=4, enc_layers=1,
              dec_layers=1, ffn=64, num_queries=6, levels=2)
    rng = np.random.RandomState(3)
    feats = [rng.randn(8, 10, 32).astype(np.float32),
             rng.randn(4, 5, 32).astype(np.float32)]
    jm = jd.DeformableDETR(points=2, **kw)
    # the tree's shapes without running flax's init op by op (~20 s here);
    # every parameter from a seeded normal(0, 0.2)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats], None)
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 0.2).astype(np.float32), shapes)
    port = td.DeformableDETR(in_channels=(32, 32), points=2, **kw)
    assert port.points == 2
    assert port.encoder0.self_attn.points == 4
    port.load_state_dict(load_jax_params(params), strict=True)
    # one compile of the whole apply (op by op it is ~12 s here)
    want = jax.jit(jm.apply)(params, [jnp.asarray(f) for f in feats], None)
    with torch.no_grad():
        got = port([_t(f) for f in feats], None)
    for g, w in zip(got[:2], want[:2]):
        _close(g.numpy(), np.asarray(w), 1e-5)


@pytest.mark.parametrize("case", ["random", "far_mean", "one_value",
                                  "batched"])
def test_group_norm_is_the_jax_two_pass_form(case):
    """F2: the shared GroupNorm against the JAX GroupNorm, including
    groups whose mean lies 30 spreads above zero (where `F.group_norm`'s
    CPU variance loses digits: 10x further from JAX than the two-pass
    form) and groups of one value. rtol 1e-6 (far_mean 1e-5: the group
    mean itself rounds at ulp(30), 1.9e-6 of the spread, in another
    summation order)."""
    rng = np.random.RandomState(5)
    c, h, w = 64, 3, 5
    if case == "one_value":
        h = w = 1
    x = rng.randn(2 if case == "batched" else 1, h, w, c).astype(np.float32)
    if case == "far_mean":
        x = x + np.float32(30.0)
    if case == "one_value":
        c, x = 32, x[..., :32]
    gn = GroupNorm(32, c)
    with torch.no_grad():
        gn.weight.copy_(_t(rng.randn(c).astype(np.float32)))
        gn.bias.copy_(_t(rng.randn(c).astype(np.float32)))
        got = gn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    jm = JaxGN(num_groups=32)
    params = {"params": {"scale": jnp.asarray(gn.weight.detach().numpy()),
                         "bias": jnp.asarray(gn.bias.detach().numpy())}}
    want = np.stack([np.asarray(jm.apply(params, jnp.asarray(xi)))
                     for xi in x])
    _close(got, want, 1e-5 if case == "far_mean" else 1e-6)
    if case == "far_mean":
        with torch.no_grad():
            lib = torch.nn.functional.group_norm(
                _t(x).permute(0, 3, 1, 2), 32, gn.weight,
                gn.bias).permute(0, 2, 3, 1).numpy()
        assert np.abs(lib - want).max() > 10 * np.abs(got - want).max()


# --------------------------------------------------- kernels 9 and 9b: DCNv2

def dcn_inputs(rng, stride, dilation, modulated, bias, h=7, w=9, cin=5,
               cout=6, k=3):
    """x, offset (normal(0, 2), so samples cross every border), mask,
    weight, bias and the geometry of one case."""
    pad = dilation * (k - 1) // 2
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    x = rng.randn(h, w, cin).astype(np.float32)
    off = (rng.randn(ho, wo, 2 * k * k) * 2).astype(np.float32)
    # some samples exactly on pixel centres and on the -1 row / column
    off[0, 0, :4] = [0.0, 0.0, -1.0, -0.5]
    off[-1, -1, -2:] = [float(h), float(w)]
    mask = rng.rand(ho, wo, k * k).astype(np.float32) if modulated else None
    weight = rng.randn(k, k, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    return x, off, mask, weight, b, pad


DCN_CASES = [(s, d, m, b) for s in (1, 2) for d in (1, 2)
             for m in (True, False) for b in (True, False)]


@pytest.mark.parametrize("stride,dilation,modulated,bias", DCN_CASES)
def test_modulated_deform_conv_forward_and_grads_vs_jax(stride, dilation,
                                                        modulated, bias):
    """The forward within rtol 1e-6 of JAX's largest output, and
    `jax.grad` of sum(out * g) for x, offset, mask, weight and bias within
    rtol 1e-5 of each gradient's largest (+ 1e-6: f32 sums in other
    orders)."""
    rng = np.random.RandomState(100 + 8 * stride + 4 * dilation +
                                2 * modulated + bias)
    x, off, mask, weight, b, pad = dcn_inputs(rng, stride, dilation,
                                              modulated, bias)
    args = [x, off, mask, weight, b]
    live = [i for i, a in enumerate(args) if a is not None]

    def jf(*a):
        full = [None] * 5
        for i, v in zip(live, a):
            full[i] = v
        return jdc.modulated_deform_conv(*full, stride, pad, dilation)

    want = np.asarray(jf(*[_j(args[i]) for i in live]))
    g = rng.randn(*want.shape).astype(np.float32)
    leaves = [_t(a).requires_grad_() if a is not None else None
              for a in args]
    got = tdc.modulated_deform_conv(*leaves, stride, pad, dilation)
    _close(got.detach().numpy(), want, 1e-6)
    jg = jax.grad(lambda *a: jnp.sum(jf(*a) * g),
                  argnums=tuple(range(len(live))))(
                      *[_j(args[i]) for i in live])
    tg = torch.autograd.grad(got, [leaves[i] for i in live], _t(g))
    for want_g, got_g in zip(jg, tg):
        _close(got_g.numpy(), np.asarray(want_g), 1e-5)


def _emulate_corners(x, offset, kh, kw, stride, padding, dilation):
    """`csrc/deform_conv.cu:corners` over every (pixel, tap): (flat pixels
    clipped into the image [P, K, 4], weights with validity [P, K, 4],
    validity, ly, lx [P, K])."""
    h, w, _ = x.shape
    ho, wo = offset.shape[:2]
    k = kh * kw
    i = torch.arange(ho)[:, None, None]
    j = torch.arange(wo)[None, :, None]
    a, b = torch.arange(k) // kw, torch.arange(k) % kw
    off = offset.reshape(ho, wo, k, 2)
    sy = (i * stride - padding + a * dilation).float() + off[..., 0]
    sx = (j * stride - padding + b * dilation).float() + off[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ly, lx = sy - y0, sx - x0
    gy, gx = 1.0 - ly, 1.0 - lx
    hats = [gy * gx, gy * lx, ly * gx, ly * lx]
    pix, wgt, ok = [], [], []
    for q in range(4):
        yy, xx = y0 + (q >> 1), x0 + (q & 1)
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        pix.append(yc * w + xc)
        wgt.append(torch.where(valid, hats[q], 0.0))
        ok.append(valid)
    flat = lambda t: torch.stack(t, -1).reshape(ho * wo, k, 4)  # noqa: E731
    return (flat(pix), flat(wgt), flat(ok), ly.reshape(-1, k),
            lx.reshape(-1, k))


def _emulate_im2col(x, offset, mask, kh, kw, stride, padding, dilation):
    """The forward kernel's arithmetic: the corner taps v * w summed in
    order, times the mask."""
    pix, wgt, _, _, _ = _emulate_corners(x, offset, kh, kw, stride, padding,
                                         dilation)
    rows = x.reshape(-1, x.shape[-1])
    s = None
    for q in range(4):
        tap = rows[pix[..., q]] * wgt[..., q, None]
        s = tap if s is None else s + tap
    if mask is not None:
        s = s * mask.reshape(-1, kh * kw)[..., None]
    return s.reshape(s.shape[0], -1)


def _emulate_im2col_backward(x, offset, mask, gcols, kh, kw, stride,
                             padding, dilation):
    """The backward kernel's sums: per (pixel, tap) the four corner sums
    over Cin of (g * m) * v, valid corners only, combined by the hats'
    derivatives; the mask's sum of g * sample; grad_x by index_add."""
    pix, wgt, ok, ly, lx = _emulate_corners(x, offset, kh, kw, stride,
                                            padding, dilation)
    rows = x.reshape(-1, x.shape[-1])
    k = kh * kw
    g = gcols.reshape(-1, k, x.shape[-1])
    m = mask.reshape(-1, k) if mask is not None else None
    gs = g * m[..., None] if m is not None else g
    v = [rows[pix[..., q]] for q in range(4)]
    sw = [torch.where(ok[..., q], (gs * v[q]).sum(-1), 0.0)
          for q in range(4)]
    gy, gx = 1 - ly, 1 - lx
    d_ly = -sw[0] * gx - sw[1] * lx + sw[2] * gx + sw[3] * lx
    d_lx = -sw[0] * gy + sw[1] * gy - sw[2] * ly + sw[3] * ly
    grad_offset = torch.stack([d_ly, d_lx], -1).reshape(offset.shape)
    grad_mask = None
    if m is not None:
        s = sum(v[q] * wgt[..., q, None] for q in range(4))
        grad_mask = (g * s).sum(-1).reshape(mask.shape)
    grad_x = torch.zeros_like(rows)
    for q in range(4):
        c = gs * wgt[..., q, None]
        grad_x.index_add_(0, pix[..., q].reshape(-1),
                          c.reshape(-1, c.shape[-1]))
    return grad_x.reshape(x.shape), grad_offset, grad_mask


@pytest.mark.parametrize("stride,dilation,modulated", [
    (1, 1, True), (2, 2, True), (1, 2, False)])
def test_im2col_kernel_arithmetic(stride, dilation, modulated):
    """The forward kernel's arithmetic equals the plain columns bit for
    bit; the backward kernel's sums equal the plain autograd's gradients
    within rtol 1e-5 of each one's largest (other summation orders), and
    grad_x within the atomics bound of the exact sum (which the plain
    autograd also keeps)."""
    rng = np.random.RandomState(7 + stride + dilation)
    x, off, mask, weight, _, pad = dcn_inputs(rng, stride, dilation,
                                              modulated, False, h=9, w=8,
                                              cin=40)
    x_t, off_t, mask_t = _t(x), _t(off), _t(mask)
    cols = tdc.deform_im2col_plain(x_t, off_t, mask_t, 3, 3, stride, pad,
                                   dilation)
    emu = _emulate_im2col(x_t, off_t, mask_t, 3, 3, stride, pad, dilation)
    assert torch.equal(cols, emu)

    gcols = _t(rng.randn(*cols.shape).astype(np.float32))
    leaves = [x_t.clone().requires_grad_(), off_t.clone().requires_grad_()]
    if modulated:
        leaves.append(mask_t.clone().requires_grad_())
    plain = torch.autograd.grad(
        tdc.deform_im2col_plain(leaves[0], leaves[1],
                                leaves[2] if modulated else None, 3, 3,
                                stride, pad, dilation), leaves, gcols)
    gx, goff, gm = _emulate_im2col_backward(x_t, off_t, mask_t, gcols, 3, 3,
                                            stride, pad, dilation)
    _close(goff.numpy(), plain[1].numpy(), 1e-5)
    if modulated:
        _close(gm.numpy(), plain[2].numpy(), 1e-5)
    exact, bound, count = tdc.deform_conv_grad_x_exact(
        x_t, off_t, mask_t, gcols, 3, 3, stride, pad, dilation)
    assert int(count.max()) > 1
    for got in (gx, plain[0]):
        assert ((got.double() - exact).abs() <= bound).all()


def test_grad_x_exact_is_jax_grad():
    """`deform_conv_grad_x_exact` is JAX's grad_x through the columns:
    rtol 1e-5 of its largest."""
    rng = np.random.RandomState(11)
    x, off, mask, _, _, pad = dcn_inputs(rng, 1, 1, True, False, cin=24)
    g = rng.randn(off.shape[0] * off.shape[1], 9 * 24).astype(np.float32)

    def cols(xx):
        ho, wo = off.shape[:2]
        oy = jnp.arange(ho, dtype=jnp.float32) - pad
        ox = jnp.arange(wo, dtype=jnp.float32) - pad
        ky = jnp.arange(3, dtype=jnp.float32)
        sy = oy[:, None, None, None] + ky[None, None, :, None] + \
            off.reshape(ho, wo, 3, 3, 2)[..., 0]
        sx = ox[None, :, None, None] + ky[None, None, None, :] + \
            off.reshape(ho, wo, 3, 3, 2)[..., 1]
        v = jdc.bilinear_sample_zero_pad(xx, sy, sx) * \
            mask.reshape(ho, wo, 3, 3)[..., None]
        return v.reshape(ho * wo, -1)

    want = jax.grad(lambda xx: jnp.sum(cols(xx) * g))(jnp.asarray(x))
    exact, _, _ = tdc.deform_conv_grad_x_exact(_t(x), _t(off), _t(mask),
                                               _t(g), 3, 3, 1, pad, 1)
    _close(exact.numpy(), np.asarray(want), 1e-5)


def _block_case(modulated, use_bias, stride, dilation, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(9, 11, 8).astype(np.float32)
    jb = jdc.DeformConvBlock(out_channels=6, stride=stride,
                             dilation=dilation,
                             with_modulated_dcn=modulated, use_bias=use_bias)
    tree = jax.tree_util.tree_map(np.array, jb.init(jax.random.PRNGKey(seed),
                                                    jnp.asarray(x)))
    p = tree["params"]
    # a zero-initialised offset conv would only test a plain conv
    p["offset"]["kernel"] = (rng.randn(*p["offset"]["kernel"].shape) *
                             0.3).astype(np.float32)
    p["offset"]["bias"] = (rng.randn(*p["offset"]["bias"].shape)
                           ).astype(np.float32)
    if use_bias:
        p["bias"] = rng.randn(6).astype(np.float32)
    port = tdc.DeformConvBlock(8, 6, stride=stride, dilation=dilation,
                               with_modulated_dcn=modulated,
                               use_bias=use_bias)
    port.load_state_dict(load_jax_params(tree), strict=True)
    return rng, x, jb, tree, port


@pytest.mark.parametrize("modulated,use_bias,stride,dilation", [
    (True, False, 1, 1), (False, True, 2, 1), (True, True, 1, 2)])
def test_deform_conv_block_through_load_jax_params(modulated, use_bias,
                                                   stride, dilation):
    """`DeformConvBlock` loaded with `load_jax_params` from the JAX block's
    tree (seeded offset conv): the output within rtol 1e-5, and the
    gradients of sum(out * g) in x and every parameter within rtol 1e-4 of
    each one's largest (+ 1e-6), as `jax.grad` gives them."""
    rng, x, jb, tree, port = _block_case(modulated, use_bias, stride,
                                         dilation, 20 + stride + dilation)
    want = np.asarray(jb.apply(tree, jnp.asarray(x)))
    x_t = _t(x).requires_grad_()
    got = port(x_t)
    _close(got.detach().numpy(), want, 1e-5)
    g = rng.randn(*want.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(jb.apply(p, xx) * g),
                        argnums=(0, 1))(tree, jnp.asarray(x))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(got, [x_t] + list(port.parameters()), _t(g))
    _close(grads[0].numpy(), np.asarray(jgx), 1e-4)
    want_sd = load_jax_params(jax.tree_util.tree_map(np.asarray, jgp))
    for n, gr in zip(names, grads[1:]):
        _close(gr.numpy(), want_sd[n].numpy(), 1e-4)


def test_deform_conv_block_init():
    """At init the offset conv is zero (the block is a plain conv: the
    JAX block's output on the same weight, rtol 1e-5) and `weight` is
    He-normal from the given generator: the same generator seed gives the
    same weight, its std within 5 % of sqrt(2 / fan_in), no value beyond
    2 std of the untruncated normal."""
    gen = torch.Generator().manual_seed(4)
    block = tdc.DeformConvBlock(64, 32, generator=gen)
    again = tdc.DeformConvBlock(64, 32,
                                generator=torch.Generator().manual_seed(4))
    assert torch.equal(block.weight, again.weight)
    assert not block.offset.weight.any() and not block.offset.bias.any()
    std = (2.0 / (9 * 64)) ** 0.5
    assert abs(float(block.weight.detach().std()) / std - 1) < 0.05
    assert float(block.weight.abs().max()) <= 2 * std / .87962566103423978
    x = np.random.RandomState(1).randn(6, 7, 64).astype(np.float32)
    jb = jdc.DeformConvBlock(out_channels=32)
    tree = jax.tree_util.tree_map(np.array, jb.init(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    tree["params"]["weight"] = block.weight.detach().numpy()
    with torch.no_grad():
        got = block(_t(x))
    _close(got.numpy(), np.asarray(jb.apply(tree, jnp.asarray(x))), 1e-5)


def _bad_dcn(bad):
    rng = np.random.RandomState(0)
    x, off, mask, weight, _, pad = dcn_inputs(rng, 1, 1, True, False)
    x, off, mask = _t(x), _t(off), _t(mask)
    if bad == "offset_channels":
        off = off[..., :-2].contiguous()
    elif bad == "mask_shape":
        mask = mask[:, :, :4].contiguous()
    elif bad == "dtype":
        x = x.double()
    elif bad == "stride":
        return lambda: tdc.deform_im2col_cuda(x, off, mask, 3, 3, 0)
    elif bad == "grad_shape":
        return lambda: tdc.deform_im2col_backward_cuda(
            torch.zeros(3, 3), x, off, mask, 3, 3)
    return lambda: tdc.deform_im2col_cuda(x, off, mask, 3, 3)


def _bad_read(bad):
    feats = torch.zeros(16, 8)
    obs = torch.zeros(16)
    proj = torch.zeros(8, 12, dtype=torch.int32)
    grad = torch.zeros(2, 3, 8)
    if bad == "grad_shape":
        grad = torch.zeros(2, 4, 8)
    elif bad == "proj_dtype":
        proj = proj.long()
    elif bad == "odd_dim":
        grad = torch.zeros(2, 3, 6)
    return lambda: tmo.memory_read_backward_cuda(grad, obs, proj)


@pytest.mark.parametrize("make_call", [
    *[pytest.param(lambda b=b: _bad_dcn(b), id=f"deform_im2col-{b}") for b
      in ("offset_channels", "mask_shape", "dtype", "stride",
          "grad_shape")],
    *[pytest.param(lambda b=b: _bad_read(b), id=f"read_backward-{b}")
      for b in ("grad_shape", "proj_dtype", "odd_dim")],
])
def test_wrappers_check_inputs_before_launch(monkeypatch, make_call):
    """On a card a wrapper raises on inputs its kernel does not take,
    before it builds or launches anything."""
    monkeypatch.setattr(build, "on_card", lambda t: True)

    def no_load(name):
        raise AssertionError(f"{name}: reached the launch with bad inputs")

    monkeypatch.setattr(build, "load", no_load)
    with pytest.raises(ValueError):
        make_call()()


def test_fake_implementations_give_the_shapes():
    """The three new custom ops trace under fake tensors (as
    `torch.export` traces them), with the kernels' output shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(7, 9, 5)
        off = torch.empty(7, 9, 18)
        mask = torch.empty(7, 9, 9)
        cols = torch.ops.eodt.deform_im2col(x, off, mask, 3, 3, 1, 1, 1)
        gx, goff, gm = torch.ops.eodt.deform_im2col_backward(
            x, off, None, cols, 3, 3, 1, 1, 1)
        grad = torch.ops.eodt.memory_read_backward(
            torch.empty(2, 3, 4, 8), torch.empty(2, 16),
            torch.empty(2, 12, 16, dtype=torch.int32), 4)
    assert cols.shape == (63, 45)
    assert gx.shape == x.shape and goff.shape == off.shape and \
        gm.shape == (0,)
    assert grad.shape == (2, 16, 8)


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers take the plain versions and count no
    launch."""
    rng = np.random.RandomState(2)
    x, off, mask, weight, b, pad = dcn_inputs(rng, 1, 1, True, True)
    before = (tdc.deform_im2col_cuda.launches,
              tdc.deform_im2col_backward_cuda.launches,
              tmo.memory_read_backward_cuda.launches)
    xt = _t(x).requires_grad_()
    tdc.modulated_deform_conv(xt, _t(off), _t(mask), _t(weight),
                              _t(b)).sum().backward()
    f = torch.zeros(16, 8, requires_grad=True)
    tmo.memory_read(f, torch.ones(16), torch.zeros(
        8, 12, dtype=torch.int32)).sum().backward()
    assert (tdc.deform_im2col_cuda.launches,
            tdc.deform_im2col_backward_cuda.launches,
            tmo.memory_read_backward_cuda.launches) == before


# -------------------------------------------------- kernel 2b: the transpose

def read_inputs(rng, b, cells, d, h, w, ids):
    feats = (rng.randn(b, cells, d) * 4).astype(np.float32)
    obs = rng.choice([0.0, 1.0, 2.0, 5.0], (b, cells)).astype(np.float32)
    if ids == "random":
        proj = rng.randint(0, cells, (b, h, w))
    else:   # 4 x 4-pixel squares share a cell, as in a real scene
        block = rng.randint(0, cells, (b, h // 4, w // 4))
        proj = np.repeat(np.repeat(block, 4, 1), 4, 2)
        proj[:, 1, 2] = (proj[:, 1, 2] + 1) % cells  # one window of two
    grad = rng.randn(b, h // 4, w // 4, d).astype(np.float32)
    return feats, obs, proj.astype(np.int32), grad


def _emulate_read_backward(grad, obs, proj, pool=4):
    """`csrc/memory_read.cu`'s scatter and finish: each window's distinct
    rows with their multiplicities, bf16(g / p^2) x multiplicity added in
    f32 (here in window order; the kernel's atomics take any), one bf16
    rounding, then the division."""
    b, hp, wp, d = grad.shape
    cells = obs.shape[-1]
    acc = torch.zeros((b * cells, d))
    contrib = (grad / float(pool * pool)).to(torch.bfloat16).float()
    for bi in range(b):
        for y in range(hp):
            for x in range(wp):
                win = proj[bi, y * pool:(y + 1) * pool,
                           x * pool:(x + 1) * pool].reshape(-1)
                rows, mult = torch.unique(win, return_counts=True)
                for r, m in zip(rows.tolist(), mult.tolist()):
                    acc[bi * cells + r] += contrib[bi, y, x] * float(m)
    denom = torch.where(obs > 1, obs, torch.ones_like(obs)).reshape(-1, 1)
    return (acc.to(torch.bfloat16).float() / denom).reshape(
        obs.shape + (d,))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("ids", ["random", "coherent"])
def test_memory_read_grad_vs_jax(batched, ids):
    """`torch.autograd.grad` of the read (single and batched, B = 2) in
    `features` against `jax.grad`, and the kernel's emulated scatter,
    against the exact (f64) sum s of the n contributions c = bf16(g / 16)
    over the obs denominator: the port's plain autograd and JAX (bf16
    sums) within n 2^-8 sum|c| / denominator, the emulation (an f32 sum
    rounded once to bf16) within ((2^-8 + 2^-23)|s| + (1 + 2^-7) n 2^-24
    sum|c|) / denominator; obs_count and proj take no gradient."""
    rng = np.random.RandomState(30 + 2 * batched + (ids == "random"))
    b = 2 if batched else 1
    feats, obs, proj, grad = read_inputs(rng, b, 24, 16, 16, 20, ids)
    if not batched:
        feats, obs, proj, grad = feats[0], obs[0], proj[0], grad[0]
    read = tmo.memory_read_batched if batched else tmo.memory_read
    jread = jax_read_batched if batched else jax_read
    f = _t(feats).requires_grad_()
    o = _t(obs).requires_grad_()
    out = read(f, o, _t(proj))
    got, got_obs = torch.autograd.grad(out, [f, o], _t(grad),
                                       allow_unused=True)
    assert got_obs is None
    want = np.asarray(jax.grad(lambda ff: jnp.sum(
        jread(ff, jnp.asarray(obs), jnp.asarray(proj)) *
        grad))(jnp.asarray(feats)))
    exact, bound, tight, count = tmo.memory_read_grad_exact(
        _t(grad), _t(obs), _t(proj))
    assert float(count.max()) > 1
    emu = _emulate_read_backward(_t(grad).reshape((b,) + grad.shape[-3:]),
                                 _t(obs).reshape(b, -1),
                                 _t(proj).reshape((b,) + proj.shape[-2:]))
    for name, g, b in (("port", got.numpy(), bound), ("jax", want, bound),
                       ("kernel emulation", emu.reshape(got.shape).numpy(),
                        tight)):
        gap = np.abs(g.astype(np.float64) - exact.numpy()) - b.numpy()
        assert gap.max() <= 0, f"{name}: {gap.max():.3e} beyond the bound"
