"""Slice 12 on the CPU: the work split of the deformable attention kernels
(`csrc/ms_deform_attn.cu`, kernels 8 and 8b) emulated in torch f32.

A warp takes one (query, head); lane = pp * G + sub takes point slot pp
and channel quad sub, with G the power of two at least ceil(D / 4) (up to
32 lanes), 32 / G points a pass and more quads than 32 in chunks; the last
quad holds D % 4 channels where D % 4 != 0. The forward's lane sums its
point's samples over the levels in order, and the first lane group adds
the P point partials in order p = 0, 1, ... (the shuffles). The
backward's lane sums grad_attn's and grad_loc's products over its quad's
channels, an xor tree sums them over the G lanes, and grad_value takes
one 4-channel RED a (sample, valid corner, quad).

Tolerances: the forward bit-equal to `ms_deform_attn_plain` (its sum over
the point axis in order; otherwise within 2^-23 of the largest output,
and the test says which), and within rtol 1e-6 of the JAX op, as
tests/test_torch_slice10.py holds the plain version; grad_loc and
grad_attn within 1e-5 of the plain autograd's largest and grad_value
within contributions x 2^-24 x sum|contribution| of the exact sum, the
card's tolerances.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_object_detection_tpu.ops.ms_deform_attn import (
    ms_deform_attn as jax_msda)

import chip_smoke
from embodied_object_detection_tpu_torch.ops import ms_deform_attn as tmsda

LEVELS2 = ((6, 8), (3, 4))
LEVELS3 = ((8, 10), (4, 5), (2, 3))
# name: (M, D, P, levels, Q, locality); the inputs from chip_smoke.py's
# `msda_arrays`, as on the card: random locations in [-0.1, 1.1] with
# edge cases, or the model's (Q = S: each query's own pixel centre)
CASES = {
    "detr": (8, 32, 4, LEVELS3, 24, "random"),   # 4 points x 8 quads
    "wide": (2, 48, 3, LEVELS2, 20, "random"),   # 12 quads on 16 lanes
    "tail": (4, 6, 2, LEVELS3, 20, "random"),    # a quad of 2 channels
    "deep": (1, 8, 8, LEVELS2, 20, "random"),    # 8 points on 2 lanes each
    "chunked": (1, 130, 2, LEVELS2, 8, "random"),  # 33 quads: 2 chunks
    "model": (8, 32, 4, LEVELS3, 106, "model"),  # the encoder's queries
}


def _inputs(rng, case):
    m, d, p, shapes, q, locality = CASES[case]
    return [torch.from_numpy(a) for a in chip_smoke.msda_arrays(
        rng, shapes, q, m, d, p, locality)]


def lane_map(d):
    """(quads, G, points a pass) of the launcher's plan."""
    quads = -(-d // 4)
    g_log2 = 0
    while (1 << g_log2) < quads and g_log2 < 5:
        g_log2 += 1
    return quads, 1 << g_log2, 32 >> g_log2


def _corners(lx, ly, h, w, start):
    """The kernel's `corners()` in torch f32: rows (-1 outside the level)
    and hat weights with the validity folded in, the fractional parts."""
    x = lx * w - 0.5
    y = ly * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    gx, gy = 1 - fx, 1 - fy
    hat = (gy * gx, gy * fx, fy * gx, fy * fx)
    rows, wgts = [], []
    for k in range(4):
        dy, dx = k >> 1, k & 1
        ok = (y0 + dy >= 0) & (y0 + dy < h) & (x0 + dx >= 0) & (x0 + dx < w)
        row = start + (y0 + dy) * w + x0 + dx
        rows.append(torch.where(ok, row, -1.0).long())
        wgts.append(torch.where(ok, hat[k], 0.0))
    return rows, wgts, fx, fy


class Warp:
    """The lanes of every pair's warp at once: tensors [pairs, 32, ...]."""

    def __init__(self, value, shapes, locs, attn):
        self.s, self.m, self.d = value.shape
        self.q, _, self.nl, self.p, _ = locs.shape
        self.pairs = self.q * self.m
        self.shapes = shapes
        self.starts = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
        self.table = value.reshape(self.s * self.m, self.d)
        self.loc = locs.reshape(self.pairs, self.nl, self.p, 2)
        self.attn = attn.reshape(self.pairs, self.nl, self.p)
        self.head = (torch.arange(self.pairs) % self.m)[:, None]
        self.quads, self.g, self.pc = lane_map(self.d)
        lane = torch.arange(32)
        self.pp, self.sub = lane // self.g, lane % self.g

    def quad(self, q0):
        """This chunk's quad per lane, its channels [32, 4] and their
        liveness [32, 4] (the last quad holds D % 4 of them)."""
        j = q0 + self.sub
        nc = torch.where(j < self.quads, (self.d - 4 * j).clamp(0, 4), 0)
        chan = (4 * j[:, None] + torch.arange(4)).clamp(max=self.d - 1)
        return chan, torch.arange(4) < nc[:, None]

    def sample(self, p0, lvl):
        """Each lane's point, its liveness, corners and weight at lvl."""
        pt = p0 + self.pp
        live = pt < self.p
        ptc = pt.clamp(max=self.p - 1)
        h, w = self.shapes[lvl]
        rows, wgts, fx, fy = _corners(self.loc[:, lvl, ptc, 0],
                                      self.loc[:, lvl, ptc, 1], h, w,
                                      int(self.starts[lvl]))
        a = torch.where(live, self.attn[:, lvl, ptc], 0.0)
        return pt, live, rows, wgts, fx, fy, a

    def load(self, rows, live, chan, cmask):
        """The four corners' quads [pairs, 32, 4]: 0 where not loaded."""
        out = []
        for row in rows:
            got = self.table[(row.clamp(min=0) * self.m + self.head)[..., None],
                             chan]
            ok = (row >= 0) & live
            out.append(torch.where(ok[..., None] & cmask, got, 0.0))
        return out


def emulate_forward(value, shapes, locs, attn):
    """The forward kernel's lane map and order."""
    wp = Warp(value, shapes, locs, attn)
    out = torch.zeros(wp.pairs, wp.d)
    for q0 in range(0, wp.quads, wp.g):
        chan, cmask = wp.quad(q0)
        o = None
        for p0 in range(0, wp.p, wp.pc):
            acc = torch.zeros(wp.pairs, 32, 4)
            for lvl in range(wp.nl):
                _, live, rows, wgts, _, _, a = wp.sample(p0, lvl)
                v = wp.load(rows, live, chan, cmask)
                s = None
                for k in range(4):
                    tap = torch.where((rows[k] >= 0)[..., None],
                                      v[k] * wgts[k][..., None], 0.0)
                    s = tap if k == 0 else s + tap
                acc = acc + s * a[..., None]
            # the shuffles: lane (k, sub) to lane (0, sub), in order
            for k in range(wp.pc):
                if p0 + k >= wp.p:
                    break
                part = acc[:, k * wp.g + wp.sub]
                o = part if o is None else o + part
        for lane in range(wp.g):              # the first group stores
            live = cmask[lane]
            out[:, chan[lane][live]] = o[:, lane][:, live]
    return out.reshape(wp.q, wp.m * wp.d)


def emulate_backward(value, shapes, locs, attn, grad):
    """The backward kernel's lane map: (grad_value from the RED
    contributions added in issue order, grad_loc, grad_attn, REDs)."""
    wp = Warp(value, shapes, locs, attn)
    g_rows = grad.reshape(wp.pairs, wp.d)
    grad_attn = torch.zeros(wp.pairs, wp.nl, wp.p)
    grad_loc = torch.zeros(wp.pairs, wp.nl, wp.p, 2)
    grad_value = torch.zeros(wp.s * wp.m, wp.d)
    reds = 0
    xor = torch.arange(32)
    for p0 in range(0, wp.p, wp.pc):
        for lvl in range(wp.nl):
            h, w = shapes[lvl]
            pt, live, rows, wgts, fx, fy, a = wp.sample(p0, lvl)
            gx, gy = 1 - fx, 1 - fy
            sums = [torch.zeros(wp.pairs, 32) for _ in range(3)]
            for q0 in range(0, wp.quads, wp.g):
                chan, cmask = wp.quad(q0)
                g = torch.where(live[:, None] & cmask, g_rows[:, chan], 0.0)
                v = wp.load(rows, live, chan, cmask)
                s = v[0] * wgts[0][..., None]
                for k in range(1, 4):
                    s = s + v[k] * wgts[k][..., None]
                terms = (g * s,
                         g * (gy[..., None] * (v[1] - v[0]) +
                              fy[..., None] * (v[3] - v[2])),
                         g * (gx[..., None] * (v[2] - v[0]) +
                              fx[..., None] * (v[3] - v[1])))
                for acc, t in zip(sums, terms):      # the quad's channels
                    for c in range(4):
                        acc += t[..., c]
                ga = g * a[..., None]
                for k in range(4):                   # one RED a corner
                    red = (rows[k] >= 0) & live[None] & cmask[:, 0]
                    contrib = ga * wgts[k][..., None]
                    idx = rows[k].clamp(min=0) * wp.m + wp.head
                    sel = red.nonzero(as_tuple=True)
                    for c in range(4):
                        ok = cmask[sel[1], c]
                        grad_value.index_put_(
                            (idx[sel][ok], chan[sel[1], c][ok]),
                            contrib[sel][:, c][ok], accumulate=True)
                    reds += int(red.sum())
            off = wp.g >> 1                          # the xor tree
            while off:
                sums = [acc + acc[:, xor ^ off] for acc in sums]
                off >>= 1
            first = (wp.sub == 0) & live
            pair, lane = torch.nonzero(first.expand(wp.pairs, 32),
                                       as_tuple=True)
            ptl = pt[lane]
            grad_attn[pair, lvl, ptl] = sums[0][pair, lane]
            grad_loc[pair, lvl, ptl, 0] = a[pair, lane] * sums[1][pair, lane] * w
            grad_loc[pair, lvl, ptl, 1] = a[pair, lane] * sums[2][pair, lane] * h
    return (grad_value.reshape(wp.s, wp.m, wp.d),
            grad_loc.reshape(locs.shape), grad_attn.reshape(attn.shape), reds)


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def test_lane_map_covers_every_channel_once():
    """Every (point, channel) of a pair has exactly one lane, the quads'
    lanes a power of two of at most 32, at the listed shapes and D = 1,
    128, 129 and 256."""
    for d, p in [(c[1], c[2]) for c in CASES.values()] + [
            (1, 4), (128, 4), (129, 2), (256, 1)]:
        quads, g, pc = lane_map(d)
        assert g <= 32 and g & (g - 1) == 0 and (quads <= g or g == 32)
        seen = np.zeros((p, d), int)
        for q0 in range(0, quads, g):
            for p0 in range(0, p, pc):
                for lane in range(32):
                    pt, j = p0 + lane // g, q0 + lane % g
                    if pt < p and j < quads:
                        seen[pt, 4 * j: min(4 * j + 4, d)] += 1
        assert (seen == 1).all(), (d, p)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lane_map_equals_plain_and_jax(case):
    p, shapes = CASES[case][2:4]
    value, locs, attn, _ = _inputs(np.random.RandomState(120), case)
    got = emulate_forward(value, shapes, locs, attn)
    plain = tmsda.ms_deform_attn_plain(value, shapes, locs, attn)
    # the plain version's per-point partials (every other point's weight
    # 0 adds exact zeros), added in order p = 0, 1, ...
    in_order = None
    for k in range(p):
        one = torch.zeros_like(attn)
        one[..., k] = attn[..., k]
        part = tmsda.ms_deform_attn_plain(value, shapes, locs, one)
        in_order = part if in_order is None else in_order + part
    assert torch.equal(got, in_order)
    if not torch.equal(plain, in_order):
        warnings.warn("the CPU sums the point axis in another order than "
                      "p = 0, 1, ...: held within 2^-23 of the largest")
        assert float((got - plain).abs().max()) <= \
            2.0 ** -23 * float(plain.abs().max())
    else:
        assert torch.equal(got, plain)
    want = np.asarray(jax_msda(jnp.asarray(value.numpy()), shapes,
                               jnp.asarray(locs.numpy()),
                               jnp.asarray(attn.numpy())), np.float64)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max() + 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_backward_lane_map_within_card_tolerances(case):
    d, shapes = CASES[case][1], CASES[case][3]
    value, locs, attn, grad = _inputs(np.random.RandomState(121), case)
    gv, gl, ga, reds = emulate_backward(value, shapes, locs, attn, grad)
    leaves = [t.clone().requires_grad_() for t in (value, locs, attn)]
    (tmsda.ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2]) *
     grad).sum().backward()
    assert _rel_err(gl, leaves[1].grad) <= 1e-5
    assert _rel_err(ga, leaves[2].grad) <= 1e-5
    exact, bound, _ = tmsda.ms_deform_attn_grad_value_exact(
        shapes, value, locs, attn, grad)
    assert bool(((gv.double() - exact).abs() <= bound).all())
    # one RED a (sample, corner inside its level, quad): D / 4 fewer than
    # one a channel
    inside = 0
    for lvl, (h, w) in enumerate(shapes):
        rows, _, _, _ = _corners(locs[:, :, lvl, :, 0], locs[:, :, lvl, :, 1],
                                 h, w, 0)
        inside += sum(int((r >= 0).sum()) for r in rows)
    assert reds == inside * -(-d // 4)
