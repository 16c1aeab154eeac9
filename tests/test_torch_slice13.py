"""Slice 13 on the CPU: the redesigned kernels 2b (the memory read's
transpose, a gather by row) and 9 (the DCNv2 im2col, a warp a (pixel,
tap) with float4 channel lanes), emulated in torch f32 as
`csrc/memory_read.cu` and `csrc/deform_conv.cu` write them.

Kernel 2b: a pass counts each window's distinct rows into int counters;
an exclusive scan gives the rows' bucket offsets; a second pass puts each
distinct row's key, window << 7 | multiplicity, at a slot it takes by
counting the row's counter down (the atomics hand the slots out in any
order: here in a random order of the windows); a warp a (row, 256
channels) sorts the row's keys with a bitonic network in registers (up to
256) or sweeps its frame's windows through a bitmap (more than 256,
multiplicities recounted from proj), and adds bf16(g / 16) x multiplicity
in f32 in that order from 0, rounds to bf16 once and divides.
Kernel 9: a warp a (pixel, tap), its lanes over the channels' float4 quads
(two a lane a step, quad lane + 64 i and lane + 64 i + 32), or over single
channels where Cin % 4 != 0 or a pointer is off a 16-byte boundary.

Tolerances: the emulations bit-equal (`torch.equal`) to the slice-11
emulation of the read's transpose, to `memory_read_grad_window_order` and
to `deform_im2col_plain`; the read's gradient within the bound of its
arithmetic of the exact (f64) sum (an f32 sum rounded once to bf16), and
`jax.grad` within the bf16-sum bound of the same sum; the DCNv2 op within
rtol 1e-6 of JAX's largest output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.ops import deform_conv as jdc
from embodied_object_detection_tpu.ops.memory_ops import (
    memory_read as jax_read, memory_read_batched as jax_read_batched)

from embodied_object_detection_tpu_torch.ops import deform_conv as tdc
from embodied_object_detection_tpu_torch.ops import memory_ops as tmo

from test_torch_slice11 import (
    _close, _emulate_corners, _emulate_read_backward, _j, _t, dcn_inputs,
    read_inputs)

NO_KEY = 0xFFFFFFFF
MULT_BITS = 7
SWEEP_WINDOWS = 256 * 32        # the swept rows' bitmap: 8192 windows
ROW_CHANNELS = 8                # a lane's channels of a row


# ---------------------------------------------------------- kernel 2b


def warp_sort(keys, k_slots):
    """`warp_sort<K>`: the bitonic network over element e = k * 32 + lane
    (key[k] of lane `lane`), strides under 32 by shuffles, the others in a
    lane. keys: uint64 [32 K], returned sorted by the network alone."""
    key = np.array(keys, np.uint64).reshape(k_slots, 32)
    lane = np.arange(32)
    size = 2
    while size <= 32 * k_slots:
        stride = size >> 1
        while stride > 0:
            new = key.copy()
            for k in range(k_slots):
                up = ((k * 32 + lane) & size) == 0
                if stride >= 32:
                    partner = k ^ (stride >> 5)
                    if partner > k:
                        swap = (key[k] > key[partner]) == up
                        new[k] = np.where(swap, key[partner], key[k])
                        new[partner] = np.where(swap, key[k], key[partner])
                else:
                    other = key[k][lane ^ stride]
                    lower = (lane & stride) == 0
                    new[k] = np.where(lower == up, np.minimum(key[k], other),
                                      np.maximum(key[k], other))
            key = new
            stride >>= 1
        size <<= 1
    return key.reshape(-1)


@pytest.mark.parametrize("k_slots", [1, 2, 4, 8])
def test_warp_sort_network_sorts(k_slots):
    """Every count of keys the register path takes (up to 32 K, the rest
    NO_KEY), random and with runs, comes out in ascending order."""
    rng = np.random.RandomState(k_slots)
    for n in sorted({0, 1, 2, 31, 32 * k_slots - 1, 32 * k_slots,
                     *rng.randint(0, 32 * k_slots + 1, 6)}):
        keys = np.full(32 * k_slots, NO_KEY, np.uint64)
        keys[:n] = rng.choice(1 << 20, n, replace=False) << MULT_BITS
        rng.shuffle(keys)
        assert np.array_equal(warp_sort(keys, k_slots), np.sort(keys))


def _taps(proj, cells, pool):
    """Global rows [windows, pool^2] of every window's taps."""
    b, h, w = proj.shape
    idx = proj.long() + (torch.arange(b) * cells)[:, None, None]
    return idx.reshape(b, h // pool, pool, w // pool, pool).permute(
        0, 1, 3, 2, 4).reshape(-1, pool * pool)


def _sweep_order(bucket, r, cells, frame_windows, taps):
    """`row_swept`: the frame's windows in 8192-window spans, each span's
    bucket windows set in a bitmap and read back in bit order; each
    window's multiplicity recounted from its taps."""
    first = (r // cells) * frame_windows
    windows = [int(k) >> MULT_BITS for k in bucket]
    keys = []
    for w0 in range(first, first + frame_windows, SWEEP_WINDOWS):
        bitmap = np.zeros(SWEEP_WINDOWS, bool)
        for w in windows:
            if 0 <= w - w0 < SWEEP_WINDOWS:
                bitmap[w - w0] = True
        for bit in np.flatnonzero(bitmap):
            w = w0 + int(bit)
            keys.append((w << MULT_BITS) | int((taps[w] == r).sum()))
    return keys


def emulate_gather_by_row(grad, obs, proj, rng, pool=4):
    """Kernel 2b's passes (grad [B, H/p, W/p, D], obs [B, cells], proj
    [B, H, W]) -> (grad_features [B * cells, D], the path each row took:
    "sorted K" or "swept")."""
    b, hp, wp, d = grad.shape
    cells = obs.shape[-1]
    rows = b * cells
    c = (grad.reshape(-1, d) / float(pool * pool)).to(torch.bfloat16).float()
    taps = _taps(proj, cells, pool)
    windows, t_count = taps.shape
    distinct = [{row: taps[w].tolist().count(row) for row in taps[w].tolist()}
                for w in range(windows)]
    # the count pass, the scan, then the keys' slots counted down, the
    # windows in any order
    counts = np.zeros(rows, np.int64)
    for rows_of in distinct:
        for row in rows_of:
            counts[row] += 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    keys = np.full(offsets[-1], NO_KEY, np.uint64)
    for w in rng.permutation(windows):
        for row, mult in distinct[w].items():
            counts[row] -= 1
            keys[offsets[row] + counts[row]] = (w << MULT_BITS) | mult
    assert not counts.any() and (keys != NO_KEY).all()
    # the rows: the keys in window order, then the f32 sum from 0
    out = torch.zeros((rows, d))
    path = []
    obs_f = obs.reshape(-1)
    for r in range(rows):
        bucket = keys[offsets[r]:offsets[r + 1]]
        n = len(bucket)
        if n <= 256:
            k_slots = next(k for k in (1, 2, 4, 8) if n <= 32 * k)
            padded = np.full(32 * k_slots, NO_KEY, np.uint64)
            padded[:n] = bucket
            order = [int(k) for k in
                     (warp_sort(padded, k_slots) if n > 1 else padded)[:n]]
            path.append(f"sorted {k_slots}")
        else:
            order = _sweep_order(bucket, r, cells, hp * wp, taps)
            path.append("swept")
        acc = torch.zeros(d)
        for key in order:
            acc = acc + c[key >> MULT_BITS] * float(key & 127)
        denom = obs_f[r] if obs_f[r] > 1 else torch.tensor(1.0)
        out[r] = acc.to(torch.bfloat16).float() / denom
    return out, path


def one_cell_inputs(rng, b, cells, d, h, w):
    """Most of each frame on cell 1: a row of more than 256 windows."""
    feats, obs, proj, grad = read_inputs(rng, b, cells, d, h, w, "random")
    proj[:, : h * 7 // 8] = 1
    return feats, obs, proj, grad


@pytest.mark.parametrize("batched,ids", [
    (False, "random"), (False, "coherent"), (True, "random"),
    (True, "coherent"), (False, "one_cell")])
def test_gather_by_row_is_the_window_order_sum(batched, ids):
    """The emulated gather by row bit-equal to slice 11's emulation (each
    window's distinct rows added in window order) and to
    `memory_read_grad_window_order`; within the f32-sum bound of the exact
    sum, with `jax.grad` of the JAX read within the bf16-sum bound. The
    coherent ids' windows each map to one row (16 equal pixels); one_cell
    puts 280 windows on one row, the swept path."""
    rng = np.random.RandomState(130 + 2 * batched + (ids == "random"))
    b = 2 if batched else 1
    if ids == "one_cell":
        feats, obs, proj, grad = one_cell_inputs(rng, b, 12, 8, 64, 80)
    else:
        feats, obs, proj, grad = read_inputs(rng, b, 24, 16, 16, 20, ids)
    g, o, p = _t(grad), _t(obs), _t(proj)
    got, path = emulate_gather_by_row(g, o, p, rng)
    want = _emulate_read_backward(g, o, p).reshape(got.shape)
    assert torch.equal(got, want)
    one = (lambda a: a) if batched else (lambda a: a[0])
    ref = tmo.memory_read_grad_window_order(one(g), one(o), one(p))
    assert torch.equal(got.reshape(ref.shape), ref)
    if ids == "coherent":             # windows of 16 equal pixels
        taps = _taps(p, 24, 4)
        assert bool((taps == taps[:, :1]).all(1).any())
    assert ("swept" in path) == (ids == "one_cell")
    exact, bound, tight, count = tmo.memory_read_grad_exact(
        one(g), one(o), one(p))
    assert float(count.max()) > 1
    jread = jax_read_batched if batched else jax_read
    jgrad = np.asarray(jax.grad(lambda ff: jnp.sum(jread(
        ff, jnp.asarray(one(obs)), jnp.asarray(one(proj))) * one(grad)))(
            jnp.asarray(one(feats))))
    for name, v, lim in (("emulation", got.reshape(ref.shape).numpy(), tight),
                         ("jax", jgrad, bound)):
        gap = np.abs(v.astype(np.float64) - exact.numpy()) - lim.numpy()
        assert gap.max() <= 0, f"{name}: {gap.max():.3e} beyond the bound"


def test_window_entries_and_scratch():
    """`read_window_entries` lists each window's distinct rows once, in
    window order, with multiplicities summing to the taps; the scratch
    the wrapper hands kernel 2b is the source's layout."""
    rng = np.random.RandomState(7)
    proj = torch.from_numpy(rng.randint(0, 5, (2, 8, 12)).astype(np.int32))
    window, row, mult = tmo.read_window_entries(proj, 5)
    assert torch.all(window[1:] >= window[:-1])
    assert int(mult.sum()) == proj.numel()
    pairs = set(zip(window.tolist(), row.tolist()))
    assert len(pairs) == len(row)
    taps = _taps(proj.long(), 5, 4)
    for w, r, m in zip(window.tolist(), row.tolist(), mult.tolist()):
        assert int((taps[w] == r).sum()) == m
    # table + keys + counters (with a 0 and the scan's ticket) + offsets
    # in a scan block + 9 scan blocks' prefixes, 256-byte aligned
    up = lambda n: -(-n // 256) * 256  # noqa: E731
    assert tmo.read_backward_scratch_bytes(512, 480, 640, 4, 1, 8192) == \
        up(19200 * 1024) + up(307200 * 4) + up(8194 * 4) + up(8193 * 4) + \
        up(9 * 4)


@pytest.mark.parametrize("d,vec", [(512, 8), (1024, 8), (24, 8), (20, 4),
                                   (516, 4)])
def test_row_lane_map_covers_each_channel_once(d, vec):
    """`read_bwd_rows`: a warp a slice of 32 lanes x 8 channels, lane
    vector v0 + j * 32 + lane of `vec` bf16 (D % 8 == 0: uint4, else
    uint2); every channel of the row summed and stored exactly once."""
    seen = np.zeros(d, int)
    row_vecs = d // vec
    for v0 in range(0, row_vecs, 32 * (ROW_CHANNELS // vec)):
        for j in range(ROW_CHANNELS // vec):
            for lane in range(32):
                vi = v0 + j * 32 + lane
                if vi < row_vecs:
                    seen[vi * vec:(vi + 1) * vec] += 1
    assert (seen == 1).all()


# ----------------------------------------------------------- kernel 9


def emulate_im2col_lanes(x, offset, mask, kh, kw, stride, padding,
                         dilation, quads):
    """`deform_im2col_fwd`: every warp's corner set-up once (slice 11's
    `_emulate_corners`), then the columns written lane by lane: two quads
    a lane a step (quads) or one channel. Unwritten columns stay NaN."""
    pix, wgt, _, _, _ = _emulate_corners(x, offset, kh, kw, stride,
                                         padding, dilation)
    rows = x.reshape(-1, x.shape[-1])
    cin = x.shape[-1]
    k = kh * kw
    m = mask.reshape(-1, k) if mask is not None else None
    cols = torch.full((pix.shape[0], k, cin), float("nan"))

    def write(chans):
        chans = torch.as_tensor(chans)
        v = [rows[pix[..., q]][..., chans] for q in range(4)]
        s = v[0] * wgt[..., 0, None]
        for q in (1, 2, 3):
            s = s + v[q] * wgt[..., q, None]
        if m is not None:
            s = s * m[..., None]
        assert torch.isnan(cols[..., chans]).all(), "a channel written twice"
        cols[..., chans] = s

    for lane in range(32):
        if quads:
            for c in range(lane, cin // 4, 64):
                for quad in (c, c + 32):
                    if quad < cin // 4:
                        write(range(4 * quad, 4 * quad + 4))
        else:
            for c in range(lane, cin, 32):
                write([c])
    return cols.reshape(pix.shape[0], k * cin)


@pytest.mark.parametrize("cin,quads,stride,dilation,modulated", [
    (40, True, 2, 2, True), (40, False, 1, 1, False),
    (30, False, 2, 2, True), (520, True, 1, 1, True),
    (520, True, 1, 2, False)])
def test_im2col_lane_map_is_the_plain_columns(cin, quads, stride, dilation,
                                              modulated):
    """The lane map covers every channel once (Cin 40 on quads and on
    single channels, Cin 30 with Cin % 4 != 0, Cin 520 with 130 quads:
    more than 64, so lanes loop), and the columns equal
    `deform_im2col_plain` bit for bit."""
    rng = np.random.RandomState(cin + stride + 2 * dilation)
    x, off, mask, _, _, pad = dcn_inputs(rng, stride, dilation, modulated,
                                         False, h=6, w=7, cin=cin)
    x_t, off_t, mask_t = _t(x), _t(off), _t(mask)
    got = emulate_im2col_lanes(x_t, off_t, mask_t, 3, 3, stride, pad,
                               dilation, quads)
    want = tdc.deform_im2col_plain(x_t, off_t, mask_t, 3, 3, stride, pad,
                                   dilation)
    assert torch.equal(got, want)


def test_deform_conv_op_vs_jax():
    """The op whose columns these are, against JAX's
    `modulated_deform_conv` at Cin 30: within rtol 1e-6 of JAX's largest
    output, as tests/test_torch_slice11.py holds it."""
    rng = np.random.RandomState(31)
    x, off, mask, weight, b, pad = dcn_inputs(rng, 1, 1, True, True, h=6,
                                              w=7, cin=30)
    want = np.asarray(jdc.modulated_deform_conv(
        _j(x), _j(off), _j(mask), _j(weight), _j(b), 1, pad, 1))
    got = tdc.modulated_deform_conv(_t(x), _t(off), _t(mask), _t(weight),
                                    _t(b), 1, pad, 1)
    _close(got.numpy(), want, 1e-6)
