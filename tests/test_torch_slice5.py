"""Slice 5 of the port on the CPU: the redesigned memory-read and
ROIAlign-forward kernels' algorithms, emulated in numpy operation for
operation and held against the JAX package.

  * memory read (`csrc/memory_read.cu`): the pre-pass that writes the
    normalised bf16 table once (`__fdiv_rn`, then `__float2bfloat16_rn` on
    the f32 bits), and the gather's split of the output cells over blocks
    of kCellTile cells (row ids staged, the tail masked) and of the
    channels over threads of one 16-byte vector (8 channels), each vector
    accumulated in f32 in tap order and divided by pool^2. Equal in every
    element to slice 3's emulation of the one-pass design, and within
    rtol/atol 1e-6 of JAX's `memory_read` and `memory_read_batched`.
  * ROIAlign forward (`csrc/roi_align.cu`): per (ROI, channel slab, part of
    the output rows) block, the sample table of each axis, its distinct
    taps from a bitmap ranked by popcounts, the band plan of a grid larger
    than the budget, the staged grid of distinct tap rows x distinct tap
    columns (every other position left as NaN garbage, and every read
    asserted to lie in the staged part), and the outputs in the tap form's
    order. Equal in every element to slice 2's emulation, and within
    rtol/atol 1e-5 of JAX's `multilevel_roi_align(impl="v1")`.

The wrappers' new arguments (the read's bf16 table scratch, ROIAlign's
stats) are checked here too; the kernels themselves are held against the
plain versions on the card in tests/test_torch_kernels.py and by
chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_object_detection_tpu.ops import memory_ops as jmem
from embodied_object_detection_tpu.ops import roi_align as jroi

from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.ops import memory_ops as tmem
from embodied_object_detection_tpu_torch.ops import roi_align as troi

from test_torch_slice2 import _emulated_roi_align
from test_torch_slice3 import _emulated_read_batched

T = torch.from_numpy
F32 = np.float32
STRIDES = (8, 16, 32)

# csrc/memory_read.cu
CELL_TILE = 16
READ_VEC = 8                # bf16 channels a 16-byte vector
# csrc/roi_align.cu
THREADS = 224
CHUNKS = 8                  # 16-byte vectors of a 128-byte slab
LANES = THREADS // CHUNKS
SLAB_BYTES = 128
GRID_POSITIONS = 288
MAX_SIDE = 1024


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------- memory read (2, 6)

def _bf16_rn(x):
    """`__float2bfloat16_rn` on the f32 bits: round to nearest, ties to
    even, NaN kept quiet; returned widened to f32."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32).astype(np.uint64)
    lsb = (bits >> 16) & 1
    rounded = ((bits + 0x7FFF + lsb) & 0xFFFF0000).astype(np.uint32)
    nan = np.isnan(x)
    rounded[nan] = ((bits[nan] | 0x400000) & 0xFFFF0000).astype(np.uint32)
    return rounded.view(F32)


def _emulated_prepass(features, obs):
    """Kernel 1: thread i writes table[i // vec, 8 (i % vec) ...] from its
    row's f32 elements divided by the row's denominator."""
    rows, d = features.shape
    vec = d // READ_VEC
    table = np.full((rows, d), np.nan, F32)
    i = np.arange(rows * vec)
    r, v = i // vec, i % vec
    o = obs[r]
    denom = np.where(o > F32(1), o, F32(1)).astype(F32)
    for e in range(READ_VEC):
        table[r, READ_VEC * v + e] = _bf16_rn(
            features[r, READ_VEC * v + e] / denom)
    assert not np.isnan(table).any()
    return table


def _emulated_gather(table, proj, cells, pool=4):
    """Kernel 2: block k takes output cells [16 k, 16 k + 16) of all frames
    (frame b's ids offset by b * cells), stages their pool^2 row ids (row
    0 for the tail), and thread i of the block owns cell i // vec and
    channels 8 (i % vec) ... + 8, summed in f32 in tap order, then divided
    by pool^2."""
    b, h, w = proj.shape
    d = table.shape[1]
    vec = d // READ_VEC
    taps = pool * pool
    out_w = w // pool
    frame_cells = (h // pool) * out_w
    out_cells = b * frame_cells
    out = np.full((out_cells, d), np.nan, F32)
    for block in range(-(-out_cells // CELL_TILE)):
        first = block * CELL_TILE
        rows = np.zeros((CELL_TILE, taps), np.int64)
        for j in range(CELL_TILE):
            cell = first + j
            if cell >= out_cells:
                continue
            f, local = divmod(cell, frame_cells)
            oy, ox = divmod(local, out_w)
            for t in range(taps):
                dy, dx = divmod(t, pool)
                rows[j, t] = f * cells + proj[f, oy * pool + dy,
                                              ox * pool + dx]
        here = min(CELL_TILE, out_cells - first)
        for i in range(here * vec):
            j, c = divmod(i, vec)
            acc = np.zeros(READ_VEC, F32)
            for t in range(taps):
                acc = acc + table[rows[j, t], READ_VEC * c:READ_VEC * (c + 1)]
            out[first + j, READ_VEC * c:READ_VEC * (c + 1)] = acc / F32(taps)
    assert not np.isnan(out).any()
    return out.reshape(b, h // pool, out_w, d)


def _read_inputs(seed, b, cells=20, d=16, h=8, w=24):
    rng = np.random.RandomState(seed)
    feats = (rng.randn(b, cells, d) * 4).astype(F32)
    obs = rng.choice([0.0, 1.0, 2.0, 5.0], (b, cells)).astype(F32)
    obs[:, :4] = [0.0, 1.0, 2.0, 5.0]
    proj = rng.randint(0, cells, (b, h, w)).astype(np.int32)
    return feats, obs, proj


@pytest.mark.parametrize("values", ["randn", "ties", "extremes"])
def test_bf16_rounding_emulation_vs_jax(values):
    rng = np.random.RandomState(5)
    if values == "randn":
        x = (rng.randn(4096) * 10).astype(F32)
    elif values == "ties":        # halfway cases and their neighbours
        base = rng.randint(0, 0x7F80, 2048).astype(np.uint32) << 16
        x = np.concatenate([base | 0x8000, base | 0x7FFF, base | 0x8001,
                            (base | 0x18000)]).view(F32)
    else:
        x = np.array([0.0, -0.0, 3.4e38, -3.4e38, np.inf, -np.inf, 1.0,
                      -1.0, 1.00390625, 1.01171875], F32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(_bf16_rn(x).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("b,h,w", [(1, 12, 20), (3, 8, 24)])
def test_emulated_prepass_gather_equals_one_pass_and_jax(b, h, w):
    """15 and 36 output cells: neither a multiple of the 16-cell tile."""
    cells, d = 20, 16
    feats, obs, proj = _read_inputs(31 + b, b, cells, d, h, w)
    table = _emulated_prepass(feats.reshape(-1, d), obs.reshape(-1))
    got = _emulated_gather(table, proj, cells)
    assert (b * (h // 4) * (w // 4)) % CELL_TILE
    assert np.array_equal(got, _emulated_read_batched(feats, obs, proj))
    want = np.asarray(jmem.memory_read_batched(
        jnp.asarray(feats), jnp.asarray(obs), jnp.asarray(proj)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for i in range(b):
        single = _emulated_gather(
            _emulated_prepass(feats[i], obs[i]), proj[i:i + 1], cells)[0]
        assert np.array_equal(single, got[i])
        np.testing.assert_allclose(single, np.asarray(jmem.memory_read(
            jnp.asarray(feats[i]), jnp.asarray(obs[i]),
            jnp.asarray(proj[i]))), rtol=1e-6, atol=1e-6)


def test_emulated_prepass_is_jax_normalised_table():
    feats, obs, _ = _read_inputs(40, 2)
    d = feats.shape[-1]
    table = _emulated_prepass(feats.reshape(-1, d), obs.reshape(-1))
    denom = jnp.where(jnp.asarray(obs) > 1, jnp.asarray(obs), 1.0)
    want = (jnp.asarray(feats) / denom[..., None]).astype(jnp.bfloat16)
    assert np.array_equal(table, np.asarray(want.astype(jnp.float32))
                          .reshape(-1, d))


@pytest.mark.parametrize("batched", [False, True])
def test_read_wrapper_passes_the_table_scratch(monkeypatch, batched):
    """On the card the wrapper allocates the [B * cells, D] bf16 table and
    hands the kernel its pointer; the launch is counted once."""
    feats, obs, proj = _read_inputs(41, 3 if batched else 1)
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: launch)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    empty = torch.empty
    made = []

    def record_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", record_empty)
    if batched:
        fn = tmem.memory_read_batched
        args = (T(feats).clone(), T(obs), T(proj))
    else:
        fn = tmem.memory_read
        args = (T(feats[0]).clone(), T(obs[0]), T(proj[0]))
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1
    (call,) = calls
    b = feats.shape[0]
    table = [t for t in made if t.dtype == torch.bfloat16]
    assert len(table) == 1 and table[0].shape == (b * 20, 16)
    assert call[3] == table[0].data_ptr() and call[4] == out.data_ptr()
    assert call[5:11] == (16, 8, 24, 4, b, 20)
    assert out.shape == (b, 2, 6, 16)[1 - batched:]


def test_read_wrapper_needs_eight_channel_vectors(monkeypatch):
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"{name} was loaded for bad inputs"))
    with pytest.raises(ValueError, match="D % 8"):
        tmem.memory_read(torch.ones((16, 12)), torch.ones((16,)),
                         torch.zeros((8, 8), dtype=torch.int32))


# ---------------------------------------------------- ROIAlign forward (4)

def _sample_axis(start, bin_, n, s, size):
    """sample_coord + sample_axis over the n samples of an axis; the
    weights times the in-range flag."""
    g = (np.arange(n, dtype=F32) + F32(0.5)) / F32(s)
    c = (start + g * bin_) - F32(0.5)
    ok = (c >= -1) & (c <= size)
    c = np.minimum(np.maximum(c, F32(0)), F32(size - 1))
    i0f = np.floor(c)
    frac = (c - i0f).astype(F32)
    i0 = i0f.astype(np.int64)
    okf = ok.astype(F32)
    return (i0, np.minimum(i0 + 1, size - 1), (F32(1) - frac) * okf,
            frac * okf)


def _distinct(values):
    """The bitmap of the tap values and each value's rank: the popcounts
    of the words below, then of the bits below in its word."""
    assert values.max() < MAX_SIDE
    bits = np.zeros(MAX_SIDE // 32, np.uint64)
    for v in values.tolist():
        bits[v // 32] |= np.uint64(1) << np.uint64(v % 32)
    counts = np.array([bin(int(x)).count("1") for x in bits])
    below = np.concatenate([[0], np.cumsum(counts)])

    def rank(x):
        mask = (1 << (x % 32)) - 1
        return int(below[x // 32]) + bin(int(bits[x // 32]) & mask).count("1")

    ranks = np.array([rank(v) for v in values.tolist()])
    listed = np.zeros(int(below[-1]), np.int64)
    listed[ranks] = values
    return ranks, listed, int(below[-1])


def _band_plan(y0_slots, y1_slots, rb, re, s, nx, cap):
    """One thread's greedy plan: [(end row, first slot, rows)], each band's
    tap rows the slot range of its output rows' samples."""
    lo = [min(y0_slots[r * s:(r + 1) * s]) for r in range(re)]
    hi = [max(y1_slots[r * s:(r + 1) * s]) for r in range(re)]
    max_rows = cap // nx
    assert max_rows >= 2 * s
    plan, a, b = [], lo[rb], hi[rb]
    for r in range(rb + 1, re):
        l2, u2 = min(a, lo[r]), max(b, hi[r])
        if u2 - l2 + 1 > max_rows:
            plan.append((r, a, b - a + 1))
            a, b = lo[r], hi[r]
        else:
            a, b = l2, u2
    plan.append((re, a, b - a + 1))
    return plan


def _emulated_staged_roi_align(feats, boxes, lvl, strides, out, s, parts=1,
                               cap=None, stats=None):
    """The forward kernel over f32 levels: blocks of (ROI, 32-channel slab
    of 8 16-byte vectors, part of the output rows). `stats` collects each
    ROI's (distinct rows of part 0, distinct columns, bands, largest
    grid)."""
    r, c = len(boxes), feats[0].shape[-1]
    kvec = 16 // 4
    kslab = SLAB_BYTES // 4
    cap = max(GRID_POSITIONS, 4 * out * s * s) if cap is None else cap
    n = out * s
    res = np.full((r, out, out, c), np.nan, F32)
    inv = F32(1.0) / F32(s * s)
    for roi in range(r):
        f = feats[lvl[roi]]
        h, w = f.shape[:2]
        st = F32(strides[lvl[roi]])
        x1, y1 = boxes[roi, 0] / st, boxes[roi, 1] / st
        bin_w = (boxes[roi, 2] / st - x1) / F32(out)
        bin_h = (boxes[roi, 3] / st - y1) / F32(out)
        xi0, xi1, xlo, xhi = _sample_axis(x1, bin_w, n, s, w)
        yi0, yi1, ylo, yhi = _sample_axis(y1, bin_h, n, s, h)
        for c0 in range(0, c, kslab):
            nvec = min(kslab, c - c0) // kvec
            for part in range(parts):
                rb, re = part * out // parts, (part + 1) * out // parts
                xr, xlist, nx = _distinct(np.concatenate([xi0, xi1]))
                xs0, xs1 = xr[:n], xr[n:]
                ys_lo, ys_hi = rb * s, re * s
                yr, ylist, ny = _distinct(np.concatenate(
                    [yi0[ys_lo:ys_hi], yi1[ys_lo:ys_hi]]))
                y0s = np.zeros(n, np.int64)
                y1s = np.zeros(n, np.int64)
                y0s[ys_lo:ys_hi] = yr[:ys_hi - ys_lo]
                y1s[ys_lo:ys_hi] = yr[ys_hi - ys_lo:]
                if ny * nx > cap:
                    plan = _band_plan(y0s, y1s, rb, re, s, nx, cap)
                else:
                    plan = [(re, 0, ny)]
                if stats is not None and c0 == 0:
                    prev = stats.get(roi, (0, nx, 0, 0))
                    stats[roi] = (prev[0] + ny, nx,
                                  prev[2] + len(plan) - 1,
                                  max([prev[3]] + [p[2] * nx for p in plan]))
                r0 = rb
                for r1, y0, rows in plan:
                    assert rows * nx <= cap
                    grid = np.full((cap, CHUNKS, kvec), np.nan, F32)
                    written = np.zeros(cap, bool)
                    for lane in range(LANES):          # the staging loop
                        yi, xi = divmod(lane, nx)
                        for p in range(lane, rows * nx, LANES):
                            assert p == yi * nx + xi and not written[p]
                            src = f[ylist[y0 + yi], xlist[xi]]
                            for q in range(nvec):
                                grid[p, q] = src[c0 + q * kvec:
                                                 c0 + (q + 1) * kvec]
                            written[p] = True
                            xi += LANES
                            while xi >= nx:
                                xi -= nx
                                yi += 1
                    assert written[:rows * nx].all()
                    for lane in range(LANES):          # the output loop
                        pw, ph = lane % out, r0 + lane // out
                        while ph < r1:
                            for q in range(nvec):
                                acc = np.zeros(kvec, F32)
                                for iy in range(s):
                                    ky = ph * s + iy
                                    row0 = (y0s[ky] - y0) * nx
                                    row1 = (y1s[ky] - y0) * nx
                                    for ix in range(s):
                                        kx = pw * s + ix
                                        wt = (ylo[ky] * xlo[kx],
                                              ylo[ky] * xhi[kx],
                                              yhi[ky] * xlo[kx],
                                              yhi[ky] * xhi[kx])
                                        pos = (row0 + xs0[kx], row0 + xs1[kx],
                                               row1 + xs0[kx], row1 + xs1[kx])
                                        val = np.zeros(kvec, F32)
                                        for t in range(4):
                                            # only the staged grid is read
                                            assert 0 <= pos[t] < rows * nx
                                            val = val + grid[pos[t], q] * wt[t]
                                        acc = acc + val
                                res[roi, ph, pw, c0 + q * kvec:
                                    c0 + (q + 1) * kvec] = acc * inv
                            pw += LANES
                            while pw >= out:
                                pw -= out
                                ph += 1
                    r0 = r1
    assert not np.isnan(res).any()
    return res


def _staged_inputs(case, c=8):
    """p3-p5 of a 256 x 320 image ([32, 40], [16, 20], [8, 10]) and boxes of
    one kind."""
    rng = np.random.RandomState(70)
    feats = [rng.randn(hh, ww, c).astype(F32)
             for hh, ww in ((32, 40), (16, 20), (8, 10))]
    if case == "mixed":
        _, random_boxes, _ = _staged_inputs("random")
        _, larger, _ = _staged_inputs("larger")
        boxes = np.concatenate([random_boxes, larger])
    elif case == "tiny":          # under one level pixel, and thinner
        boxes = [[100.3, 60.2, 104.1, 63.9], [10, 10, 10.5, 12],
                 [200, 100, 200.2, 100.1], [318, 254, 319.5, 255.9]]
    elif case == "border":      # across the image border
        boxes = [[-30, -20, 60, 50], [280, 200, 360, 290],
                 [-5, 100, 40, 140], [150, 230, 260, 300]]
    elif case == "larger":      # larger than the level: the whole level
        boxes = [[0, 0, 320, 256], [-300, -200, 620, 456],
                 [-50, -40, 370, 300], [0, 0, 640, 512]]
    elif case == "wide":        # aspect e^+-0.7
        side = np.array([40.0, 90.0, 150.0, 230.0])
        asp = np.exp(np.array([0.7, -0.7, 0.7, -0.7]))
        cx, cy = np.array([80, 200, 160, 150]), np.array([60, 180, 120, 128])
        bw, bh = side * np.sqrt(asp), side / np.sqrt(asp)
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                          cy + bh / 2], 1)
    else:
        x0, y0 = rng.uniform(-20, 300, 6), rng.uniform(-20, 240, 6)
        boxes = np.stack([x0, y0, x0 + rng.uniform(1, 300, 6),
                          y0 + rng.uniform(1, 250, 6)], 1)
    boxes = np.asarray(boxes, F32)
    lvl = _np(troi.assign_levels(T(boxes), 3, 5)) - 3
    return feats, boxes, lvl


CASES = ("tiny", "border", "larger", "wide", "random")


@pytest.mark.parametrize("out", [7, 14])
@pytest.mark.parametrize("case", CASES)
def test_emulated_staged_roi_align_vs_jax_v1(out, case):
    feats, boxes, lvl = _staged_inputs(case)
    stats = {}
    got = _emulated_staged_roi_align(feats, boxes, lvl, STRIDES, out, 2,
                                     stats=stats)
    assert np.array_equal(got, _emulated_roi_align(feats, boxes, lvl,
                                                   STRIDES, out, 2))
    want = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                     jnp.asarray(boxes), strides=STRIDES,
                                     output_size=out, sampling_ratio=2,
                                     impl="v1")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    rows, cols = zip(*[v[:2] for v in stats.values()])
    assert max(rows) <= min(2 * out * 2, max(f.shape[0] for f in feats))
    assert max(cols) <= 2 * out * 2
    if case == "tiny":
        assert max(rows) <= 2 and max(cols) <= 2
    if case == "larger":
        # the whole of p4 (16 x 20 positions): more than the budget
        assert stats[0][2] > 0


@pytest.mark.parametrize("out,parts,cap", [(7, 2, None), (14, 3, None),
                                           (14, 1, 4 * 14 * 4),
                                           (7, 3, 4 * 7 * 4)])
def test_emulated_parts_and_small_budgets_equal_slice2(out, parts, cap):
    """Row parts (the mask pooler's blocks when they are few) and the
    smallest budget the kernel allows (one output row's 2 s tap rows x
    2 S s columns), which bands most ROIs; 40 channels make a partial
    second slab."""
    feats, boxes, lvl = _staged_inputs("mixed", c=40)
    stats = {}
    got = _emulated_staged_roi_align(feats, boxes, lvl, STRIDES, out, 2,
                                     parts=parts, cap=cap, stats=stats)
    assert np.array_equal(got, _emulated_roi_align(feats, boxes, lvl,
                                                   STRIDES, out, 2))
    if cap is not None:
        assert sum(v[2] > 0 for v in stats.values()) >= 2
        assert all(v[3] <= cap for v in stats.values())


def test_band_plan_covers_every_row_once():
    feats, boxes, lvl = _staged_inputs("larger")
    for roi in range(len(boxes)):
        f = feats[lvl[roi]]
        st = F32(STRIDES[lvl[roi]])
        y1 = boxes[roi, 1] / st
        bin_h = (boxes[roi, 3] / st - y1) / F32(14)
        yi0, yi1, _, _ = _sample_axis(y1, bin_h, 28, 2, f.shape[0])
        ranks, _, ny = _distinct(np.concatenate([yi0, yi1]))
        plan = _band_plan(ranks[:28], ranks[28:], 0, 14, 2, 20, 4 * 14 * 4)
        ends = [p[0] for p in plan]
        assert ends == sorted(ends) and ends[-1] == 14
        # the slots are sorted and the samples monotone: an output row's
        # tap rows are a range of at most 2 s, and the bands cover [0, ny)
        for r in range(14):
            rows = set(ranks[2 * r:2 * r + 2]) | set(ranks[28 + 2 * r:
                                                           30 + 2 * r])
            assert max(rows) - min(rows) + 1 == len(rows) <= 4
        covered = set()
        for _, y0, rows in plan:
            covered |= set(range(y0, y0 + rows))
        assert covered == set(range(ny))


def test_roi_align_wrapper_checks_stats_and_geometry(monkeypatch):
    feats, boxes, lvl = _staged_inputs("random")
    feats = [T(f) for f in feats]
    boxes, lvl = T(boxes), T(lvl.astype(np.int32))
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"{name} was loaded for bad inputs"))
    r = len(boxes)
    for stats in (torch.zeros((r, 3)), torch.zeros((r, 2), dtype=torch.int32),
                  torch.zeros((3, r), dtype=torch.int32).T):
        with pytest.raises(ValueError, match="stats"):
            troi.roi_align_cuda(feats, boxes, lvl, STRIDES, 7, 2, stats)
    with pytest.raises(ValueError, match="divisible by 8"):
        troi.roi_align_cuda([f[..., :6].contiguous() for f in feats], boxes,
                            lvl, STRIDES, 7, 2)
    with pytest.raises(ValueError, match="<= 64"):
        troi.roi_align_cuda(feats, boxes, lvl, STRIDES, 65, 1)
    with pytest.raises(ValueError, match="H, W <= 1024"):
        troi.roi_align_cuda([torch.zeros((2, MAX_SIDE + 1, 8))] + feats[1:],
                            boxes, lvl, STRIDES, 7, 2)


def test_roi_align_wrapper_passes_zeroed_stats(monkeypatch):
    feats, boxes, lvl = _staged_inputs("random")
    feats = [T(f).clone() for f in feats]       # 64-byte aligned
    boxes, lvl = T(boxes), T(lvl.astype(np.int32))
    calls = []
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load",
                        lambda name: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    stats = torch.full((len(boxes), 3), 7, dtype=torch.int32)
    before = troi.roi_align_cuda.launches
    troi.roi_align_cuda(feats, boxes, lvl, STRIDES, 7, 2, stats)
    troi.roi_align_cuda(feats, boxes, lvl, STRIDES, 7, 2)
    assert troi.roi_align_cuda.launches == before + 2
    assert int(stats.abs().sum()) == 0
    assert calls[0][-2] == stats.data_ptr() and calls[1][-2] == 0


def test_slice5_kernel_sources():
    read_src = (build.CSRC / "memory_read.cu").read_text()
    for note in ("pre-pass", "__fdiv_rn", "__float2bfloat16_rn", "__stcs",
                 "16-byte", "tap order", "What bounds it on Hopper",
                 "template <int kPool>", "evict-first"):
        assert note in read_src
    assert f"kCellTile = {CELL_TILE};" in read_src
    roi_src = (build.CSRC / "roi_align.cu").read_text()
    for note in ("cp.async.cg.shared.global", "staged tap grid", "bands",
                 "__popc", "What bounds it on Hopper",
                 "roi_align_backward_kernel", "sample_table"):
        assert note in roi_src
    assert f"kThreads = {THREADS};" in roi_src
    assert f"kSlabBytes = {SLAB_BYTES};" in roi_src
    assert f"kGridPositions = {GRID_POSITIONS};" in roi_src
    assert f"kMaxSide = {MAX_SIDE};" in roi_src
    # the tap arithmetic is the one-pass kernel's
    assert "val[e] = __fadd_rn(val[e], __fmul_rn(tv[e], wt[tap]));" in \
        roi_src
    assert re.search(r"acc\[e\] = __fmul_rn\(acc\[e\], inv\)", roi_src)
    # the entry point takes the stats pointer before the stream
    assert build.ENTRY_POINTS["roi_align"][1][-2] is build.ctypes.c_void_p
    assert len(build.ENTRY_POINTS["memory_read"][1]) == 12
