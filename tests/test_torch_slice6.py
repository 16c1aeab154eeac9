"""Slice 6 of the port on the CPU: the redesigned ROIAlign backward and the
exact write's selection with its first pass folded into the mask paste,
emulated in numpy operation for operation and held against the JAX
package; and the training loop's cell-id guard.

  * ROIAlign backward (`csrc/roi_align.cu`): per (ROI, 128-channel slab)
    block, the slab of grad_out staged once and divided by s^2, the
    forward's sample table (distinct taps from a bitmap ranked by
    popcounts), each axis's (sample, tap) entries sorted by slot, and each
    grid position's contributions (the taps of its row's y-entries times
    its column's x-entries) summed in a fixed order and flushed once.
    Every tap lands on exactly one staged position; within contributions
    x 2^-24 x sum|contribution| of the exact sum of the plain tap form's
    f32 contributions, of slice 3's emulation of the per-tap kernel and of
    the port's plain v1 autograd (the same taps and weights), and within
    rtol 1e-5 of `jax.grad` of JAX's
    `multilevel_roi_align(impl="v1")` (whose sample coordinates XLA may
    round differently by an ulp, as in tests/test_torch_slice3.py); one
    flush per distinct position a ROI touches with a nonzero weight and
    slab.
  * mask paste epilogue (`csrc/mask_paste.cu`): per 8 x 32 tile and pass
    of 128 masks, each pixel's stored values ANDed with valid (32-bit
    words when the pass's span is a multiple of 4) ORed into its flag,
    and one count per (row, tile); then the select pass
    (`csrc/write_select.cu`) on those flags: the row start from the
    counts above, the ballot words and their popcount ranks, the slots,
    the covering counts and the rows. seg_idx and aug equal the plain
    selection and slice 3's two-pass emulation, and the memory write
    through them equals JAX's exact write bit for bit (identity features
    and one cell a pixel make each cell's update the selected pixel's
    weight row).

The wrappers' new arguments and errors are checked here too; the kernels
themselves are held against the plain versions on the card in
tests/test_torch_kernels.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.ops import memory_ops as jmem
from embodied_object_detection_tpu.ops import roi_align as jroi

from embodied_object_detection_tpu_torch.engine.train import (
    ChunkRecord, train)
from embodied_object_detection_tpu_torch.data.synthetic import (
    synthetic_batch_fn)
from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.models.detector import build_detector
from embodied_object_detection_tpu_torch.ops import mask_paste as tmask
from embodied_object_detection_tpu_torch.ops import memory_ops as tmem
from embodied_object_detection_tpu_torch.ops import roi_align as troi

from test_torch_slice3 import (_emulated_roi_align_backward,
                               _emulated_write_select)
from test_torch_slice4 import _emulated_paste
from test_torch_slice5 import _distinct, _sample_axis, _staged_inputs
from test_torch_train_loop import ZS, _config

T = torch.from_numpy
F32 = np.float32
STRIDES = (8, 16, 32)

# csrc/roi_align.cu
BWD_SLAB = 128
MAX_AXIS = 128
GRID_POSITIONS = 288        # the forward's budget: its grids above it band
# csrc/mask_paste.cu
TILE_ROWS, TILE_COLS = 8, 32
PASS = 128                  # bool masks a pass: 32 KB of stage / 256 pixels


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------- ROIAlign backward (4b)

def _slot_entries(s0, s1, lo, hi, n_slots, s):
    """An axis's 2 n (sample, tap) entries sorted by slot as the kernel
    sorts them: a count a slot, the exclusive scan, and each entry's rank
    among its slot's entries in entry order. Returns (first [MAX_AXIS +
    1], output cell [2 n], weight [2 n])."""
    n = len(s0)
    slots = np.empty(2 * n, np.int64)
    slots[0::2], slots[1::2] = s0, s1
    weights = np.empty(2 * n, F32)
    weights[0::2], weights[1::2] = lo, hi
    assert slots.max() < n_slots <= MAX_AXIS
    count = np.zeros(MAX_AXIS, np.int64)
    np.add.at(count, slots, 1)
    first = np.concatenate([[0], np.cumsum(count)])
    cells = np.full(2 * n, -1, np.int64)
    w = np.full(2 * n, np.nan, F32)
    for e in range(2 * n):
        at = first[slots[e]] + int((slots[:e] == slots[e]).sum())
        assert cells[at] == -1
        cells[at], w[at] = (e >> 1) // s, weights[e]
    assert (cells >= 0).all()
    return first, cells, w


def _emulated_staged_backward(shapes, c, boxes, lvl, grad, out, s):
    """The backward kernel over f32 gradients: per (ROI, 128-channel slab)
    the slab of grad / s^2 (NaN beyond the slab's channels), the sample
    table, the sorted entries, then for every position of the grid its
    contributions (wt = w_y * w_x, zero weights skipped) summed in entry
    order and, if any weight was nonzero, added once to the level.
    Returns (level accumulators, flushes, largest grid)."""
    acc = [np.zeros((h, w, c), F32) for h, w in shapes]
    flushes, largest = 0, 0
    n = out * s
    for roi in range(len(boxes)):
        h, w = shapes[lvl[roi]]
        st = F32(STRIDES[lvl[roi]])
        x1, y1 = boxes[roi, 0] / st, boxes[roi, 1] / st
        bin_w = (boxes[roi, 2] / st - x1) / F32(out)
        bin_h = (boxes[roi, 3] / st - y1) / F32(out)
        xi0, xi1, xlo, xhi = _sample_axis(x1, bin_w, n, s, w)
        yi0, yi1, ylo, yhi = _sample_axis(y1, bin_h, n, s, h)
        xr, xlist, nx = _distinct(np.concatenate([xi0, xi1]))
        yr, ylist, ny = _distinct(np.concatenate([yi0, yi1]))
        fx, cx, wx = _slot_entries(xr[:n], xr[n:], xlo, xhi, nx, s)
        fy, cy, wy = _slot_entries(yr[:n], yr[n:], ylo, yhi, ny, s)
        largest = max(largest, nx * ny)
        # every tap lands on exactly one position of the staged grid
        assert sum((fy[py + 1] - fy[py]) * (fx[px + 1] - fx[px])
                   for py in range(ny) for px in range(nx)) == 4 * n * n
        assert fy[ny] == fx[nx] == 2 * n
        for c0 in range(0, c, BWD_SLAB):
            span = min(BWD_SLAB, c - c0)
            staged = np.full((out * out, BWD_SLAB), np.nan, F32)
            staged[:, :span] = grad[roi, :, :, c0:c0 + span].reshape(
                out * out, span) / F32(s * s)
            for p in range(nx * ny):
                py, px = divmod(p, nx)
                total = np.zeros(span, F32)
                touched = False
                for a in range(fy[py], fy[py + 1]):
                    for b in range(fx[px], fx[px + 1]):
                        wt = F32(wy[a] * wx[b])
                        if wt == 0:
                            continue
                        touched = True
                        total = total + staged[cy[a] * out + cx[b],
                                               :span] * wt
                if touched:
                    flushes += 1
                    dst = acc[lvl[roi]][ylist[py], xlist[px]]
                    dst[c0:c0 + span] = dst[c0:c0 + span] + total
    for a in acc:
        assert not np.isnan(a).any()
    return acc, flushes, largest


def _distinct_touched(shapes, boxes, lvl, out):
    """Per ROI, the distinct level positions its nonzero-weight taps
    reach (the plain tap form's rows and weights)."""
    rows, wgt = troi.roi_align_taps(shapes, T(boxes), STRIDES, out, 2,
                                    T(lvl))
    r = len(boxes)
    rows, live = rows.reshape(r, -1), wgt.reshape(r, -1) != 0
    return sum(int(torch.unique(rows[i][live[i]]).numel()) for i in range(r))


def _exact_sums(shapes, boxes, lvl, grad, out):
    """Each position's f32 contributions (grad / s^2) * w of the plain tap
    form summed exactly (f64): n contributions summed in any f32 order
    stay within (n - 1) 2^-24 sum|c| of it."""
    rows, wgt = troi.roi_align_taps(shapes, T(boxes), STRIDES, out, 2,
                                    T(lvl))
    c = grad.shape[-1]
    g = T(grad) / 4.0
    prod = (g[:, :, None, :, None, None, :] * wgt[..., None]).reshape(-1, c)
    total = sum(h * w for h, w in shapes)
    exact = torch.zeros((total, c), dtype=torch.float64).index_add_(
        0, rows.reshape(-1), prod.double())
    sizes = [h * w for h, w in shapes]
    return [e.reshape(h, w, c).numpy() for e, (h, w) in
            zip(torch.split(exact, sizes), shapes)]


def _miniature_inputs(seed, r=64, c=8):
    """p3-p5 of the 64 x 96 miniature and r boxes from under a level pixel
    to past the image, over all three levels."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(h, w, c).astype(F32)
             for h, w in ((8, 12), (4, 6), (2, 3))]
    side = np.exp(rng.uniform(np.log(2), np.log(200), r))
    cx, cy = rng.uniform(-10, 106, r), rng.uniform(-10, 74, r)
    boxes = np.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                      cy + side / 2], 1).astype(F32)
    lvl = _np(troi.assign_levels(T(boxes), 3, 5)) - 3
    return feats, boxes, lvl


def _backward_inputs(case):
    if case == "miniature":
        return _miniature_inputs(80)
    return _staged_inputs(case)


def _jax_grad(feats, boxes, grad, out):
    _, vjp = jax.vjp(lambda *f: jroi.multilevel_roi_align(
        list(f), jnp.asarray(boxes), strides=STRIDES, output_size=out,
        sampling_ratio=2, impl="v1"), *[jnp.asarray(f) for f in feats])
    return [np.asarray(g) for g in vjp(jnp.asarray(grad))]


@pytest.mark.parametrize("case,out", [("miniature", 7), ("tiny", 7),
                                      ("larger", 7), ("wide", 7),
                                      ("border", 7), ("miniature", 14)])
def test_emulated_staged_backward_vs_jax(case, out):
    """R = 64 at the miniature's shapes; ROIs under one level pixel; a
    whole level and larger (the forward bands its grid); wide and across
    the border. The 14 x 14 case takes the mask pooler's size."""
    feats, boxes, lvl = _backward_inputs(case)
    shapes = [f.shape[:2] for f in feats]
    c = feats[0].shape[-1]
    grad = np.random.RandomState(81).randn(len(boxes), out, out,
                                           c).astype(F32)
    got, flushes, largest = _emulated_staged_backward(shapes, c, boxes, lvl,
                                                      grad, out, 2)
    # one flush per distinct touched position and slab
    assert flushes == _distinct_touched(shapes, boxes, lvl, out) * \
        -(-c // BWD_SLAB)
    if case == "larger":
        assert largest > GRID_POSITIONS
    if case == "tiny":
        assert largest <= 4
    per_tap, count, mag = _emulated_roi_align_backward(shapes, c, boxes, lvl,
                                                       grad, out, 2)
    leaves = [T(f).requires_grad_(True) for f in feats]
    plain = torch.autograd.grad(troi.multilevel_roi_align(
        leaves, T(boxes), STRIDES, out, 2, impl="v1"), leaves, T(grad))
    want = _jax_grad(feats, boxes, grad, out)
    exact = _exact_sums(shapes, boxes, lvl, grad, out)
    scale = max(np.abs(j).max() for j in want)
    for a, n, m, t, p, j, x in zip(got, count, mag, per_tap, plain, want,
                                   exact):
        bound = n[..., None] * 2.0 ** -24 * m
        assert (np.abs(a - x) <= bound).all()
        assert (np.abs(a - t) <= bound).all()
        assert (np.abs(a - _np(p)) <= bound).all()
        # XLA on the CPU may fuse a sample coordinate into an FMA, so JAX's
        # tap weights can differ from the tap form's by an ulp
        np.testing.assert_allclose(a, j, rtol=1e-5, atol=1e-6 * scale)
    assert max(n.max() for n in count) > 4


@pytest.mark.parametrize("c", [8, 136])
def test_emulated_staged_backward_slabs(c):
    """A second, partial slab of channels (136 = 128 + 8): each slab's
    positions are flushed on their own and every channel is summed."""
    feats, boxes, lvl = _miniature_inputs(82, r=12, c=c)
    shapes = [f.shape[:2] for f in feats]
    grad = np.random.RandomState(83).randn(len(boxes), 7, 7, c).astype(F32)
    got, flushes, _ = _emulated_staged_backward(shapes, c, boxes, lvl, grad,
                                                7, 2)
    assert flushes == _distinct_touched(shapes, boxes, lvl, 7) * \
        -(-c // BWD_SLAB)
    per_tap, count, mag = _emulated_roi_align_backward(shapes, c, boxes, lvl,
                                                       grad, 7, 2)
    for a, n, m, t in zip(got, count, mag, per_tap):
        assert (np.abs(a - t) <= n[..., None] * 2.0 ** -24 * m).all()


def test_slot_entries_cover_clamped_taps_twice():
    """At the far border both taps of a sample clamp to one position: its
    two entries land in the same slot, as the tap form adds both."""
    s0 = np.array([0, 1, 2, 2])
    s1 = np.array([1, 2, 2, 2])
    lo = np.array([0.75, 0.25, 1.0, 1.0], F32)
    hi = np.array([0.25, 0.75, 0.0, 0.0], F32)
    first, cells, w = _slot_entries(s0, s1, lo, hi, 3, 2)
    assert first[:4].tolist() == [0, 1, 3, 8]
    assert cells[3:8].tolist() == [0, 1, 1, 1, 1]
    assert w[3:8].tolist() == [0.75, 1.0, 0.0, 1.0, 0.0]


# ------------------------------------- mask paste epilogue + selection (5, 7)

def _emulated_epilogue(masks, valid):
    """The paste kernel's flag epilogue over its stored values ([H, W, N]
    bool): per 8 x 32 tile and pass of 128 masks, each pixel's values ANDed
    with valid (32-bit words when the span is a multiple of 4) ORed into
    its flag; then each tile row's popcount. Returns (observed [H, W],
    counts [H, tiles])."""
    h, w, n = masks.shape
    tiles = -(-w // TILE_COLS)
    observed = np.zeros((h, w), bool)
    counts = np.full((h, tiles), -1, np.int32)
    for y0 in range(0, h, TILE_ROWS):
        for bx in range(tiles):
            x0 = bx * TILE_COLS
            rows, cols = min(TILE_ROWS, h - y0), min(TILE_COLS, w - x0)
            flag = np.zeros((rows, cols), bool)
            for q0 in range(0, n, PASS):
                span = min(PASS, n - q0)
                stage = np.ascontiguousarray(
                    masks[y0:y0 + rows, x0:x0 + cols, q0:q0 + span]
                ).astype(np.uint8)
                v = np.ascontiguousarray(valid[q0:q0 + span]).astype(np.uint8)
                if span % 4 == 0:
                    flag |= (stage.view(np.uint32) & v.view(np.uint32)).any(-1)
                else:
                    flag |= (stage & v).any(-1)
            observed[y0:y0 + rows, x0:x0 + cols] = flag
            counts[y0:y0 + rows, bx] = flag.sum(1)
    assert (counts >= 0).all()
    return observed, counts


def _popc(x):
    return bin(int(x)).count("1")


def _emulated_select(masks, valid, proj, observed, counts, s):
    """The select pass, one row at a time: the counts of the rows above
    (a contiguous prefix of y K ints), the row's flags as 32-bit ballot
    words and each word's first rank, each observed pixel's slot, then per
    filled slot the covering count from ballots of 32 masks and the row."""
    h, w, n = masks.shape
    slots = -(-w // s)
    words = -(-w // 32)
    flat = counts.reshape(-1)
    seg = np.full(h * slots, -99, np.int32)
    aug = np.full((h * slots, n + 1), np.nan, F32)
    for y in range(h):
        row_start = int(flat[:y * counts.shape[1]].sum())
        t0 = (-row_start) % s
        bits = [0] * words
        for x in range(w):
            if observed[y, x]:
                bits[x // 32] |= 1 << (x % 32)
        rank0 = np.concatenate([[0], np.cumsum([_popc(b) for b in bits])])
        slot_col = np.full(slots, -1)
        for x in range(w):
            if (bits[x // 32] >> (x % 32)) & 1:
                k = int(rank0[x // 32]) + \
                    _popc(bits[x // 32] & ((1 << (x % 32)) - 1)) - t0
                if k >= 0 and k % s == 0 and k // s < slots:
                    slot_col[k // s] = x
        for j, x in enumerate(slot_col):
            row = y * slots + j
            if x < 0:
                seg[row], aug[row] = -1, 0.0
                continue
            m = masks[y, x] & valid
            c = sum(int(m[k0:k0 + 32].sum()) for k0 in range(0, n, 32))
            seg[row] = proj[y, x]
            aug[row, :n] = np.where(m, F32(1) / F32(c), F32(0))
            aug[row, n] = 1.0
    assert not np.isnan(aug).any() and (seg >= -1).all()
    return seg, aug


FULL_ROWS = (2, 5)          # rows the all-ones band of mask 0 covers
EMPTY_ROWS = (14, 17)       # rows no valid mask reaches
H, W = 24, 72               # three tiles a row, the last of 8 columns


def _fused_inputs(seed, n):
    """n masks and boxes (slice 4's paste inputs: one covering the image,
    three outside it), mask 0 an all-ones band over FULL_ROWS, a quarter
    of the detections invalid and every detection near EMPTY_ROWS too;
    one cell id a pixel, shuffled."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, 28, 28).astype(F32)
    x0, y0 = rng.uniform(-30, W - 5, n), rng.uniform(-30, H - 5, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, 40, n),
                      y0 + rng.uniform(2, 30, n)], 1).astype(F32)
    if n >= 4:
        boxes[1:4] = [[W + 10.0, 5.0, W + 30.0, 20.0], [5.0, -40.0, 30.0, -12.0],
                      [-50.0, H + 4.0, -20.0, H + 20.0]]
    probs[0] = 1.0
    boxes[0] = [-1.0, 1.0, W + 1.0, 6.0]
    near = (boxes[:, 1] < EMPTY_ROWS[1] + 3) & (boxes[:, 3] > EMPTY_ROWS[0] - 3)
    valid = (rng.rand(n) > 0.25) & ~near
    valid[0] = True
    proj = rng.permutation(H * W).astype(np.int32).reshape(H, W)
    return probs, boxes, valid, proj


FUSED_CASES = [(12, 0.5), (7, 0.5), (130, 0.5), (12, 0.0), (1, 0.5)]


@pytest.mark.parametrize("n,threshold", FUSED_CASES)
def test_emulated_fused_selection_vs_plain_and_two_pass(n, threshold):
    """Flags from the paste's stored values, then the select pass on them:
    equal to the plain selection and to slice 3's two-pass emulation,
    with a full row and an empty row (threshold 0 observes every pixel),
    invalid detections, N % 4 != 0 and two passes of masks."""
    probs, boxes, valid, proj = _fused_inputs(90 + n, n)
    masks, _ = _emulated_paste(probs, boxes, H, W, threshold,
                               pixel_major=True)
    observed, counts = _emulated_epilogue(masks, valid)
    assert np.array_equal(observed, (masks & valid).any(-1))
    assert np.array_equal(counts.sum(1), observed.sum(1))
    if threshold > 0:
        assert observed[FULL_ROWS[0]:FULL_ROWS[1]].all()
        assert not observed[EMPTY_ROWS[0]:EMPTY_ROWS[1]].any()
    else:
        assert observed.all()
    for s in (8, 3):
        seg, aug = _emulated_select(masks, valid, proj, observed, counts, s)
        seg_p, aug_p = tmem.write_select_plain(T(masks), T(valid), T(proj),
                                               s, T(observed), T(counts))
        assert np.array_equal(seg, _np(seg_p))
        assert np.array_equal(aug, _np(aug_p))
        seg_2, aug_2 = _emulated_write_select(masks, valid, proj, s)
        assert np.array_equal(seg, seg_2) and np.array_equal(aug, aug_2)


@pytest.mark.parametrize("n,threshold", FUSED_CASES)
@pytest.mark.parametrize("selection", ["emulated", "plain"])
def test_memory_write_through_fused_selection_vs_jax(monkeypatch, n,
                                                     threshold, selection):
    """The memory write on the paste's flags against JAX's exact write,
    bit for bit: identity features and one cell a pixel make each cell's
    update exactly the selected pixel's weight row."""
    probs, boxes, valid, proj = _fused_inputs(90 + n, n)
    masks, _ = _emulated_paste(probs, boxes, H, W, threshold,
                               pixel_major=True)
    observed, counts = _emulated_epilogue(masks, valid)
    if selection == "emulated":
        def emulated(m, v, p, s, observed=None, row_counts=None):
            assert observed is not None and row_counts is not None
            seg, aug = _emulated_select(_np(m), _np(v), _np(p),
                                        _np(observed), _np(row_counts), s)
            return T(seg), T(aug)

        monkeypatch.setattr(tmem, "write_select", emulated)
    feats = np.eye(n, dtype=F32)
    cells = H * W
    got = tmem.memory_write(T(feats), T(masks), T(valid), T(proj), cells,
                            subsample=8, exact_subsample=True,
                            pixel_major=True, observed=T(observed),
                            row_counts=T(counts))
    want = jmem.memory_write(jnp.asarray(feats), jnp.asarray(masks),
                             jnp.asarray(valid), jnp.asarray(proj), cells,
                             subsample=8, exact_subsample=True,
                             pixel_major=True)
    assert np.array_equal(_np(got.features_update),
                          np.asarray(want.features_update))
    assert np.array_equal(_np(got.obs_update), np.asarray(want.obs_update))
    written = np.abs(np.asarray(want.features_update)).sum(1) > 0
    assert written.sum() == -(-observed.sum() // 8)


def test_cpu_paste_masks_observed_is_the_plain_paste_and_its_flags():
    probs, boxes, valid, _ = _fused_inputs(95, 12)
    before = tmask.paste_masks.launches
    masks, observed, counts = tmask.paste_masks_observed(
        T(probs), T(boxes), T(valid), H, W)
    assert tmask.paste_masks.launches == before
    plain = tmask.paste_masks_plain(T(probs), T(boxes), H, W,
                                    pixel_major=True)
    assert torch.equal(masks, plain)
    assert torch.equal(observed, (plain & T(valid)).any(-1))
    assert counts.dtype == torch.int32 and counts.shape == (H, 1)
    assert torch.equal(counts[:, 0], observed.sum(1, dtype=torch.int32))


# ---------------------------------------------------- wrappers

def _card(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load",
                        lambda name: lambda *a: calls.append((name, a)) or 0)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    return calls


def test_paste_wrappers_pass_the_epilogue_buffers(monkeypatch):
    calls = _card(monkeypatch)
    probs, boxes, valid, _ = _fused_inputs(96, 12)
    valid = T(valid)
    before = tmask.paste_masks.launches
    masks, observed, counts = tmask.paste_masks_observed(
        T(probs), T(boxes), valid, H, W)
    bare = tmask.paste_masks(T(probs), T(boxes), H, W, pixel_major=True)
    assert tmask.paste_masks.launches == before + 2
    (name, fused), (_, plain) = calls
    assert name == "mask_paste"
    assert masks.shape == bare.shape == (H, W, 12)
    assert observed.shape == (H, W) and observed.dtype == torch.bool
    assert counts.shape == (H, 3) and counts.dtype == torch.int32
    assert fused[2] == masks.data_ptr() and fused[9] == 1
    assert fused[10:13] == (valid.data_ptr(), observed.data_ptr(),
                            counts.data_ptr())
    assert plain[10:13] == (0, 0, 0)
    assert len(fused) == len(build.ENTRY_POINTS["mask_paste"][1])


@pytest.mark.parametrize("bad", ["threshold", "valid_dtype", "valid_shape"])
def test_paste_masks_observed_checks_its_inputs(monkeypatch, bad):
    probs, boxes, valid, _ = _fused_inputs(97, 12)
    probs, boxes, valid = T(probs), T(boxes), T(valid)
    threshold = 0.5
    if bad == "threshold":
        threshold = -1.0
        with pytest.raises(ValueError, match="threshold"):
            tmask.paste_masks_observed(probs, boxes, valid, H, W, threshold)
    elif bad == "valid_dtype":
        valid = valid.to(torch.uint8)
    else:
        valid = valid[:-1]
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"{name} was loaded for bad inputs"))
    with pytest.raises(ValueError):
        tmask.paste_masks_observed(probs, boxes, valid, H, W, threshold)


def test_write_select_passes_the_flags_or_its_scratch(monkeypatch):
    calls = _card(monkeypatch)
    probs, boxes, valid, proj = _fused_inputs(98, 12)
    masks, _ = _emulated_paste(probs, boxes, H, W, 0.5, pixel_major=True)
    observed, counts = _emulated_epilogue(masks, valid)
    args = (T(masks), T(valid), T(proj), 8)
    before = tmem.write_select.launches
    flags = (T(observed), T(counts))
    tmem.write_select(*args, *flags)
    tmem.write_select(*args)
    assert tmem.write_select.launches == before + 2
    (_, given), (_, scratch) = calls
    assert given[3] == flags[0].data_ptr() and given[4] == flags[1].data_ptr()
    assert given[7:13] == (H, W, 12, 8, 3, 1)
    assert scratch[3] not in (0, flags[0].data_ptr())
    assert scratch[7:13] == (H, W, 12, 8, 1, 0)
    assert len(given) == len(build.ENTRY_POINTS["write_select"][1])


@pytest.mark.parametrize("bad", ["observed_alone", "counts_alone",
                                 "observed_dtype", "observed_shape",
                                 "counts_dtype", "counts_rows"])
def test_write_select_checks_the_flags(monkeypatch, bad):
    probs, boxes, valid, proj = _fused_inputs(99, 12)
    masks, _ = _emulated_paste(probs, boxes, H, W, 0.5, pixel_major=True)
    observed, counts = (T(x) for x in _emulated_epilogue(masks, valid))
    flags = {"observed_alone": (observed, None),
             "counts_alone": (None, counts),
             "observed_dtype": (observed.to(torch.uint8), counts),
             "observed_shape": (observed[:, :-1].contiguous(), counts),
             "counts_dtype": (observed, counts.long()),
             "counts_rows": (observed, counts[:-1])}[bad]
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"{name} was loaded for bad inputs"))
    with pytest.raises(ValueError, match="write_select"):
        tmem.write_select(T(masks), T(valid), T(proj), 8, *flags)


def _backward_call(c=8, size=7, side=16, offset=0):
    shapes = [(side, 24), (8, 12), (4, 6)]
    r = 3
    base = torch.ones(r * size * size * c + offset)
    grad = base[offset:].view(r, size, size, c)
    boxes = T(np.array([[0, 0, 40, 40], [10, 10, 100, 90],
                        [5, 5, 190, 120]], F32))
    return lambda: troi.roi_align_backward_cuda(
        grad, shapes, boxes, torch.zeros(r, dtype=torch.int32), STRIDES, 2,
        torch.float32), grad


@pytest.mark.parametrize("bad", [dict(c=12), dict(size=29), dict(side=1025)])
def test_backward_wrapper_checks_the_new_geometry(monkeypatch, bad):
    """16-byte vectors of channels, the staged gradient slab (S <= 20) and
    the bitmaps' level sides (<= 1024)."""
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"{name} was loaded for bad inputs"))
    call, _ = _backward_call(**bad)
    with pytest.raises(ValueError, match="roi_align_backward"):
        call()


def test_backward_wrapper_aligns_grad_out(monkeypatch):
    """A gradient 4 bytes off a 16-byte boundary is copied before the
    kernel reads it in 16-byte vectors; an aligned one is passed as is."""
    calls = _card(monkeypatch)
    for offset in (1, 0):
        call, grad = _backward_call(offset=offset)
        before = troi.roi_align_backward_cuda.launches
        out = call()
        assert troi.roi_align_backward_cuda.launches == before + 1
        ptr = calls[-1][1][7]
        assert ptr % 16 == 0 and (ptr == grad.data_ptr()) == (offset == 0)
        assert [tuple(g.shape) for g in out] == [(16, 24, 8), (8, 12, 8),
                                                 (4, 6, 8)]


def test_slice6_kernel_sources():
    roi_src = (build.CSRC / "roi_align.cu").read_text()
    for note in ("float4 atomicAdd", "sample_table", "sorted by slot",
                 "in registers", "What bounds it on Hopper, backward",
                 "__fdiv_rn(f[q], ss)", "struct Entry"):
        assert note in roi_src
    assert f"kBwdSlab = {BWD_SLAB};" in roi_src
    assert f"kMaxAxis = {MAX_AXIS};" in roi_src
    # each contribution is the tap form's product, added unfused
    assert "acc[h2].x = __fadd_rn(acc[h2].x, __fmul_rn(gv.x, wt));" in \
        roi_src
    assert "const float wt = __fmul_rn(ey.w, ex.w);" in roi_src
    paste_src = (build.CSRC / "mask_paste.cu").read_text()
    for note in ("observed[y, x] = any_n(out[y, x, n] && valid[n])",
                 "__ballot_sync", "tile_counts", "nobody zeroes them"):
        assert note in paste_src
    select_src = (build.CSRC / "write_select.cu").read_text()
    for note in ("count_cols", "flags_given", "__ballot_sync", "select pass",
                 "What bounds it on Hopper"):
        assert note in select_src
    assert tmask.TILE_COLS == TILE_COLS


# ---------------------------------------------------- the training guard

def _bad_chunk(cfg, value):
    rng = np.random.RandomState(12)
    t, g, h, w = 2, 4, cfg.input.height, cfg.input.width
    proj = rng.randint(0, cfg.memory.max_cells, (t, h, w)).astype(np.int32)
    proj[1, 3, 5] = value
    boxes = np.tile(np.array([[4.0, 4.0, 40.0, 30.0]], F32), (t, g, 1))
    return ChunkRecord(
        sequence_name="bad", images=rng.randint(0, 255, (t, h, w, 3)),
        proj_indices=proj, frame_valid=np.ones(t, bool), gt_boxes=boxes,
        gt_classes=np.zeros((t, g), np.int32), gt_valid=np.ones((t, g), bool))


@pytest.mark.parametrize("source", ["chunks", "batch_fn"])
@pytest.mark.parametrize("bad", ["negative", "max_cells"])
def test_train_raises_on_cell_ids_outside_the_memory(tmp_path, source, bad):
    """A batch holding a cell id of -1 or of memory.max_cells stops the
    loop before any step, whether it comes from chunks or a batch_fn: the
    batched memory read takes only ids in [0, cells)."""
    cfg = _config(tmp_path)
    value = -1 if bad == "negative" else cfg.memory.max_cells
    model = build_detector(cfg, seed=0, device="cpu")
    dataset, batch_fn = None, None
    if source == "chunks":
        dataset = [_bad_chunk(cfg, value)]
    else:
        make = synthetic_batch_fn(cfg, 2, 1)

        def batch_fn(it, rng, dp):
            batch = make(it, rng, dp)
            batch.proj_indices[0, 3, 5] = value
            return batch
    with pytest.raises(ValueError, match="< 0" if bad == "negative"
                       else "max_cells"):
        train(model, cfg, dataset, ZS, max_iter=1, log_period=1, seed=5,
              verbose=False, batch_fn=batch_fn)
