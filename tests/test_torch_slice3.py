"""Slice 3 of the port on the CPU: the write-selection, batched memory-read
and ROIAlign-backward kernels' algorithms, the plain backward, and the
wrappers.

The CUDA kernels have no CPU build, so their algorithms are emulated here
in numpy, step for step, and held against the JAX package:

  * write selection (`csrc/write_select.cu`): the observed flags with the
    kernel's 32-bit word tests, the row counts, each row's start as the
    sum of the counts above, the per-row rank scan and the slots filled
    by rank, then the [J, N + 1] rows; exact against the port's plain
    version and the reference's "every 8th of the compacted observed
    pixels", and the memory write through it against JAX's
  * batched memory read (`csrc/memory_read.cu` with a batch): frame b
    reads rows b * cells + id; exact against JAX's `memory_read_batched`
    on values whose sums are exact in any order
  * ROIAlign backward (`csrc/roi_align.cu`'s backward): every tap's
    contribution (grad / s^2) * weight added into an f32 accumulator,
    within contributions x 2^-24 x sum|contribution| of the port's plain
    v1 autograd (the same taps and weights), and within rtol 1e-5 of
    `jax.vjp` (XLA may round the sample coordinates differently, as for
    the forward in tests/test_torch_slice2.py)

The plain v1 and v4 backward (torch autograd) are held to `jax.vjp` of the
JAX function of the same impl. The kernels themselves are held against the
plain versions on the card in tests/test_torch_kernels.py and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.ops import memory_ops as jmem
from embodied_object_detection_tpu.ops import roi_align as jroi

from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.ops import mask_paste as tmask
from embodied_object_detection_tpu_torch.ops import memory_ops as tmem
from embodied_object_detection_tpu_torch.ops import roi_align as troi

T = torch.from_numpy
F32 = np.float32
STRIDES = (8, 16, 32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------- write selection (7)

def _emulated_write_select(masks, valid, proj, s):
    """The two passes of the write-selection kernel."""
    h, w, n = masks.shape
    # pass 1: observed flags (32-bit word ANDs when N % 4 == 0), row counts
    if n % 4 == 0:
        words = np.ascontiguousarray(masks).view(np.uint32)
        vwords = np.ascontiguousarray(valid).view(np.uint32)
        observed = (words & vwords[None, None, :]).any(-1)
    else:
        observed = (masks & valid[None, None, :]).any(-1)
    row_count = observed.sum(1)
    # pass 2, per row: start, rank scan, slots by rank, then the rows
    slots = -(-w // s)
    seg = np.full(h * slots, -1, np.int32)
    aug = np.zeros((h * slots, n + 1), F32)
    for y in range(h):
        row_start = int(row_count[:y].sum())
        t0 = (-row_start) % s
        slot_col = np.full(slots, -1)
        rank = 0
        for x in range(w):
            if observed[y, x]:
                k = rank - t0
                if k >= 0 and k % s == 0 and k // s < slots:
                    slot_col[k // s] = x
                rank += 1
        for j, x in enumerate(slot_col):
            if x < 0:
                continue
            m = masks[y, x] & valid
            seg[y * slots + j] = proj[y, x]
            aug[y * slots + j, :n] = np.where(m, F32(1) / F32(m.sum()),
                                              F32(0))
            aug[y * slots + j, n] = 1.0
    return seg, aug


def _pasted_masks(seed, n=12, h=24, w=40):
    """Pixel-major masks pasted from random 28 x 28 probabilities (as the
    write gets them), with a row no mask covers and a row every mask
    covers."""
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, 28, 28).astype(F32)
    x0, y0 = rng.uniform(-8, w - 8, n), rng.uniform(-8, h - 8, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 30, n),
                      y0 + rng.uniform(4, 20, n)], 1).astype(F32)
    masks = _np(tmask.paste_masks(T(probs), T(boxes), h, w, 0.5,
                                  pixel_major=True)).copy()
    masks[3] = False
    masks[5] = True
    valid = rng.rand(n) > 0.25
    proj = rng.randint(0, 50, (h, w)).astype(np.int32)
    return masks, valid, proj


@pytest.mark.parametrize("n,s", [(12, 8), (12, 3), (7, 8)])
def test_emulated_write_select_vs_plain_and_reference(n, s):
    masks, valid, proj = _pasted_masks(30 + n, n=n)
    seg, aug = _emulated_write_select(masks, valid, proj, s)
    seg_p, aug_p = tmem.write_select_plain(T(masks), T(valid), T(proj), s)
    assert np.array_equal(seg, _np(seg_p))
    assert np.array_equal(aug, _np(aug_p))
    # the reference's selection: every s-th pixel of the row-major
    # compacted set of observed pixels
    observed = (masks & valid).any(-1)
    chosen = np.flatnonzero(observed.reshape(-1))[::s]
    filled = aug[:, -1] == 1
    assert filled.sum() == len(chosen)
    assert np.array_equal(np.sort(seg[filled]),
                          np.sort(proj.reshape(-1)[chosen]))
    assert observed[5].any() and not observed[3].any()


def test_memory_write_through_emulated_selection_vs_jax(monkeypatch):
    masks, valid, proj = _pasted_masks(40)
    cells = 50
    feats = (np.random.RandomState(41).randn(len(valid), 16) * 50
             ).astype(F32)

    def emulated(m, v, p, s):
        seg, aug = _emulated_write_select(_np(m), _np(v), _np(p), s)
        return T(seg), T(aug)

    monkeypatch.setattr(tmem, "write_select", emulated)
    got = tmem.memory_write(T(feats), T(masks), T(valid), T(proj), cells,
                            subsample=8, exact_subsample=True,
                            pixel_major=True)
    want = jmem.memory_write(jnp.asarray(feats), jnp.asarray(masks),
                             jnp.asarray(valid), jnp.asarray(proj), cells,
                             subsample=8, exact_subsample=True,
                             pixel_major=True)
    # the selection is exact; the segment-sum and the [cells, N] x [N, D]
    # product may sum in another order
    np.testing.assert_allclose(_np(got.features_update),
                               np.asarray(want.features_update),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(_np(got.obs_update), np.asarray(want.obs_update))
    assert np.abs(np.asarray(want.features_update)).max() > 0


# ---------------------------------------------------- batched read (6)

def _emulated_read_batched(features, obs, proj, pool=4):
    """Frame b's ids offset by b * cells into the flattened table; each
    output cell the f32 mean of its pool x pool bf16-rounded rows."""
    b, cells, d = features.shape
    h, w = proj.shape[1:]
    denom = np.where(obs > 1, obs, F32(1)).reshape(-1)
    table = features.reshape(-1, d) / denom[:, None]
    table = np.asarray(jnp.asarray(table).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    out = np.zeros((b, h // pool, w // pool, d), F32)
    for i in range(b):
        ids = proj[i] + i * cells
        for oy in range(h // pool):
            for ox in range(w // pool):
                win = ids[oy * pool:(oy + 1) * pool, ox * pool:(ox + 1) * pool]
                acc = np.zeros(d, F32)
                for t in win.reshape(-1):
                    acc = acc + table[t]
                out[i, oy, ox] = acc / F32(pool * pool)
    return out


def test_emulated_batched_read_index_offset_vs_jax_exact():
    """Small-integer features and power-of-two counts: every sum is exact
    in any order, so a wrong id offset is the only way to differ."""
    rng = np.random.RandomState(42)
    b, cells, d = 3, 20, 8
    feats = rng.randint(-8, 9, (b, cells, d)).astype(F32)
    obs = rng.choice([0.0, 1.0, 2.0, 4.0], (b, cells)).astype(F32)
    proj = rng.randint(0, cells, (b, 8, 12)).astype(np.int32)
    want = np.asarray(jmem.memory_read_batched(
        jnp.asarray(feats), jnp.asarray(obs), jnp.asarray(proj)))
    assert np.array_equal(_emulated_read_batched(feats, obs, proj), want)
    got = tmem.memory_read_batched(T(feats), T(obs), T(proj))
    assert np.array_equal(_np(got), want)
    singles = np.stack([_np(tmem.memory_read(T(feats[i]), T(obs[i]),
                                             T(proj[i]))) for i in range(b)])
    assert np.array_equal(singles, want)


def test_plain_batched_read_vs_jax_and_single_reads():
    rng = np.random.RandomState(43)
    b, cells, d = 2, 64, 32
    feats = (rng.randn(b, cells, d) * 5).astype(F32)
    obs = rng.choice([0.0, 1.0, 3.0], (b, cells)).astype(F32)
    proj = rng.randint(0, cells, (b, 16, 24)).astype(np.int32)
    got = _np(tmem.memory_read_batched(T(feats), T(obs), T(proj)))
    want = np.asarray(jmem.memory_read_batched(
        jnp.asarray(feats), jnp.asarray(obs), jnp.asarray(proj)))
    # the same bf16 rounding per tap; the 16-term f32 mean may sum in
    # another order
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for i in range(b):
        assert np.array_equal(got[i], _np(tmem.memory_read(
            T(feats[i]), T(obs[i]), T(proj[i]))))


# ---------------------------------------------------- ROIAlign backward (4b)

def _roi_inputs(seed, r=6, c=8):
    """p3-p5 of a 128 x 192 image and boxes from 1 px to past the image
    (so all three levels are assigned and borders are crossed)."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(h, w, c).astype(F32)
             for h, w in ((16, 24), (8, 12), (4, 6))]
    side = np.exp(rng.uniform(0, np.log(900), r))
    cx, cy = rng.uniform(-20, 210, r), rng.uniform(-20, 150, r)
    boxes = np.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                      cy + side / 2], 1).astype(F32)
    return feats, boxes


def _emulated_roi_align_backward(shapes, c, boxes, lvl, grad, out, s):
    """The backward kernel: per (ROI, output row) the forward's sample
    positions, taps and weights (true f32 divisions), then for every tap
    of nonzero weight (grad / s^2) * weight added into the level's f32
    accumulator. Also returns, per level position, the number of
    contributions and the sum of their magnitudes."""
    acc = [np.zeros((h, w, c), F32) for h, w in shapes]
    count = [np.zeros((h, w), np.int64) for h, w in shapes]
    mag = [np.zeros((h, w, c), np.float64) for h, w in shapes]
    grid = (np.arange(out * s, dtype=F32) + F32(0.5)) / F32(s)
    for i in range(len(boxes)):
        li = lvl[i]
        h, w = shapes[li]
        st = F32(STRIDES[li])
        x1, y1 = boxes[i, 0] / st, boxes[i, 1] / st
        bin_w = (boxes[i, 2] / st - x1) / F32(out)
        bin_h = (boxes[i, 3] / st - y1) / F32(out)
        sx = (x1 + grid * bin_w) - F32(0.5)
        sy = (y1 + grid * bin_h) - F32(0.5)

        def axis(v, size):
            ok = (v >= -1) & (v <= size)
            v = np.minimum(np.maximum(v, F32(0)), F32(size - 1))
            i0 = np.floor(v)
            frac = (v - i0).astype(F32)
            i0 = i0.astype(int)
            return i0, np.minimum(i0 + 1, size - 1), F32(1) - frac, frac, ok

        xi0, xi1, xlo, xhi, xok = axis(sx, w)
        yi0, yi1, ylo, yhi, yok = axis(sy, h)
        for py in range(out * s):
            for px in range(out * s):
                okf = F32(yok[py] and xok[px])
                g = grad[i, py // s, px // s] / F32(s * s)
                for yy, xx, wt in (
                        (yi0[py], xi0[px], ylo[py] * xlo[px] * okf),
                        (yi0[py], xi1[px], ylo[py] * xhi[px] * okf),
                        (yi1[py], xi0[px], yhi[py] * xlo[px] * okf),
                        (yi1[py], xi1[px], yhi[py] * xhi[px] * okf)):
                    if wt == 0:
                        continue
                    contrib = g * wt
                    acc[li][yy, xx] = acc[li][yy, xx] + contrib
                    count[li][yy, xx] += 1
                    mag[li][yy, xx] += np.abs(contrib)
    return acc, count, mag


def _jax_vjp(feats, boxes, grad, out, impl):
    _, vjp = jax.vjp(lambda *f: jroi.multilevel_roi_align(
        list(f), jnp.asarray(boxes), strides=STRIDES, output_size=out,
        sampling_ratio=2, impl=impl), *[jnp.asarray(f) for f in feats])
    return [np.asarray(g) for g in vjp(jnp.asarray(grad))]


@pytest.mark.parametrize("out", [7, 14])
def test_emulated_roi_align_backward_vs_jax_vjp(out):
    feats, boxes = _roi_inputs(44, r=12)
    lvl = _np(troi.assign_levels(T(boxes), 3, 5)) - 3
    assert set(lvl.tolist()) == {0, 1, 2}
    grad = np.random.RandomState(45).randn(len(boxes), out, out,
                                           8).astype(F32)
    acc, count, mag = _emulated_roi_align_backward(
        [f.shape[:2] for f in feats], 8, boxes, lvl, grad, out, 2)
    leaves = [T(f).requires_grad_(True) for f in feats]
    plain = torch.autograd.grad(troi.multilevel_roi_align(
        leaves, T(boxes), STRIDES, out, 2, impl="v1"), leaves, T(grad))
    for a, n, m, p in zip(acc, count, mag, plain):
        bound = n[..., None] * 2.0 ** -24 * m
        assert (np.abs(a - _np(p)) <= bound).all()
    assert max(n.max() for n in count) > 4
    want = _jax_vjp(feats, boxes, grad, out, "v1")
    scale = max(np.abs(w).max() for w in want)
    for a, w in zip(acc, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("impl", ["v1", "v4"])
def test_plain_roi_align_backward_vs_jax_vjp(impl):
    feats, boxes = _roi_inputs(46)
    grad = np.random.RandomState(47).randn(len(boxes), 7, 7, 8).astype(F32)
    leaves = [T(f).requires_grad_(True) for f in feats]
    out = troi.multilevel_roi_align(leaves, T(boxes), STRIDES, 7, 2,
                                    impl=impl)
    got = torch.autograd.grad(out, leaves, T(grad))
    want = _jax_vjp(feats, boxes, grad, 7, impl)
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-6 * scale)


def test_card_autograd_path_wires_the_backward(monkeypatch):
    """On a card tensor under autograd, the pooler runs RoiAlignFunction:
    the forward kernel, then the backward kernel on the output's
    gradient, the level gradients cast to the levels' type and none for
    the boxes. Both kernels stand in as their emulations here."""
    feats, boxes = _roi_inputs(48)
    grad = np.random.RandomState(49).randn(len(boxes), 7, 7, 8).astype(F32)
    calls = []

    def forward(features, b, lvl, strides, size, s):
        calls.append("forward")
        return troi._roi_align_taps(features, b, strides, size, s, lvl)

    def backward(g, shapes, b, lvl, strides, s, dtype):
        calls.append("backward")
        acc, _, _ = _emulated_roi_align_backward(
            shapes, g.shape[-1], _np(b), _np(lvl), _np(g), g.shape[1], s)
        return tuple(T(a).to(dtype) for a in acc)

    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(troi, "roi_align_cuda", forward)
    monkeypatch.setattr(troi, "roi_align_backward_cuda", backward)
    leaves = [T(f).requires_grad_(True) for f in feats]
    b = T(boxes).requires_grad_(True)
    out = troi.multilevel_roi_align(leaves, b, STRIDES, 7, 2)
    got = torch.autograd.grad(out, leaves + [b], T(grad), allow_unused=True)
    assert calls == ["forward", "backward"]
    assert got[-1] is None                       # boxes take no gradient
    want = _jax_vjp(feats, boxes, grad, 7, "v1")
    for g, w in zip(got[:-1], want):
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():                        # no autograd: no Function
        troi.multilevel_roi_align(leaves, b, STRIDES, 7, 2)
    assert calls == ["forward", "backward", "forward"]


# ---------------------------------------------------- wrappers

def _select_args():
    masks, valid, proj = _pasted_masks(50)
    return T(masks), T(valid), T(proj)


def _call(kernel):
    if kernel == "write_select":
        args = _select_args()
        return lambda: tmem.write_select(*args, 8)
    if kernel == "memory_read_batched":
        return lambda: tmem.memory_read_batched(
            torch.ones((2, 16, 8)), torch.ones((2, 16)),
            torch.zeros((2, 8, 8), dtype=torch.int32))
    feats, boxes = _roi_inputs(51)
    return lambda: troi.roi_align_backward_cuda(
        torch.ones((len(boxes), 7, 7, 8)), [f.shape[:2] for f in feats],
        T(boxes), torch.zeros(len(boxes), dtype=torch.int32), STRIDES, 2,
        torch.float32)


KERNELS = ("write_select", "memory_read_batched", "roi_align_backward")


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_raises_instead_of_falling_back(monkeypatch, kernel):
    call = _call(kernel)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "on_card", lambda t: True)
    for name in ("write_select_plain", "memory_read_batched_plain"):
        monkeypatch.setattr(tmem, name, lambda *a, **k: pytest.fail(
            "fell back to the plain version"))
    wrapper = {"write_select": tmem.write_select,
               "memory_read_batched": tmem.memory_read_batched,
               "roi_align_backward": troi.roi_align_backward_cuda}[kernel]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert wrapper.launches == before


@pytest.mark.parametrize("bad", ["masks_dtype", "valid_shape", "proj_dtype",
                                 "read_shape", "read_proj", "grad_dtype",
                                 "levels_ids"])
def test_wrapper_checks_inputs_before_launch(monkeypatch, bad):
    masks, valid, proj = _select_args()
    feats, boxes = _roi_inputs(52)
    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(
        f"{name} was loaded for bad inputs"))
    shapes = [f.shape[:2] for f in feats]
    calls = {
        "masks_dtype": lambda: tmem.write_select(masks.float(), valid, proj,
                                                 8),
        "valid_shape": lambda: tmem.write_select(masks, valid[:-1], proj, 8),
        "proj_dtype": lambda: tmem.write_select(masks, valid, proj.long(),
                                                8),
        "read_shape": lambda: tmem.memory_read_batched(
            torch.ones((16, 8)), torch.ones((16,)),
            torch.zeros((8, 8), dtype=torch.int32)),
        "read_proj": lambda: tmem.memory_read_batched(
            torch.ones((2, 16, 8)), torch.ones((2, 16)),
            torch.zeros((3, 8, 8), dtype=torch.int32)),
        "grad_dtype": lambda: troi.roi_align_backward_cuda(
            torch.ones((len(boxes), 7, 7, 8), dtype=torch.float64), shapes,
            T(boxes), torch.zeros(len(boxes), dtype=torch.int32), STRIDES, 2,
            torch.float32),
        "levels_ids": lambda: troi.roi_align_backward_cuda(
            torch.ones((len(boxes), 7, 7, 8)), shapes, T(boxes),
            torch.zeros(len(boxes), dtype=torch.int64), STRIDES, 2,
            torch.float32),
    }
    with pytest.raises(ValueError):
        calls[bad]()
