"""Slice 2 of the port on the CPU: the NMS, ROIAlign and mask-paste
kernels' algorithms and their wrappers.

The CUDA kernels have no CPU build, so their algorithms are emulated here
in numpy, operation for operation, and held against the JAX package:

  * NMS: the 64-bit-word IoU bitmask and the row-block sweep of
    `csrc/nms.cu`, plugged into the port's `nms_padded` and
    `multiclass_nms` in place of the keep-set kernel; keep sets and rows
    must equal the JAX package's exactly
  * ROIAlign: the per-sample coordinates, taps and weights of
    `csrc/roi_align.cu`, against the JAX tap form (impl="v1")
  * mask paste: the direct 2 x 2-tap evaluation of `csrc/mask_paste.cu`,
    against the JAX separable products, flips at 0.5 counted and bounded

and the wrappers take the plain version on a CPU tensor, check their
inputs before a launch, and raise rather than fall back when the card is
missing. The kernels themselves are held against the plain versions on
the card in tests/test_torch_kernels.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_object_detection_tpu.ops import mask_paste as jmask
from embodied_object_detection_tpu.ops import nms as jnms
from embodied_object_detection_tpu.ops import roi_align as jroi

from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.ops import mask_paste as tmask
from embodied_object_detection_tpu_torch.ops import nms as tnms
from embodied_object_detection_tpu_torch.ops import roi_align as troi

T = torch.from_numpy
F32 = np.float32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ NMS emulation

def _emulated_mask(boxes, classes, valid, thresh, disabled):
    """The mask kernel: word w of row i holds bit k iff row i suppresses
    column 64 w + k (i < j, both valid, one class, IoU > t), the IoU in
    pairwise_iou's f32 operation order."""
    n = len(boxes)
    words = -(-n // 64)
    x0, y0, x1, y1 = (boxes[:, k] for k in range(4))
    area = np.maximum(x1 - x0, F32(0)) * np.maximum(y1 - y0, F32(0))
    mask = np.zeros((n, words), np.uint64)
    if disabled:
        return mask
    for i in np.flatnonzero(valid):
        w = np.maximum(np.minimum(x1[i], x1) - np.maximum(x0[i], x0), F32(0))
        h = np.maximum(np.minimum(y1[i], y1) - np.maximum(y0[i], y0), F32(0))
        inter = w * h
        union = (area[i] + area) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0,
                           inter / np.maximum(union, F32(1e-12)), F32(0))
        hit = (iou > F32(thresh)) & valid & (classes == classes[i]) & \
            (np.arange(n) > i)
        padded = np.zeros(words * 64, bool)
        padded[:n] = hit
        mask[i] = np.packbits(padded, bitorder="little").view("<u8")
    return mask


def _emulated_sweep(mask, valid):
    """The sweep kernel: per block of 64 rows, a branch-free chain over the
    block's removed word and diagonal words decides the rows, then the
    kept rows' words right of the diagonal are OR-ed into the removed set."""
    n, words = mask.shape
    removed = [0] * words
    keep = np.zeros(n, bool)
    for b in range(words):
        row0 = 64 * b
        rows = min(64, n - row0)
        vb = sum(1 << r for r in range(rows) if valid[row0 + r])
        cur, kb = removed[b], 0
        for r in range(64):
            d = int(mask[row0 + r, b]) if r < rows else 0
            k = ((vb & ~cur) >> r) & 1
            kb |= k << r
            cur |= d if k else 0
        for r in range(rows):
            if (kb >> r) & 1:
                keep[row0 + r] = True
                for w in range(b + 1, words):
                    removed[w] |= int(mask[row0 + r, w])
    return keep


def _emulated_keep(boxes_s, classes_s, valid_s, iou_threshold,
                   disabled=False):
    b, c, v = _np(boxes_s), _np(classes_s), _np(valid_s)
    mask = _emulated_mask(b, c, v, iou_threshold, disabled)
    return T(_emulated_sweep(mask, v))


@pytest.fixture
def bitmask_nms(monkeypatch):
    """Run the port's NMS entry points through the kernel's algorithm."""
    monkeypatch.setattr(tnms, "nms_keep", _emulated_keep)


def _nms_inputs(seed, n, ties, classes=1):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 120, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))],
                           1).astype(F32)
    scores = rng.rand(n).astype(F32)
    if ties:
        scores = np.round(scores * 4) / 4           # many exactly tied scores
        boxes[1::5] = boxes[0::5][: len(boxes[1::5])]   # duplicated boxes
    valid = rng.rand(n) > 0.1
    return boxes, scores, valid, rng.randint(0, classes, n).astype(np.int32)


def _chain(n=150, shift=25.0, width=100.0):
    """A suppression chain deeper than 64: box i overlaps box i+1 at IoU
    (w - s)/(w + s) = 0.6 and box i+2 at 0.33; scores descend along it, so
    the greedy keep set is every other box."""
    c = np.arange(n)
    boxes = np.stack([c * shift, np.zeros(n), c * shift + width,
                      np.full(n, 50.0)], 1).astype(F32)
    scores = (1.0 - c / n).astype(F32)
    return boxes, scores, np.ones(n, bool)


def _same_detections(got, want):
    for g, w_ in zip(got, want):
        assert (_np(g) == np.asarray(w_)).all()


@pytest.mark.parametrize("n", [60, 64, 130])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thresh,ml", [(0.5, False), (0.9, True),
                                       (0.0, True), (0.0, False)])
def test_bitmask_nms_padded_vs_jax(bitmask_nms, n, ties, thresh, ml):
    boxes, scores, valid, _ = _nms_inputs(n, n, ties)
    got = tnms.nms_padded(T(boxes), T(scores), T(valid), thresh, 40,
                          ml_nms_semantics=ml)
    want = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(valid), thresh, 40,
                           ml_nms_semantics=ml)
    _same_detections(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cap,topk", [(2048, 30), (100, 30), (0, 300)])
def test_bitmask_multiclass_nms_vs_jax(bitmask_nms, ties, cap, topk):
    boxes, _, valid, _ = _nms_inputs(21, 70, ties)
    scores = np.random.RandomState(22).rand(70, 6).astype(F32)
    if ties:
        scores = np.round(scores * 8) / 8
    got, got_rows = tnms.multiclass_nms(T(boxes), T(scores), T(valid), 0.1,
                                        0.5, topk, candidate_cap=cap)
    want, want_rows = jnms.multiclass_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.1,
        0.5, topk, candidate_cap=cap)
    _same_detections(got, want)
    assert (_np(got_rows) == np.asarray(want_rows)).all()


@pytest.mark.parametrize("keep_fn", ["bitmask", "plain"])
def test_chain_deeper_than_64_vs_jax(keep_fn, monkeypatch):
    if keep_fn == "bitmask":
        monkeypatch.setattr(tnms, "nms_keep", _emulated_keep)
    boxes, scores, valid = _chain()
    n = len(boxes)
    got = tnms.nms_padded(T(boxes), T(scores), T(valid), 0.5, n)
    want = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(valid), 0.5, n)
    _same_detections(got, want)
    assert int(got.valid.sum()) == n // 2


def test_emulated_keep_equals_plain_fixpoint_with_classes():
    boxes, scores, valid, classes = _nms_inputs(23, 200, True, classes=3)
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    args = (T(boxes[order]), T(classes[order]), T(valid[order]))
    for thresh in (0.3, 0.7):
        want = tnms.nms_keep_plain(*args, thresh)
        assert torch.equal(_emulated_keep(*args, thresh), want)


# ------------------------------------------------------------ ROIAlign

def _roi_inputs(seed, r=12):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(h, w, 8).astype(F32)
             for h, w in ((16, 24), (8, 12), (4, 6))]
    x0 = rng.uniform(-20, 170, r)
    y0 = rng.uniform(-20, 110, r)
    boxes = np.stack([x0, y0, x0 + rng.uniform(1, 150, r),
                      y0 + rng.uniform(1, 120, r)], 1).astype(F32)
    return feats, boxes


def _emulated_roi_align(feats, boxes, lvl, strides, out, s):
    """The ROIAlign kernel: per (ROI, output row) its sample positions,
    taps and weights with true f32 divisions, 4 taps summed in order, the
    s x s samples summed in order and scaled by 1/s^2."""
    r, c = len(boxes), feats[0].shape[-1]
    res = np.zeros((r, out, out, c), F32)
    grid = (np.arange(out * s, dtype=F32) + F32(0.5)) / F32(s)
    for i in range(r):
        f = feats[lvl[i]]
        h, w = f.shape[:2]
        st = F32(strides[lvl[i]])
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
                taps = ((yi0[py], xi0[px], ylo[py] * xlo[px] * okf),
                        (yi0[py], xi1[px], ylo[py] * xhi[px] * okf),
                        (yi1[py], xi0[px], yhi[py] * xlo[px] * okf),
                        (yi1[py], xi1[px], yhi[py] * xhi[px] * okf))
                v = np.zeros(c, F32)
                for yy, xx, wt in taps:
                    v = v + f[yy, xx] * wt
                res[i, py // s, px // s] += v
    return res * F32(1.0 / (s * s))


@pytest.mark.parametrize("out", [7, 14])
def test_emulated_roi_align_vs_jax_v1(out):
    feats, boxes = _roi_inputs(24, r=6)
    lvl = _np(troi.assign_levels(T(boxes), 3, 5)) - 3
    got = _emulated_roi_align(feats, boxes, lvl, (8, 16, 32), out, 2)
    want = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                     jnp.asarray(boxes), strides=(8, 16, 32),
                                     output_size=out, sampling_ratio=2,
                                     impl="v1")
    # the same taps and weights; the window mean may sum in another order
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ mask paste

def _emulated_paste(probs, boxes, h, w, x_stride=1):
    """The mask-paste kernel, values [N, H, W']: per (mask, row) and (mask,
    column) the hat taps of the pixel centre, then the 2 x 2 taps
    contracted rows first."""
    n, m, _ = probs.shape

    def taps(centre, lo, hi):
        extent = np.maximum(hi - lo, F32(1e-4))
        g = ((centre - lo) / extent) * F32(2) - F32(1)
        src = ((g + F32(1)) * F32(m) - F32(1)) / F32(2)
        inside = (src > -1) & (src < m)
        f = np.floor(np.where(inside, src, 0)).astype(F32)
        w0 = np.maximum(F32(1) - np.abs(src - f), F32(0))
        w1 = np.maximum(F32(1) - np.abs(src - (f + F32(1))), F32(0))
        k = f.astype(int)
        w0 = np.where(inside & (k >= 0), w0, F32(0))
        w1 = np.where(inside & (k + 1 <= m - 1), w1, F32(0))
        return np.maximum(k, 0), np.minimum(k + 1, m - 1), w0, w1

    ys = np.arange(h, dtype=F32) + F32(0.5)
    xs = np.arange(0, w, x_stride, dtype=F32) + F32(0.5)
    out = np.zeros((n, h, len(xs)), F32)
    for i in range(n):
        ya, yb, wy0, wy1 = taps(ys, boxes[i, 1], boxes[i, 3])
        xa, xb, wx0, wx1 = taps(xs, boxes[i, 0], boxes[i, 2])
        mk = probs[i]
        t0 = wy0[:, None] * mk[ya][:, xa] + wy1[:, None] * mk[yb][:, xa]
        t1 = wy0[:, None] * mk[ya][:, xb] + wy1[:, None] * mk[yb][:, xb]
        out[i] = t0 * wx0[None] + t1 * wx1[None]
    return out


@pytest.mark.parametrize("x_stride", [1, 8])
def test_emulated_paste_vs_jax(x_stride):
    rng = np.random.RandomState(25)
    n, h, w = 6, 48, 64
    probs = rng.rand(n, 28, 28).astype(F32)
    x0, y0 = rng.uniform(-10, w - 10, n), rng.uniform(-10, h - 10, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, 40, n),
                      y0 + rng.uniform(2, 30, n)], 1).astype(F32)
    vals = _emulated_paste(probs, boxes, h, w, x_stride)
    want_vals = np.asarray(jmask.paste_masks(
        jnp.asarray(probs), jnp.asarray(boxes), h, w, -1.0,
        x_stride=x_stride))
    np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-6)
    want = np.asarray(jmask.paste_masks(jnp.asarray(probs),
                                        jnp.asarray(boxes), h, w, 0.5,
                                        x_stride=x_stride))
    # at most one flip in 10^4 pixels, and only where the value sits at 0.5
    flipped = (vals >= 0.5) != want
    assert flipped.sum() <= max(1, want.size // 10000)
    assert (np.abs(want_vals[flipped] - 0.5) < 1e-5).all()


# ------------------------------------------------------------ wrappers

def _nms_args(n=10):
    boxes, _, valid, classes = _nms_inputs(26, n, False)
    return T(boxes), T(classes), T(valid)


def _roi_args(dtype=torch.float32):
    feats, boxes = _roi_inputs(27, r=4)
    return [T(f).to(dtype) for f in feats], T(boxes)


def _paste_args():
    rng = np.random.RandomState(28)
    boxes = np.array([[2, 3, 20, 30], [-5, 0, 10, 12]], F32)
    return T(rng.rand(2, 28, 28).astype(F32)), T(boxes)


def _forbid(monkeypatch, module, *names):
    for name in names:
        def plain(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} was called: the wrapper fell back "
                                 "to its plain version")
        monkeypatch.setattr(module, name, plain)


def _call(kernel):
    if kernel == "nms":
        return tnms.nms_keep(*_nms_args(), 0.5)
    if kernel == "roi_align":
        feats, boxes = _roi_args()
        return troi.multilevel_roi_align(feats, boxes, (8, 16, 32), 7)
    masks, boxes = _paste_args()
    return tmask.paste_masks(masks, boxes, 40, 48, pixel_major=True)


COUNTERS = {"nms": lambda: tnms.nms_keep,
            "roi_align": lambda: troi.roi_align_cuda,
            "mask_paste": lambda: tmask.paste_masks}


@pytest.mark.parametrize("kernel", ["nms", "roi_align", "mask_paste"])
def test_wrapper_raises_instead_of_falling_back(monkeypatch, kernel):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "on_card", lambda t: True)
    _forbid(monkeypatch, tnms, "nms_keep_plain", "_greedy_keep")
    _forbid(monkeypatch, troi, "_roi_align_taps", "_roi_align_matmul")
    _forbid(monkeypatch, tmask, "paste_masks_plain")
    before = COUNTERS[kernel]().launches
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _call(kernel)
    assert COUNTERS[kernel]().launches == before


@pytest.mark.parametrize("kernel", ["nms", "roi_align", "mask_paste"])
def test_cpu_tensors_take_the_plain_version(kernel):
    before = COUNTERS[kernel]().launches
    got = _call(kernel)
    assert COUNTERS[kernel]().launches == before
    if kernel == "nms":
        assert torch.equal(got, tnms.nms_keep_plain(*_nms_args(), 0.5))
    elif kernel == "roi_align":
        feats, boxes = _roi_args()
        lvl = troi.assign_levels(boxes, 3, 5) - 3
        assert torch.equal(got, troi._roi_align_taps(
            feats, boxes, (8, 16, 32), 7, 2, lvl))
    else:
        masks, boxes = _paste_args()
        assert torch.equal(got, tmask.paste_masks_plain(
            masks, boxes, 40, 48, pixel_major=True))


def _bad_nms(bad):
    boxes, classes, valid = _nms_args()
    if bad == "boxes_dtype":
        boxes = boxes.double()
    elif bad == "boxes_shape":
        boxes = boxes[:, :3]
    elif bad == "classes_dtype":
        classes = classes.long()
    elif bad == "valid_shape":
        valid = valid[:-1]
    return lambda: tnms.nms_keep(boxes, classes, valid, 0.5)


def _bad_roi(bad):
    feats, boxes = _roi_args(torch.float16 if bad == "dtype"
                             else torch.float32)
    lvl = troi.assign_levels(boxes, 3, 5) - 3
    size = 7
    if bad == "odd_channels":
        feats = [f[..., :7].contiguous() for f in feats]
    elif bad == "mixed_levels":
        feats = [feats[0].to(torch.bfloat16)] + feats[1:]
    elif bad == "level_ids":
        lvl = lvl.long()
    elif bad == "too_many_samples":
        size = 65
    return lambda: troi.roi_align_cuda(feats, boxes, lvl, (8, 16, 32), size,
                                       2)


def _bad_paste(bad):
    masks, boxes = _paste_args()
    stride = 1
    if bad == "not_square":
        masks = masks[:, :, :20]
    elif bad == "boxes_shape":
        boxes = boxes[:1]
    elif bad == "x_stride":
        stride = 0
    return lambda: tmask.paste_masks(masks, boxes, 40, 48, x_stride=stride)


@pytest.mark.parametrize("make_call", [
    *[pytest.param(lambda b=b: _bad_nms(b), id=f"nms-{b}") for b in
      ("boxes_dtype", "boxes_shape", "classes_dtype", "valid_shape")],
    *[pytest.param(lambda b=b: _bad_roi(b), id=f"roi_align-{b}") for b in
      ("dtype", "odd_channels", "mixed_levels", "level_ids",
       "too_many_samples")],
    *[pytest.param(lambda b=b: _bad_paste(b), id=f"mask_paste-{b}") for b in
      ("not_square", "boxes_shape", "x_stride")],
])
def test_wrapper_checks_inputs_before_launch(monkeypatch, make_call):
    monkeypatch.setattr(build, "on_card", lambda t: True)

    def no_load(name):
        raise AssertionError(f"{name}: reached the launch with bad inputs")

    monkeypatch.setattr(build, "load", no_load)
    with pytest.raises(ValueError):
        make_call()()


@pytest.mark.parametrize("name,replaces", [
    ("nms", "ops/nms.py:_greedy_keep"),
    ("roi_align", "ops/roi_align.py:multilevel_roi_align"),
    ("mask_paste", "ops/mask_paste.py:paste_masks"),
])
def test_slice2_kernel_sources(name, replaces):
    src = (build.CSRC / f"{name}.cu").read_text()
    symbol, argtypes = build.ENTRY_POINTS[name]
    assert f'extern "C" int {symbol}(' in src
    assert "torch/extension.h" not in src
    # the header note: what it replaces, what bounds it, no FMA contraction
    assert f"Replaces {replaces}" in src
    assert "What bounds it on Hopper" in src
    assert "__fdiv_rn" in src and "__fmul_rn" in src
    assert argtypes[-1] is build.ctypes.c_void_p     # the stream
    assert build.library_path(name).parent == build.BUILD_DIR


def test_all_five_kernels_are_built():
    # slice 2's five sources, with slice 3's write selection and ROIAlign
    # backward, slice 10's deformable attention (forward and backward) and
    # slice 11's read transpose and deformable convolution beside them
    assert set(build.ENTRY_POINTS) == {"segment_sum", "memory_read", "nms",
                                       "roi_align", "mask_paste",
                                       "write_select", "roi_align_backward",
                                       "ms_deform_attn",
                                       "ms_deform_attn_backward",
                                       "memory_read_backward",
                                       "deform_im2col",
                                       "deform_im2col_backward"}
