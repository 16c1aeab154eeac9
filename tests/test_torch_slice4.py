"""Slice 4 of the port on the CPU: the redesigned NMS and mask-paste
kernels' algorithms, emulated in numpy operation for operation and held
against the JAX package.

  * NMS (`csrc/nms.cu`): the stable partition of the candidates by class
    (per-warp slices, counts, the scan over bins and warps, the scatter by
    rank), the same-class tile predicate of the mask kernel with each row's
    column range, and the per-class warp sweep (the removed set in lane
    words, the sparse and the dense chain, the OR of the kept rows' later
    words). Every mask word the sweep reads must have been written by a
    tile the predicate kept. Plugged into the port's `nms_padded` and
    `multiclass_nms` in place of the keep-set kernel, detections and rows
    must equal the JAX package's exactly.
  * mask paste (`csrc/mask_paste.cu`): the live-mask predicate of a tile
    (src at the tile's edge rows and columns), the stage filled with
    finish(0), the live masks' 2 x 2-tap values, and the stores of every
    layout. Every (pixel, mask) pair the predicate skips must be exactly 0
    in the JAX package's values.

The emulations of slice 2's algorithms stay in tests/test_torch_slice2.py;
the kernels themselves are held against the plain versions on the card in
tests/test_torch_kernels.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_object_detection_tpu.ops import mask_paste as jmask
from embodied_object_detection_tpu.ops import nms as jnms

from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.ops import nms as tnms

T = torch.from_numpy
F32 = np.float32
FULL = (1 << 64) - 1
INVALID = 2 ** 31 - 1
BINS = tnms.CLASS_BINS
WARPS = 32
LANE_WORDS = 8
SPARSE_ROWS = 16
FLAGGED = 384           # flagged rows' words staged for a small segment


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    while x:
        low = x & -x
        yield low.bit_length() - 1
        x ^= low


# ------------------------------------------------------- NMS: the partition

def _partition(classes, valid):
    """The partition kernel: (perm, pos_seg, seg_bounds, num_segs)."""
    n = len(classes)
    cls = classes[valid]
    lo, hi = (int(cls.min()), int(cls.max())) if len(cls) else (1, 0)
    binned = lo <= hi and hi - lo < BINS
    bins = np.where(~valid, BINS, classes - lo if binned else 0)
    per = -(-n // WARPS)
    slices = [range(w * per, min(n, (w + 1) * per)) for w in range(WARPS)]
    # each warp counts its slice, 32 at a time (one leader a bin a chunk)
    cnt = np.zeros((WARPS, BINS + 1), np.int64)
    for w, sl in enumerate(slices):
        for base in range(sl.start, sl.stop, 32):
            for b in bins[base:min(sl.stop, base + 32)]:
                cnt[w, b] += 1
    # bins in order, then warps in order
    total = cnt.sum(0)
    start = np.concatenate([[0], np.cumsum(total)[:-1]])
    nonempty = (np.arange(BINS + 1) < BINS) & (total > 0)
    seg_of_bin = np.cumsum(nonempty) - nonempty
    num_segs = int(nonempty.sum())
    offsets = start[None, :] + np.cumsum(cnt, 0) - cnt
    seg_bounds = np.zeros(BINS + 2, np.int64)
    seg_bounds[seg_of_bin[nonempty]] = start[nonempty]
    seg_bounds[num_segs] = start[BINS]
    seg_of_bin = np.where(nonempty, seg_of_bin, INVALID)
    # the scatter: rank = the (warp, bin) offset + earlier lanes of the bin
    perm = np.full(n, -1, np.int64)
    pos_seg = np.full(n, -1, np.int64)
    for w, sl in enumerate(slices):
        for base in range(sl.start, sl.stop, 32):
            for i in range(base, min(sl.stop, base + 32)):
                rank = offsets[w, bins[i]]
                offsets[w, bins[i]] += 1
                perm[rank] = i
                pos_seg[rank] = seg_of_bin[bins[i]]
    assert (perm >= 0).all() and sorted(perm) == list(range(n))
    return perm, pos_seg, seg_bounds, num_segs


# ------------------------------------------------------- NMS: the mask

def _iou_row(a, cols):
    """IoU of box a with boxes cols [K, 4] in pairwise_iou's f32 order."""
    area = lambda b: (np.maximum(b[..., 2] - b[..., 0], F32(0)) *  # noqa
                      np.maximum(b[..., 3] - b[..., 1], F32(0)))
    w = np.maximum(np.minimum(a[2], cols[:, 2]) -
                   np.maximum(a[0], cols[:, 0]), F32(0))
    h = np.maximum(np.minimum(a[3], cols[:, 3]) -
                   np.maximum(a[1], cols[:, 1]), F32(0))
    inter = w * h
    union = (area(a) + area(cols)) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / np.maximum(union, F32(1e-12)),
                        F32(0))


def _mask(boxes, classes, perm, pos_seg, seg_bounds, thresh):
    """The mask kernel over the partitioned order: words of the tiles the
    predicate keeps (on or above the diagonal, the first column's segment
    not after the last row's), each row over its own segment's columns in
    four quarters OR-ed together; and each row block's later-rows word
    (rows with a nonzero word right of the diagonal). Every other word
    holds garbage, and `written` says which were set."""
    n = len(perm)
    words = -(-n // 64)
    mask = np.full((n, words), 0xA5A5A5A5A5A5A5A5, np.uint64)
    written = np.zeros((n, words), bool)
    later = [0] * words
    pb = boxes[perm]
    pc = classes[perm]
    for rt in range(words):
        rows = range(rt * 64, min(n, rt * 64 + 64))
        for ct in range(rt, words):
            col0 = ct * 64
            first = pos_seg[col0]
            if first == INVALID or first > pos_seg[rows[-1]]:
                continue
            for i in rows:
                bits = 0
                seg = pos_seg[i]
                for quarter in range(4) if seg != INVALID else ():
                    k0 = max(max(i + 1, col0) - col0, 16 * quarter)
                    k1 = min(min(seg_bounds[seg + 1], col0 + 64) - col0,
                             16 * quarter + 16)
                    if k1 > k0:
                        j = np.arange(col0 + k0, col0 + k1)
                        hit = (_iou_row(pb[i], pb[j]) > F32(thresh)) & \
                            (pc[j] == pc[i])
                        for k in np.flatnonzero(hit):
                            bits |= 1 << (int(k) + k0)
                mask[i, ct] = bits
                written[i, ct] = True
                if bits and ct > rt:
                    later[rt] |= 1 << (i - rt * 64)
    return mask, written, later


# ------------------------------------------------------- NMS: the sweep

def _decide(cur, vb, diag, chains):
    """A block's keep bits: the sparse chain over the rows whose diagonal
    word is nonzero, or the dense one by 32-bit halves."""
    nz = sum(1 << r for r in range(64) if diag[r])
    if bin(nz).count("1") <= SPARSE_ROWS:
        chains["sparse"] += 1
        for r in _bits(nz):
            if not (cur >> r) & 1:
                cur |= diag[r]
    else:
        chains["dense"] += 1
        lo, hi = cur & 0xFFFFFFFF, cur >> 32
        for r in range(32):
            if not (lo >> r) & 1:
                lo |= diag[r] & 0xFFFFFFFF
                hi |= diag[r] >> 32
        for r in range(32):
            if not (hi >> r) & 1:
                hi |= diag[32 + r] >> 32
        cur = (hi << 32) | lo
    return vb & ~cur & FULL


def _sweep(mask, written, later, perm, seg_bounds, num_segs, chains,
           flagged_cap=FLAGGED):
    """The sweep kernel, one warp per segment. A segment of at most 32
    words: lane l owns word b0 + l; the flagged rows (nonzero later word,
    in block then row order) get slots from a scan of the lanes' counts,
    the first `flagged_cap` have their words staged, and a block ORs in its
    kept flagged rows' words, staged or (past the cap) read again. A larger
    segment: lane l owns words b0 + l + 32 j, every word read when needed.
    `chains` counts the sparse and dense decisions taken."""
    n = len(perm)
    keep = np.zeros(n, bool)
    for s in range(num_segs):
        seg_lo, seg_hi = int(seg_bounds[s]), int(seg_bounds[s + 1])
        b0, b1 = seg_lo // 64, (seg_hi - 1) // 64
        small = b1 - b0 < 32
        assert b1 - b0 + 1 <= 32 * LANE_WORDS
        removed = [[0] * LANE_WORDS for _ in range(32)]    # [lane][j]

        def word(row, w):
            assert written[row, w], f"read the unwritten word ({row}, {w})"
            return int(mask[row, w])

        def block_rows(row0):
            lo, hi = max(seg_lo, row0) - row0, min(seg_hi, row0 + 64) - row0
            return ((1 << (hi - lo)) - 1) << lo

        if small:
            flags = [later[b0 + lane] & block_rows(64 * (b0 + lane))
                     if b0 + lane < b1 else 0 for lane in range(32)]
            counts = [bin(f).count("1") for f in flags]
            first = list(np.cumsum([0] + counts[:-1]))
            rows = [64 * (b0 + lane) + r for lane in range(32)
                    for r in _bits(flags[lane])][:flagged_cap]
            staged = [[word(row, b0 + lane)
                       if row // 64 < b0 + lane <= b1 else 0
                       for lane in range(32)] for row in rows]
        for b in range(b0, b1 + 1):
            rel, row0 = b - b0, 64 * b
            vb = block_rows(row0)
            diag = [word(row0 + r, b) if (vb >> r) & 1 else 0
                    for r in range(64)]
            kb = _decide(removed[rel % 32][rel // 32], vb, diag, chains)
            for r in _bits(kb):
                keep[perm[row0 + r]] = True
            if small:
                fl = flags[rel]
                if not kb & fl:
                    continue
                n_staged = max(0, min(counts[rel], flagged_cap - first[rel]))
                past = fl
                for k, r in enumerate(_bits(fl)):
                    if k < n_staged:
                        past &= past - 1
                        if (kb >> r) & 1:
                            for lane in range(32):
                                removed[lane][0] |= staged[first[rel] + k][lane]
                for lane in range(32):
                    w = b0 + lane
                    for r in _bits(kb & past):
                        if b < w <= b1:
                            removed[lane][0] |= word(row0 + r, w)
                continue
            rows_kb = kb & later[b] if b < b1 else 0
            for lane in range(32):
                for j in range(LANE_WORDS):
                    w = b0 + lane + 32 * j
                    if b < w <= b1:
                        for r in _bits(rows_kb):
                            removed[lane][j] |= word(row0 + r, w)
    return keep


CHAINS = {"sparse": 0, "dense": 0}


def _bypass(valid):
    return valid.copy()


def _emulated_keep(boxes_s, classes_s, valid_s, iou_threshold,
                   disabled=False, flagged_cap=FLAGGED):
    b, c, v = _np(boxes_s), _np(classes_s).astype(np.int64), _np(valid_s)
    if len(v) == 0:
        return T(np.zeros(0, bool))
    if disabled:
        return T(_bypass(v))
    perm, pos_seg, bounds, segs = _partition(c, v)
    # the partition is a stable sort by class, invalid candidates last
    key = np.where(v, c, np.iinfo(np.int64).max)
    if v.any() and c[v].max() - c[v].min() < BINS:
        assert (perm == np.argsort(key, kind="stable")).all()
    mask, written, later = _mask(b, c, perm, pos_seg, bounds, iou_threshold)
    return T(_sweep(mask, written, later, perm, bounds, segs, CHAINS,
                    flagged_cap))


@pytest.fixture
def warp_nms(monkeypatch):
    """Run the port's NMS entry points through the redesigned kernels'
    algorithm."""
    monkeypatch.setattr(tnms, "nms_keep", _emulated_keep)


def _boxes(rng, n, span=300.0):
    xy = rng.uniform(0, span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(8, 90, (n, 2))],
                          1).astype(F32)


def _class_sizes_inputs(seed, sizes, ties=False):
    """Candidates whose classes have the given member counts, the classes
    interleaved in score order, so that most segments start mid-word."""
    rng = np.random.RandomState(seed)
    classes = np.concatenate([np.full(k, c, np.int32)
                              for c, k in enumerate(sizes)])
    rng.shuffle(classes)
    n = len(classes)
    boxes = _boxes(rng, n)
    scores = rng.rand(n).astype(F32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(F32)
        boxes[1::7] = boxes[0::7][: len(boxes[1::7])]
    valid = rng.rand(n) > 0.05
    return boxes, scores, valid, classes


def _chain_among_others(seed, n_other=200, chain=150, chain_class=2):
    """A 150-deep suppression chain in one class (box i overlaps i + 1 at
    IoU 0.6 and i + 2 at 0.33, scores descending) among candidates of three
    other classes with interleaved scores."""
    rng = np.random.RandomState(seed)
    c = np.arange(chain)
    cb = np.stack([c * 25.0, np.zeros(chain), c * 25.0 + 100.0,
                   np.full(chain, 50.0)], 1).astype(F32)
    cs = (1.0 - c / chain).astype(F32)
    ob = _boxes(rng, n_other)
    os_ = rng.rand(n_other).astype(F32)
    oc = rng.choice([0, 1, 3], n_other).astype(np.int32)
    boxes = np.concatenate([cb, ob])
    scores = np.concatenate([cs, os_])
    classes = np.concatenate([np.full(chain, chain_class, np.int32), oc])
    return boxes, scores, np.ones(len(boxes), bool), classes


def _same_detections(got, want):
    for g, w_ in zip(got, want):
        assert (_np(g) == np.asarray(w_)).all()


def _vs_jax(boxes, scores, valid, classes, thresh, ml, topk):
    got = tnms.nms_padded(T(boxes), T(scores), T(valid), thresh, topk,
                          classes=T(classes), ml_nms_semantics=ml)
    want = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(valid), thresh, topk,
                           classes=jnp.asarray(classes), ml_nms_semantics=ml)
    _same_detections(got, want)
    return got


CLASS_SIZES = (0, 1, 63, 64, 65, 130)


@pytest.mark.parametrize("thresh,ml", [(0.5, False), (0.9, True),
                                       (0.0, True), (0.0, False)])
@pytest.mark.parametrize("ties", [False, True])
def test_warp_nms_class_sizes_vs_jax(warp_nms, thresh, ml, ties):
    """Classes of 0, 1, 63, 64, 65 and 130 members, interleaved."""
    boxes, scores, valid, classes = _class_sizes_inputs(41, CLASS_SIZES,
                                                        ties)
    _vs_jax(boxes, scores, valid, classes, thresh, ml, 200)


@pytest.mark.parametrize("n", [64, 200, 700])
@pytest.mark.parametrize("thresh", [0.5, 0.9])
def test_warp_nms_one_class_vs_jax(warp_nms, n, thresh):
    """Every candidate in one class: one segment over all words."""
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, n, span=150.0)
    scores = rng.rand(n).astype(F32)
    valid = rng.rand(n) > 0.1
    _vs_jax(boxes, scores, valid, np.zeros(n, np.int32), thresh, True, n)


def test_warp_nms_segment_starts_mid_word(warp_nms):
    """37 candidates of class 0 score above 100 of class 1, which overlap
    heavily: class 1's segment starts at row 37 of the first word."""
    rng = np.random.RandomState(43)
    boxes = _boxes(rng, 137, span=60.0)
    scores = np.concatenate([1.0 + rng.rand(37),
                             rng.rand(100)]).astype(F32)
    classes = np.array([0] * 37 + [1] * 100, np.int32)
    valid = np.ones(137, bool)
    perm, pos_seg, bounds, segs = _partition(classes, valid)
    assert segs == 2 and list(bounds[:3]) == [0, 37, 137]
    _vs_jax(boxes, scores, valid, classes, 0.5, False, 137)


def test_warp_nms_chain_among_classes_vs_jax(warp_nms):
    """The 150-deep chain inside one class among three others: every other
    chain box kept, through the dense chain."""
    boxes, scores, valid, classes = _chain_among_others(44)
    before = CHAINS["dense"]
    got = _vs_jax(boxes, scores, valid, classes, 0.5, False, len(boxes))
    assert CHAINS["dense"] > before
    kept = _np(got.scores)[_np(got.classes) == 2]
    assert len(kept) == 75


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cap,topk", [(2048, 30), (100, 30), (0, 300)])
def test_warp_multiclass_nms_vs_jax(warp_nms, ties, cap, topk):
    rng = np.random.RandomState(45)
    boxes = _boxes(rng, 90, span=120.0)
    valid = rng.rand(90) > 0.1
    scores = rng.rand(90, 21).astype(F32)
    if ties:
        scores = (np.round(scores * 8) / 8).astype(F32)
        boxes[1::5] = boxes[0::5][: len(boxes[1::5])]
    got, got_rows = tnms.multiclass_nms(T(boxes), T(scores), T(valid), 0.2,
                                        0.5, topk, candidate_cap=cap)
    want, want_rows = jnms.multiclass_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.2,
        0.5, topk, candidate_cap=cap)
    _same_detections(got, want)
    assert (_np(got_rows) == np.asarray(want_rows)).all()


@pytest.mark.parametrize("classes", [
    pytest.param(lambda rng, n: rng.choice([-5, 1000], n), id="wide-range"),
    pytest.param(lambda rng, n: rng.randint(-3, 4, n), id="negative"),
    pytest.param(lambda rng, n: rng.randint(0, 256, n), id="256-bins"),
])
def test_warp_nms_class_ranges_equal_plain(classes):
    """Class ids beyond the bins (one unbinned segment with the per-pair
    class test), negative ids and a range filling all 256 bins."""
    rng = np.random.RandomState(46)
    n = 300
    boxes = _boxes(rng, n, span=80.0)
    scores = rng.rand(n).astype(F32)
    valid = rng.rand(n) > 0.1
    cls = classes(rng, n).astype(np.int32)
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    args = (T(boxes[order]), T(cls[order]), T(valid[order]))
    for thresh in (0.3, 0.7):
        assert torch.equal(_emulated_keep(*args, thresh),
                           tnms.nms_keep_plain(*args, thresh))


@pytest.mark.parametrize("cap", [0, 3, FLAGGED])
def test_warp_nms_flagged_rows_past_the_staged(cap):
    """Kept flagged rows past the staged slots are read again: with no,
    three and all slots, the keep set is the plain fixpoint."""
    rng = np.random.RandomState(49)
    n = 500
    boxes = _boxes(rng, n, span=100.0)
    scores = rng.rand(n).astype(F32)
    valid = rng.rand(n) > 0.05
    cls = rng.randint(0, 2, n).astype(np.int32)
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    args = (T(boxes[order]), T(cls[order]), T(valid[order]))
    assert torch.equal(_emulated_keep(*args, 0.6, flagged_cap=cap),
                       tnms.nms_keep_plain(*args, 0.6))


def test_warp_nms_segment_over_32_words():
    """One class of 2112 candidates spans 33 words: the larger segment's
    path, lanes holding two words."""
    rng = np.random.RandomState(50)
    n = 2112
    boxes = _boxes(rng, n, span=400.0)
    scores = rng.rand(n).astype(F32)
    valid = np.ones(n, bool)
    order = np.argsort(-scores, kind="stable")
    args = (T(boxes[order]), T(np.zeros(n, np.int32)), T(valid[order]))
    assert torch.equal(_emulated_keep(*args, 0.5),
                       tnms.nms_keep_plain(*args, 0.5))


def test_warp_nms_no_valid_candidate():
    boxes = _boxes(np.random.RandomState(47), 70)
    args = (T(boxes), T(np.zeros(70, np.int32)), T(np.zeros(70, bool)))
    assert not _emulated_keep(*args, 0.5).any()


def test_sweep_takes_both_chains():
    """The random cases decide their blocks through the sparse chain, the
    chain case through the dense one; both give the plain fixpoint."""
    for seed in range(3):
        boxes, scores, valid, classes = _class_sizes_inputs(
            50 + seed, (120, 90, 200), ties=True)
        order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
        args = (T(boxes[order]), T(classes[order]), T(valid[order]))
        for thresh in (0.1, 0.5):
            assert torch.equal(_emulated_keep(*args, thresh),
                               tnms.nms_keep_plain(*args, thresh))
    assert CHAINS["sparse"] > 0


# ------------------------------------------------------- NMS: the wrapper

def test_nms_wrapper_scratch_and_bypass(monkeypatch):
    """The wrapper passes an int64 [n + 1, words] mask (the last row the
    later-rows flags) and an int32 [2n + 259] scratch, and neither when the
    bypass builds no mask."""
    calls = []

    def fake_launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(build, "on_card", lambda t: True)
    monkeypatch.setattr(build, "load", lambda name: fake_launch)
    monkeypatch.setattr(build, "stream_handle", lambda: 0)
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append((tuple(t.shape), t.dtype))
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    n = 130
    boxes, _, valid, classes = _class_sizes_inputs(48, (130,))
    args = (T(boxes), T(classes), T(valid))
    before = tnms.nms_keep.launches
    tnms.nms_keep(*args, 0.5)
    assert made == [((n,), torch.bool), ((n + 1, 3), torch.int64),
                    ((2 * n + BINS + 3,), torch.int32)]
    assert calls[-1][3] is not None and calls[-1][4] is not None
    made.clear()
    tnms.nms_keep(*args, 0.0, True)
    assert made == [((n,), torch.bool)]
    assert calls[-1][3] is None and calls[-1][4] is None
    assert calls[-1][6:9] == (n, 0.0, 1)
    assert tnms.nms_keep.launches == before + 2
    with pytest.raises(ValueError, match="at most"):
        big = tnms.MAX_CANDIDATES + 1
        tnms.nms_keep(torch.zeros((big, 4)), torch.zeros(big, dtype=torch.int32),
                      torch.zeros(big, dtype=torch.bool), 0.5)


# ------------------------------------------------------- mask paste

ROWS, COLS = 8, 32
PIX = ROWS * COLS
STAGE_BYTES = 32768


def _src(centre, lo, hi, m):
    """hat_src: the pixel centre's source coordinate, f32, in order."""
    extent = np.maximum(hi - lo, F32(1e-4))
    g = ((centre - lo) / extent) * F32(2) - F32(1)
    return ((g + F32(1)) * F32(m) - F32(1)) / F32(2)


def _taps(centre, lo, hi, m):
    src = _src(centre, lo, hi, m)
    inside = (src > -1) & (src < m)
    f = np.floor(np.where(inside, src, 0)).astype(F32)
    w0 = np.maximum(F32(1) - np.abs(src - f), F32(0))
    w1 = np.maximum(F32(1) - np.abs(src - (f + F32(1))), F32(0))
    k = f.astype(int)
    w0 = np.where(inside & (k >= 0), w0, F32(0))
    w1 = np.where(inside & (k + 1 <= m - 1), w1, F32(0))
    return np.maximum(k, 0), np.minimum(k + 1, m - 1), w0, w1


def _values(probs, boxes, q, ys, xs):
    """Mask q's 2 x 2-tap values at rows ys x columns xs (centres)."""
    m = probs.shape[1]
    ya, yb, wy0, wy1 = _taps(ys, boxes[q, 1], boxes[q, 3], m)
    xa, xb, wx0, wx1 = _taps(xs, boxes[q, 0], boxes[q, 2], m)
    mk = probs[q]
    t0 = wy0[:, None] * mk[ya][:, xa] + wy1[:, None] * mk[yb][:, xa]
    t1 = wy0[:, None] * mk[ya][:, xb] + wy1[:, None] * mk[yb][:, xb]
    return t0 * wx0[None] + t1 * wx1[None]


def _live(boxes, q, y0, y1, x0, x1, m):
    """The tile predicate: src at the tile's last row > -1 and at its first
    row < M, and likewise over its columns (centres y0..y1, x0..x1)."""
    b = boxes[q]
    return bool(_src(F32(y1), b[1], b[3], m) > -1 and
                _src(F32(y0), b[1], b[3], m) < m and
                _src(F32(x1), b[0], b[2], m) > -1 and
                _src(F32(x0), b[0], b[2], m) < m)


def _emulated_paste(probs, boxes, h, w, threshold, x_stride=1,
                    pixel_major=False):
    """The mask-paste kernel: per 8 x 32 tile and per pass of masks, the
    live list, the stage filled with finish(0), the live masks' values,
    and the store of the layout, into an output first filled with a
    sentinel. Returns (output, the skipped-pair map [N, H, W'])."""
    n, m, _ = probs.shape
    out_w = -(-w // x_stride)
    as_bool = threshold >= 0
    dtype = np.uint8 if as_bool else F32
    finish = (lambda v: (v >= threshold).astype(np.uint8)) if as_bool \
        else (lambda v: v.astype(F32))
    zero = finish(np.zeros((), F32))
    per_pass = STAGE_BYTES // (PIX * np.dtype(dtype).itemsize)
    flat = np.full(n * h * out_w, 7 if as_bool else np.nan, dtype)
    skipped = np.zeros((n, h, out_w), bool)
    for y_base in range(0, h, ROWS):
        for x_base in range(0, out_w, COLS):
            rows, cols = min(ROWS, h - y_base), min(COLS, out_w - x_base)
            ys = np.arange(y_base, y_base + rows).astype(F32) + F32(0.5)
            xs = ((np.arange(x_base, x_base + cols) * x_stride)
                  .astype(F32) + F32(0.5))
            for q0 in range(0, n, per_pass):
                span = min(per_pass, n - q0)
                live = [q for q in range(q0, q0 + span)
                        if _live(boxes, q, ys[0], ys[-1], xs[0], xs[-1], m)]
                stage = np.full(PIX * span, zero, dtype)
                for q in range(q0, q0 + span):
                    if q not in live:
                        skipped[q, y_base:y_base + rows,
                                x_base:x_base + cols] = True
                r, c = np.divmod(np.arange(rows * cols), cols)
                t = r * COLS + c
                for q in live:
                    v = finish(_values(probs, boxes, q, ys, xs))
                    stage[t * span + q - q0 if pixel_major
                          else (q - q0) * PIX + t] = v[r, c]
                e = np.arange(PIX * span)
                if pixel_major:
                    p, j = np.divmod(e, span)
                    pr, pc = np.divmod(p, COLS)
                    dst = ((y_base + pr) * out_w + x_base + pc) * n + q0 + j
                else:
                    q, p = np.divmod(e, PIX)
                    pr, pc = np.divmod(p, COLS)
                    dst = ((q0 + q) * h + y_base + pr) * out_w + x_base + pc
                mine = (pr < rows) & (pc < cols)
                flat[dst[mine]] = stage[e[mine]]
    shape = (h, out_w, n) if pixel_major else (n, h, out_w)
    out = flat.reshape(shape)
    if as_bool:
        assert (out != 7).all(), "an output element was never stored"
        out = out.astype(bool)
    else:
        assert not np.isnan(out).any(), "an output element was never stored"
    return out, skipped


def _paste_inputs(seed, n, h, w, special=True):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, 28, 28).astype(F32)
    x0 = rng.uniform(-30, w - 5, n)
    y0 = rng.uniform(-30, h - 5, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, 40, n),
                      y0 + rng.uniform(2, 30, n)], 1).astype(F32)
    if special and n >= 4:
        boxes[0] = [-1.0, -2.0, w + 3.0, h + 1.0]        # covers the image
        boxes[1] = [w + 10.0, 5.0, w + 30.0, 20.0]       # right of it
        boxes[2] = [5.0, -40.0, 30.0, -12.0]             # above it
        boxes[3] = [-50.0, h + 4.0, -20.0, h + 20.0]     # below-left
    return probs, boxes


@pytest.mark.parametrize("n", [1, 100, 130])
@pytest.mark.parametrize("threshold", [0.5, 0.0, -1.0])
@pytest.mark.parametrize("x_stride,pixel_major", [(1, True), (8, False),
                                                  (1, False)])
def test_tile_paste_vs_jax(n, threshold, x_stride, pixel_major):
    h, w = 20, 72
    probs, boxes = _paste_inputs(60 + n, n, h, w)
    got, skipped = _emulated_paste(probs, boxes, h, w, threshold, x_stride,
                                   pixel_major)
    want_vals = np.asarray(jmask.paste_masks(
        jnp.asarray(probs), jnp.asarray(boxes), h, w, -1.0,
        x_stride=x_stride))
    # every pair the tiles skip is exactly 0 in the JAX package's values
    assert (want_vals[skipped] == 0).all()
    if n >= 4:
        assert skipped[1:4].all() and not skipped[0].any()
    if pixel_major:
        want_vals = want_vals.transpose(1, 2, 0)
    if threshold < 0:
        np.testing.assert_allclose(got, want_vals, rtol=1e-5, atol=1e-6)
        return
    want = want_vals >= threshold
    if threshold == 0.0:
        assert got.all() and want.all()
    # at most one flip in 10^4 pixels, and only where the value sits at it
    flipped = got != want
    assert flipped.sum() <= max(1, want.size // 10000)
    assert (np.abs(want_vals[flipped] - threshold) < 1e-5).all()


def test_tile_predicate_skips_most_pairs():
    """At the frame's box sizes most (pixel, mask) pairs are skipped, and
    the predicate is exact on the tile's edges: a live mask reaches the
    tile's rows and columns."""
    rng = np.random.RandomState(70)
    n, h, w, m = 40, 96, 128, 28
    x0, y0 = rng.uniform(-60, w - 20, n), rng.uniform(-60, h - 20, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 60, n),
                      y0 + rng.uniform(4, 45, n)], 1).astype(F32)
    ys = np.arange(h, dtype=F32) + F32(0.5)
    xs = np.arange(w, dtype=F32) + F32(0.5)
    live_pairs = 0
    for y_base in range(0, h, ROWS):
        for x_base in range(0, w, COLS):
            yt, xt = ys[y_base:y_base + ROWS], xs[x_base:x_base + COLS]
            for q in range(n):
                live = _live(boxes, q, yt[0], yt[-1], xt[0], xt[-1], m)
                sy = _src(yt, boxes[q, 1], boxes[q, 3], m)
                sx = _src(xt, boxes[q, 0], boxes[q, 2], m)
                reach = ((sy > -1) & (sy < m)).any() and \
                    ((sx > -1) & (sx < m)).any()
                assert live == reach
                live_pairs += live * len(yt) * len(xt)
    assert live_pairs < 0.35 * n * h * w


def test_slice4_kernel_sources():
    nms_src = (build.CSRC / "nms.cu").read_text()
    for note in ("stable counting sort", "__match_any_sync",
                 "one block a segment", "cp.async", "later-rows",
                 "__shfl_sync", "kFlagged",
                 "kSparseRows", "What bounds it on Hopper"):
        assert note in nms_src
    assert f"kBins = {BINS};" in nms_src
    assert f"kLaneWords = {LANE_WORDS};" in nms_src
    assert f"kFlagged = {FLAGGED};" in nms_src
    assert f"kSparseRows = {SPARSE_ROWS};" in nms_src
    assert tnms.MAX_CANDIDATES == 32 * LANE_WORDS * 64
    paste_src = (build.CSRC / "mask_paste.cu").read_text()
    for note in ("finish(0)", "live", "16-byte vector stores",
                 "What bounds it on Hopper", "kRows = 8;", "kCols = 32;"):
        assert note in paste_src
    # the tap arithmetic is slice 2's
    assert "fmaf(ty.w1, m10, __fmul_rn(ty.w0, m00))" in paste_src
