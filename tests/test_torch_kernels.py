"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card, at the main path's shapes.

CUDA kernels have no CPU build, so these tests skip without a card. The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from centernet_reference import FULL_LEVELS, decode_per_level, head_outputs
from embodied_object_detection_tpu_torch.config import CenterNetConfig
from embodied_object_detection_tpu_torch.models import centernet as tcn
from embodied_object_detection_tpu_torch.ops import centernet as cn_ops
from embodied_object_detection_tpu_torch.ops import (
    mask_paste, memory_ops, ms_deform_attn, nms, roi_align, segment_sum)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


def _coherent_ids(rng, rows, cells, run=4):
    """Cell ids where runs of `run` neighbouring rows share a cell, and
    every 40th run repeats the cell of the run 40 before it (the rows of
    one image row of pixel blocks, then the next image row)."""
    runs = -(-rows // run)
    ids = rng.randint(0, cells, runs)
    ids[40:] = np.where(rng.rand(runs - 40) < 0.5, ids[:-40], ids[40:])
    return np.repeat(ids, run)[:rows].astype(np.int32)


@pytest.mark.parametrize("ids,lanes", [
    ("random", 101), ("one_cell", 101), ("coherent", 101),
    ("random", 100), ("coherent", 100), ("coherent", 7), ("random", 257)])
def test_segment_sum_kernel_vs_plain(ids, lanes):
    """Random, one-cell and coherent ids (runs of rows on one cell), K % 4
    in {0, 1, 3} and a K past one 128-column sweep; every 7th row dropped
    as an empty slot (id -1) and others beyond the cells."""
    _need_card()
    rng = np.random.RandomState(16)
    rows, cells = 38400, 8192
    w = rng.rand(rows, lanes).astype(np.float32)
    w[rng.rand(rows, lanes) < 0.7] = 0.0
    w[:, -1] = 1.0                                   # a count lane
    if ids == "one_cell":
        idx = np.full(rows, 5, np.int32)             # worst contention
    elif ids == "coherent":
        idx = _coherent_ids(rng, rows, cells)
    else:
        idx = rng.randint(0, cells, rows).astype(np.int32)
    idx[::7] = -1
    idx[3::11] = cells + 3
    w[::7] = np.nan                  # an empty slot's weights reach no sum
    w_d, idx_d = torch.from_numpy(w).cuda(), torch.from_numpy(idx).cuda()
    got = segment_sum.segment_sum(w_d, idx_d, cells)
    want = segment_sum.segment_sum_plain(w_d, idx_d, cells)
    torch.cuda.synchronize()
    assert got.shape == (cells, lanes)
    # sums in any order: |err| <= rows in the cell * 2^-24 * sum|w|
    keep = (idx_d >= 0) & (idx_d < cells)
    rows_in_cell = torch.bincount(idx_d[keep].long(), minlength=cells)
    abs_sum = segment_sum.segment_sum_plain(w_d.abs(), idx_d, cells)
    bound = rows_in_cell[:, None] * 2.0 ** -24 * abs_sum + 1e-7
    assert bool(((got - want).abs() <= bound).all())
    # an integer-valued lane (the write's pixel count) is exact
    assert torch.equal(got[:, -1], rows_in_cell.float())


def test_memory_read_batched_kernel_vs_single_reads():
    """Kernel 6 at B = 4: bit-exact per frame to kernel 2, and close to
    the plain batched read (its 16-term mean may sum in another order)."""
    _need_card()
    rng = np.random.RandomState(21)
    b, cells, d = 4, 8192, 512
    feats = torch.from_numpy(
        rng.randn(b, cells, d).astype(np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (b, cells))
                           .astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, cells, (b, 480, 640)).astype(np.int32)).cuda()
    got = memory_ops.memory_read_batched(feats, obs, proj)
    singles = torch.stack([memory_ops.memory_read(feats[i], obs[i], proj[i])
                           for i in range(b)])
    plain = memory_ops.memory_read_batched_plain(feats, obs, proj)
    torch.cuda.synchronize()
    assert torch.equal(got, singles)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,h,w,d", [(3, 36, 52, 264), (1, 20, 28, 512)])
def test_memory_read_off_tile_shapes_bit_equal(b, h, w, d):
    """Output cells that are no multiple of the gather's 16-cell tile (351
    and 35) and a channel count of 33 vectors: the batched read is
    bit-equal to B single reads, and close to the plain version."""
    _need_card()
    rng = np.random.RandomState(22)
    cells = 1000
    feats = torch.from_numpy(
        (rng.randn(b, cells, d) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (b, cells))
                           .astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, cells, (b, h, w)).astype(np.int32)).cuda()
    got = memory_ops.memory_read_batched(feats, obs, proj)
    singles = torch.stack([memory_ops.memory_read(feats[i], obs[i], proj[i])
                           for i in range(b)])
    plain = memory_ops.memory_read_batched_plain(feats, obs, proj)
    torch.cuda.synchronize()
    assert (b * (h // 4) * (w // 4)) % 16
    assert torch.equal(got, singles)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)


# boxes of the ROIAlign edge cases, with the staged grid they must give
ROI_EDGES = {
    "tiny": ([[100.3, 60.2, 104.1, 63.9], [300.0, 200.0, 300.4, 200.3],
              [636.0, 476.0, 639.5, 479.9]], "small"),
    "whole_level": ([[0.0, 0.0, 640.0, 480.0]], "banded"),
    "beyond_image": ([[-300.0, -200.0, 940.0, 680.0]], None),
    "wide": ([[40.0, 160.0, 520.0, 260.0], [300.0, 20.0, 360.0, 140.0]],
             None),
}


@pytest.mark.parametrize("size", [7, 14])
@pytest.mark.parametrize("case", sorted(ROI_EDGES))
def test_roi_align_kernel_edge_cases(case, size):
    """ROIs under one level pixel, over a whole level, beyond the image
    and wide (aspect 4.8 and 1/2), ahead of 256 random ROIs: f32 within
    1e-5 of the plain tap form on the CPU; the kernel's stats show the
    tiny ROIs' grids of at most 2 x 2 and the whole level in bands."""
    _need_card()
    rng = np.random.RandomState(23)
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              for h, w in ((60, 80), (30, 40), (15, 20))]
    side = np.exp(rng.uniform(np.log(16), np.log(900), 256))
    cx, cy = rng.uniform(-40, 680, 256), rng.uniform(-40, 520, 256)
    edge, expect = ROI_EDGES[case]
    boxes = torch.from_numpy(np.concatenate([np.array(edge), np.stack(
        [cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], 1)])
        .astype(np.float32))
    lvl = (roi_align.assign_levels(boxes, 3, 5) - 3).contiguous()
    strides = (8, 16, 32)
    stats = torch.zeros((len(boxes), 3), dtype=torch.int32, device="cuda")
    got = roi_align.roi_align_cuda([f.cuda() for f in levels], boxes.cuda(),
                                   lvl.cuda(), strides, size, 2,
                                   stats=stats).cpu()
    want = roi_align._roi_align_taps(levels, boxes, strides, size, 2, lvl)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    st = stats[:len(edge)].cpu()
    assert bool((st[:, 0] >= 1).all())
    if expect == "small":
        assert int(st[:, 0].max()) <= 4 and int(st[:, 2].max()) == 0
    elif expect == "banded":
        assert int(st[:, 2].min()) >= 1 and int(st[:, 0].max()) <= 288


def _pasted_masks(rng, n=100, h=480, w=640):
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    probs = torch.from_numpy(rng.rand(n, 28, 28).astype(np.float32)).cuda()
    x0, y0 = rng.uniform(-60, w - 40, n), rng.uniform(-60, h - 40, n)
    boxes = torch.from_numpy(np.stack(
        [x0, y0, x0 + rng.uniform(4, 400, n), y0 + rng.uniform(4, 300, n)],
        1).astype(np.float32)).cuda()
    masks = mp.paste_masks(probs, boxes, h, w, 0.5, pixel_major=True)
    masks[7] = False                       # an image row no mask covers
    masks[9] = True                        # a row every mask covers
    return masks.contiguous()


@pytest.mark.parametrize("subsample", [8, 3])
def test_write_select_kernel_vs_plain(subsample):
    """Kernel 7: equal to its plain version in every element, with real
    pasted masks, an empty and a full row, and invalid detections."""
    _need_card()
    rng = np.random.RandomState(22)
    masks = _pasted_masks(rng)
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    seg, aug = memory_ops.write_select(masks, valid, proj, subsample)
    seg_p, aug_p = memory_ops.write_select_plain(masks, valid, proj,
                                                 subsample)
    torch.cuda.synchronize()
    assert torch.equal(seg, seg_p)
    assert torch.equal(aug, aug_p)
    assert int((seg >= 0).sum()) > 1000


def _flat(grads):
    return torch.cat([g.float().cpu().reshape(-1, g.shape[-1])
                      for g in grads])


def _exact_contributions(levels, boxes, lvl, grad, strides, size):
    """(count [P], exact [P, C], magnitude [P, C]) over the flattened
    levels' positions: the nonzero tap contributions (grad / s^2) * w of
    the plain tap form on the CPU, each the f32 product the kernel forms,
    their sum and the sum of their magnitudes taken exactly (f64)."""
    rows, wgt = roi_align.roi_align_taps([f.shape[:2] for f in levels],
                                         boxes, strides, size, 2, lvl)
    total = sum(f.shape[0] * f.shape[1] for f in levels)
    c = grad.shape[-1]
    g = grad.float().cpu() / 4.0
    count = torch.zeros(total).index_add_(0, rows.reshape(-1),
                                          (wgt.reshape(-1) != 0).float())
    exact = torch.zeros((total, c), dtype=torch.float64)
    mag = torch.zeros((total, c), dtype=torch.float64)
    for i in range(0, boxes.shape[0], 32):
        prod = (g[i:i + 32, :, None, :, None, None, :] *
                wgt[i:i + 32, ..., None]).reshape(-1, c).double()
        exact.index_add_(0, rows[i:i + 32].reshape(-1), prod)
        mag.index_add_(0, rows[i:i + 32].reshape(-1), prod.abs())
    return count, exact, mag


def _check_backward(levels, boxes, grad, strict_plain):
    """Kernel 4b in f32 within contributions x 2^-24 x sum|contribution|
    per element of the exact sum of the plain tap form's f32
    contributions: summed in any order in f32, n contributions stay within
    (n - 1) 2^-24 sum|c| of it. With `strict_plain` also of torch
    autograd of the plain v1 on the CPU, itself an f32 sum in another
    order (two such orders may differ by up to twice the exact sum's
    bound, which the ROIs of the edge cases reach). In bf16 within 2^-8
    |ref| + (1 + 2^-8) contributions x 2^-24 x sum|contribution| of the
    exact sum of the bf16-rounded gradient's contributions (the kernel
    sums in f32 and rounds once); and against the card's plain v1
    autograd, which rounds each contribution and each partial sum to
    bf16: within (contributions + 1) x 2^-8 x sum|contribution|."""
    strides = (8, 16, 32)
    lvl = (roi_align.assign_levels(boxes, 3, 5) - 3).contiguous()
    shapes = [f.shape[:2] for f in levels]
    count, exact, mag = _exact_contributions(levels, boxes, lvl, grad,
                                             strides, 7)
    bound = count[:, None].double() * 2.0 ** -24 * mag

    got = _flat(roi_align.roi_align_backward_cuda(
        grad.cuda(), shapes, boxes.cuda(), lvl.cuda(), strides, 2,
        torch.float32))
    assert bool(((got.double() - exact).abs() <= bound).all())
    if strict_plain:
        leaves = [f.clone().requires_grad_(True) for f in levels]
        want = _flat(torch.autograd.grad(
            roi_align._roi_align_taps(leaves, boxes, strides, 7, 2, lvl),
            leaves, grad))
        assert bool(((got - want).abs().double() <= bound).all())

    # bf16, the training path's types
    dev16 = [f.cuda().to(torch.bfloat16).requires_grad_(True)
             for f in levels]
    g16 = grad.cuda().to(torch.bfloat16)
    got16 = _flat(roi_align.roi_align_backward_cuda(
        g16, shapes, boxes.cuda(), lvl.cuda(), strides, 2,
        torch.bfloat16)).double()
    out = roi_align._roi_align_taps(dev16, boxes.cuda(), strides, 7, 2,
                                    lvl.cuda())
    want16 = _flat(torch.autograd.grad(out, dev16, g16.float())).double()
    torch.cuda.synchronize()
    _, exact16, mag16 = _exact_contributions(levels, boxes, lvl, g16,
                                             strides, 7)
    tight = 2.0 ** -8 * exact16.abs() + \
        (1 + 2.0 ** -8) * count[:, None].double() * 2.0 ** -24 * mag16
    assert bool(((got16 - exact16).abs() <= tight).all())
    tol16 = (count[:, None].double() + 1) * 2.0 ** -8 * mag16
    assert bool(((got16 - want16).abs() <= tol16).all())


def _random_rois(rng, r):
    side = np.exp(rng.uniform(np.log(16), np.log(900), r))
    cx, cy = rng.uniform(-40, 680, r), rng.uniform(-40, 520, r)
    return np.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                     cy + side / 2], 1)


@pytest.mark.parametrize("r", [512, 64])
def test_roi_align_backward_kernel_vs_plain(r):
    """Kernel 4b at the training shape (R = 512, 7 x 7 x 256) and at 64
    ROIs, within the bounds of `_check_backward`."""
    _need_card()
    rng = np.random.RandomState(23)
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              for h, w in ((60, 80), (30, 40), (15, 20))]
    boxes = torch.from_numpy(_random_rois(rng, r).astype(np.float32))
    grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32))
    _check_backward(levels, boxes, grad, strict_plain=True)


@pytest.mark.parametrize("case", sorted(ROI_EDGES))
def test_roi_align_backward_kernel_edge_cases(case):
    """ROIs under one level pixel (all their taps on 1-4 positions), over
    a whole level (the grid the forward takes in bands), beyond the image
    and wide, ahead of 64 random ROIs, within the bounds of
    `_check_backward`."""
    _need_card()
    rng = np.random.RandomState(24)
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              for h, w in ((60, 80), (30, 40), (15, 20))]
    edge, _ = ROI_EDGES[case]
    boxes = torch.from_numpy(np.concatenate(
        [np.array(edge), _random_rois(rng, 64)]).astype(np.float32))
    grad = torch.from_numpy(
        rng.randn(len(boxes), 7, 7, 256).astype(np.float32))
    _check_backward(levels, boxes, grad, strict_plain=False)


@pytest.mark.parametrize("n,threshold", [(100, 0.5), (99, 0.5), (130, 0.5),
                                         (100, 0.0)])
def test_fused_paste_select_vs_plain(n, threshold):
    """The exact write's path: the paste with its flag epilogue, then the
    selection on its flags, against the plain paste, its flags and the
    plain selection. Masks within the paste's flip bound; flags, per-tile
    counts, ids and rows equal in every element to the plain chain on the
    kernel's masks (and on the plain paste's when no value flipped). Mask
    0 is all ones over rows 114-125, no valid mask reaches rows 300-311."""
    _need_card()
    rng = np.random.RandomState(25)
    h, w = 480, 640
    probs = rng.rand(n, 28, 28).astype(np.float32)
    x0, y0 = rng.uniform(-60, 600, n), rng.uniform(-60, 440, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 400, n),
                      y0 + rng.uniform(4, 300, n)], 1).astype(np.float32)
    probs[0] = 1.0
    boxes[0] = [-3.0, 110.0, 645.0, 130.0]
    near = (boxes[:, 1] < 332) & (boxes[:, 3] > 280)
    valid = (rng.rand(n) > 0.2) & ~near
    valid[0] = True
    probs, boxes = torch.from_numpy(probs).cuda(), torch.from_numpy(boxes).cuda()
    valid = torch.from_numpy(valid).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (h, w)).astype(np.int32)).cuda()
    masks, observed, counts = mask_paste.paste_masks_observed(
        probs, boxes, valid, h, w, threshold)
    seg, aug = memory_ops.write_select(masks, valid, proj, 8, observed,
                                       counts)
    plain = mask_paste.paste_masks_plain(probs, boxes, h, w, threshold,
                                         pixel_major=True)
    torch.cuda.synchronize()
    flipped = masks != plain
    assert int(flipped.sum()) <= max(1, plain.numel() // 10000)
    refs = [masks] if bool(flipped.any()) else [masks, plain]
    for ref in refs:
        want_obs = (ref & valid).any(dim=-1)
        want_counts = want_obs.reshape(h, w // 32, 32).sum(
            -1, dtype=torch.int32)
        seg_p, aug_p = memory_ops.write_select_plain(ref, valid, proj, 8)
        assert torch.equal(observed, want_obs)
        assert torch.equal(counts, want_counts)
        assert torch.equal(seg, seg_p)
        assert torch.equal(aug, aug_p)
    if threshold > 0:
        assert bool(observed[114:126].all())
        assert not bool(observed[300:312].any())
    else:
        assert bool(observed.all())


def test_memory_read_kernel_vs_plain():
    _need_card()
    rng = np.random.RandomState(17)
    feats = torch.from_numpy(rng.randn(8192, 512).astype(np.float32)).cuda()
    obs = torch.from_numpy(
        rng.choice([0.0, 1.0, 2.0, 5.0], 8192).astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    got = memory_ops.memory_read(feats, obs, proj)
    want = memory_ops.memory_read_plain(feats, obs, proj)
    torch.cuda.synchronize()
    # the same bf16 rounding per tap; the 16-term f32 mean may sum in
    # another order
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,classes,thresh,ml,shift", [
    (1024, 1, 0.9, True, 4.0),      # proposal NMS
    (1024, 1, 0.0, True, 4.0),      # proposal NMS, ml_nms bypass
    (2048, 20, 0.5, False, 25.0),   # final and write multiclass NMS
    (2000, 1, 0.9, True, 4.0),      # training proposal NMS
    (1024, 4, 0.5, False, 25.0),    # the chain among other classes
    (2048, 1, 0.5, False, 25.0),    # every candidate in one class
    (2048, "wide", 0.5, False, 25.0),   # class ids beyond the 256 bins
    (5000, 1, 0.5, False, 25.0),    # a class over more than 32 words
    (3000, 3, 0.5, False, 25.0),    # more candidates than staged
    # classes of 0, 1, 63, 64, 65 and 130 members, interleaved
    (323, (0, 1, 63, 64, 65, 130), 0.5, False, 25.0),
    (323, (0, 1, 63, 64, 65, 130), 0.9, False, 25.0),
    (323, (0, 1, 63, 64, 65, 130), 0.0, False, 25.0),
])
def test_nms_kernel_vs_plain(n, classes, thresh, ml, shift):
    _need_card()
    rng = np.random.RandomState(18)
    xy = rng.uniform(-20, 600, (n, 2)) * np.array([1.0, 0.75])
    boxes = np.concatenate([xy, xy + rng.uniform(8, 200, (n, 2))], 1)
    scores = rng.rand(n)
    scores[::3] = np.round(scores[::3] * 16) / 16          # exact ties
    dup = rng.choice(n - 1, n // 10, replace=False)
    boxes[dup] = boxes[dup + 1]                            # duplicated boxes
    valid = rng.rand(n) > 0.05
    chained = not isinstance(classes, tuple)
    if chained:
        cls = (rng.choice([-5, 1000], n) if classes == "wide"
               else rng.randint(0, classes, n))
        chain = np.arange(150)        # a suppression chain deeper than 64
        boxes[:150] = np.stack([10 + chain * shift, np.full(150, 100.0),
                                110 + chain * shift, np.full(150, 180.0)], 1)
        scores[:150], cls[:150], valid[:150] = 2.0 - chain / 150, 0, True
    else:
        cls = np.concatenate([np.full(k, c) for c, k in enumerate(classes)])
        rng.shuffle(cls)
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    b = torch.from_numpy(boxes[order].astype(np.float32)).cuda()
    c = torch.from_numpy(cls[order].astype(np.int32)).cuda()
    v = torch.from_numpy(valid[order]).cuda()
    disabled = ml and not thresh > 0
    got = nms.nms_keep(b, c, v, thresh, disabled)
    want = nms.nms_keep_plain(b, c, v, thresh, disabled)
    torch.cuda.synchronize()
    # the unique greedy solution: equal, not close
    assert torch.equal(got, want)
    if chained and not disabled:
        assert torch.equal(got[:150].cpu(), torch.arange(150) % 2 == 0)


@pytest.mark.parametrize("r,size", [(256, 7), (100, 14)])
def test_roi_align_kernel_vs_plain(r, size):
    _need_card()
    rng = np.random.RandomState(19)
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              for h, w in ((60, 80), (30, 40), (15, 20))]
    side = np.exp(rng.uniform(np.log(16), np.log(900), r))
    cx, cy = rng.uniform(-40, 680, r), rng.uniform(-40, 520, r)
    boxes = torch.from_numpy(np.stack(
        [cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2],
        1).astype(np.float32))
    lvl = (roi_align.assign_levels(boxes, 3, 5) - 3).contiguous()
    assert set(lvl.tolist()) == {0, 1, 2}
    strides = (8, 16, 32)
    dev = [f.cuda() for f in levels]
    got = roi_align.roi_align_cuda(dev, boxes.cuda(), lvl.cuda(), strides,
                                   size, 2).cpu()
    # held on the CPU, where `/ output_size` is a true division as in the
    # kernel; the tap sums may be taken in another order
    want = roi_align._roi_align_taps(levels, boxes, strides, size, 2, lvl)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # bf16 against the separable form: v4 rounds its weights, its
    # intermediate and its output to bf16, the kernel its output
    dev16 = [f.to(torch.bfloat16) for f in dev]
    got16 = roi_align.roi_align_cuda(dev16, boxes.cuda(), lvl.cuda(),
                                     strides, size, 2)
    v4 = roi_align._roi_align_matmul(dev16, boxes.cuda(), strides, size, 2,
                                     lvl.cuda())
    fmax = max(float(f.float().abs().max()) for f in dev16)
    assert float((got16.float() - v4.float()).abs().max()) <= 2 ** -7 * fmax


@pytest.mark.parametrize("n,threshold,pixel_major,x_stride,edges", [
    (100, 0.5, True, 1, False),
    (100, 0.5, False, 8, False),
    (1, 0.5, True, 1, True),
    (130, 0.5, True, 1, True),
    (100, 0.0, True, 1, True),
    (130, 0.0, False, 8, True),
    (100, -1.0, False, 8, True),
    (130, -1.0, True, 1, True),
])
def test_mask_paste_kernel_vs_plain(n, threshold, pixel_major, x_stride,
                                    edges):
    """Values within atol 1e-6 of the plain version; at a threshold at
    most one flip in 10^4 pixels, each within 1e-5 of it. With `edges` the
    first box covers the image and the next three lie wholly outside."""
    _need_card()
    rng = np.random.RandomState(20)
    x0, y0 = rng.uniform(-60, 600, n), rng.uniform(-60, 440, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 400, n),
                      y0 + rng.uniform(4, 300, n)], 1).astype(np.float32)
    if edges:
        boxes[:4] = [[-3, -1, 645, 482], [650, 10, 700, 90],
                     [20, -90, 80, -5], [-70, 490, -10, 560]][:n]
    masks = torch.from_numpy(rng.rand(n, 28, 28).astype(np.float32)).cuda()
    boxes = torch.from_numpy(boxes).cuda()
    kw = dict(x_stride=x_stride, pixel_major=pixel_major)
    vals = mask_paste.paste_masks(masks, boxes, 480, 640, -1.0, **kw)
    want_vals = mask_paste.paste_masks_plain(masks, boxes, 480, 640, -1.0,
                                             **kw)
    torch.testing.assert_close(vals, want_vals, rtol=0, atol=1e-6)
    if threshold < 0:
        return
    got = mask_paste.paste_masks(masks, boxes, 480, 640, threshold, **kw)
    want = mask_paste.paste_masks_plain(masks, boxes, 480, 640, threshold,
                                        **kw)
    torch.cuda.synchronize()
    # the four taps may sum in another order: a value within f32 rounding
    # of the threshold may flip, at most one in 10^4 pixels
    flipped = got != want
    assert int(flipped.sum()) <= max(1, got.numel() // 10000)
    assert bool(((want_vals[flipped] - threshold).abs() < 1e-5).all())


# the encoder's levels at 480x640 (C3-C5 and the stride-64 extra level)
MSDA_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10))


def _msda_inputs(rng, shapes, q, m, d, p, locality="random"):
    """chip_smoke.py's phase 12 inputs (`msda_arrays`) on the card: random
    locations with edge cases, or the model's."""
    return [torch.from_numpy(a).cuda() for a in
            chip_smoke.msda_arrays(rng, shapes, q, m, d, p, locality)]


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("q,m,d,p,locality,levels", [
    (None, 8, 32, 4, "random", 4), (100, 8, 32, 4, "random", 4),
    (300, 4, 8, 2, "random", 4), (200, 2, 48, 3, "random", 4),
    (2000, 8, 6, 4, "random", 4), (None, 8, 32, 4, "model", 4),
    (2000, 8, 32, 4, "random", 3), (500, 8, 32, 4, "random", 1)],
    ids=["encoder", "decoder", "narrow", "wide", "d6", "encoder_model",
         "three_levels", "one_level"])
def test_ms_deform_attn_kernels_vs_plain(q, m, d, p, locality, levels):
    """Kernels 8 and 8b at the encoder's (Q = S = 6380) and the decoder's
    (Q = 100) shapes, D = 8 (a point on 2 lanes), D = 48 (12 quads on 16
    lanes, 2 point passes), D = 6 (rows without 16-byte alignment, a quad
    of 2 channels), the encoder on the model's locations, and on 3 and 1
    levels (an odd L: the forward's instantiation that takes one level at
    a time): the forward
    within 1e-5 of the plain version's largest output and equal to it bit
    for bit (the card's plain version adds the points in order, as the
    kernel does), grad_loc and grad_attn within 1e-5 of the largest of the
    plain version's autograd, grad_value within its atomics bound of the
    exact sum, and that exact sum within the same bound of the plain
    autograd's grad_value (so the sum the kernel is held to is the plain
    version's gradient, not only the taps' own arithmetic)."""
    _need_card()
    rng = np.random.RandomState(26)
    shapes = MSDA_LEVELS[:levels]
    q = q or sum(h * w for h, w in shapes)
    value, locs, attn, grad = _msda_inputs(rng, shapes, q, m, d, p, locality)
    out = ms_deform_attn.ms_deform_attn_cuda(value, shapes, locs, attn)
    plain = ms_deform_attn.ms_deform_attn_plain(value, shapes, locs, attn)
    assert _rel_err(out, plain) <= 1e-5
    assert torch.equal(out, plain)
    gv, gl, ga = ms_deform_attn.ms_deform_attn_backward_cuda(
        grad, value, shapes, locs, attn)
    leaves = [t.clone().requires_grad_() for t in (value, locs, attn)]
    (ms_deform_attn.ms_deform_attn_plain(leaves[0], shapes, leaves[1],
                                         leaves[2]) * grad).sum().backward()
    assert _rel_err(gl, leaves[1].grad) <= 1e-5
    assert _rel_err(ga, leaves[2].grad) <= 1e-5
    exact, bound, _ = ms_deform_attn.ms_deform_attn_grad_value_exact(
        shapes, value, locs, attn, grad)
    assert bool(((gv.double() - exact).abs() <= bound).all())
    assert bool(((leaves[0].grad.double() - exact).abs() <= bound).all())


# the `detr-r50-frame` cell's levels: an 800 x 1067 frame's C3-C5 and its
# stride-64 extra level, 17 821 tokens
DETR_CELL_LEVELS = ((100, 134), (50, 67), (25, 34), (13, 17))


def test_ms_deform_attn_forward_at_the_detr_cells_encoder_shape():
    """Kernel 8's forward at the `detr-r50-frame` cell's encoder call: Q =
    S = 17 821 tokens over its four levels, 8 heads of 32 channels, 4
    points, each sample laid out as Deformable-DETR initialises its
    offsets (head m along (cos, sin)(2 pi m / 8) scaled to a largest
    coordinate of 1, point p at p + 1 level pixels) around the query's own
    pixel centre, plus normal(0, 2) level pixels: equal to the plain
    version bit for bit and within 1e-5 of its largest output, as phase 12
    holds the encoder's."""
    _need_card()
    rng = np.random.RandomState(29)
    shapes, m, d, p = DETR_CELL_LEVELS, 8, 32, 4
    s = sum(h * w for h, w in shapes)
    assert s == 17821
    refs = np.concatenate([np.stack(
        [(np.arange(h * w) % w + 0.5) / w,
         (np.arange(h * w) // w + 0.5) / h], -1) for h, w in shapes])
    theta = np.arange(m) * 2 * np.pi / m
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid /= np.abs(grid).max(-1, keepdims=True)
    offsets = grid[:, None, None, :] * np.arange(1, p + 1)[:, None] + \
        rng.normal(0.0, 2.0, (s, m, len(shapes), p, 2))
    sizes = np.array([(w, h) for h, w in shapes], np.float64)
    locs = refs[:, None, None, None, :] + \
        offsets / sizes[None, None, :, None, :]
    logits = rng.randn(s, m, len(shapes) * p)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value, locs, attn = (torch.from_numpy(a.astype(np.float32)).cuda()
                         for a in (rng.randn(s, m, d), locs,
                                   attn.reshape(s, m, len(shapes), p)))
    out = ms_deform_attn.ms_deform_attn_cuda(value, shapes, locs, attn)
    plain = ms_deform_attn.ms_deform_attn_plain(value, shapes, locs, attn)
    assert _rel_err(out, plain) <= 1e-5
    assert torch.equal(out, plain)


def test_ms_deform_attn_autograd_launches_both_kernels():
    """Under autograd a CUDA tensor goes through MSDeformAttnFunction: one
    forward and one backward launch, and the gradients of the plain
    version."""
    _need_card()
    rng = np.random.RandomState(27)
    shapes = ((12, 16), (6, 8))
    value, locs, attn, grad = _msda_inputs(rng, shapes, 40, 4, 8, 4)
    leaves = [t.clone().requires_grad_() for t in (value, locs, attn)]
    fwd = ms_deform_attn.ms_deform_attn_cuda.launches
    bwd = ms_deform_attn.ms_deform_attn_backward_cuda.launches
    (ms_deform_attn.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]) *
     grad).sum().backward()
    assert ms_deform_attn.ms_deform_attn_cuda.launches == fwd + 1
    assert ms_deform_attn.ms_deform_attn_backward_cuda.launches == bwd + 1
    ref = [t.clone().requires_grad_() for t in (value, locs, attn)]
    (ms_deform_attn.ms_deform_attn_plain(ref[0], shapes, ref[1], ref[2]) *
     grad).sum().backward()
    for a, b in zip(leaves, ref):
        assert _rel_err(a.grad, b.grad) <= 1e-5


@pytest.mark.parametrize("d", [32, 6])
def test_ms_deform_attn_counting_build_counts_the_design(d):
    """The counting build's tallies (`ms_deform_attn_tally`): D x 4 bytes
    of corner quads copied by the forward and loaded by the backward for
    every corner inside its level, and ceil(D / 4) float4 REDs a corner
    (D scalar ones where D % 4 != 0); its launches leave the wrappers'
    counters alone."""
    _need_card()
    rng = np.random.RandomState(28)
    shapes = MSDA_LEVELS
    value, locs, attn, grad = _msda_inputs(rng, shapes, 300, 8, d, 4)
    inside = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[:, :, lvl, :, 0] * w - 0.5)
        y0 = torch.floor(locs[:, :, lvl, :, 1] * h - 0.5)
        for dy in (0, 1):
            for dx in (0, 1):
                inside += int(((x0 + dx >= 0) & (x0 + dx < w) &
                               (y0 + dy >= 0) & (y0 + dy < h)).sum())
    fwd = ms_deform_attn.ms_deform_attn_cuda.launches
    bwd = ms_deform_attn.ms_deform_attn_backward_cuda.launches
    tally = ms_deform_attn.ms_deform_attn_tally(value, shapes, locs, attn,
                                                grad)
    assert tally == {"forward_bytes": inside * d * 4,
                     "backward_bytes": inside * d * 4,
                     "backward_reds": inside * (d // 4 if d % 4 == 0
                                                else d)}
    assert ms_deform_attn.ms_deform_attn_cuda.launches == fwd
    assert ms_deform_attn.ms_deform_attn_backward_cuda.launches == bwd


@pytest.mark.parametrize("h,w,cin,stride,dilation,modulated", [
    (60, 80, 256, 1, 1, True), (15, 20, 256, 1, 1, False),
    (9, 7, 40, 2, 2, True), (4, 5, 33, 1, 2, False),
    (9, 7, 30, 2, 2, True), (12, 10, 520, 1, 1, False)])
def test_deform_conv_kernels_vs_plain(h, w, cin, stride, dilation,
                                      modulated):
    """The im2col kernel equals the plain columns bit for bit (it repeats
    their arithmetic op for op), on float4 lanes (Cin % 4 == 0, 130 quads
    at Cin 520) and on single channels (Cin 30 and 33, and x off a 16-byte
    boundary); the backward kernel, on float4 lanes and with x or
    grad_columns off a 16-byte boundary (one channel a lane): grad_offset
    and grad_mask within 1e-5 of the plain autograd's largest and equal
    from call to call, grad_x within contributions x 2^-24 x
    sum|contribution| of the exact sum; offsets of std 2 cross every
    border."""
    from embodied_object_detection_tpu_torch.ops import deform_conv
    _need_card()
    rng = np.random.RandomState(21)
    pad = dilation
    ho = (h + 2 * pad - 2 * dilation - 1) // stride + 1
    wo = (w + 2 * pad - 2 * dilation - 1) // stride + 1
    x = torch.from_numpy(rng.randn(h, w, cin).astype(np.float32)).cuda()
    off = torch.from_numpy((rng.randn(ho, wo, 18) * 2).astype(
        np.float32)).cuda()
    mask = torch.from_numpy(rng.rand(ho, wo, 9).astype(
        np.float32)).cuda() if modulated else None
    geo = (stride, pad, dilation)
    cols = deform_conv.deform_im2col_cuda(x, off, mask, 3, 3, *geo)
    plain = deform_conv.deform_im2col_plain(x, off, mask, 3, 3, *geo)
    assert torch.equal(cols, plain)
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x)
    shifted.copy_(x)
    assert torch.equal(deform_conv.deform_im2col_cuda(
        shifted, off, mask, 3, 3, *geo), plain)
    gcols = torch.from_numpy(rng.randn(*cols.shape).astype(np.float32)).cuda()
    leaves = [t.clone().requires_grad_() for t in (x, off) +
              ((mask,) if modulated else ())]
    want = torch.autograd.grad(deform_conv.deform_im2col_plain(
        leaves[0], leaves[1], leaves[2] if modulated else None, 3, 3, *geo),
        leaves, gcols)
    exact, bound, _ = deform_conv.deform_conv_grad_x_exact(
        x, off, mask, gcols, 3, 3, *geo)
    gcols_off = torch.empty(gcols.numel() + 1, device="cuda")[1:].view_as(
        gcols)
    gcols_off.copy_(gcols)
    # aligned (float4 lanes where Cin % 4 == 0), then x and grad_columns
    # each off a 16-byte boundary (one channel a lane)
    for xs, gc in ((x, gcols), (shifted, gcols), (x, gcols_off)):
        gx, goff, gm = deform_conv.deform_im2col_backward_cuda(
            gc, xs, off, mask, 3, 3, *geo)
        for got, ref in ((goff, want[1]),) + (((gm, want[2]),) if modulated
                                              else ()):
            assert float((got - ref).abs().max()) <= \
                1e-5 * float(ref.abs().max())
        assert bool(((gx.double() - exact).abs() <= bound).all())
        _, goff2, gm2 = deform_conv.deform_im2col_backward_cuda(
            gc, xs, off, mask, 3, 3, *geo)
        assert torch.equal(goff2, goff)
        if modulated:
            assert torch.equal(gm2, gm)


@pytest.mark.parametrize("cin,misaligned", [(256, False), (30, False),
                                            (256, True)])
def test_deform_conv_counting_build_counts_the_design(cin, misaligned):
    """The backward's counting build (`deform_im2col_backward_tally`):
    Cin x 4 bytes of grad_columns and 4 x Cin x 4 of corner rows loaded a
    (pixel, tap), and one float4 RED a valid corner and 4 channels (one a
    channel where Cin % 4 != 0 or x is off a 16-byte boundary), as
    `deform_im2col_backward_design` counts them; its launch leaves the
    wrapper's counter alone. Offsets of std 2 cross every border."""
    from embodied_object_detection_tpu_torch.ops import deform_conv
    _need_card()
    rng = np.random.RandomState(29)
    h, w = 30, 40
    x = torch.from_numpy(rng.randn(h, w, cin).astype(np.float32)).cuda()
    if misaligned:
        x = torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x).copy_(x)
    off = torch.from_numpy((rng.randn(h, w, 18) * 2).astype(
        np.float32)).cuda()
    mask = torch.from_numpy(rng.rand(h, w, 9).astype(np.float32)).cuda()
    gcols = torch.from_numpy(rng.randn(h * w, 9 * cin).astype(
        np.float32)).cuda()
    launches = deform_conv.deform_im2col_backward_cuda.launches
    tally = deform_conv.deform_im2col_backward_tally(x, off, mask, gcols, 3,
                                                     3)
    design = deform_conv.deform_im2col_backward_design(
        x, off, 3, 3, quads=cin % 4 == 0 and not misaligned)
    assert tally == design
    assert deform_conv.deform_im2col_backward_cuda.launches == launches


@pytest.mark.parametrize("pool,d", [(2, 8), (3, 20), (8, 512)])
def test_memory_read_backward_kernel_pools(pool, d):
    """Kernel 2b at other pools (p^2 = 4 and 9: 8 and 3 windows a warp in
    its merge; 64: one window a warp in two steps) and D % 8 != 0, with
    half the frame on one cell (at pools 2 and 3 its row of more than 256
    windows takes the swept path): bit-equal to the window-order sum."""
    _need_card()
    rng = np.random.RandomState(23 + pool)
    cells, h, w = 40, 48, 96
    proj = rng.randint(0, cells, (h, w)).astype(np.int32)
    proj[: h // 2] = 7
    proj = torch.from_numpy(proj).cuda()
    grad = torch.from_numpy(rng.randn(h // pool, w // pool, d).astype(
        np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 3.0], cells).astype(
        np.float32)).cuda()
    got = memory_ops.memory_read_backward_cuda(grad, obs, proj, pool)
    want = memory_ops.memory_read_grad_window_order(grad, obs, proj, pool)
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch,ids", [(None, "random"), (None, "coherent"),
                                       (4, "random")])
def test_memory_read_backward_kernel_vs_exact(batch, ids):
    """The read's gradient in features (kernel 2b) against the exact sum s
    of the n bf16(g / 16) contributions c, at 8192 x 512 and 480x640 ids:
    the kernel within ((2^-8 + 2^-23)|s| + (1 + 2^-7) n 2^-24 sum|c|) /
    denominator (an f32 sum rounded once to bf16), the plain autograd
    within n 2^-8 sum|c| / denominator (a bf16 sum); one launch a
    gradient. The kernel equals the window-order sum and a second call
    bit for bit."""
    _need_card()
    rng = np.random.RandomState(22)
    n = batch or 1
    cells, d, h, w = 8192, 512, 480, 640
    feats = torch.from_numpy((rng.randn(n, cells, d) * 4).astype(
        np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (n, cells))
                           .astype(np.float32)).cuda()
    if ids == "coherent":
        block = rng.randint(0, cells, (n, h // 16, w // 16))
        proj = np.repeat(np.repeat(block, 16, 1), 16, 2)
    else:
        proj = rng.randint(0, cells, (n, h, w))
    proj = torch.from_numpy(proj.astype(np.int32)).cuda()
    grad = torch.from_numpy(rng.randn(n, h // 4, w // 4, d).astype(
        np.float32)).cuda()
    if batch is None:
        feats, obs, proj, grad = feats[0], obs[0], proj[0], grad[0]
    read = memory_ops.memory_read_batched if batch else \
        memory_ops.memory_read
    before = memory_ops.memory_read_backward_cuda.launches
    leaf = feats.clone().requires_grad_()
    got = torch.autograd.grad(read(leaf, obs, proj), leaf, grad)[0]
    assert memory_ops.memory_read_backward_cuda.launches == before + 1
    exact, bound, tight, _ = memory_ops.memory_read_grad_exact(grad, obs,
                                                               proj)
    plain = memory_ops.memory_read_backward_plain(grad, feats, obs, proj)
    assert bool(((got.double() - exact).abs() <= tight).all())
    assert bool(((plain.double() - exact).abs() <= bound).all())
    assert torch.equal(got, memory_ops.memory_read_grad_window_order(
        grad, obs, proj))
    assert torch.equal(got, memory_ops.memory_read_backward_cuda(
        grad, obs, proj))


@pytest.mark.parametrize("r", [129, 1])
def test_roi_align_cotraining_shapes_vs_plain(r):
    """Kernels 4 and 4b at the co-training pools: R = 129 (128 random
    ROIs and the whole-image box, the weak path's) and R = 1 (the
    whole-image box alone, the caption region, one ROI over all of p5):
    the forward in f32 within rtol/atol 1e-5 of the plain tap form on
    the CPU, the backward within the bounds of `_check_backward`."""
    _need_card()
    rng = np.random.RandomState(25)
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              for h, w in ((60, 80), (30, 40), (15, 20))]
    boxes = torch.from_numpy(np.concatenate(
        [_random_rois(rng, r - 1), [[0.0, 0.0, 640.0, 480.0]]]).astype(
            np.float32))
    lvl = (roi_align.assign_levels(boxes, 3, 5) - 3).contiguous()
    assert int(lvl[-1]) == 2
    strides = (8, 16, 32)
    got = roi_align.roi_align_cuda([f.cuda() for f in levels], boxes.cuda(),
                                   lvl.cuda(), strides, 7, 2).cpu()
    want = roi_align._roi_align_taps(levels, boxes, strides, 7, 2, lvl)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32))
    _check_backward(levels, boxes, grad, strict_plain=False)


@pytest.mark.parametrize("label", ["max_size", "wsddn", "captiontag"])
def test_cotraining_losses_card_vs_cpu(label):
    """One weak frame (`frame_train_weak`, max_size and wsddn) and one
    captiontag step (a caption-less frame and a padding row) at the 64x96
    f32 miniature on the card against the CPU from the same weights:
    losses within rtol 1e-4, gradients within 1e-4 of each tensor's
    largest, wsddn's prop heads within 1e-3 (`chip_smoke.hold_cotraining`,
    `grad_rtol`)."""
    _need_card()
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    cfg, x = chip_smoke.cotraining_miniature()
    runs = [chip_smoke.cotraining_losses(
        build_detector(cfg, seed=3, device=dev), cfg, x, label)
        for dev in ("cuda", "cpu")]
    chip_smoke.hold_cotraining(label, *runs)


@pytest.mark.parametrize("r,whole", [(256, 0), (256, 256), (512, 0)])
def test_roi_align_res5_shapes_vs_plain(r, whole):
    """Kernels 4 and 4b at the Res5 heads' shape: one C4 level of 30 x 40
    x 1024 (stride 16), 14 x 14, s = 2, every ROI on level 0, on random
    boxes and on whole-image boxes (the banded plan): the forward as
    phase 4b holds it (`chip_smoke.check_roi_case`); at R = 512 the
    backward within phase 4f's bounds of the exact sums
    (`chip_smoke.check_backward_c4`)."""
    _need_card()
    rng = np.random.RandomState(26)
    levels, boxes = chip_smoke.c4_inputs(rng, r, whole)
    lvl = torch.zeros((r,), dtype=torch.int32, device="cuda")
    assert torch.equal(roi_align.assign_levels(boxes, 4, 4) - 4, lvl)
    *_, stats = chip_smoke.check_roi_case(levels, boxes, 14, (16,), lvl)
    if whole:
        assert int((stats[:, 2] > 0).sum()) == r
    if r == 512:
        grad = torch.from_numpy(rng.randn(r, 14, 14, 1024).astype(
            np.float32)).cuda()
        chip_smoke.check_backward_c4(levels, boxes, lvl, grad)


@pytest.mark.parametrize("check", ["res5", "swin"])
def test_slice16_miniatures_card_vs_cpu(check):
    """The Res5 detector and the Swin-B detector (rate 0) at the 64x96 f32
    miniature on the card against the CPU from the same seeded weights:
    `chip_smoke.check_res5_against_cpu` (detections, losses within rtol
    1e-5, gradients within 1e-4 of each tensor's largest) and
    `chip_smoke.check_swin_against_cpu` (losses within rtol 1e-4)."""
    _need_card()
    if check == "res5":
        chip_smoke.check_res5_against_cpu()
    else:
        chip_smoke.check_swin_against_cpu()


CANVAS_CASES = {"frame": (FULL_LEVELS, 256), "res5": (((30, 40),), 1024)}


def _canvas_levels(rng, shapes, channels, dtype):
    """Levels on the card whose groups sit at different means and
    spreads, as a tower layer's output does."""
    out = []
    for h, w in shapes:
        x = rng.randn(h, w, channels) * rng.uniform(0.5, 3.0, channels) + \
            rng.uniform(-2.0, 2.0, channels)
        out.append(torch.from_numpy(x.astype(np.float32)).cuda().to(dtype))
    return out


@pytest.mark.parametrize("case", sorted(CANVAS_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_centernet_pack_kernel_vs_plain(case, dtype):
    """Kernel 10 at the frame's five levels and at Res5's one level,
    f32 or bf16 levels onto a bf16 canvas (and f32 onto f32): equal to
    the plain copy, zeros at every pad."""
    _need_card()
    shapes, c = CANVAS_CASES[case]
    layout = cn_ops.canvas_layout(shapes)
    levels = _canvas_levels(np.random.RandomState(30), shapes, c, dtype)
    for out in {torch.bfloat16, dtype}:
        before = cn_ops.pack_levels.launches
        got = cn_ops.pack_levels(levels, layout, out)
        want = cn_ops.pack_levels_plain(levels, layout.flat(), layout.height,
                                        layout.width, out)
        torch.cuda.synchronize()
        assert cn_ops.pack_levels.launches == before + 1
        assert got.dtype == out and torch.equal(got, want)


@pytest.mark.parametrize("case,dtype,out_f32", [
    ("frame", torch.bfloat16, False), ("frame", torch.bfloat16, True),
    ("frame", torch.float32, True), ("res5", torch.bfloat16, False)])
def test_group_norm_relu_kernel_vs_plain(case, dtype, out_f32):
    """Kernel 10b against the plain per-level GroupNorm on the same bands:
    bit-equal (its statistics summed in the order PyTorch's own reduction
    sums the plain version's means, each product and sum rounded alone);
    pads exactly 0; one launch; the same call twice equal."""
    _need_card()
    shapes, c = CANVAS_CASES[case]
    layout = cn_ops.canvas_layout(shapes)
    rng = np.random.RandomState(31)
    x = cn_ops.pack_levels(_canvas_levels(rng, shapes, c, torch.float32),
                           layout, dtype)
    pad = torch.ones((layout.height, layout.width), dtype=torch.bool,
                     device="cuda")
    for (y0, x0), (h, w) in zip(layout.origins, layout.shapes):
        pad[y0:y0 + h, x0:x0 + w] = False
    x[pad] = 7.0                       # a convolution's output at the pads
    bands = [x[r0:r1] for r0, r1 in layout.bands]
    weight = torch.from_numpy(rng.normal(1.0, 0.3, c).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(0.0, 0.3, c).astype(
        np.float32)).cuda()
    before = cn_ops.group_norm_relu.launches
    got = cn_ops.group_norm_relu(bands, weight, bias, layout,
                                 out_f32=out_f32)
    want = cn_ops.group_norm_relu_plain(
        bands, weight, bias, layout.flat(), layout.band_rows(),
        layout.height, 32, 1e-5, out_f32)
    torch.cuda.synchronize()
    assert cn_ops.group_norm_relu.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool((got[pad] == 0).all())
    gap = (got.float() - want.float()).abs()
    print(f"{case} {dtype} out_f32={out_f32}: "
          f"{int((gap > 0).sum())} of {gap.numel()} differ, "
          f"largest {float(gap.max()):.3e}")
    assert torch.equal(got, want)
    assert torch.equal(cn_ops.group_norm_relu(bands, weight, bias, layout,
                                              out_f32=out_f32), got)


@pytest.mark.parametrize("scaled", [False, True])
def test_centernet_decode_kernel_vs_plain(scaled):
    """Kernel 10c against its plain version on the card, per level and on
    a canvas with the scales applied inside: bit-equal (PyTorch's own f32
    expressions, no contraction)."""
    _need_card()
    rng = np.random.RandomState(32)
    strides = (8, 16, 32, 64, 128)
    if scaled:
        layout = cn_ops.canvas_layout(FULL_LEVELS)
        raw = torch.from_numpy((rng.randn(layout.height, layout.width, 5) *
                                3).astype(np.float32)).cuda()
        outs = layout.levels(raw)
        hms, regs = [o[..., 0] for o in outs], [o[..., 1:] for o in outs]
        scales = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(
            np.float32)).cuda()
    else:
        hms, regs = head_outputs(FULL_LEVELS, seed=33, device="cuda")
        hms, scales = [h[..., 0] for h in hms], None
    before = cn_ops.centernet_decode.launches
    got = cn_ops.centernet_decode(hms, regs, scales, strides, 1e-4)
    want = cn_ops.centernet_decode_plain(hms, regs, scales, strides, 1e-4)
    torch.cuda.synchronize()
    assert cn_ops.centernet_decode.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("setting", ["test", "train", "not_nms", "tied"])
def test_decode_proposals_bit_equal_to_per_level_on_card(setting):
    """The one-sort decode against five stable sorts a frame on the card,
    from the same heatmaps and regressions: bit-equal."""
    _need_card()
    cfg = CenterNetConfig(not_nms=setting == "not_nms")
    training = setting == "train"
    hms, regs = head_outputs(FULL_LEVELS, seed=34, device="cuda",
                             constant=setting == "tied")
    want = decode_per_level(hms, regs, cfg, training)
    got = tcn.decode_proposals(hms, regs, cfg, training)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_frame_proposals_packed_vs_per_level():
    """The default head (256 channels, bf16 tower) on the same 480 x 640
    FPN features, packed under no_grad against level by level under
    autograd: the heads' outputs and every position's box and score within
    the bf16 tower's rounding: the heads' outputs within 2^-9 of the
    largest (the canvas's tower rounds as the per-level one does, and its
    f32 heads' sums may run in another order: 6.9e-6 of 1.6 measured on
    an H100), every position's box within 0.01 px (3.4e-4 px measured)
    and score within 2^-12 (0 measured), and at least 95 % of the frame's
    proposals within 0.5 px of a per-level one (0.996 measured; a level
    placed or scaled wrongly moves most of them); the decode of the packed
    head's outputs bit-equal to the frame's proposals; 1 pack, 4 GroupNorm
    and 1 decode launches."""
    _need_card()
    torch.manual_seed(35)
    head = tcn.CenterNetHead(5, 256, 4, dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        for name, p in head.named_parameters():
            if "tower_gn" in name and name.endswith("weight"):
                p.normal_(1.0, 0.2)
            elif "scale" in name:
                p.uniform_(0.5, 1.5)
            elif name.endswith("weight"):      # the detector's init
                p.normal_(0.0, 0.01)
        head.agn_hm.bias.fill_(-2.0)
    cfg = CenterNetConfig()
    feats = [torch.randn(h, w, 256, device="cuda").to(torch.bfloat16)
             for h, w in FULL_LEVELS]
    want_hms, want_regs = head(feats)
    want_hms = [t.detach() for t in want_hms]
    want_regs = [t.detach() for t in want_regs]
    counts = (cn_ops.pack_levels.launches, cn_ops.group_norm_relu.launches,
              cn_ops.centernet_decode.launches)
    with torch.no_grad():
        props = head.proposals(feats, cfg)
        assert (cn_ops.pack_levels.launches - counts[0],
                cn_ops.group_norm_relu.launches - counts[1],
                cn_ops.centernet_decode.launches - counts[2]) == (1, 4, 1)
        got_hms, got_regs = head(feats)
        again = tcn.decode_proposals(got_hms, got_regs, cfg)
    torch.cuda.synchronize()
    for g, w in zip(props, again):
        assert torch.equal(g, w)
    gaps = []
    for gots, wants in ((got_hms, want_hms), (got_regs, want_regs)):
        top = max(float(w.abs().max()) for w in wants)
        gap = max(float((g - w).abs().max()) for g, w in zip(gots, wants))
        print(f"head output gap {gap:.3e} of {top:.3e}")
        gaps.append((gap, top))
    strides = cfg.strides
    _, got_rows = cn_ops.centernet_decode(
        [h[..., 0] for h in got_hms], got_regs, None, strides, 1e-4)
    _, want_rows = cn_ops.centernet_decode(
        [h[..., 0] for h in want_hms], want_regs, None, strides, 1e-4)
    box_gap = float((got_rows[:, :4] - want_rows[:, :4]).abs().max())
    score_gap = float((got_rows[:, 4] - want_rows[:, 4]).abs().max())
    print(f"box gap {box_gap:.3e} px, score gap {score_gap:.3e}")
    want = decode_per_level(want_hms, want_regs, cfg)
    shared = float((torch.cdist(props.boxes[props.valid],
                                want.boxes[want.valid]).min(1).values <
                    0.5).float().mean())
    print(f"proposals within 0.5 px of a per-level one: {shared:.4f}")
    for gap, top in gaps:
        assert gap <= 2.0 ** -9 * top
    assert box_gap <= 0.01
    assert score_gap <= 2.0 ** -12
    assert shared >= 0.95
