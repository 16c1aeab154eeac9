"""The torch port's device ops against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages; on CPU
tensors every kernel wrapper of the port runs its plain PyTorch version.
Each comparison states its tolerance. The hand-written kernels are held
against their plain versions on the card in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.ops import mask_paste as jmask
from embodied_object_detection_tpu.ops import memory_ops as jmem
from embodied_object_detection_tpu.ops import nms as jnms
from embodied_object_detection_tpu.ops import roi_align as jroi
from embodied_object_detection_tpu.ops.pallas_scatter import scatter_sum_pallas

from embodied_object_detection_tpu_torch.models.detector import frame_inputs
from embodied_object_detection_tpu_torch.ops import mask_paste as tmask
from embodied_object_detection_tpu_torch.ops import memory_ops as tmem
from embodied_object_detection_tpu_torch.ops import nms as tnms
from embodied_object_detection_tpu_torch.ops import roi_align as troi
from embodied_object_detection_tpu_torch.ops import segment_sum as tseg

T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bf16_round(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _segment_inputs(rng, rows, lanes, cells, out_of_range=True):
    w = rng.rand(rows, lanes).astype(np.float32)
    w[rng.rand(rows, lanes) < 0.7] = 0.0            # sparse like mask weights
    idx = rng.randint(0, cells, rows).astype(np.int32)
    if out_of_range:
        idx[::7] = -1                                # dropped padding rows
        idx[3::11] = cells + rng.randint(0, 5, idx[3::11].shape)
    return w, idx


# ------------------------------------------------------------ segment-sum

@pytest.mark.parametrize("rows,lanes,cells", [(1000, 101, 64), (333, 7, 5)])
def test_segment_sum_plain_vs_jax_segment_sum(rows, lanes, cells):
    rng = np.random.RandomState(rows)
    w, idx = _segment_inputs(rng, rows, lanes, cells)
    got = tseg.segment_sum(T(w), T(idx), cells)
    want = jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(idx),
                               num_segments=cells)
    # both f32; only the summation order may differ
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_segment_sum_plain_vs_pallas_interpret():
    rng = np.random.RandomState(1)
    rows, lanes, cells = 700, 128, 256
    w, idx = _segment_inputs(rng, rows, lanes, cells, out_of_range=False)
    idx[::9] = -1                                    # the kernel's padding id
    want = np.asarray(scatter_sum_pallas(jnp.asarray(w), jnp.asarray(idx),
                                         cells, pixel_tile=512,
                                         interpret=True))
    # the Pallas kernel rounds the weights to bf16 and sums in f32: the
    # port on bf16-rounded weights agrees to f32 summation order ...
    got_rounded = _np(tseg.segment_sum(T(_bf16_round(w)), T(idx), cells))
    np.testing.assert_allclose(got_rounded, want, rtol=1e-5, atol=1e-5)
    # ... and on the f32 weights to one bf16 rounding (2^-8 relative)
    got = _np(tseg.segment_sum(T(w), T(idx), cells))
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-2)


def test_segment_sum_count_lane_exact():
    rng = np.random.RandomState(2)
    rows, cells = 5000, 16
    idx = rng.randint(-2, cells + 2, rows).astype(np.int32)
    w = np.ones((rows, 1), np.float32)
    got = _np(tseg.segment_sum(T(w), T(idx), cells))[:, 0]
    keep = (idx >= 0) & (idx < cells)
    want = np.bincount(idx[keep], minlength=cells).astype(np.float32)
    assert (got == want).all()


# ------------------------------------------------------------ memory read

@pytest.mark.parametrize("obs_values", [(0.0,), (1.0,), (2.0,), (0.0, 1.0, 2.0)])
def test_memory_read_vs_jax(obs_values):
    rng = np.random.RandomState(3)
    cells, d, h, w = 48, 32, 16, 24
    feats = (rng.randn(cells, d) * 3).astype(np.float32)
    obs = rng.choice(obs_values, cells).astype(np.float32)
    proj = rng.randint(0, cells, (h, w)).astype(np.int32)
    want = np.asarray(jmem.memory_read(jnp.asarray(feats), jnp.asarray(obs),
                                       jnp.asarray(proj)))
    got = _np(tmem.memory_read(T(feats), T(obs), T(proj)))
    assert got.shape == (h // 4, w // 4, d)
    # same bf16 rounding points; the 16-term f32 mean may sum in another
    # order (1e-6 relative)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_normalize_memory_strict_gt1():
    feats = np.array([[2.0, 4.0], [3.0, 6.0], [5.0, 10.0]], np.float32)
    obs = np.array([0.0, 1.0, 2.0], np.float32)
    got = _np(tmem.normalize_memory(T(feats), T(obs)))
    want = np.asarray(jmem.normalize_memory(jnp.asarray(feats),
                                            jnp.asarray(obs)))
    assert (got == want).all()


def test_pyramid_pool_vs_jax():
    ego = np.random.RandomState(4).randn(16, 24, 8).astype(np.float32)
    got = tmem.pyramid_pool(T(ego), 3)
    want = jmem.pyramid_pool(jnp.asarray(ego), 3)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w_), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ memory write

def _write_inputs(seed, n=6, h=16, w=24, cells=40, d=16):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, d).astype(np.float32)
    masks = np.zeros((n, h, w), bool)
    for i in range(n):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        masks[i, y0:y0 + rng.randint(3, 10), x0:x0 + rng.randint(3, 12)] = True
    valid = np.ones(n, bool)
    valid[-1] = False
    proj = rng.randint(0, cells, (h, w)).astype(np.int32)
    return feats, masks, valid, proj, cells


def _capture_segment_sums(monkeypatch):
    seen = []

    def spy(w, idx, num_cells):
        out = tseg.segment_sum(w, idx, num_cells)
        seen.append(out)
        return out

    monkeypatch.setattr(tmem, "segment_sum", spy)
    return seen


@pytest.mark.parametrize("host_visibility", [False, True])
def test_memory_write_exact_vs_jax(monkeypatch, host_visibility):
    feats, masks, valid, proj, cells = _write_inputs(5)
    vis = jmem_vis = None
    if host_visibility:
        vis = tmem.obs_visibility_host(proj, cells)
        jmem_vis = jnp.asarray(vis)
        vis = T(vis)
    seen = _capture_segment_sums(monkeypatch)
    masks_pm = np.moveaxis(masks, 0, -1)
    got = tmem.memory_write(T(feats), T(masks_pm), T(valid), T(proj), cells,
                            subsample=8, exact_subsample=True,
                            obs_visibility=vis, pixel_major=True)
    want = jmem.memory_write(jnp.asarray(feats), jnp.asarray(masks_pm),
                             jnp.asarray(valid), jnp.asarray(proj), cells,
                             subsample=8, exact_subsample=True,
                             obs_visibility=jmem_vis, pixel_major=True)
    # f32 both; the segment-sum and the [cells, N] x [N, D] product may sum
    # in another order
    np.testing.assert_allclose(_np(got.features_update),
                               np.asarray(want.features_update),
                               rtol=1e-5, atol=1e-5)
    assert (_np(got.obs_update) == np.asarray(want.obs_update)).all()
    assert bool(got.any_detection) == bool(want.any_detection)
    # the count lane is exact: every 8th pixel of the row-major compacted
    # observed set, counted per cell (a numpy oracle of the selection)
    observed = (masks & valid[:, None, None]).any(0).reshape(-1)
    chosen = np.flatnonzero(observed)[::8]
    count = np.bincount(proj.reshape(-1)[chosen], minlength=cells)
    assert (_np(seen[0])[:, -1] == count).all()


def test_memory_write_strided_vs_jax(monkeypatch):
    feats, masks, valid, proj, cells = _write_inputs(6, w=32)
    s = 8
    seen = _capture_segment_sums(monkeypatch)
    got = tmem.memory_write(T(feats), T(masks[:, :, ::s].copy()), T(valid),
                            T(proj[:, ::s].copy()), cells, subsample=1,
                            exact_subsample=False, obs_proj_indices=T(proj))
    want = jmem.memory_write(jnp.asarray(feats), jnp.asarray(masks[:, :, ::s]),
                             jnp.asarray(valid), jnp.asarray(proj[:, ::s]),
                             cells, subsample=1, exact_subsample=False,
                             obs_proj_indices=jnp.asarray(proj))
    np.testing.assert_allclose(_np(got.features_update),
                               np.asarray(want.features_update),
                               rtol=1e-5, atol=1e-5)
    assert (_np(got.obs_update) == np.asarray(want.obs_update)).all()
    observed = (masks[:, :, ::s] & valid[:, None, None]).any(0).reshape(-1)
    count = np.bincount(proj[:, ::s].reshape(-1)[observed], minlength=cells)
    assert (_np(seen[0])[:, -1] == count).all()


def test_memory_write_no_detection_is_zero():
    feats, masks, valid, proj, cells = _write_inputs(7)
    got = tmem.memory_write(T(feats), T(masks), T(np.zeros_like(valid)),
                            T(proj), cells)
    assert not bool(got.any_detection)
    assert float(got.features_update.abs().max()) == 0.0
    assert float(got.obs_update.abs().max()) == 0.0


def test_obs_visibility_host_matches_jax_package():
    from embodied_object_detection_tpu.engine.eval import obs_visibility_host
    proj = np.random.RandomState(8).randint(0, 30, (3, 8, 12)).astype(np.int32)
    assert (tmem.obs_visibility_host(proj, 40) ==
            obs_visibility_host(proj, 40)).all()


@pytest.mark.parametrize("bad", [64, 1000, -1])
def test_proj_index_guard_raises(bad):
    proj = np.zeros((2, 8, 12), np.int32)
    proj[1, 3, 4] = bad
    with pytest.raises(ValueError, match="proj index"):
        frame_inputs(np.zeros((2, 8, 12, 3), np.float32), proj,
                     np.array([True, False]), 64, "cpu")


# ------------------------------------------------------------ mask paste

def _paste_inputs(seed, n=5, m=28, h=48, w=64):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, m, m).astype(np.float32)
    x0 = rng.uniform(-10, w - 10, n)
    y0 = rng.uniform(-10, h - 10, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, 40, n),
                      y0 + rng.uniform(2, 30, n)], 1).astype(np.float32)
    return probs, boxes, h, w


@pytest.mark.parametrize("pixel_major,x_stride", [(True, 1), (False, 1),
                                                  (False, 8)])
def test_paste_masks_vs_jax(pixel_major, x_stride):
    probs, boxes, h, w = _paste_inputs(9)
    kw = dict(pixel_major=pixel_major, x_stride=x_stride)
    vals = _np(tmask.paste_masks(T(probs), T(boxes), h, w, -1.0, **kw))
    want_vals = np.asarray(jmask.paste_masks(jnp.asarray(probs),
                                             jnp.asarray(boxes), h, w, -1.0,
                                             **kw))
    np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-6)
    got = _np(tmask.paste_masks(T(probs), T(boxes), h, w, 0.5, **kw))
    want = np.asarray(jmask.paste_masks(jnp.asarray(probs),
                                        jnp.asarray(boxes), h, w, 0.5, **kw))
    # a value within f32 rounding of the 0.5 threshold may flip: allow at
    # most one in 10^4 pixels, and only where the value sits at 0.5
    flipped = got != want
    assert flipped.sum() <= max(1, got.size // 10000)
    assert (np.abs(want_vals[flipped] - 0.5) < 1e-5).all()


# ------------------------------------------------------------ ROIAlign

def _roi_inputs(seed, r=12):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(h, w, 8).astype(np.float32)
             for h, w in ((16, 24), (8, 12), (4, 6))]
    x0 = rng.uniform(-20, 170, r)
    y0 = rng.uniform(-20, 110, r)
    boxes = np.stack([x0, y0, x0 + rng.uniform(1, 150, r),
                      y0 + rng.uniform(1, 120, r)], 1).astype(np.float32)
    return feats, boxes


@pytest.mark.parametrize("impl,out,tol", [("v1", 7, 1e-5), ("v1", 14, 1e-5),
                                          ("v4", 7, 1e-5), ("v4", 14, 1e-5)])
def test_roi_align_vs_jax(impl, out, tol):
    feats, boxes = _roi_inputs(10)
    kw = dict(strides=(8, 16, 32), output_size=out, sampling_ratio=2,
              impl=impl)
    got = troi.multilevel_roi_align([T(f) for f in feats], T(boxes), **kw)
    want = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                     jnp.asarray(boxes), **kw)
    # f32 both: v1 gathers the same four taps; v4 contracts the same hat
    # weights, summed in another order
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


def test_roi_align_v4_vs_jax_v1():
    """v4 is the tap form re-associated: ~1 ulp per term."""
    feats, boxes = _roi_inputs(11)
    kw = dict(strides=(8, 16, 32), output_size=7, sampling_ratio=2)
    got = troi.multilevel_roi_align([T(f) for f in feats], T(boxes),
                                    impl="v4", **kw)
    want = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                     jnp.asarray(boxes), impl="v1", **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_assign_levels_vs_jax():
    _, boxes = _roi_inputs(12, r=64)
    got = troi.assign_levels(T(boxes), 3, 5)
    want = jroi.assign_levels(jnp.asarray(boxes), 3, 5)
    assert (_np(got) == np.asarray(want)).all()


# ------------------------------------------------------------ NMS

def _nms_inputs(seed, n=60, ties=False):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4          # many exactly tied scores
        boxes[1::5] = boxes[0::5][: len(boxes[1::5])]   # duplicated boxes
    valid = rng.rand(n) > 0.1
    return boxes, scores, valid


def _same_detections(got, want):
    for g, w_ in zip(got, want):
        assert (_np(g) == np.asarray(w_)).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thresh,ml", [(0.5, False), (0.9, True), (0.0, True)])
def test_nms_padded_vs_jax(ties, thresh, ml):
    boxes, scores, valid = _nms_inputs(13, ties=ties)
    got = tnms.nms_padded(T(boxes), T(scores), T(valid), thresh, 40,
                          ml_nms_semantics=ml)
    want = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(valid), thresh, 40,
                           ml_nms_semantics=ml)
    _same_detections(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("cap,topk", [(2048, 30), (50, 30), (0, 300)])
def test_multiclass_nms_vs_jax(ties, cap, topk):
    boxes, _, valid = _nms_inputs(14, n=40, ties=ties)
    rng = np.random.RandomState(15)
    scores = rng.rand(40, 6).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8
    got, got_rows = tnms.multiclass_nms(T(boxes), T(scores), T(valid), 0.1,
                                        0.5, topk, candidate_cap=cap)
    want, want_rows = jnms.multiclass_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.1,
        0.5, topk, candidate_cap=cap)
    _same_detections(got, want)
    assert (_np(got_rows) == np.asarray(want_rows)).all()


def test_topk_padded_pads_past_n():
    scores = np.array([0.3, 0.9, 0.3, 0.1], np.float32)
    rows = np.arange(4, dtype=np.int32)
    got = tnms.topk_padded(T(scores), 6, T(rows))
    want = jnms.topk_padded(jnp.asarray(scores), 6, jnp.asarray(rows))
    assert (_np(got[0]) == np.asarray(want[0])).all()
    assert (_np(got[1]) == np.asarray(want[1])).all()
    assert (_np(got[2][0]) == np.asarray(want[2][0])).all()
