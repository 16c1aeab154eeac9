"""Slice 10 of the torch port against the JAX package, on the CPU: the
Deformable-DETR family's ops, layers, heads, matching, losses and
inference, and the converter for its parameter tree.

Inputs are made from a seed with numpy; JAX parameters are carried into
the port with `load_jax_params`. The sampling-offset and attention-weight
kernels, which JAX initialises to zero (every sample on its reference
point, uniform attention), are drawn from a seeded normal, so that samples
spread across level borders and some fall outside the maps. The miniature
is the JAX tests' (tests/test_deformable_detr.py): hidden 32, 4 heads,
2 + 2 layers, FFN 64, 12 queries, 4 levels of 16x20 .. 2x3.

JAX's `DeformableDETR` does not pass its `points` field to its layers,
which keep their default of 4 points; the port's does the same, so both
miniatures are built with `points=2` and run 4 points.

Tolerances: max |port - jax| <= rtol * max |jax| + atol, stated per test
(f32 on both sides, sums in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_object_detection_tpu.models import deformable_detr as jd
from embodied_object_detection_tpu.ops.deform_conv import (
    bilinear_sample_zero_pad as jax_sample)
from embodied_object_detection_tpu.ops.ms_deform_attn import (
    ms_deform_attn as jax_msda)
from embodied_object_detection_tpu.structures import GroundTruth as JaxGT

from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.kernels import build
from embodied_object_detection_tpu_torch.models import deformable_detr as td
from embodied_object_detection_tpu_torch.ops import ms_deform_attn as tmsda
from embodied_object_detection_tpu_torch.ops.deform_conv import (
    bilinear_sample_zero_pad)
from embodied_object_detection_tpu_torch.structures import GroundTruth

FEAT_SHAPES = ((16, 20), (8, 10), (4, 5), (2, 3))
MINI = dict(num_classes=5, hidden_dim=32, heads=4, enc_layers=2,
            dec_layers=2, ffn=64, num_queries=12, levels=4)


def _close(got, want, rtol, atol=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * np.abs(want).max() + atol, \
        f"max err {err:.3e} against max |want| {np.abs(want).max():.3e}"


def _t(x):
    return torch.from_numpy(np.array(x))


def spread(tree, rng, std):
    """The tree with every `sampling_offsets` and `attention_weights`
    kernel drawn from normal(0, std) (numpy arrays, a copy)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = spread(v, rng, std)
            if k in ("sampling_offsets", "attention_weights"):
                out[k]["kernel"] = (rng.randn(*v["kernel"].shape) *
                                    std).astype(np.float32)
        else:
            out[k] = np.array(v)
    return out


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _feats(rng, shapes=FEAT_SHAPES, c=32):
    return [rng.randn(*s, c).astype(np.float32) for s in shapes]


# --------------------------------------------------------------------- ops

@pytest.mark.parametrize("batched", [False, True])
def test_bilinear_sample_zero_pad_matches_jax(batched):
    """Coordinates over [-1.5, H + 0.5] x [-1.5, W + 0.5] (taps beyond
    every border) and on exact pixel centres; a batch against JAX's vmap.
    Tolerance: rtol 1e-6."""
    rng = np.random.RandomState(1)
    h, w, c = 7, 9, 5
    img = rng.randn(3, h, w, c).astype(np.float32)
    y = rng.uniform(-1.5, h + 0.5, (3, 40)).astype(np.float32)
    x = rng.uniform(-1.5, w + 0.5, (3, 40)).astype(np.float32)
    y[:, :6] = np.arange(6)
    x[:, :6] = np.array([0, 3, 8, -1, 9, 4])
    if batched:
        want = jax.vmap(jax_sample)(jnp.asarray(img), jnp.asarray(y),
                                    jnp.asarray(x))
        got = bilinear_sample_zero_pad(_t(img), _t(y), _t(x))
    else:
        want = jax_sample(jnp.asarray(img[0]), jnp.asarray(y[0]),
                          jnp.asarray(x[0]))
        got = bilinear_sample_zero_pad(_t(img[0]), _t(y[0]), _t(x[0]))
    _close(got, want, 1e-6)


def _msda_inputs(rng, shapes, m, d, q, p):
    s = sum(h * w for h, w in shapes)
    value = rng.randn(s, m, d).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (q, m, len(shapes), p, 2)).astype(
        np.float32)
    weights = rng.rand(q, m, len(shapes), p).astype(np.float32)
    weights /= weights.sum(axis=(2, 3), keepdims=True)
    return value, locs, weights


MSDA_CASES = {
    # the JAX test's shapes (tests/test_ms_deform_attn.py:39-51)
    "jax_test": (((6, 8), (3, 4)), 2, 4, 5, 3),
    # the miniature's levels, 4 heads of 8 channels, 4 points
    "miniature": (FEAT_SHAPES, 4, 8, 30, 4),
}


@pytest.mark.parametrize("case", list(MSDA_CASES))
def test_ms_deform_attn_plain_forward_matches_jax(case):
    """Locations in [-0.1, 1.1]. Tolerance: rtol 1e-6."""
    shapes, m, d, q, p = MSDA_CASES[case]
    value, locs, weights = _msda_inputs(np.random.RandomState(2), shapes, m,
                                        d, q, p)
    want = jax_msda(jnp.asarray(value), shapes, jnp.asarray(locs),
                    jnp.asarray(weights))
    got = tmsda.ms_deform_attn(_t(value), shapes, _t(locs), _t(weights))
    assert tmsda.ms_deform_attn_cuda.launches == 0
    _close(got, want, 1e-6)


@pytest.mark.parametrize("case", list(MSDA_CASES))
def test_ms_deform_attn_plain_gradients_match_jax(case):
    """jax.grad of <out, cotangent> for value, locations and weights
    against torch autograd of the plain version; locations in [-0.1, 1.1].
    Tolerance: rtol 1e-5 of each gradient's largest element."""
    shapes, m, d, q, p = MSDA_CASES[case]
    rng = np.random.RandomState(3)
    value, locs, weights = _msda_inputs(rng, shapes, m, d, q, p)
    ct = rng.randn(q, m * d).astype(np.float32)

    def f(v, l, a):
        return jnp.sum(jax_msda(v, shapes, l, a) * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(weights))
    args = [_t(a).requires_grad_() for a in (value, locs, weights)]
    (tmsda.ms_deform_attn(args[0], shapes, args[1], args[2]) *
     _t(ct)).sum().backward()
    for a, w in zip(args, want):
        _close(a.grad, w, 1e-5)


@pytest.mark.parametrize("case", list(MSDA_CASES))
def test_ms_deform_attn_grad_value_exact_is_jax_grad(case):
    """The exact (f64) sum of the taps' contributions, which the card holds
    the backward kernel's grad_value to, against the plain version's
    autograd and JAX's grad_value, locations in [-0.1, 1.1] and some on
    the -1 row and column. Tolerances: against the plain autograd
    elementwise, contributions x 2^-24 x sum |contribution| (an f32 sum,
    in any order, of the same products); against JAX rtol 1e-5, as the
    gradient test above (XLA's products differ from the taps' in their
    last bits, up to a few units in the last place)."""
    shapes, m, d, q, p = MSDA_CASES[case]
    rng = np.random.RandomState(4)
    value, locs, weights = _msda_inputs(rng, shapes, m, d, q, p)
    for lvl, (h, w) in enumerate(shapes):
        locs[::3, :, lvl, 0] = (-0.5 / w, -0.5 / h)
    ct = rng.randn(q, m * d).astype(np.float32)

    def f(v):
        return jnp.sum(jax_msda(v, shapes, jnp.asarray(locs),
                                jnp.asarray(weights)) * ct)

    want = np.asarray(jax.grad(f)(jnp.asarray(value)), np.float64)
    v = _t(value).requires_grad_()
    (tmsda.ms_deform_attn_plain(v, shapes, _t(locs), _t(weights)) *
     _t(ct)).sum().backward()
    exact, bound, count = tmsda.ms_deform_attn_grad_value_exact(
        shapes, _t(value), _t(locs), _t(weights), _t(ct))
    assert int(count.max()) > 1
    exact, bound = exact.numpy(), bound.numpy()
    assert (np.abs(v.grad.double().numpy() - exact) <= bound).all()
    _close(exact, want, 1e-5)


def test_ms_deform_attn_wrapper_launches_or_raises_on_card(monkeypatch):
    """A tensor the wrapper must run on the card goes to the kernel's
    custom op, forward and under autograd, and never to the plain
    version: without a card the build raises and no launch is counted."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "on_card", lambda t: True)

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(tmsda, "ms_deform_attn_plain", plain)
    shapes = ((2, 3), (1, 2))
    value, locs, weights = _msda_inputs(np.random.RandomState(4), shapes, 2,
                                        4, 3, 2)
    fwd = tmsda.ms_deform_attn_cuda.launches
    bwd = tmsda.ms_deform_attn_backward_cuda.launches
    for grad in (False, True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmsda.ms_deform_attn(_t(value).requires_grad_(grad), shapes,
                                 _t(locs), _t(weights))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmsda.ms_deform_attn_backward_cuda(
            torch.zeros(3, 8), _t(value), shapes, _t(locs), _t(weights))
    assert tmsda.ms_deform_attn_cuda.launches == fwd
    assert tmsda.ms_deform_attn_backward_cuda.launches == bwd


@pytest.mark.parametrize("bad", ["value_dtype", "tokens", "loc_shape",
                                 "points", "grad_shape"])
def test_ms_deform_attn_ops_check_inputs_before_launch(bad):
    """The custom ops refuse what the kernels do not take, before any
    build: f64 values, a token count that is not sum H_l W_l, locations
    of the wrong shape, more than 8 points, a grad_out of the wrong
    shape."""
    shapes = ((2, 3), (1, 2))
    p = 9 if bad == "points" else 2
    value, locs, weights = _msda_inputs(np.random.RandomState(5), shapes, 2,
                                        4, 3, p)
    value = _t(value)
    if bad == "value_dtype":
        value = value.double()
    if bad == "tokens":
        value = value[:-1].contiguous()
    locs = _t(locs)
    if bad == "loc_shape":
        locs = locs[:, :1].contiguous()
    if bad == "grad_shape":
        with pytest.raises(ValueError, match="ms_deform_attn_backward"):
            tmsda.ms_deform_attn_backward_cuda(
                torch.zeros(3, 7), value, shapes, locs, _t(weights))
        return
    with pytest.raises(ValueError, match="ms_deform_attn"):
        tmsda.ms_deform_attn_cuda(value, shapes, locs, _t(weights))


# ------------------------------------------------------------------ layers

def _layer_inputs(rng, q, ref_dim, c=32, shapes=FEAT_SHAPES):
    s = sum(h * w for h, w in shapes)
    query = rng.randn(q, c).astype(np.float32)
    if ref_dim == 2:
        ref = rng.rand(q, 2).astype(np.float32)
    else:
        ref = np.concatenate([rng.uniform(0.1, 0.9, (q, 2)),
                              rng.uniform(0.05, 0.5, (q, 2))], -1)
        ref = ref.astype(np.float32)
    value = rng.randn(s, c).astype(np.float32)
    return query, ref, value


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn_layer_matches_flax(ref_dim):
    """Both reference branches: the 2-d point (offsets / (W_l, H_l)) and
    the 4-d box (offsets / P * wh * 0.5). Tolerance: rtol 1e-5."""
    rng = np.random.RandomState(6)
    query, ref, value = _layer_inputs(rng, 20, ref_dim)
    jm = jd.MSDeformAttnLayer(dim=32, heads=4, levels=4, points=2)
    params = jm.init(jax.random.PRNGKey(0), query, ref, value, FEAT_SHAPES)
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.5)
    want = jm.apply(_jax_tree(tree), query, ref, value, FEAT_SHAPES)
    port = td.MSDeformAttnLayer(32, 4, 4, 2)
    port.load_state_dict(load_jax_params(tree))
    with torch.no_grad():
        got = port(_t(query), _t(ref), _t(value), FEAT_SHAPES)
    _close(got, want, 1e-5)


def test_encoder_layer_matches_flax():
    """Tolerance: rtol 1e-5 (LayerNorm epsilon 1e-6 on both sides)."""
    rng = np.random.RandomState(7)
    src, ref, _ = _layer_inputs(rng, sum(h * w for h, w in FEAT_SHAPES), 2)
    pos = rng.randn(*src.shape).astype(np.float32)
    jm = jd.EncoderLayer(dim=32, heads=4, levels=4, ffn=64)
    params = jm.init(jax.random.PRNGKey(1), src, pos, ref, FEAT_SHAPES)
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.5)
    want = jm.apply(_jax_tree(tree), src, pos, ref, FEAT_SHAPES)
    port = td.EncoderLayer(32, 4, 4, 64, points=4)
    port.load_state_dict(load_jax_params(tree))
    with torch.no_grad():
        got = port(_t(src), _t(pos), _t(ref), FEAT_SHAPES)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_decoder_layer_matches_flax(ref_dim):
    """The self-attention (flax MultiHeadDotProductAttention, value = tgt)
    written as projections, and the deformable cross-attention in either
    reference branch. Tolerance: rtol 1e-5."""
    rng = np.random.RandomState(8)
    tgt, ref, memory = _layer_inputs(rng, 12, ref_dim)
    qpos = rng.randn(*tgt.shape).astype(np.float32)
    jm = jd.DecoderLayer(dim=32, heads=4, levels=4, ffn=64)
    params = jm.init(jax.random.PRNGKey(2), tgt, qpos, ref, memory,
                     FEAT_SHAPES)
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.5)
    want = jm.apply(_jax_tree(tree), tgt, qpos, ref, memory, FEAT_SHAPES)
    port = td.DecoderLayer(32, 4, 4, 64, points=4)
    port.load_state_dict(load_jax_params(tree))
    with torch.no_grad():
        got = port(_t(tgt), _t(qpos), _t(ref), _t(memory), FEAT_SHAPES)
    _close(got, want, 1e-5)


def test_position_and_proposal_embeddings_match_jax():
    """position_embedding_sine, proposal_pos_embed and inverse_sigmoid
    (clipped at eps). Tolerance: rtol 1e-6 (sin, cos, pow may round
    apart by an ulp)."""
    rng = np.random.RandomState(9)
    _close(td.position_embedding_sine(6, 8, 32),
           jd.position_embedding_sine(6, 8, 32), 1e-6)
    unact = rng.randn(7, 4).astype(np.float32) * 3
    _close(td.proposal_pos_embed(_t(unact), 64),
           jd.proposal_pos_embed(jnp.asarray(unact), 64), 1e-6)
    x = np.concatenate([rng.rand(20), [0.0, 1.0, 1e-8, 1 - 1e-8]])
    x = x.astype(np.float32)
    _close(td.inverse_sigmoid(_t(x)), jd.inverse_sigmoid(jnp.asarray(x)),
           1e-6)


@pytest.mark.parametrize("shapes", [((4, 4), (2, 2)),
                                    ((60, 4), (30, 2), (15, 1), (8, 1))])
def test_encoder_output_proposals_match_jax(shapes):
    """The second case has invalid tokens: the 60-row level's first and
    last rows have centres within 0.01 of a border. Tolerance: exact
    validity, rtol 1e-6."""
    unact, valid = td.encoder_output_proposals(shapes)
    j_unact, j_valid = jd.encoder_output_proposals(shapes)
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    _close(unact, j_unact, 1e-6)
    if len(shapes) == 4:
        assert not valid.all()


def test_stable_topk_breaks_ties_as_jax():
    """Ties broken by the lowest index, as jax.lax.top_k does."""
    rng = np.random.RandomState(10)
    x = rng.randint(0, 4, 200).astype(np.float32)
    for k in (1, 7, 60, 200):
        v, i = td.stable_topk(_t(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(i.numpy(), np.asarray(ji))
        assert np.array_equal(v.numpy(), np.asarray(jv))


# ------------------------------------------------------------ DeformableDETR

VARIANTS = {
    "plain": {},
    "zeroshot": dict(use_zeroshot=True, zs_dim=16),
    "two_stage_refine": dict(with_box_refine=True, two_stage=True),
    "two_stage": dict(two_stage=True),
    # every encoder logit equal (enc_output's kernel zeroed): the top-k
    # seeding is all ties, broken by the lowest token index
    "two_stage_ties": dict(with_box_refine=True, two_stage=True),
    # fewer tokens (29) than queries (32): padded queries suppressed
    "padded": dict(with_box_refine=True, two_stage=True, num_queries=32,
                   enc_layers=1),
}
PADDED_SHAPES = ((4, 5), (2, 3), (1, 2), (1, 1))


def detr_case(name, seed=0):
    """(JAX module, numpy tree with spread sampling kernels, port module
    with the tree loaded, features, zs or None)."""
    kw = dict(MINI, **VARIANTS[name])
    rng = np.random.RandomState(seed)
    feats = _feats(rng, PADDED_SHAPES if name == "padded" else FEAT_SHAPES)
    zs = rng.randn(16, 6).astype(np.float32) if kw.get("use_zeroshot") \
        else None
    jm = jd.DeformableDETR(points=2, **kw)
    params = jm.init(jax.random.PRNGKey(seed), [jnp.asarray(f) for f in feats],
                     None if zs is None else jnp.asarray(zs))
    tree = spread(jax.tree_util.tree_map(np.asarray, params), rng, 0.5)
    if name == "two_stage_ties":
        tree["params"]["enc_output"]["kernel"][:] = 0.0
    port = td.DeformableDETR(in_channels=(32,) * 4, points=2, **kw)
    port.load_state_dict(load_jax_params(tree), strict=True)
    return jm, tree, port, feats, zs


@pytest.mark.parametrize("name", list(VARIANTS))
def test_deformable_detr_matches_flax(name):
    """DETROutputs of every variant. Tolerance: rtol 1e-5 (logits of the
    zero-shot head, at temperature 50, rtol 1e-5 of their largest)."""
    jm, tree, port, feats, zs = detr_case(name)
    want = jm.apply(_jax_tree(tree), [jnp.asarray(f) for f in feats],
                    None if zs is None else jnp.asarray(zs))
    with torch.no_grad():
        got = port([_t(f) for f in feats], None if zs is None else _t(zs))
    for field, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), field
        if g is not None:
            _close(g, w, 1e-5)
    if name == "padded":
        assert (got.logits[:, 29:] <= -1e3).all()
    if name == "two_stage_ties":
        enc = got.enc_logits[:, 0]
        assert bool((enc == enc[0]).all())


@pytest.mark.parametrize("name", [n for n in VARIANTS
                                  if n != "two_stage_ties"])
def test_converter_maps_every_leaf_once(name):
    """Every leaf of the JAX tree becomes exactly one port parameter of
    the same shape, and the strict load has nothing missing or unused."""
    _, tree, port, _, _ = detr_case(name)
    leaves = jax.tree_util.tree_leaves(tree)
    sd = load_jax_params(tree)
    assert len(sd) == len(leaves)
    own = port.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    res = port.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys


# ------------------------------------------------ matching, losses, inference

def _gt_np(rng, g, valid, hw=(128, 160)):
    h, w = hw
    x1 = rng.uniform(0, w * 0.6, g)
    y1 = rng.uniform(0, h * 0.6, g)
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, w * 0.4, g),
                      y1 + rng.uniform(8, h * 0.4, g)], -1).astype(np.float32)
    classes = rng.randint(0, 5, g).astype(np.int32)
    v = np.arange(g) < valid
    boxes[~v] = 0.0
    classes[~v] = 0
    return boxes, classes, v


def _both_gt(boxes, classes, valid):
    return (JaxGT(jnp.asarray(boxes), jnp.asarray(classes),
                  jnp.asarray(valid)),
            GroundTruth(_t(boxes), _t(classes), _t(valid)))


def test_matcher_cost_and_hungarian_match_jax():
    """Cost matrix within rtol 1e-5 (1e9 on padded GT columns), and the
    same assignment from each side's own cost."""
    rng = np.random.RandomState(11)
    logits = (rng.randn(12, 5) * 2).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (12, 2)),
                            rng.uniform(0.05, 0.4, (12, 2))], -1)
    boxes = boxes.astype(np.float32)
    jgt, tgt = _both_gt(*_gt_np(rng, 6, 4))
    want = jd.matcher_cost_matrix(jnp.asarray(logits), jnp.asarray(boxes),
                                  jgt, (128, 160))
    got = td.matcher_cost_matrix(_t(logits), _t(boxes), tgt, (128, 160))
    _close(got, want, 1e-5)
    qi, gi = td.hungarian_match(got.numpy(), tgt.valid.numpy())
    jqi, jgi = jd.hungarian_match(np.asarray(want), np.asarray(jgt.valid))
    assert np.array_equal(qi, jqi) and np.array_equal(gi, jgi)
    assert len(qi) == 4
    empty = td.hungarian_match(got.numpy(), np.zeros(6, bool))
    assert empty[0].size == 0 and empty[1].size == 0


@pytest.mark.parametrize("matched", [3, 0])
def test_detr_losses_match_jax(matched):
    """A padded assignment (3 of 5 rows, or none); focal CE, L1 and giou.
    Tolerance: rtol 1e-5."""
    rng = np.random.RandomState(12)
    logits = (rng.randn(12, 5) * 2).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (12, 2)),
                            rng.uniform(0.05, 0.4, (12, 2))], -1)
    boxes = boxes.astype(np.float32)
    jgt, tgt = _both_gt(*_gt_np(rng, 5, 4))
    mq = np.array([7, 2, 10, 0, 0], np.int64)
    mg = np.array([1, 0, 3, 0, 0], np.int64)
    mv = np.arange(5) < matched
    want = jd.detr_losses(jnp.asarray(logits), jnp.asarray(boxes), jgt,
                          jnp.asarray(mq), jnp.asarray(mg), jnp.asarray(mv),
                          (128, 160), 5)
    got = td.detr_losses(_t(logits), _t(boxes), tgt, _t(mq), _t(mg), _t(mv),
                         (128, 160), 5)
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], 1e-5)


def test_detr_inference_matches_jax_with_ties():
    """Top-k over flattened (query, class) scores with tied scores (the
    padded queries' sigmoid(-1e4) = 0, and repeated logits): the same
    indices, ties by the lowest index. Tolerance: boxes rtol 1e-6."""
    rng = np.random.RandomState(13)
    logits = rng.randint(-3, 3, (12, 5)).astype(np.float32)
    logits[8:] = -1e4
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (12, 2)),
                            rng.uniform(0.05, 0.4, (12, 2))], -1)
    boxes = boxes.astype(np.float32)
    for k in (10, 45, 60):
        want = jd.detr_inference(jnp.asarray(logits), jnp.asarray(boxes),
                                 (128, 160), topk=k)
        got = td.detr_inference(_t(logits), _t(boxes), (128, 160), topk=k)
        assert np.array_equal(got.classes.numpy(), np.asarray(want.classes))
        assert np.array_equal(got.scores.numpy(), np.asarray(want.scores))
        assert bool(got.valid.all()) and got.valid.shape == (k,)
        _close(got.boxes, want.boxes, 1e-6)
