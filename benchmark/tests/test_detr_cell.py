"""The `detr-r50-frame` cell on the CPU, at a miniature of its own (the
shared `miniature.json` has no `frame_batches` entry): its traffic and
weights are functions of the seed, a whole run of the miniature is
`correct` against `reference/detr_plain.py`, planted faults (decoder
references not refined between layers; detections' boxes a pixel off)
are not, the two-stage head's prior keeps the seeds on the tokens the
encoder saw, a traced run gives every per-layer reader of the cell a
value, and kernel 8's bound counts what a hand count gives. The control (TF32) acts on the card only: its readings
there are in PERF.md."""

from __future__ import annotations

import math

import torch

from benchmark import common
from benchmark.bounds import ms_deform_attn as msda
from benchmark.bounds.peaks import bound_s
from benchmark.traffic import frame_batches

SEED = 2 ** 36 + 11
MINI_OVERRIDES = {"backbone.depths": "(1, 1, 1, 1)", "detr.hidden_dim": 32,
                  "detr.heads": 4, "detr.enc_layers": 2,
                  "detr.dec_layers": 2, "detr.ffn_dim": 48,
                  "detr.num_queries": 12, "detr.test_topk": 20,
                  "roi.num_classes": 7, "roi.zs_weight_dim": 16,
                  "input.height": 64, "input.width": 96}
MINI_TRAFFIC = {"batch": 2, "height": 64, "width": 96, "source_hw": [48, 64],
                "pool_images": 4, "rectangles": 2, "warmup_batches": 1}


def mini_cell():
    cell = common.find_cell("detr-r50-frame")
    cell["config_file"] = dict(cell.config, overrides={
        **cell.config["overrides"], **MINI_OVERRIDES})
    cell["traffic_file"] = {**cell.traffic, **MINI_TRAFFIC}
    return cell


def test_pool_and_weights_are_functions_of_the_seed():
    p = mini_cell().traffic
    a, b, c = (frame_batches.image_pool(p, s, "cpu")
               for s in (SEED, SEED, 5))
    assert a.shape == (2, 2, 64, 96, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    r = frame_batches.Run(mini_cell(), SEED, "cpu")
    again = frame_batches.make_weights(r.model, SEED,
                                       mini_cell().config["init"], r.zs)
    assert all(torch.equal(r.weights[k], again[k]) for k in r.weights)
    assert float(r.weights["detr.level_embed0"].std()) > 0.5


def test_offset_bias_is_upstreams_grid():
    """Head m points along (cos, sin)(2 pi m / M) scaled to a largest
    coordinate of 1, point p at p + 1 cells, on every level."""
    r = frame_batches.Run(mini_cell(), SEED, "cpu")
    attn = r.model.detr.encoder0.self_attn
    bias = r.weights["detr.encoder0.self_attn.sampling_offsets.bias"].view(
        attn.heads, attn.levels, attn.points, 2)
    assert attn.heads == 4
    assert torch.allclose(bias[0, 2, 3], torch.tensor([4.0, 0.0]))
    assert torch.allclose(bias[1, 0, 0], torch.tensor([0.0, 1.0]),
                          atol=1e-6)
    assert torch.allclose(bias[2, 1, 1], torch.tensor([-2.0, 0.0]),
                          atol=1e-6)


@torch.no_grad()
def test_two_stage_prior_seeds_from_valid_tokens():
    """At the cell's four level shapes (17 821 tokens, the border ones
    zeroed before the two-stage head), on a memory whose every token
    scores below 0 for class 0 without the prior (a classifier column
    opposite the tokens' mean embedding): with `make_weights`' prior the
    border tokens score the floor, -temperature, and every seed is a
    token inside the border; with a zero bias the border tokens' 0
    outranks them all and seeds every query."""
    from embodied_object_detection_tpu_torch.models import \
        deformable_detr as td
    r = frame_batches.Run(mini_cell(), SEED, "cpu")
    detr = r.model.detr
    shapes = ((100, 134), (50, 67), (25, 34), (13, 17))
    _, valid = td.encoder_output_proposals(shapes, "cpu")
    assert 0 < int((~valid).sum()) < 1000
    gen = torch.Generator().manual_seed(3)
    src = 0.3 * torch.randn(int(valid.numel()), detr.hidden_dim,
                            generator=gen) + \
        torch.randn(detr.hidden_dim, generator=gen)
    head = getattr(detr, f"cls_embed{detr.dec_layers}")
    emb = detr.enc_output_norm(detr.enc_output(src[valid])) @ head.weight.T
    zs = r.zs.clone()
    zs[:, 0] = -emb.mean(0) / emb.mean(0).norm()
    init = mini_cell().config["init"]
    weights = frame_batches.make_weights(r.model, SEED, init, zs)
    head.bias.copy_(weights[f"detr.cls_embed{detr.dec_layers}.bias"])
    assert math.isclose(float(head.bias.norm()), init["enc_class_prior"],
                        rel_tol=1e-5)
    out = detr._seed_queries(src, shapes, zs)
    enc0, topk_idx = out[3][:, 0], out[5]
    temperature = r.cfg.roi.norm_temperature
    assert bool((enc0[~valid] <= -temperature * (1 - 1e-5)).all())
    assert bool(valid[topk_idx].all())
    head.bias.zero_()
    flat = detr._seed_queries(src, shapes, zs)
    assert float(flat[3][valid, 0].max()) < 0
    assert not bool(valid[flat[5]].any())


def test_miniature_is_correct():
    cell = mini_cell()
    result, checks, extra = frame_batches.run(cell, SEED, 0.3, False, False,
                                              "cpu")
    assert result["correct"] is True, checks
    assert set(checks) == set(cell["checks_file"]["limits"])
    assert result["attempted"] % 2 == 0 and extra["rate"] > 0


def test_planted_fault_is_not_correct(monkeypatch):
    """The port's decoder keeps every layer's reference at its seed box."""
    from embodied_object_detection_tpu_torch.models import \
        deformable_detr as td

    def unrefined(self, tgt, query_pos, ref, src, shapes, query_valid,
                  zs_weight):
        logits, boxes = [], []
        for i in range(self.dec_layers):
            tgt = getattr(self, f"decoder{i}")(tgt, query_pos, ref, src,
                                               shapes)
            logits.append(self.apply_cls(i, tgt, zs_weight))
            boxes.append(torch.sigmoid(self.apply_bbox(i, tgt) +
                                       td.inverse_sigmoid(ref)))
        return torch.stack(logits), torch.stack(boxes)

    monkeypatch.setattr(td.DeformableDETR, "_decode", unrefined)
    result, checks, _ = frame_batches.run(mini_cell(), SEED, 0.1, False,
                                          False, "cpu")
    assert result["correct"] is False
    assert checks["held_logit_gap_max"][0] > \
        checks["held_logit_gap_max"][1], checks


def test_planted_box_fault_is_not_correct(monkeypatch):
    """The detections' boxes a pixel to the right: every other check
    reads as before, the detection-box gap fails."""
    from embodied_object_detection_tpu_torch.models import \
        deformable_detr as td
    inference = td.detr_inference

    def shifted(*args, **kwargs):
        dets = inference(*args, **kwargs)
        return dets._replace(boxes=dets.boxes + torch.tensor(
            [1.0, 0.0, 1.0, 0.0]))

    monkeypatch.setattr(td, "detr_inference", shifted)
    result, checks, _ = frame_batches.run(mini_cell(), SEED, 0.1, False,
                                          False, "cpu")
    assert result["correct"] is False
    assert [k for k, (v, lim) in checks.items() if v > lim] == \
        ["det_box_gap_max"], checks


def test_traced_miniature_reads_every_metric():
    cell = mini_cell()
    result, _, extra = frame_batches.run(cell, SEED, 0.1, True, False, "cpu")
    view = common.TraceView(extra["trace"], extra["plain_clock"],
                            extra["frames"], extra["steps"], extra["flops"],
                            extra["f32_share"], extra["bounds"],
                            result["device"]["memory_peak_bytes"],
                            extra["plain_s"])
    names = [m["name"] for m in cell["per_layer"]]
    assert len(names) == 14
    got = {n: common.metric_reader(n)(view) for n in names}
    # on the CPU no kernel 8 launches, so its share is None; every span
    # is found
    assert got.pop("ms_deform_attn_roofline.detr") is None
    assert all(v is not None for v in got.values()), got
    assert extra["flops"] > 0 and extra["f32_share"] > 0.99


def test_ms_deform_attn_bound_against_a_hand_count():
    value = torch.zeros(10, 2, 4)
    locs = torch.zeros(3, 2, 2, 2, 2)
    attn = torch.zeros(3, 2, 2, 2)
    # value 320 B, locations 192, weights 96 read, output 3 x 8 x 4 written
    assert msda.ms_deform_attn(value, [2, 3, 2, 2], locs, attn) == \
        (320 + 192 + 96 + 96, 10 * 3 * 2 * 2 * 2 * 4)
    # the cell's encoder call: 63.9 MB, bound by bytes
    q = 100 * 134 + 50 * 67 + 25 * 34 + 13 * 17
    assert q == 17821
    b, ops = msda.ms_deform_attn(
        torch.empty(q, 8, 32), [], torch.empty(q, 8, 4, 4, 2),
        torch.empty(q, 8, 4, 4))
    assert b == q * 256 * 4 * 2 + q * 8 * 16 * 4 * 3
    assert bound_s(b, ops) == b / 3.35e12
