"""Deformable-DETR (the reference's alternative detector family).

Counterpart of the JAX package's `models/deformable_detr.py` (ref:
Detic/detic/modeling/meta_arch/d2_deformable_detr.py and
third_party/Deformable-DETR). Defaults mirror detic/config.py:160-180:
hidden 256, 8 heads, 6 encoder + 6 decoder layers, FFN 2048, 4 feature
levels x 4 points, focal alpha 0.25, cost and loss weights cls 2 / L1 5 /
giou 2.

Module names mirror the JAX parameter tree, so `convert/from_jax.py`
carries a JAX model's parameters across leaf by leaf. The layouts are the
JAX package's: one image [H, W, 3], features [H, W, C], tokens [S, C].
Every deformable attention (6 encoder and 6 decoder layers a frame) calls
`ops/ms_deform_attn.py:ms_deform_attn`, which launches the hand-written
kernels on the card and takes the plain version on the CPU.

`models/detector.py:build_detector` builds the family for
`roi.head_type="detr"`, sized by `DetectorConfig.detr` (whose defaults are
the JAX package's); `DeformableDetrDetector.detect` runs a batch of frames
(the trunk over the batch, the transformer a frame at a time, one top-k over
the batch), as `engine/coco.py:evaluate_coco` calls it. Its stages are the
spans `eodt.detr.trunk`, `.encoder`, `.two_stage`, `.decoder` and `.post`
(`utils/tracing.py`), which cover it whole.

Where the two frameworks differ:
  * the JAX package's LayerNorm uses epsilon 1e-6 (torch's default is
    1e-5);
  * the decoder's self-attention (the JAX multi-head dot-product
    attention module) is written as its projections, softmax(q k^T /
    sqrt(d)) v and the output projection; the value is `tgt` without
    `query_pos`;
  * `jax.lax.top_k` breaks ties by the lowest index and `torch.topk`
    promises no order on the card, so both top-ks (the two-stage query
    seeding, `detr_inference`) are a stable descending sort and a slice;
  * constants that JAX builds from lists are filled on the device
    (`_const`), never copied from the host, so the forward and
    `detr_inference` run without a host sync;
  * TF32 is switched off by `build_deformable_detr`: the family is f32
    throughout, as in the JAX package;
  * `DeformableDETR.points` is kept but never reaches the layers, which
    sample 4 points whatever it says: the JAX `DeformableDETR` builds its
    encoder and decoder layers without it (their default is 4), and a JAX
    parameter tree of any `points` loads only into the same shapes.
The Hungarian assignment of the train step runs on the host (scipy), as
in the JAX package and the reference (matcher.py is no-grad).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import DetectorConfig
from ..ops.ms_deform_attn import ms_deform_attn
from ..structures import Detections, GroundTruth, giou_xyxy
from ..utils.tracing import span
from .detector import resolve_device
from .layers import GroupNorm, nchw, nhwc
from .resnet import ResNet50

LN_EPS = 1e-6           # the JAX package's LayerNorm epsilon


@functools.lru_cache(maxsize=None)
def _const_on(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    out = torch.empty((len(values),), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def _const(values: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """A small f32 tensor of `values` on `like`'s device, made once per
    values and device by fill kernels (no host-to-device copy, so no host
    sync); callers must not write to it."""
    return _const_on(tuple(float(v) for v in values), like.device)


def position_embedding_sine(h: int, w: int, dim: int = 256,
                            temperature: float = 10000.0,
                            device: "torch.device | str" = "cpu"
                            ) -> torch.Tensor:
    """[H, W, dim] sine position embedding (ref: position_encoding.py,
    normalize=True)."""
    scale = 2 * math.pi
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / h * \
        scale
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / w * \
        scale
    half = dim // 2
    dim_t = temperature ** (2 * (torch.arange(half, device=device) // 2) /
                            half)
    pos_x = xs[None, :, None] / dim_t
    pos_y = ys[:, None, None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]),
                         torch.cos(pos_x[..., 1::2])], -1).reshape(1, w, half)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]),
                         torch.cos(pos_y[..., 1::2])], -1).reshape(h, 1, half)
    return torch.cat([pos_y.expand(h, w, half), pos_x.expand(h, w, half)], -1)


class MSDeformAttnLayer(nn.Module):
    """Multi-scale deformable attention module (query side; ref:
    models/ops/modules/ms_deform_attn.py): per (head, level, point)
    sampling offsets and attention weights predicted from the query,
    applied to value projections of the flattened features."""

    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4,
                 points: int = 4):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                value: torch.Tensor, spatial_shapes) -> torch.Tensor:
        """query [Q, C]; ref_points [Q, 2] (x, y) or [Q, 4] (cx, cy, w, h)
        in [0, 1]; value [S, C] -> [Q, C]."""
        q, c = query.shape
        m, l, p = self.heads, self.levels, self.points
        v = self.value_proj(value).reshape(-1, m, c // m)
        offsets = self.sampling_offsets(query).reshape(q, m, l, p, 2)
        attn = torch.softmax(
            self.attention_weights(query).reshape(q, m, l * p), -1)
        attn = attn.reshape(q, m, l, p)
        if ref_points.shape[-1] == 4:
            # the 4-d (box) reference: offsets scale with the box size
            # (ref: deformable_transformer.py decoder
            # `offsets / n_points * reference_points[..., 2:] * 0.5`)
            r = ref_points[:, None, None, None, :]
            locs = r[..., :2] + offsets / p * r[..., 2:] * 0.5
        else:
            wh = _const([v for h, w in spatial_shapes for v in (w, h)],
                        query).reshape(-1, 2)
            locs = ref_points[:, None, None, None, :] + \
                offsets / wh[None, None, :, None, :]
        out = ms_deform_attn(v, tuple(spatial_shapes), locs, attn)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4,
                 ffn: int = 2048, points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttnLayer(dim, heads, levels, points)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, src, pos, ref_points, spatial_shapes):
        attn = self.self_attn(src + pos, ref_points, src, spatial_shapes)
        src = self.norm1(src + attn)
        y = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + y)


class MultiHeadAttention(nn.Module):
    """The JAX package's multi-head dot-product attention on one
    sequence: per-head projections, softmax(q k^T / sqrt(d)) v, the output
    projection (the query scaled before the product, as there)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in):
        n, c = q_in.shape
        h = self.heads
        d = c // h
        q = self.query(q_in).reshape(n, h, d) / math.sqrt(d)
        k = self.key(k_in).reshape(-1, h, d)
        v = self.value(v_in).reshape(-1, h, d)
        w = torch.softmax(torch.einsum("qhd,khd->hqk", q, k), -1)
        return self.out(torch.einsum("hqk,khd->qhd", w, v).reshape(n, c))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4,
                 ffn: int = 2048, points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = MSDeformAttnLayer(dim, heads, levels, points)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, tgt, query_pos, ref_points, memory, spatial_shapes):
        # q = k = tgt + pos but value = tgt: the positional term must not
        # leak into the attention values
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        ca = self.cross_attn(tgt + query_pos, ref_points, memory,
                             spatial_shapes)
        tgt = self.norm2(tgt + ca)
        y = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + y)


class DETROutputs(NamedTuple):
    logits: torch.Tensor        # [layers, Q, C]
    boxes_cxcywh: torch.Tensor  # [layers, Q, 4] normalised
    # two-stage encoder proposals (ref: deformable_detr.py:186-188
    # out['enc_outputs']); None in single-stage mode
    enc_logits: Optional[torch.Tensor] = None        # [S, C]
    enc_boxes_cxcywh: Optional[torch.Tensor] = None  # [S, 4]
    # the encoder tokens that seeded the decoder's queries, [Q] (two-stage)
    topk_idx: Optional[torch.Tensor] = None


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def proposal_pos_embed(unact: torch.Tensor, dim: int = 512,
                       temperature: float = 10000.0) -> torch.Tensor:
    """[Q, 4] unactivated proposal coords -> [Q, dim] sine embedding (ref:
    deformable_transformer.py get_proposal_pos_embed)."""
    q = unact.shape[0]
    num_pos_feats = dim // 4
    dim_t = temperature ** (2 * (torch.arange(num_pos_feats,
                                              device=unact.device) // 2) /
                            num_pos_feats)
    pos = (torch.sigmoid(unact) * (2 * math.pi))[:, :, None] / dim_t
    pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                      -1)                                # [Q, 4, F/2, 2]
    return pos.reshape(q, dim)


def encoder_output_proposals(shapes: Sequence[Tuple[int, int]],
                             device: "torch.device | str" = "cpu"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token initial proposals for the two-stage first stage (ref:
    deformable_transformer.py gen_encoder_output_proposals): grid centres
    (i + 0.5) / H with wh = 0.05 * 2^level; a token whose proposal leaves
    (0.01, 0.99) is invalid. Returns (unactivated proposals [S, 4], valid
    [S]); an invalid token's proposal is the saturating 1e4."""
    props = []
    for lvl, (h, w) in enumerate(shapes):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        wh = torch.full((h, w), 0.05 * (2.0 ** lvl), dtype=torch.float32,
                        device=device)
        props.append(torch.stack([gx, gy, wh, wh], -1).reshape(-1, 4))
    proposals = torch.cat(props, 0)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
    unact = torch.where(valid[:, None], inverse_sigmoid(proposals), 1e4)
    return unact, valid


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest, ties by the
    lowest index (a stable descending sort and a slice)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class DeformableDETR(nn.Module):
    """Single-image Deformable-DETR head over feature levels of
    `in_channels` channels (the trailing `pre_projected` levels already at
    `hidden_dim`). Classes through a plain linear head, or through the
    CLIP-space `zs_weight` with `use_zeroshot` (the Detic open-vocabulary
    DETR, d2_deformable_detr.py:163-177). `points` is recorded only: the
    layers sample their default 4 points, as the JAX package's do."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 20,
                 hidden_dim: int = 256, heads: int = 8, enc_layers: int = 6,
                 dec_layers: int = 6, ffn: int = 2048,
                 num_queries: int = 100, levels: int = 4, points: int = 4,
                 use_zeroshot: bool = False, zs_dim: int = 512,
                 norm_temperature: float = 50.0,
                 with_box_refine: bool = False, two_stage: bool = False,
                 pre_projected: int = 0):
        super().__init__()
        c = hidden_dim
        self.num_classes = num_classes
        self.hidden_dim = c
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.num_queries = num_queries
        self.use_zeroshot = use_zeroshot
        self.norm_temperature = norm_temperature
        self.with_box_refine = with_box_refine
        self.two_stage = two_stage
        self.points = points
        self.n_proj = len(in_channels) - pre_projected
        for i, ch in enumerate(in_channels):
            if i < self.n_proj:
                self.add_module(f"input_proj{i}", nn.Conv2d(ch, c, 1))
                self.add_module(f"input_gn{i}", GroupNorm(32, c))
            self.register_parameter(f"level_embed{i}",
                                    nn.Parameter(torch.zeros(c)))
        for i in range(enc_layers):
            self.add_module(f"encoder{i}",
                            EncoderLayer(c, heads, levels, ffn))
        # prediction heads: shared across decoder layers (per-layer clones
        # only under box refine); two-stage adds one more head for the
        # encoder stage, shared with the decoder's unless refining
        # (ref: deformable_detr.py:96-106 num_pred / _get_clones)
        self.n_heads = (dec_layers + (1 if two_stage else 0)) \
            if with_box_refine else 1
        for k in range(self.n_heads):
            if use_zeroshot:
                self.add_module(f"cls_embed{k}", nn.Linear(c, zs_dim))
            else:
                self.add_module(f"class_embed{k}", nn.Linear(c, num_classes))
            self.add_module(f"bbox_embed{k}_0", nn.Linear(c, c))
            self.add_module(f"bbox_embed{k}_1", nn.Linear(c, c))
            self.add_module(f"bbox_embed{k}_out", nn.Linear(c, 4))
        if two_stage:
            self.enc_output = nn.Linear(c, c)
            self.enc_output_norm = nn.LayerNorm(c, eps=LN_EPS)
            self.pos_trans = nn.Linear(2 * c, 2 * c)
            self.pos_trans_norm = nn.LayerNorm(2 * c, eps=LN_EPS)
        else:
            self.query_embed = nn.Parameter(torch.zeros(num_queries, 2 * c))
            self.reference_points = nn.Linear(c, 2)
        for i in range(dec_layers):
            self.add_module(f"decoder{i}",
                            DecoderLayer(c, heads, levels, ffn))

    def apply_cls(self, k: int, x: torch.Tensor,
                  zs_weight: Optional[torch.Tensor]) -> torch.Tensor:
        if self.use_zeroshot:
            if zs_weight is None:
                raise ValueError("a zero-shot DeformableDETR needs zs_weight")
            emb = getattr(self, f"cls_embed{k}")(x)
            emb = self.norm_temperature * emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp(min=1e-12)
            # f32 logits against the [D, C+1] classifier (TF32 off)
            return emb @ zs_weight[:, :self.num_classes].float()
        return getattr(self, f"class_embed{k}")(x)

    def apply_bbox(self, k: int, x: torch.Tensor) -> torch.Tensor:
        d = F.relu(getattr(self, f"bbox_embed{k}_0")(x))
        d = F.relu(getattr(self, f"bbox_embed{k}_1")(d))
        return getattr(self, f"bbox_embed{k}_out")(d)

    def forward(self, features: Sequence[torch.Tensor],
                zs_weight: Optional[torch.Tensor] = None) -> DETROutputs:
        """features: per-level [H_l, W_l, C_l]; zs_weight [D, C+1] for the
        zero-shot classifier."""
        shapes = tuple((int(f.shape[0]), int(f.shape[1])) for f in features)
        with span("eodt.detr.encoder"):
            src = self._encode(features, shapes)
        with span("eodt.detr.two_stage"):
            query_pos, tgt, ref, enc_logits, enc_boxes, topk_idx, \
                query_valid = self._seed_queries(src, shapes, zs_weight)
        with span("eodt.detr.decoder"):
            logits, boxes = self._decode(tgt, query_pos, ref, src, shapes,
                                         query_valid, zs_weight)
        return DETROutputs(logits=logits, boxes_cxcywh=boxes,
                           enc_logits=enc_logits, enc_boxes_cxcywh=enc_boxes,
                           topk_idx=topk_idx)

    def _encode(self, features, shapes):
        """Input projections, position embeddings and the encoder layers:
        the memory [S, C]."""
        c = self.hidden_dim
        device = features[0].device
        srcs, poss, refs = [], [], []
        for i, f in enumerate(features):
            if i < self.n_proj:
                s = getattr(self, f"input_proj{i}")(nchw(f.float()))
                s = nhwc(getattr(self, f"input_gn{i}")(s), False)
            else:
                s = f.float()
            h, w = shapes[i]
            pos = position_embedding_sine(h, w, c, device=device) + \
                getattr(self, f"level_embed{i}")
            srcs.append(s.reshape(-1, c))
            poss.append(pos.reshape(-1, c))
            ys = (torch.arange(h, dtype=torch.float32, device=device) +
                  0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=device) +
                  0.5) / w
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        src = torch.cat(srcs, 0)
        pos = torch.cat(poss, 0)
        enc_ref = torch.cat(refs, 0)

        for i in range(self.enc_layers):
            src = getattr(self, f"encoder{i}")(src, pos, enc_ref, shapes)
        return src

    def _seed_queries(self, src, shapes, zs_weight):
        """The decoder's queries: two-stage, every encoder token a proposal
        scored by the encoder head, the top-`num_queries` seeding queries
        and 4-d references; else the learned queries and 2-d references.
        Returns (query_pos, tgt, ref, enc_logits, enc_boxes, topk_idx,
        query_valid); the last four None where they do not apply."""
        c = self.hidden_dim
        device = src.device
        enc_logits = enc_boxes = topk_idx = query_valid = None
        if self.two_stage:
            # encoder tokens -> proposals; the top-k seed the decoder
            # (ref: deformable_transformer.py:157-172)
            prop_unact, prop_valid = encoder_output_proposals(shapes, device)
            out_mem = torch.where(prop_valid[:, None], src, 0.0)
            out_mem = self.enc_output_norm(self.enc_output(out_mem))
            k_enc = self.dec_layers if self.with_box_refine else 0
            enc_logits = self.apply_cls(k_enc, out_mem, zs_weight)  # [S, C]
            enc_unact = self.apply_bbox(k_enc, out_mem) + prop_unact
            enc_boxes = torch.sigmoid(enc_unact)
            # fewer tokens than queries (miniature inputs): repeat the last
            # index and suppress the padded queries' logits below
            kq = min(self.num_queries, enc_logits.shape[0])
            _, topk_idx = stable_topk(enc_logits[:, 0], kq)
            if kq < self.num_queries:
                topk_idx = torch.cat([topk_idx, topk_idx[-1:].expand(
                    self.num_queries - kq)])
                query_valid = torch.arange(self.num_queries,
                                           device=device) < kq
            topk_unact = enc_unact[topk_idx].detach()           # [Q, 4]
            ref = torch.sigmoid(topk_unact)
            pos_trans = self.pos_trans_norm(self.pos_trans(
                proposal_pos_embed(topk_unact, 2 * c)))
            query_pos, tgt = pos_trans[:, :c], pos_trans[:, c:]
        else:
            query_pos = self.query_embed[:, :c]
            tgt = self.query_embed[:, c:]
            ref = torch.sigmoid(self.reference_points(query_pos))  # [Q, 2]
        return (query_pos, tgt, ref, enc_logits, enc_boxes, topk_idx,
                query_valid)

    def _decode(self, tgt, query_pos, ref, src, shapes, query_valid,
                zs_weight):
        """The decoder layers with each layer's class and box heads:
        (logits [layers, Q, C], boxes [layers, Q, 4])."""
        all_logits, all_boxes = [], []
        for i in range(self.dec_layers):
            tgt = getattr(self, f"decoder{i}")(tgt, query_pos, ref, src,
                                               shapes)
            k = i if self.with_box_refine else 0
            logits = self.apply_cls(k, tgt, zs_weight)
            delta = self.apply_bbox(k, tgt)
            # boxes = sigmoid(delta + inverse_sigmoid(ref)); 2-d references
            # update only cx, cy (ref: deformable_detr.py tmp[..., :2] += ref)
            inv_ref = inverse_sigmoid(ref)
            if ref.shape[-1] == 2:
                inv_ref = F.pad(inv_ref, (0, 2))
            boxes = torch.sigmoid(delta + inv_ref)
            if query_valid is not None:
                # padded duplicate queries: scores driven to ~0, so they
                # can match no GT in training and rank last in inference
                logits = torch.where(query_valid[:, None], logits, -1e4)
            all_logits.append(logits)
            all_boxes.append(boxes)
            if self.with_box_refine:
                # the detached 4-d box is the next layer's reference
                # (deformable_transformer.py new_reference_points)
                ref = boxes.detach()
        return torch.stack(all_logits), torch.stack(all_boxes)


class DeformableDetrDetector(nn.Module):
    """End-to-end single-image DETR detector: ResNet-50 C3-C5 (f32) and an
    extra stride-2 level, then the deformable transformer sized by
    `cfg.detr` (ref: d2_deformable_detr.py DeformableDetr), 4 points a
    level."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        d = cfg.detr
        self.cfg = cfg
        self.num_queries = d.num_queries
        self.backbone = ResNet50(cfg.backbone.depths, dtype=torch.float32)
        self.detr = DeformableDETR(
            in_channels=(512, 1024, 2048, d.hidden_dim),
            num_classes=cfg.roi.num_classes, hidden_dim=d.hidden_dim,
            heads=d.heads, enc_layers=d.enc_layers, dec_layers=d.dec_layers,
            ffn=d.ffn_dim, num_queries=d.num_queries,
            use_zeroshot=d.use_zeroshot, zs_dim=cfg.roi.zs_weight_dim,
            norm_temperature=cfg.roi.norm_temperature,
            with_box_refine=d.with_box_refine, two_stage=d.two_stage,
            pre_projected=1)
        # the extra level: ONE stride-2 3x3 conv + GN on C5 is that level's
        # whole input projection (ref: deformable_detr.py input_proj
        # extra-level branch), so the trunk takes it pre-projected
        self.extra_level = nn.Conv2d(2048, self.detr.hidden_dim, 3, 2, 1)
        self.extra_gn = GroupNorm(32, self.detr.hidden_dim)

    def levels(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """RGB pixels [H, W, 3] or [B, H, W, 3] -> the four levels (C3, C4,
        C5 and the projected extra level) in the same layout."""
        batched = images.dim() == 4
        with span("eodt.detr.trunk"):
            mean = _const(self.cfg.input.pixel_mean, images)
            std = _const(self.cfg.input.pixel_std, images)
            c3, c4, c5 = self.backbone((images.float() - mean) / std)
            c6 = nhwc(self.extra_gn(self.extra_level(nchw(c5))), batched)
        return c3, c4, c5, c6

    def forward(self, image: torch.Tensor,
                zs_weight: Optional[torch.Tensor] = None) -> DETROutputs:
        """image [H, W, 3] RGB pixels -> DETROutputs."""
        return self.detr(self.levels(image), zs_weight)

    def detect(self, images: torch.Tensor,
               zs_weight: Optional[torch.Tensor] = None) -> Detections:
        """RGB pixels [B, H, W, 3] -> the top `detr.test_topk` detections
        of each frame, [B, K, ...] in pixels: the trunk over the batch,
        the transformer a frame at a time, `detr_inference` over the
        batch's last-layer outputs at once. No host sync."""
        feats = self.levels(images)
        outs = [self.detr(tuple(f[k] for f in feats), zs_weight)
                for k in range(images.shape[0])]
        with span("eodt.detr.post"):
            return detr_inference(
                torch.stack([o.logits[-1] for o in outs]),
                torch.stack([o.boxes_cxcywh[-1] for o in outs]),
                tuple(images.shape[1:3]), self.cfg.detr.test_topk)


def init_detr_weights(model: nn.Module, seed: int,
                      attn_init_std: float = 0.0) -> None:
    """Random weights from `seed` with the JAX package's init families:
    fan-in normal for every dense and conv kernel, zero biases, unit
    norms, normal(1) level and query embeddings, and zero sampling-offset
    and attention-weight kernels (every sample on its reference point,
    uniform attention; deformable_detr.py:68-73). `attn_init_std` > 0
    draws those two kernels from normal(0, attn_init_std) instead, so that
    the samples spread over the levels and their borders."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, (nn.Linear, nn.Conv2d)):
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("sampling_offsets", "attention_weights"):
                fill(mod.weight, attn_init_std)
            else:
                fill(mod.weight, math.sqrt(1.0 / mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("level_embed") or leaf == "query_embed":
                fill(p, 1.0)


def build_deformable_detr(cfg: Optional[DetectorConfig] = None, seed: int = 0,
                          device: "torch.device | str" = "cuda",
                          attn_init_std: float = 0.0
                          ) -> DeformableDetrDetector:
    """`DeformableDetrDetector(cfg)` on `device` with random
    weights from `seed` (load real ones with `load_jax_params`). TF32 is
    switched off for the process: the family runs in f32."""
    cfg = cfg or DetectorConfig()
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = DeformableDetrDetector(cfg)
    init_detr_weights(model, seed, attn_init_std)
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Matching, losses and inference (SetCriterion / HungarianMatcher)
# ---------------------------------------------------------------------------

def boxes_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _gt_cxcywh(boxes_xyxy: torch.Tensor, image_hw) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """GT pixel boxes -> (normalised xyxy, normalised cxcywh)."""
    h, w = image_hw
    xyxy = boxes_xyxy / _const((w, h, w, h), boxes_xyxy)
    cxcywh = torch.stack([
        (xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2,
        xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], -1)
    return xyxy, cxcywh


def matcher_cost_matrix(logits: torch.Tensor, boxes_cxcywh: torch.Tensor,
                        gt: GroundTruth, image_hw: Tuple[int, int],
                        cls_weight: float = 2.0, l1_weight: float = 5.0,
                        giou_weight: float = 2.0,
                        focal_alpha: float = 0.25) -> torch.Tensor:
    """[Q, G] Hungarian cost (ref: models/matcher.py): focal-style class
    cost + L1 on normalised cxcywh + giou; 1e9 for padded GT columns."""
    p = torch.sigmoid(logits)[:, gt.classes.long()]             # [Q, G]
    pos_cost = focal_alpha * ((1 - p) ** 2) * (-torch.log(p + 1e-8))
    neg_cost = (1 - focal_alpha) * (p ** 2) * (-torch.log(1 - p + 1e-8))
    cost_cls = pos_cost - neg_cost
    gt_xyxy, gt_cxcywh = _gt_cxcywh(gt.boxes, image_hw)
    cost_l1 = (boxes_cxcywh[:, None] - gt_cxcywh[None]).abs().sum(-1)
    cost_giou = -giou_xyxy(boxes_cxcywh_to_xyxy(boxes_cxcywh)[:, None],
                           gt_xyxy[None])
    cost = cls_weight * cost_cls + l1_weight * cost_l1 + \
        giou_weight * cost_giou
    return torch.where(gt.valid[None, :], cost, 1e9)


def hungarian_match(cost: np.ndarray, gt_valid: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side assignment over the valid (leading) GT columns: (query
    idx, gt idx)."""
    from scipy.optimize import linear_sum_assignment
    g = int(gt_valid.sum())
    if g == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    q_idx, g_idx = linear_sum_assignment(cost[:, :g])
    return q_idx, g_idx


def detr_losses(logits: torch.Tensor, boxes_cxcywh: torch.Tensor,
                gt: GroundTruth, match_q: torch.Tensor, match_g: torch.Tensor,
                match_valid: torch.Tensor, image_hw: Tuple[int, int],
                num_classes: int, cls_weight: float = 2.0,
                l1_weight: float = 5.0, giou_weight: float = 2.0,
                focal_alpha: float = 0.25) -> Dict[str, torch.Tensor]:
    """SetCriterion losses of one decoder layer for a fixed, padded
    assignment (ref: deformable_detr.py SetCriterion and
    d2_deformable_detr.py CustomSetCriterion.loss_labels)."""
    q = logits.shape[0]
    num_boxes = match_valid.float().sum().clamp(min=1.0)
    # padded assignment rows land in a dummy slot q, dropped after
    target = torch.full((q + 1,), num_classes, dtype=torch.long,
                        device=logits.device)
    slot = torch.where(match_valid, match_q, q)
    target = target.index_put((slot,), gt.classes[match_g].long())[:q]
    onehot = (target[:, None] == torch.arange(
        num_classes, device=logits.device)).float()
    p = torch.sigmoid(logits)
    ce = -(onehot * torch.log(p + 1e-8) +
           (1 - onehot) * torch.log(1 - p + 1e-8))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    focal = ce * ((1 - p_t) ** 2)
    alpha_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
    loss_ce = (alpha_t * focal).sum() / num_boxes

    _, gt_cxcywh = _gt_cxcywh(gt.boxes[match_g], image_hw)
    pred = boxes_cxcywh[match_q]
    l1 = torch.where(match_valid[:, None], (pred - gt_cxcywh).abs(),
                     0.0).sum() / num_boxes
    giou = giou_xyxy(boxes_cxcywh_to_xyxy(pred),
                     boxes_cxcywh_to_xyxy(gt_cxcywh))
    loss_giou = torch.where(match_valid, 1 - giou, 0.0).sum() / num_boxes
    return {"loss_ce": cls_weight * loss_ce, "loss_bbox": l1_weight * l1,
            "loss_giou": giou_weight * loss_giou}


def detr_inference(logits: torch.Tensor, boxes_cxcywh: torch.Tensor,
                   image_hw: Tuple[int, int], topk: int = 100) -> Detections:
    """ref: d2_deformable_detr.py post-processing: the top-k of the
    flattened (query, class) sigmoid scores, ties by the lowest index;
    boxes shared across classes, in pixels. logits [..., Q, C] and boxes
    [..., Q, 4] (leading axes: frames, each on its own) -> [..., K]."""
    h, w = image_hw
    q, c = logits.shape[-2:]
    scores, idx = stable_topk(torch.sigmoid(logits).flatten(-2),
                              min(topk, q * c))
    boxes = torch.take_along_dim(boxes_cxcywh, (idx // c)[..., None], -2)
    boxes = boxes_cxcywh_to_xyxy(boxes) * _const((w, h, w, h), boxes_cxcywh)
    return Detections(boxes=boxes, scores=scores,
                      classes=(idx % c).to(torch.int32),
                      valid=torch.ones_like(scores, dtype=torch.bool))


def detr_train_step_host_matched(model: nn.Module, image: torch.Tensor,
                                 gt: GroundTruth, image_hw: Tuple[int, int],
                                 zs_weight: Optional[torch.Tensor] = None):
    """One DETR training step body: one forward, the Hungarian assignment
    on the host per decoder layer (and, two-stage, for the encoder stage
    against class-agnostic targets), then one backward through the losses
    with the assignment fixed, on the device of `gt`. `model` is a
    `DeformableDetrDetector` (or any module with `cfg.roi.num_classes` that
    maps `model(image, zs_weight)` to DETROutputs).
    Returns ((total, aux), grads): aux keys `{loss}_l{layer}` and
    `{loss}_enc`, grads {parameter name: gradient} (zeros where a parameter
    takes none). The optimizer step is the caller's.

    Host copies a step: GT validity once, one cost matrix a matched stage
    (device to host), then one copy of every assignment back."""
    out = model(image, zs_weight)
    g = gt.boxes.shape[0]
    valid = gt.valid.cpu().numpy()

    def host_match(logits, boxes, targets):
        with torch.no_grad():
            cost = matcher_cost_matrix(logits, boxes, targets, image_hw)
        qi, gi = hungarian_match(cost.cpu().numpy(), valid)
        m = np.zeros((3, g), np.int64)
        m[0, :len(qi)] = qi
        m[1, :len(gi)] = gi
        m[2, :len(qi)] = 1
        return m

    stages = [host_match(out.logits[i], out.boxes_cxcywh[i], gt)
              for i in range(out.logits.shape[0])]
    # two-stage: the encoder stage matches class-agnostic "binary" targets,
    # every GT label 0 (ref: deformable_detr.py:375-389 bin_targets)
    bin_gt = gt._replace(classes=torch.zeros_like(gt.classes))
    if out.enc_logits is not None:
        stages.append(host_match(out.enc_logits, out.enc_boxes_cxcywh,
                                 bin_gt))
    matches = torch.from_numpy(np.stack(stages))
    device = gt.boxes.device
    if device.type == "cuda":
        matches = matches.pin_memory()
    matches = matches.to(device, non_blocking=True)

    num_classes = model.cfg.roi.num_classes
    total = 0.0
    aux = {}
    for i, (mq, mg, mv) in enumerate(matches):
        enc = i == out.logits.shape[0]
        losses = detr_losses(
            out.enc_logits if enc else out.logits[i],
            out.enc_boxes_cxcywh if enc else out.boxes_cxcywh[i],
            bin_gt if enc else gt, mq, mg, mv.bool(), image_hw, num_classes)
        for k, v in losses.items():
            aux[f"{k}_enc" if enc else f"{k}_l{i}"] = v
            total = total + v
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, [p for _, p in named],
                                allow_unused=True)
    return ((total.detach(), {k: v.detach() for k, v in aux.items()}),
            {n: torch.zeros_like(p) if gr is None else gr
             for (n, p), gr in zip(named, grads)})
