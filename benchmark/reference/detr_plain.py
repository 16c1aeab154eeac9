"""A plain reference of Deformable-DETR in its two-stage, box-refined form
with Detic's open-vocabulary classifier (arXiv:2010.04159; the reference
repository's detic/modeling/meta_arch/d2_deformable_detr.py over
fundamentalvision/Deformable-DETR), in plain `torch` and float32, one
frame at a time: no kernel, no cache, no batching. It imports nothing of
the program it is held against, and runs with TF32 off (`full_f32`).

Weights are read by name from a state dict in the program's naming (the
trunk `backbone.*`, the extra level `extra_level` / `extra_gn`, the
transformer `detr.*`), so both sides can be handed the same tensors.

Multi-scale deformable attention is Deformable-DETR's
`ms_deform_attn_core_pytorch`: per level, `F.grid_sample` (bilinear, zero
padding, align_corners=False) of the value map at 2 * location - 1, the
samples weighted by the attention weights and summed.

Departures from the published model (each the program's, and the JAX
package's it was ported from):

- LayerNorm epsilon 1e-6 (torch's default, which upstream uses, is 1e-5);
- the top-k of the two-stage seeding and of the post-processing is a
  stable descending sort and a slice, ties by the lowest index
  (`torch.topk` promises no order among ties);
- no padding mask: every frame fills its canvas, so the mask is all
  valid and the valid ratios are 1 (letterboxed frames, which pad, are
  not what this reference runs);
- the sine position embedding normalises (i + 1) / H (DETR's form;
  Deformable-DETR's position_encoding.py normalises (i + 0.5) / (H +
  1e-6));
- `inverse_sigmoid` clamps at 1e-6 (upstream 1e-5), and a proposal
  outside (0.01, 0.99) gets the unactivated coordinate 1e4 (upstream
  inf);
- the GroupNorms of the input projections compute the variance as the
  mean of the squared deviations.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
GN_EPS = 1e-5
BN_EPS = 1e-5


class Spec(NamedTuple):
    """The widths the reference runs at."""
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    hidden: int = 256
    heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    num_queries: int = 300
    points: int = 4
    num_classes: int = 1203
    temperature: float = 50.0
    topk: int = 300
    pixel_mean: Tuple[float, ...] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)


def full_f32() -> None:
    """f32 matmuls and convolutions in f32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------ the trunk

def frozen_bn(w: Dict[str, torch.Tensor], name: str,
              x: torch.Tensor) -> torch.Tensor:
    scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] +
                                             BN_EPS)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32) -> torch.Tensor:
    """x [1, C, H, W]."""
    g = x.reshape(x.shape[0], groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    g = (g - mean) / torch.sqrt(var + GN_EPS)
    return g.reshape(x.shape) * weight[:, None, None] + bias[:, None, None]


def resnet50(w: Dict[str, torch.Tensor], depths: Sequence[int],
             x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Normalised image [1, 3, H, W] -> (C3, C4, C5), [1, C, h, w]: a 7x7
    stride-2 stem, a 3x3 stride-2 max pool, four stages of bottlenecks
    (1x1, 3x3 with the stage's stride, 1x1 x4; a 1x1 projection on the
    first block's shortcut), frozen batch norm."""
    x = F.relu(frozen_bn(w, "backbone.bn1", F.conv2d(
        x, w["backbone.conv1.weight"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for stage, depth in enumerate(depths):
        for i in range(depth):
            p = f"backbone.layer{stage + 1}_{i}"
            stride = 2 if stage > 0 and i == 0 else 1
            y = F.relu(frozen_bn(w, f"{p}.bn1", F.conv2d(
                x, w[f"{p}.conv1.weight"])))
            y = F.relu(frozen_bn(w, f"{p}.bn2", F.conv2d(
                y, w[f"{p}.conv2.weight"], stride=stride, padding=1)))
            y = frozen_bn(w, f"{p}.bn3", F.conv2d(y, w[f"{p}.conv3.weight"]))
            if i == 0:
                x = frozen_bn(w, f"{p}.downsample_bn", F.conv2d(
                    x, w[f"{p}.downsample_conv.weight"], stride=stride))
            x = F.relu(y + x)
        outs.append(x)
    return tuple(outs[1:])


# ------------------------------------------------------------ the layers

def linear(w, name, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def layer_norm(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def sine_embedding(h: int, w: int, dim: int, device) -> torch.Tensor:
    """[h * w, dim]: y's sines and cosines, then x's (DETR's
    PositionEmbeddingSine, normalised, temperature 10000)."""
    half = dim // 2
    t = 10000.0 ** (2 * (torch.arange(half, device=device) // 2) / half)
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1) / h * \
        2 * math.pi
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1) / w * \
        2 * math.pi
    py, px = y[:, None] / t, x[:, None] / t
    py = torch.stack([py[:, 0::2].sin(), py[:, 1::2].cos()], -1).flatten(1)
    px = torch.stack([px[:, 0::2].sin(), px[:, 1::2].cos()], -1).flatten(1)
    return torch.cat([py[:, None].expand(h, w, half),
                      px[None].expand(h, w, half)], -1).reshape(h * w, dim)


def ms_deform_attn_core(value: torch.Tensor, shapes, locations: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Deformable-DETR's ms_deform_attn_core_pytorch for one frame: value
    [S, M, D], locations [Q, M, L, P, 2] in [0, 1], weights [Q, M, L, P]
    -> [Q, M * D]."""
    _, m, d = value.shape
    q, _, nl, p, _ = locations.shape
    per_level = value.split([h * w for h, w in shapes], 0)
    grids = 2 * locations - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        v = per_level[lvl].permute(1, 2, 0).reshape(m, d, h, w)
        g = grids[:, :, lvl].transpose(0, 1)                # [M, Q, P, 2]
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))  # [M, D, Q, P]
    a = weights.permute(1, 0, 2, 3).reshape(m, 1, q, nl * p)
    out = (torch.stack(sampled, -2).flatten(-2) * a).sum(-1)  # [M, D, Q]
    return out.permute(2, 0, 1).reshape(q, m * d)


def deform_attn(w, name, query, ref, value, shapes, heads):
    """MSDeformAttn: query [Q, C], ref [Q, 2] (a point) or [Q, 4] (a box),
    value [S, C]."""
    q, c = query.shape
    nl = len(shapes)
    v = linear(w, f"{name}.value_proj", value).reshape(-1, heads, c // heads)
    off = linear(w, f"{name}.sampling_offsets", query).reshape(
        q, heads, nl, -1, 2)
    p = off.shape[3]
    a = torch.softmax(linear(w, f"{name}.attention_weights", query).reshape(
        q, heads, nl * p), -1).reshape(q, heads, nl, p)
    if ref.shape[-1] == 2:
        norm = torch.tensor([[wd, ht] for ht, wd in shapes],
                            dtype=torch.float32, device=query.device)
        loc = ref[:, None, None, None] + off / norm[None, None, :, None]
    else:
        loc = ref[:, None, None, None, :2] + \
            off / p * ref[:, None, None, None, 2:] * 0.5
    return linear(w, f"{name}.output_proj",
                  ms_deform_attn_core(v, shapes, loc, a))


def self_attention(w, name, qk, v_in, heads):
    n, c = qk.shape
    d = c // heads
    q = linear(w, f"{name}.query", qk).reshape(n, heads, d).transpose(0, 1)
    k = linear(w, f"{name}.key", qk).reshape(n, heads, d).transpose(0, 1)
    v = linear(w, f"{name}.value", v_in).reshape(n, heads, d).transpose(0, 1)
    att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(d), -1)
    return linear(w, f"{name}.out", (att @ v).transpose(0, 1).reshape(n, c))


def ffn(w, name, x):
    return linear(w, f"{name}.linear2", F.relu(linear(w, f"{name}.linear1",
                                                      x)))


def classify(w, k, x, zs, spec: Spec):
    """Detic's zero-shot classifier: a linear embedding, L2-normalised,
    times the temperature, against the vocabulary's first C columns."""
    e = linear(w, f"detr.cls_embed{k}", x)
    e = spec.temperature * e / e.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return e @ zs[:, :spec.num_classes]


def box_delta(w, k, x):
    x = F.relu(linear(w, f"detr.bbox_embed{k}_0", x))
    x = F.relu(linear(w, f"detr.bbox_embed{k}_1", x))
    return linear(w, f"detr.bbox_embed{k}_out", x)


def stable_topk(x: torch.Tensor, k: int):
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


# ------------------------------------------------------------ the model

def levels(w: Dict[str, torch.Tensor], spec: Spec,
           image: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """RGB pixels [H, W, 3] -> the four levels [C, h, w]: C3-C5 by 1x1
    projections with GroupNorm, and a stride-2 3x3 convolution with
    GroupNorm on C5."""
    mean = torch.tensor(spec.pixel_mean, device=image.device)
    std = torch.tensor(spec.pixel_std, device=image.device)
    x = ((image.float() - mean) / std).permute(2, 0, 1)[None]
    c3, c4, c5 = resnet50(w, spec.depths, x)
    out = [group_norm(F.conv2d(c, w[f"detr.input_proj{i}.weight"],
                               w[f"detr.input_proj{i}.bias"]),
                      w[f"detr.input_gn{i}.weight"],
                      w[f"detr.input_gn{i}.bias"])
           for i, c in enumerate((c3, c4, c5))]
    out.append(group_norm(F.conv2d(c5, w["extra_level.weight"],
                                   w["extra_level.bias"], stride=2,
                                   padding=1),
                          w["extra_gn.weight"], w["extra_gn.bias"]))
    return tuple(x[0] for x in out)


def encode(w, spec: Spec, feats):
    """The encoder over the levels' tokens: (memory [S, C], shapes)."""
    device = feats[0].device
    shapes = [tuple(f.shape[1:]) for f in feats]
    src = torch.cat([f.flatten(1).t() for f in feats])
    pos = torch.cat([sine_embedding(h, wd, spec.hidden, device) +
                     w[f"detr.level_embed{i}"]
                     for i, (h, wd) in enumerate(shapes)])
    ref = torch.cat([torch.stack(torch.meshgrid(
        (torch.arange(wd, device=device) + 0.5) / wd,
        (torch.arange(h, device=device) + 0.5) / h, indexing="xy"),
        -1).reshape(-1, 2) for h, wd in shapes])
    for i in range(spec.enc_layers):
        p = f"detr.encoder{i}"
        src = layer_norm(w, f"{p}.norm1", src + deform_attn(
            w, f"{p}.self_attn", src + pos, ref, src, shapes, spec.heads))
        src = layer_norm(w, f"{p}.norm2", src + ffn(w, p, src))
    return src, shapes


def proposals(shapes, device):
    """Each token's proposal, (unactivated [S, 4], valid [S]): its cell's
    centre and a side of 0.05 x 2^level; valid inside (0.01, 0.99)."""
    out = []
    for lvl, (h, wd) in enumerate(shapes):
        gx, gy = torch.meshgrid((torch.arange(wd, device=device) + 0.5) / wd,
                                (torch.arange(h, device=device) + 0.5) / h,
                                indexing="xy")
        side = torch.full_like(gx, 0.05 * 2.0 ** lvl)
        out.append(torch.stack([gx, gy, side, side], -1).reshape(-1, 4))
    props = torch.cat(out)
    valid = ((props > 0.01) & (props < 0.99)).all(-1)
    return torch.where(valid[:, None], inverse_sigmoid(props), 1e4), valid


def proposal_embedding(unact: torch.Tensor, dim: int) -> torch.Tensor:
    """[Q, 4] -> [Q, dim]: each coordinate's sigmoid x 2 pi over dim / 4
    frequencies, sines and cosines interleaved."""
    n = dim // 4
    t = 10000.0 ** (2 * (torch.arange(n, device=unact.device) // 2) / n)
    x = torch.sigmoid(unact)[:, :, None] * 2 * math.pi / t
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                       -1).reshape(unact.shape[0], dim)


def forward(w: Dict[str, torch.Tensor], spec: Spec, image: torch.Tensor,
            zs: torch.Tensor, seed_idx: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """One frame [H, W, 3] through the detector. The decoder's queries are
    seeded by the encoder head's top `num_queries` tokens, or by the
    tokens `seed_idx` where it is given (the held check); each layer's
    box is the next layer's reference. Returns enc_logits [S, C], topk_idx [Q] (the seeds used),
    logits [layers, Q, C] and boxes [layers, Q, 4] (cx, cy, w, h in
    [0, 1])."""
    c = spec.hidden
    k_enc = spec.dec_layers
    src, shapes = encode(w, spec, levels(w, spec, image))
    unact, valid = proposals(shapes, src.device)
    mem = layer_norm(w, "detr.enc_output_norm", linear(
        w, "detr.enc_output", torch.where(valid[:, None], src, 0.0)))
    enc_logits = classify(w, k_enc, mem, zs, spec)
    enc_unact = box_delta(w, k_enc, mem) + unact
    if seed_idx is None:
        seed_idx = stable_topk(enc_logits[:, 0], spec.num_queries)[1]
    seed = enc_unact[seed_idx]
    q = layer_norm(w, "detr.pos_trans_norm", linear(
        w, "detr.pos_trans", proposal_embedding(seed, 2 * c)))
    query_pos, tgt = q[:, :c], q[:, c:]
    ref = torch.sigmoid(seed)
    logits, boxes = [], []
    for i in range(spec.dec_layers):
        p = f"detr.decoder{i}"
        qk = tgt + query_pos
        tgt = layer_norm(w, f"{p}.norm1", tgt + self_attention(
            w, f"{p}.self_attn", qk, tgt, spec.heads))
        tgt = layer_norm(w, f"{p}.norm2", tgt + deform_attn(
            w, f"{p}.cross_attn", tgt + query_pos, ref, src, shapes,
            spec.heads))
        tgt = layer_norm(w, f"{p}.norm3", tgt + ffn(w, p, tgt))
        logits.append(classify(w, i, tgt, zs, spec))
        box = torch.sigmoid(box_delta(w, i, tgt) + inverse_sigmoid(ref))
        boxes.append(box)
        ref = box
    return {"enc_logits": enc_logits, "topk_idx": seed_idx,
            "logits": torch.stack(logits), "boxes": torch.stack(boxes)}


def pixel_boxes(boxes: torch.Tensor, image_hw: Tuple[int, int]
                ) -> torch.Tensor:
    """Boxes (cx, cy, w, h) in [0, 1] [N, 4] -> xyxy in pixels [N, 4]."""
    h, wd = image_hw
    xyxy = torch.stack([boxes[:, 0] - boxes[:, 2] / 2,
                        boxes[:, 1] - boxes[:, 3] / 2,
                        boxes[:, 0] + boxes[:, 2] / 2,
                        boxes[:, 1] + boxes[:, 3] / 2], -1)
    scale = torch.tensor([wd, h, wd, h], dtype=torch.float32,
                         device=boxes.device)
    return xyxy * scale


def inference(logits: torch.Tensor, boxes: torch.Tensor,
              image_hw: Tuple[int, int], topk: int):
    """The top-k of the (query, class) sigmoid scores [Q, C]: (boxes xyxy
    in pixels [K, 4], scores [K], classes [K], queries [K])."""
    c = logits.shape[1]
    scores, idx = stable_topk(torch.sigmoid(logits).flatten(), topk)
    return pixel_boxes(boxes[idx // c], image_hw), scores, idx % c, idx // c
