"""Seeded weights for the detector, drawn on the card in a few large calls.

The families are those of the port's `models/detector.py:init_weights`
(fan-in normal convs in the trunk and FPN, normal(0.01) CenterNet convs
with the focal prior bias on the heatmap and 8.0 on the regression,
c2_xavier box FCs, PyTorch's default Linear bound for the zero-shot
projection, normal(0.001) delta predictor, c2_msra mask convs,
normal(0.02) relative position tables, norms at identity, other biases
0); the draws differ: one normal and one uniform draw over all the leaves
of each family, from a `torch.Generator` on the card. The benchmark hands
the same tensors to the port and to the plain reference.

One family departs: the mask predictor is drawn at He scale
(sqrt(2 / fan_in)), like the mask convolutions, and not normal(0.001).
At 0.001 every mask probability is 0.5 +- 0.004, so the paste's 0.5
threshold decides each pixel on rounding noise, the memory's writes flip
between two runs of the same program, and every later frame follows
them; a trained mask head is confident, as it is at He scale."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from .common import torch_seed


def families(named: Iterable[Tuple[str, torch.Tensor]],
             prior_prob: float) -> Dict[str, tuple]:
    """{name: ("skip",) | ("const", v) | ("normal", std) |
    ("uniform", bound)} by `init_weights`'s rules."""
    out = {}
    for name, p in named:
        leaf = name.rsplit(".", 1)[-1]
        if "_gn" in name or name.startswith("centernet.scale") or \
                ("norm" in name and leaf == "weight" and p.dim() == 1):
            out[name] = ("skip",)
            continue
        if leaf == "relative_position_bias_table":
            out[name] = ("normal", 0.02)
            continue
        if leaf == "bias":
            if name == "centernet.agn_hm.bias":
                out[name] = ("const",
                             -math.log((1 - prior_prob) / prior_prob))
            elif name == "centernet.bbox_pred.bias":
                out[name] = ("const", 8.0)
            else:
                out[name] = ("const", 0.0)
            continue
        fan_in = p[0].numel()
        if ".deconv." in name:        # [in, out, kh, kw]
            fan_out = p.shape[1] * p[0, 0].numel()
        else:
            fan_out = p.shape[0] * p[0, 0].numel() if p.dim() == 4 \
                else p.shape[0]
        if name.startswith("centernet."):
            out[name] = ("normal", 0.01)
        elif ".box_head" in name or ".bbox_fc1." in name:
            out[name] = ("uniform", math.sqrt(3.0 / fan_in))
        elif ".cls_linear." in name:
            out[name] = ("uniform", math.sqrt(1.0 / fan_in))
        elif name.startswith("prop_score"):
            out[name] = ("uniform", math.sqrt(3.0 / fan_in)) \
                if ".fc1." in name else ("normal", 0.001)
        elif "mask_head.predictor" in name:
            out[name] = ("normal", math.sqrt(2.0 / fan_in))
        elif ".bbox_fc2." in name:
            out[name] = ("normal", 0.001)
        elif ".mask_head." in name:
            out[name] = ("normal", math.sqrt(2.0 / fan_out))
        else:
            out[name] = ("normal", math.sqrt(1.0 / fan_in))
    return out


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int,
                 prior_prob: float) -> Dict[str, torch.Tensor]:
    """{parameter name: f32 tensor on the model's device} from `seed`: the
    parameters' own values where the family is "skip" (the norms'
    identity), else the family's draw."""
    named = list(model.named_parameters())
    device = named[0][1].device
    fam = families(named, prior_prob)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 101))
    sizes = {k: sum(p.numel() for n, p in named if fam[n][0] == k)
             for k in ("normal", "uniform")}
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, p in named:
        kind = fam[name]
        if kind[0] == "skip":
            out[name] = p.detach().float().clone()
        elif kind[0] == "const":
            out[name] = torch.full(p.shape, kind[1], device=device)
        else:
            n = p.numel()
            flat = (normal if kind[0] == "normal" else uniform)[
                at[kind[0]]:at[kind[0]] + n]
            at[kind[0]] += n
            out[name] = (flat * kind[1] if kind[0] == "normal" else
                         (flat * 2.0 - 1.0) * kind[1]).view(p.shape)
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into the model's parameters, every one named."""
    for name, p in model.named_parameters():
        p.copy_(weights[name])
