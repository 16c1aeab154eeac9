"""FPN (p3-p7) with spatial-memory fusion.

Counterpart of the JAX package's `models/fpn.py`: lateral 1x1 + output
3x3 convs over C3-C5, nearest 2x top-down merges, p6/p7 by stride-2 3x3
convs, and per-level fusion of the egocentric memory image: 2x2-pooled
again for each level, a 1x1 `map_merge_projection` in f32 (512 -> 256),
scaled by `map_feature_weight`, then summed with (`sum`), replacing
(`mem_only`) or ignored by (`image_only`) the image features. A model
that reads no memory (`memory_type` "image_only" or "") has no
`map_merge_projection` parameters, as the JAX parameter tree and the
reference's image-only checkpoints have none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.memory_ops import pyramid_pool
from .layers import conv, nchw, nhwc

FUSIONS = ("sum", "mem_only", "image_only")


class RecurrentFPN(nn.Module):

    def __init__(self, in_channels=(512, 1024, 2048), out_channels: int = 256,
                 memory_dim: int = 512, feat_fusion: str = "sum",
                 map_feature_weight: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16,
                 with_memory: bool = True):
        super().__init__()
        if feat_fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {feat_fusion!r}")
        self.feat_fusion = feat_fusion
        self.dtype = dtype
        self.map_feature_weight = map_feature_weight
        oc = out_channels
        for i, ic in enumerate(in_channels):
            self.add_module(f"lateral{i + 1}",
                            nn.Conv2d(ic, oc, 1))
            self.add_module(f"output{i + 1}", nn.Conv2d(oc, oc, 3, 1, 1))
            if with_memory:
                self.add_module(f"map_merge_projection{i + 1}",
                                nn.Conv2d(memory_dim, oc, 1))
        self.p6 = nn.Conv2d(oc, oc, 3, 2, 1)
        self.p7 = nn.Conv2d(oc, oc, 3, 2, 1)

    def forward(self, c3: torch.Tensor, c4: torch.Tensor, c5: torch.Tensor,
                ego_memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
        """C3-C5 [H, W, C] and the memory image [H/4, W/4, D] (or None) of
        one frame -> p3..p7, each [H_l, W_l, 256]."""
        dt = self.dtype
        lat3 = conv(nchw(c3), self.lateral1, dt)
        lat4 = conv(nchw(c4), self.lateral2, dt)
        m5 = conv(nchw(c5), self.lateral3, dt)
        m4 = lat4 + F.interpolate(m5, scale_factor=2, mode="nearest")
        m3 = lat3 + F.interpolate(m4, scale_factor=2, mode="nearest")
        ps = [conv(m3, self.output1, dt), conv(m4, self.output2, dt),
              conv(m5, self.output3, dt)]

        if ego_memory is not None:
            mems = pyramid_pool(ego_memory.float(), 3)
            for i, mem in enumerate(mems):
                if self.feat_fusion == "image_only":
                    continue
                proj = conv(nchw(mem), getattr(
                    self, f"map_merge_projection{i + 1}"))
                proj = (proj * self.map_feature_weight).to(ps[i].dtype)
                ps[i] = proj + ps[i] if self.feat_fusion == "sum" else proj

        p6 = conv(ps[2], self.p6, dt)
        p7 = conv(F.relu(p6), self.p7, dt)
        return tuple(nhwc(p, batched=False) for p in (*ps, p6, p7))
