"""Carry the JAX package's parameters into the port.

`load_jax_params` takes the JAX model's `params` tree as nested dicts of numpy
arrays and returns the port's state dict. The port's module names mirror
that tree, so the conversion is per leaf:

  conv kernel      HWIO [kh, kw, in, out] -> OIHW weight
  dense kernel     [in, out]              -> Linear weight [out, in]
  deconv_kernel    [2, 2, in, out]        -> ConvTranspose2d weight
                                             [in, out, 2, 2]
  GroupNorm / LayerNorm scale             -> weight
  attention kernel [C, heads, head_dim]   -> Linear weight [heads*head_dim,
                                             C] (the JAX multi-head
                                             attention's query, key, value)
  attention `out` kernel [heads, head_dim, C]
                                          -> Linear weight [C,
                                             heads*head_dim]
  attention bias [heads, head_dim]        -> flat bias
  `embedding` table [vocab, width]        -> nn.Embedding weight (the
                                             CLIP text tower's
                                             token_embedding)
  FrozenBN weight / bias / running_mean / running_var, other biases, the
  CenterNet `Scale` scalars (modules `scale{i}`), the Deformable-DETR's
  plain parameters (`level_embed{i}`, `query_embed`), the Swin trunk's
  `relative_position_bias_table`s and the text tower's
  `positional_embedding` and `text_projection` are copied as they are.

The box head's fc1 needs no permutation: the port flattens the pooled
[R, 7, 7, C] map in the same HWC order as the JAX package.

The RL models load by the same rules, their module names mirroring the
JAX trees: `rl/policy.py:PointNavPolicy` (blind or RGB: the GRU's `ih` /
`hh` Dense layers are `Linear`s of those names; `SimpleCNN_0`'s fc sees
the last map flattened in HWC order, as in JAX), `rl/resnet_policy.py:
PointNavResNetPolicy` (GroupNorm `scale` -> weight, the
`prev_action_embed` table) and `rl/monodepth.py:MonoDepthNet` (FrozenBN
leaves as they are).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _leaf(path: tuple, value: np.ndarray):
    """(port key, port value) of one leaf of the JAX tree."""
    *mods, leaf = path
    if leaf == "kernel":
        if value.ndim == 4:
            return mods + ["weight"], value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return mods + ["weight"], value.T
        if value.ndim == 3 and mods and mods[-1] == "out":
            return mods + ["weight"], value.reshape(-1, value.shape[-1]).T
        if value.ndim == 3:
            return mods + ["weight"], value.reshape(value.shape[0], -1).T
        raise ValueError(f"unexpected kernel rank {value.ndim} at {path}")
    if leaf == "bias" and value.ndim == 2:
        return mods + ["bias"], value.reshape(-1)
    if leaf == "embedding":
        return mods + ["weight"], value
    if leaf == "deconv_kernel":
        return mods + ["deconv", "weight"], value.transpose(2, 3, 0, 1)
    if leaf == "deconv_bias":
        return mods + ["deconv", "bias"], value
    if leaf == "scale" and mods and not re.fullmatch(r"scale\d+", mods[-1]):
        return mods + ["weight"], value
    return mods + [leaf], value


def load_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params (nested dicts of numpy arrays, with or without the
    top-level "params" key) -> state dict for `EmbodiedDetector`,
    `Res5Detector`, a Swin trunk, the CLIP text tower, a Deformable-DETR
    module or an RL model (`PointNavPolicy`, `PointNavResNetPolicy`,
    `MonoDepthNet`); load it
    with `model.load_state_dict(sd)`, which casts to each parameter's
    dtype and device."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                key, value = _leaf(path + (k,), np.asarray(v, np.float32))
                out[".".join(key)] = torch.from_numpy(np.array(value))

    walk(params, ())
    return out
