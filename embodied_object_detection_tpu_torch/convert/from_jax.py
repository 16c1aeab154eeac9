"""Carry the JAX package's parameters into the port.

`load_jax_params` takes the JAX model's `params` tree as nested dicts of numpy
arrays and returns the port's state dict. The port's module names mirror
that tree, so the conversion is per leaf:

  conv kernel      HWIO [kh, kw, in, out] -> OIHW weight
  dense kernel     [in, out]              -> Linear weight [out, in]
  deconv_kernel    [2, 2, in, out]        -> ConvTranspose2d weight
                                             [in, out, 2, 2]
  GroupNorm scale                         -> weight
  FrozenBN weight / bias / running_mean / running_var, biases and the
  CenterNet `Scale` scalars are copied as they are.

The box head's fc1 needs no permutation: the port flattens the pooled
[R, 7, 7, C] map in the same HWC order as the JAX package.
"""

from __future__ import annotations

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
        raise ValueError(f"unexpected kernel rank {value.ndim} at {path}")
    if leaf == "deconv_kernel":
        return mods + ["deconv", "weight"], value.transpose(2, 3, 0, 1)
    if leaf == "deconv_bias":
        return mods + ["deconv", "bias"], value
    if leaf == "scale" and mods and mods[-1].startswith("bbox_tower_gn"):
        return mods + ["weight"], value
    return mods + [leaf], value


def load_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params (nested dicts of numpy arrays, with or without the
    top-level "params" key) -> state dict for `EmbodiedDetector`; load it
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
