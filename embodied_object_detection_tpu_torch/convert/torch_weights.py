"""The reference's detectron2 checkpoints (`.pth`) into the port.

Maps the reference's detectron2 state dict (the four golden checkpoints:
Detic_LCOCOI21k_...max-size.pth, vanilla_training.pth,
detic_finetuned.pth, implicit_object_memory.pth; ref: README.md:44-62)
onto `EmbodiedDetector`'s state dict. The port's parameter names mirror
the JAX parameter tree, so the rules are the JAX package's
`convert/torch_weights.py` table with `.`-joined port keys; the layouts
are PyTorch's own, so nothing is transposed:

  conv     OIHW                -> OIHW
  linear   (out, in)           -> (out, in)
  deconv   (in, out, kh, kw)   -> (in, out, kh, kw)
  FrozenBN weight / bias / running_mean / running_var, biases, the
  CenterNet tower's GroupNorm weight / bias and its `Scale` scalars are
  copied under the port's names.

The one permutation: each box head's fc1 reads the pooled [R, 7, 7, C]
map, which detectron2 flattens c-major and the port flattens HWC
(`convert/from_jax.py`), so its (out, C*7*7) weight becomes (out, 7*7*C).
The classifier's `zs_weight` buffers are a runtime input, returned apart.
A checkpoint trained with WITH_SOFTMAX_PROP carries each stage's
`prop_score` head, mapped to the port's `prop_score{k}`. A Swin-B trunk's
keys (`backbone.bottom_up.{patch_embed, layers.{s}.blocks.{b}, layers.{s}.
downsample, norm{s}}`, the vendored swintransformer.py's names) map to
`models/swin.py`'s modules.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _fc_after_pool(w: torch.Tensor, res: int = 7) -> torch.Tensor:
    """(out, C*res*res) c-major -> (out, res*res*C) HWC."""
    out_dim, in_dim = w.shape
    c = in_dim // (res * res)
    if c * res * res != in_dim:
        raise ValueError(f"fc1 weight {tuple(w.shape)} is not "
                         f"(out, C*{res}*{res})")
    return w.reshape(out_dim, c, res, res).permute(0, 2, 3, 1).reshape(
        out_dim, in_dim).contiguous()


_BN = r"(weight|bias|running_mean|running_var)"
_WB = r"(weight|bias)"
# (regex over detectron2 names) -> (port key template, transform)
_RULES = [
    # backbone stem and residual stages (backbone.bottom_up.base.*)
    (r"backbone\.bottom_up\.base\.conv1\.weight", "backbone.conv1.weight",
     None),
    (rf"backbone\.bottom_up\.base\.bn1\.{_BN}", "backbone.bn1.{0}", None),
    (r"backbone\.bottom_up\.base\.layer(\d)\.(\d+)\.conv(\d)\.weight",
     "backbone.layer{0}_{1}.conv{2}.weight", None),
    (rf"backbone\.bottom_up\.base\.layer(\d)\.(\d+)\.bn(\d)\.{_BN}",
     "backbone.layer{0}_{1}.bn{2}.{3}", None),
    (r"backbone\.bottom_up\.base\.layer(\d)\.(\d+)\.downsample\.0\.weight",
     "backbone.layer{0}_{1}.downsample_conv.weight", None),
    (rf"backbone\.bottom_up\.base\.layer(\d)\.(\d+)\.downsample\.1\.{_BN}",
     "backbone.layer{0}_{1}.downsample_bn.{2}", None),
    # Swin-B trunk (backbone.bottom_up.*, swintransformer.py naming)
    (rf"backbone\.bottom_up\.patch_embed\.proj\.{_WB}",
     "backbone.patch_embed.{0}", None),
    (rf"backbone\.bottom_up\.patch_embed\.norm\.{_WB}",
     "backbone.patch_norm.{0}", None),
    (rf"backbone\.bottom_up\.layers\.(\d)\.blocks\.(\d+)\.norm(\d)\.{_WB}",
     "backbone.stage{0}_block{1}.norm{2}.{3}", None),
    (rf"backbone\.bottom_up\.layers\.(\d)\.blocks\.(\d+)\.attn\."
     rf"(qkv|proj)\.{_WB}", "backbone.stage{0}_block{1}.attn.{2}.{3}", None),
    (r"backbone\.bottom_up\.layers\.(\d)\.blocks\.(\d+)\.attn\."
     r"relative_position_bias_table",
     "backbone.stage{0}_block{1}.attn.relative_position_bias_table", None),
    (rf"backbone\.bottom_up\.layers\.(\d)\.blocks\.(\d+)\.mlp\.fc(\d)\."
     rf"{_WB}", "backbone.stage{0}_block{1}.mlp_fc{2}.{3}", None),
    (rf"backbone\.bottom_up\.layers\.(\d)\.downsample\.norm\.{_WB}",
     "backbone.merge_norm{0}.{1}", None),
    (r"backbone\.bottom_up\.layers\.(\d)\.downsample\.reduction\.weight",
     "backbone.merge_reduction{0}.weight", None),
    (rf"backbone\.bottom_up\.norm(\d)\.{_WB}", "backbone.out_norm{0}.{1}",
     None),
    # FPN (detectron2: fpn_lateral{3,4,5} / fpn_output{3,4,5})
    (rf"backbone\.fpn_lateral3\.{_WB}", "fpn.lateral1.{0}", None),
    (rf"backbone\.fpn_lateral4\.{_WB}", "fpn.lateral2.{0}", None),
    (rf"backbone\.fpn_lateral5\.{_WB}", "fpn.lateral3.{0}", None),
    (rf"backbone\.fpn_output3\.{_WB}", "fpn.output1.{0}", None),
    (rf"backbone\.fpn_output4\.{_WB}", "fpn.output2.{0}", None),
    (rf"backbone\.fpn_output5\.{_WB}", "fpn.output3.{0}", None),
    (rf"backbone\.top_block\.p([67])\.{_WB}", "fpn.p{0}.{1}", None),
    # memory merge projections (CustomRecurrentFPN, timm.py:78-88)
    (rf"backbone\.map_merge_projection(\d)\.{_WB}",
     "fpn.map_merge_projection{0}.{1}", None),
    # CenterNet head (centernet_head.py); the bbox_tower conv / GN pairs
    # are mapped in convert_state_dict
    (rf"proposal_generator\.centernet_head\.(agn_hm|bbox_pred)\.{_WB}",
     "centernet.{0}.{1}", None),
    (r"proposal_generator\.centernet_head\.scales\.(\d)\.scale",
     "centernet.scale{0}.scale", None),
    # cascade box heads and predictors
    (r"roi_heads\.box_head\.(\d)\.fc1\.weight",
     "roi_heads.box_head{0}.fc1.weight", _fc_after_pool),
    (r"roi_heads\.box_head\.(\d)\.fc1\.bias", "roi_heads.box_head{0}.fc1.bias",
     None),
    (rf"roi_heads\.box_head\.(\d)\.fc2\.{_WB}",
     "roi_heads.box_head{0}.fc2.{1}", None),
    (rf"roi_heads\.box_predictor\.(\d)\.cls_score\.linear\.{_WB}",
     "roi_heads.box_predictor{0}.cls_linear.{1}", None),
    (rf"roi_heads\.box_predictor\.(\d)\.bbox_pred\.0\.{_WB}",
     "roi_heads.box_predictor{0}.bbox_fc1.{1}", None),
    (rf"roi_heads\.box_predictor\.(\d)\.bbox_pred\.2\.{_WB}",
     "roi_heads.box_predictor{0}.bbox_fc2.{1}", None),
    # WITH_SOFTMAX_PROP score heads (detic_fast_rcnn.py:118-125)
    (rf"roi_heads\.box_predictor\.(\d)\.prop_score\.0\.{_WB}",
     "prop_score{0}.fc1.{1}", None),
    (rf"roi_heads\.box_predictor\.(\d)\.prop_score\.2\.{_WB}",
     "prop_score{0}.fc2.{1}", None),
    # mask head
    (rf"roi_heads\.mask_head\.mask_fcn(\d)\.{_WB}",
     "roi_heads.mask_head.mask_fcn{0}.{1}", None),
    (rf"roi_heads\.mask_head\.deconv\.{_WB}", "roi_heads.mask_head.deconv.{0}",
     None),
    (rf"roi_heads\.mask_head\.predictor\.{_WB}",
     "roi_heads.mask_head.predictor.{0}", None),
]


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def convert_state_dict(state_dict: Mapping[str, Any]
                       ) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
    """detectron2 state dict (tensors or numpy arrays) -> ({"state_dict":
    port state dict, "_unmapped": [names]}, zs_weight [D, C+1] as numpy,
    or None). "_unmapped" lists the keys no rule maps (optimizer state,
    text-encoder weights and the like) and is present only when there are
    some."""
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    zs_weight = None
    for name, value in state_dict.items():
        if re.match(r"roi_heads\.box_predictor\.\d\.cls_score\.zs_weight$",
                    name):
            # D x (C+1), already normalised, with the background column
            zs_weight = _tensor(value).float().numpy()
            continue
        # CenterNet tower: indices 0/3/6/9 are convs, 1/4/7/10 GroupNorms
        m = re.match(r"proposal_generator\.centernet_head\.bbox_tower\."
                     r"(\d+)\.(weight|bias)$", name)
        if m:
            layer, role = divmod(int(m.group(1)), 3)
            kind = "conv" if role == 0 else "gn"
            out[f"centernet.bbox_tower_{kind}{layer}.{m.group(2)}"] = \
                _tensor(value)
            continue
        for pattern, template, transform in _RULES:
            m = re.match(pattern + r"$", name)
            if m:
                v = _tensor(value)
                out[template.format(*m.groups())] = \
                    transform(v) if transform else v
                break
        else:
            unmapped.append(name)
    converted: Dict[str, Any] = {"state_dict": out}
    if unmapped:
        converted["_unmapped"] = unmapped
    return converted, zs_weight


def load_torch_checkpoint(path: str):
    """Load a detectron2 `.pth` / `.pkl` on the CPU and convert it (its
    `model` or `state_dict` entry, else the file's dict itself)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("model", data.get("state_dict", data))
    return convert_state_dict(sd)


def verify_against_model(converted: Mapping[str, Any],
                         model: "nn.Module | Mapping[str, torch.Tensor]"
                         ) -> Tuple[list, list, list]:
    """Compare a converted state dict with a model's (or a state dict):
    (keys missing from the checkpoint, extra keys, [(key, checkpoint
    shape, model shape)] of shape mismatches)."""
    got = converted.get("state_dict", converted)
    want = model.state_dict() if isinstance(model, nn.Module) else model
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want) - {"_unmapped"})
    mismatch = [(k, tuple(got[k].shape), tuple(want[k].shape))
                for k in sorted(set(got) & set(want))
                if tuple(got[k].shape) != tuple(want[k].shape)]
    return missing, extra, mismatch
