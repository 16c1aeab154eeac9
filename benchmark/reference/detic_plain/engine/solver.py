"""Optimizer, LR schedule and parameter freezing.

Counterpart of the JAX package's `engine/solver.py`, which builds an optax
chain: AdamW (or SGD) with per-parameter LR groups -- `backbone_multiplier`
for the trunk and FPN, `custom_multiplier` (x10) for names containing
`custom_multiplier_name` ("map_merge") -- frozen parameters masked out,
elementwise (or global-norm) gradient clipping over the trainable
gradients, and a warmup-cosine (or warmup-multistep) schedule.

`GroupedOptimizer` applies the same arithmetic in the same order as that
chain: optax's moments `(1 - b) * g + b * m`, its bias correction by
`1 - b ** count` with `count` counting updates from 1, `eps` outside the
square root, weight decay added to the Adam direction before the LR, and
the schedule evaluated at the update's index (0 on the first update). It
runs on the parameters' device with no host sync. FrozenBN statistics and
affine are buffers in the port, never parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..config import SolverConfig

# the reference's UNFROZEN_LAYERS vocabulary -> the port's module names
UNFROZEN_ALIAS = {"roi": "roi_heads", "proposal_generator": "centernet",
                  "map_merge": "map_merge"}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def param_label(name: str, cfg: SolverConfig) -> str:
    """'frozen' | 'backbone' | 'custom' | 'backbone_custom' | 'default' for
    a parameter name ("." or "/" separated). Multipliers multiply, so one
    parameter can be in both the backbone and the custom group; the FPN
    belongs to the backbone group, as the reference's FPN-wrapped trunk
    does. Freezing applies only with a non-empty `unfrozen_layers`."""
    name = name.replace(".", "/")
    if cfg.freeze_backbone and cfg.unfrozen_layers:
        if not any(u in name or UNFROZEN_ALIAS.get(u, u) in name
                   for u in cfg.unfrozen_layers):
            return "frozen"
    parts = name.split("/")
    is_backbone = "backbone" in parts or "fpn" in parts
    is_custom = any(n in name for n in cfg.custom_multiplier_name)
    if is_backbone and is_custom:
        return "backbone_custom"
    if is_custom:
        return "custom"
    if is_backbone:
        return "backbone"
    return "default"


def param_labels(named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: SolverConfig) -> Dict[str, str]:
    return {name: param_label(name, cfg) for name, _ in named_params}


def _warmup(cfg: SolverConfig, step: int) -> float:
    return cfg.warmup_factor + (1 - cfg.warmup_factor) * \
        min(step / max(cfg.warmup_iters, 1), 1.0)


def warmup_cosine_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """lr = base * warmup(t) * 0.5 * (1 + cos(pi * t / max_iter)); the
    cosine applies during the warmup too."""
    def schedule(step: int) -> float:
        cos = 0.5 * (1 + math.cos(math.pi * step / max(cfg.max_iter, 1)))
        return cfg.base_lr * _warmup(cfg, step) * cos
    return schedule


def warmup_multistep_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """lr = base * warmup(t) * gamma ** (milestones passed)."""
    steps = cfg.steps or (cfg.max_iter + 1,)

    def schedule(step: int) -> float:
        k = sum(step >= s for s in steps)
        return cfg.base_lr * _warmup(cfg, step) * cfg.gamma ** k
    return schedule


def lr_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    name = cfg.lr_scheduler
    if name in ("warmup_cosine", "WarmupCosineLR"):
        return warmup_cosine_schedule(cfg)
    if name in ("warmup_multistep", "WarmupMultiStepLR"):
        return warmup_multistep_schedule(cfg)
    raise NotImplementedError(f"no LR scheduler {name!r}")


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in f32, as optax computes it (0.999 is not an
    f32 number: in f64 the correction would differ by ~1e-5)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class GroupedOptimizer:
    """AdamW or SGD over a model's named parameters, grouped by label.

    `step()` reads each parameter's `.grad` (None counts as zeros), zeroes
    the frozen ones, clips the rest, and updates the parameters in place
    under `torch.no_grad()`. `count` is the number of updates applied."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 cfg: SolverConfig):
        opt = cfg.optimizer.upper()
        if opt not in ("ADAMW", "SGD"):
            raise NotImplementedError(f"no optimizer type {cfg.optimizer!r}")
        if cfg.clip_gradients and cfg.clip_value > 0 and \
                cfg.clip_type not in ("value", "full_model"):
            raise NotImplementedError(
                f"no gradient clip type {cfg.clip_type!r}")
        self.cfg = cfg
        self.kind = opt
        self.schedule = lr_schedule(cfg)
        mult = {"default": 1.0, "backbone": cfg.backbone_multiplier,
                "custom": cfg.custom_multiplier,
                "backbone_custom": cfg.backbone_multiplier *
                cfg.custom_multiplier}
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        self.mults: List[float] = []
        for name, p in named_params:
            label = param_label(name, cfg)
            if label == "frozen":
                continue
            self.names.append(name)
            self.params.append(p)
            self.mults.append(mult[label])
        self.count = 0
        if opt == "ADAMW":
            self.state = {"mu": [torch.zeros_like(p) for p in self.params],
                          "nu": [torch.zeros_like(p) for p in self.params]}
        else:
            self.state = {"trace": [torch.zeros_like(p)
                                    for p in self.params]}

    def lr(self, step: int) -> float:
        return self.schedule(step)

    def _grads(self) -> List[torch.Tensor]:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        cfg = self.cfg
        if not (cfg.clip_gradients and cfg.clip_value > 0):
            return grads
        if cfg.clip_type == "value":
            return [g.clamp(-cfg.clip_value, cfg.clip_value) for g in grads]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        return [torch.where(norm < cfg.clip_value, g,
                            g / norm * cfg.clip_value) for g in grads]

    @torch.no_grad()
    def step(self) -> None:
        grads = self._grads()
        lr = self.schedule(self.count)
        scales = [-lr * m for m in self.mults]
        wd = self.cfg.weight_decay
        if self.kind == "ADAMW":
            mu, nu = self.state["mu"], self.state["nu"]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
            n = self.count + 1
            mu_hat = torch._foreach_div(mu, _bias_correction(ADAM_B1, n))
            nu_hat = torch._foreach_div(nu, _bias_correction(ADAM_B2, n))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(mu_hat, denom)
            torch._foreach_add_(update, self.params, alpha=wd)
        else:
            update = torch._foreach_add(grads, self.params, alpha=wd)
            if self.cfg.momentum:
                trace = self.state["trace"]
                torch._foreach_mul_(trace, self.cfg.momentum)
                torch._foreach_add_(trace, update)
                if self.cfg.nesterov:
                    update = torch._foreach_add(update, trace,
                                                alpha=self.cfg.momentum)
                else:
                    update = [t.clone() for t in trace]
        torch._foreach_mul_(update, scales)
        torch._foreach_add_(self.params, update)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count,
                "state": {k: dict(zip(self.names, v))
                          for k, v in self.state.items()}}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        for k, tensors in self.state.items():
            for name, t in zip(self.names, tensors):
                t.copy_(sd["state"][k][name])


def build_optimizer(model: torch.nn.Module,
                    cfg: SolverConfig) -> GroupedOptimizer:
    return GroupedOptimizer(model.named_parameters(), cfg)
