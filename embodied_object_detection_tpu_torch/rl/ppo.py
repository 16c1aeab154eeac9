"""PPO update (ref: habitat_baselines/rl/ppo/ppo.py).

Counterpart of the JAX package's `rl/ppo.py`, which runs the update as one
`lax.scan` over the (epoch x minibatch) grid. Here `PPO.update` loops over
the same grid on the policy's device with no host sync: each step gathers
its envs with `index_select`, evaluates the sequence policy, takes the
loss's gradient with `torch.autograd.grad`, clips it by its global norm
and applies an Adam step, all on device tensors; the metrics stay on the
device until the caller copies them.

The arithmetic follows the optax chain the JAX package builds:
  * `clip_by_global_norm`: g while the norm is below max_norm, else
    g / norm * max_norm (not `clip_grad_norm_`'s max_norm / (norm + 1e-6));
  * Adam: moments (1 - b) g + b m, f32 bias corrections 1 - b ** count,
    eps outside the square root;
  * the linear learning-rate decay reads the optimizer's step count
    before its increment, lr * (1 - min(k // (ppo_epoch * num_mini_batch),
    U) / U), and the clip decay reads the update index, both in f32;
  * advantages normalised by the population variance (ppo.py:138-146),
    over the process group when there is one (DD-PPO, `rl/ddppo.py`).
With a process group, each rank runs the whole schedule on its own envs
with the same permutations, the gradient is summed over the group and
divided by its size, and the metrics are averaged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..engine.solver import _bias_correction
from ..parallel.mesh import all_reduce_gradients, all_reduce_sum
from .policy import full_f32

EPS_PPO = 1e-5
ADAM_B1, ADAM_B2 = 0.9, 0.999

__all__ = ["PPOConfig", "PPO", "ppo_loss",
           "distributed_mean_and_var", "minibatch_indices"]


@dataclass(frozen=True)
class PPOConfig:
    clip_param: float = 0.2
    ppo_epoch: int = 4
    num_mini_batch: int = 2
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    lr: float = 2.5e-4
    eps: float = 1e-5
    max_grad_norm: float = 0.5
    use_gae: bool = True
    gamma: float = 0.99
    tau: float = 0.95
    use_clipped_value_loss: bool = True
    use_normalized_advantage: bool = True
    # linear schedules over num_updates (ppo_trainer.py:328-343); 0 = off
    use_linear_lr_decay: bool = False
    use_linear_clip_decay: bool = False
    num_updates: int = 0


def distributed_mean_and_var(values: torch.Tensor, group=None):
    """Mean and population variance of `values` over the ranks of `group`
    (ddppo.py:18-42): sums over the group, divided by the global count.
    Without a group, the same formula over this rank's values."""
    n = all_reduce_sum(torch.full((), float(values.numel()),
                                  device=values.device), group)
    mean = all_reduce_sum(values.sum(), group) / n
    var = all_reduce_sum(((values - mean) ** 2).sum(), group) / n
    return mean, var


def ppo_loss(evaluate_actions: Callable, minibatch: Dict, cfg: PPOConfig,
             clip=None):
    """Loss for one minibatch of shape [T, n_envs, ...] (ppo.py:84-134);
    `clip` overrides cfg.clip_param (the linear clip decay)."""
    clip = cfg.clip_param if clip is None else clip
    values, log_probs, entropy = evaluate_actions(
        minibatch["observations"], minibatch["hidden0"],
        minibatch["prev_actions"], minibatch["masks"], minibatch["actions"])

    ratio = torch.exp(log_probs - minibatch["old_log_probs"])
    adv = minibatch["advantages"]
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, float(1.0 - clip), float(1.0 + clip)) * adv
    action_loss = -torch.minimum(surr1, surr2).mean()

    returns = minibatch["returns"]
    if cfg.use_clipped_value_loss:
        v_old = minibatch["value_preds"]
        v_clipped = v_old + torch.clamp(values - v_old, float(-clip),
                                        float(clip))
        value_loss = 0.5 * torch.maximum((values - returns) ** 2,
                                         (v_clipped - returns) ** 2).mean()
    else:
        value_loss = 0.5 * ((returns - values) ** 2).mean()

    total = (value_loss * cfg.value_loss_coef + action_loss
             - entropy * cfg.entropy_coef)
    return total, {"value_loss": value_loss, "action_loss": action_loss,
                   "dist_entropy": entropy}


def minibatch_indices(cfg: PPOConfig, num_envs: int,
                      generator: Optional[torch.Generator],
                      device: "torch.device | str") -> torch.Tensor:
    """[ppo_epoch * num_mini_batch, num_envs / num_mini_batch] env indices:
    one permutation an epoch (sorted uniform draws from `generator`, on
    `device`, no host sync), cut into minibatches."""
    keys = torch.rand((cfg.ppo_epoch, num_envs), generator=generator,
                      device=device)
    return keys.argsort(dim=1).reshape(
        cfg.ppo_epoch * cfg.num_mini_batch, num_envs // cfg.num_mini_batch)


class PPO:
    """The PPO update of `policy`'s parameters (in place) with clipped
    Adam; `group` is DD-PPO's process group (None: plain PPO).
    `count` counts optimizer steps, `update_idx` updates."""

    def __init__(self, policy: torch.nn.Module, cfg: PPOConfig, group=None,
                 world_size: int = 1):
        self.policy = policy
        self.cfg = cfg
        self.group = group
        self.world_size = world_size
        self.params: List[torch.nn.Parameter] = [
            p for p in policy.parameters() if p.requires_grad]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.update_idx = 0
        self.last_grad_norm = None   # the last step's, before the clip

    # -- the schedules, on the host in f32 (no device value is read) -------
    def lr(self, count: int) -> np.float32:
        cfg = self.cfg
        lr = np.float32(cfg.lr)
        if cfg.use_linear_lr_decay and cfg.num_updates > 0:
            per_update = cfg.ppo_epoch * cfg.num_mini_batch
            frac = np.float32(min(count // per_update, cfg.num_updates)) / \
                np.float32(cfg.num_updates)
            lr = lr * (np.float32(1.0) - frac)
        return lr

    def clip_param(self, update_idx: int):
        cfg = self.cfg
        if cfg.use_linear_clip_decay and cfg.num_updates > 0:
            frac = np.float32(min(update_idx, cfg.num_updates)) / \
                np.float32(cfg.num_updates)
            return np.float32(cfg.clip_param) * (np.float32(1.0) - frac)
        return cfg.clip_param

    def advantages(self, batch: Dict) -> torch.Tensor:
        adv = batch["returns"] - batch["value_preds"]
        if not self.cfg.use_normalized_advantage:
            return adv
        mean, var = distributed_mean_and_var(adv, self.group)
        return (adv - mean) / (torch.sqrt(var) + EPS_PPO)

    @torch.no_grad()
    def _adam_step(self, grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        self.last_grad_norm = norm
        grads = [torch.where(norm < cfg.max_grad_norm, g,
                             g / norm * cfg.max_grad_norm) for g in grads]
        torch._foreach_mul_(self.mu, ADAM_B1)
        torch._foreach_add_(self.mu, grads, alpha=1 - ADAM_B1)
        torch._foreach_mul_(self.nu, ADAM_B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - ADAM_B2)
        n = self.count + 1
        mu_hat = torch._foreach_div(self.mu, _bias_correction(ADAM_B1, n))
        nu_hat = torch._foreach_div(self.nu, _bias_correction(ADAM_B2, n))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, cfg.eps)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(update, float(-self.lr(self.count)))
        torch._foreach_add_(self.params, update)
        self.count += 1

    def _minibatch_step(self, batch: Dict, env_idx: torch.Tensor, clip):
        mb = {"observations": {k: v.index_select(1, env_idx)
                               for k, v in batch["observations"].items()},
              "hidden0": batch["hidden0"].index_select(0, env_idx)}
        for k in ("actions", "prev_actions", "value_preds", "returns",
                  "masks", "old_log_probs", "advantages"):
            mb[k] = batch[k].index_select(1, env_idx)
        loss, metrics = ppo_loss(self.policy.evaluate_actions, mb, self.cfg,
                                 clip)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            self.params, torch.autograd.grad(loss, self.params,
                                             allow_unused=True))]
        if self.group is not None:
            for p, g in zip(self.params, grads):
                p.grad = g
            all_reduce_gradients(self.params, self.group)
            grads = [p.grad / self.world_size for p in self.params]
            for p in self.params:
                p.grad = None
        self._adam_step(grads)
        return metrics

    @full_f32()
    def update(self, batch: Dict, generator: Optional[torch.Generator] = None,
               mb_indices: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """One PPO update over a rollout batch (`RolloutStorage.batch()`).
        The minibatches' env indices are `mb_indices` [E*M, N/M] when
        given, else drawn from `generator` (`minibatch_indices`). Returns
        the metrics averaged over the minibatches, as 0-d device tensors."""
        cfg = self.cfg
        num_envs = batch["actions"].shape[1]
        if num_envs % cfg.num_mini_batch:
            raise ValueError(f"num_envs {num_envs} is not a multiple of "
                             f"num_mini_batch {cfg.num_mini_batch}")
        device = batch["actions"].device
        if mb_indices is None:
            mb_indices = minibatch_indices(cfg, num_envs, generator, device)
        mb_indices = mb_indices.to(device)
        batch = dict(batch, advantages=self.advantages(batch))
        clip = self.clip_param(self.update_idx)
        rows = [self._minibatch_step(batch, env_idx, clip)
                for env_idx in mb_indices]
        metrics = {k: torch.stack([r[k].detach() for r in rows]).mean()
                   for k in rows[0]}
        if self.group is not None:
            flat = all_reduce_sum(torch.stack(list(metrics.values())),
                                  self.group) / self.world_size
            metrics = dict(zip(metrics, flat))
        self.update_idx += 1
        return metrics

    # -- state (numpy, for checkpoints and preemption) ---------------------
    def state_dict(self) -> Dict:
        return {"mu": [m.detach().cpu().numpy() for m in self.mu],
                "nu": [v.detach().cpu().numpy() for v in self.nu],
                "count": self.count, "update_idx": self.update_idx}

    def load_state_dict(self, state: Dict) -> None:
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
                dst.copy_(torch.from_numpy(np.asarray(src)))
        self.count = int(state["count"])
        self.update_idx = int(state["update_idx"])
