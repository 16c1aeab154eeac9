"""Rollout storage + GAE for PPO.

Counterpart of the JAX package's `rl/rollout.py` (ref: habitat_baselines
common/rollout_storage.py:12-242). Storage is host numpy: observations
arrive from CPU simulator workers, and `batch()` copies each array to the
device once an update (pinned, without blocking the host). Returns and GAE
(`compute_returns`, rollout_storage.py:115-133) are a reverse loop over
time in f32, in the JAX package's order of operations.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["RolloutStorage", "compute_gae", "to_device"]


def compute_gae(rewards: torch.Tensor, value_preds: torch.Tensor,
                masks: torch.Tensor, gamma: float, tau: float,
                use_gae: bool = True) -> torch.Tensor:
    """Returns [T, N] from rewards [T, N], value_preds [T+1, N] (last row =
    the bootstrap value), masks [T+1, N], all f32."""
    T = rewards.shape[0]
    returns = torch.empty_like(rewards)
    if use_gae:
        gae = torch.zeros_like(rewards[0])
        for t in range(T - 1, -1, -1):
            delta = (rewards[t] + gamma * value_preds[t + 1] * masks[t + 1]
                     - value_preds[t])
            gae = delta + gamma * tau * masks[t + 1] * gae
            returns[t] = gae + value_preds[t]
    else:
        ret = value_preds[T]
        for t in range(T - 1, -1, -1):
            ret = ret * gamma * masks[t + 1] + rewards[t]
            returns[t] = ret
    return returns


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of `x`: through pinned memory, without
    blocking the host, on a card."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class RolloutStorage:
    """(T+1, N, ...) rolling buffers with the reference's insert /
    after_update / compute_returns lifecycle."""

    def __init__(self, num_steps: int, num_envs: int, obs_space,
                 hidden_size: int):
        self.observations: Dict[str, np.ndarray] = {
            k: np.zeros((num_steps + 1, num_envs) + tuple(s.shape),
                        np.float32)
            for k, s in obs_space.spaces.items()}
        self.hidden_states = np.zeros((num_steps + 1, num_envs, hidden_size),
                                      np.float32)
        self.rewards = np.zeros((num_steps, num_envs), np.float32)
        self.value_preds = np.zeros((num_steps + 1, num_envs), np.float32)
        self.returns = np.zeros((num_steps + 1, num_envs), np.float32)
        self.action_log_probs = np.zeros((num_steps, num_envs), np.float32)
        self.actions = np.zeros((num_steps, num_envs), np.int64)
        self.prev_actions = np.zeros((num_steps + 1, num_envs), np.int64)
        self.masks = np.zeros((num_steps + 1, num_envs), np.float32)
        self.num_steps = num_steps
        self.num_envs = num_envs
        self.step = 0

    def insert(self, observations, hidden_states, actions, action_log_probs,
               value_preds, rewards, masks) -> None:
        for k, v in observations.items():
            self.observations[k][self.step + 1] = v
        self.hidden_states[self.step + 1] = hidden_states
        self.actions[self.step] = actions
        self.prev_actions[self.step + 1] = actions
        self.action_log_probs[self.step] = action_log_probs
        self.value_preds[self.step] = value_preds
        self.rewards[self.step] = rewards
        self.masks[self.step + 1] = masks
        self.step += 1

    def set_first_observations(self, observations) -> None:
        for k, v in observations.items():
            self.observations[k][0] = v

    def after_update(self) -> None:
        for k in self.observations:
            self.observations[k][0] = self.observations[k][self.step]
        self.hidden_states[0] = self.hidden_states[self.step]
        self.masks[0] = self.masks[self.step]
        self.prev_actions[0] = self.prev_actions[self.step]
        self.step = 0

    def compute_returns(self, next_value: np.ndarray, use_gae: bool,
                        gamma: float, tau: float) -> None:
        self.value_preds[self.step] = next_value
        returns = compute_gae(
            torch.from_numpy(self.rewards[:self.step]),
            torch.from_numpy(self.value_preds[:self.step + 1]),
            torch.from_numpy(self.masks[:self.step + 1]),
            gamma, tau, use_gae=use_gae)
        self.returns[:self.step] = returns.numpy()

    def batch(self, device: "torch.device | str") -> Dict:
        """The training batch on `device` for `ppo.PPO.update`."""
        device = torch.device(device)
        T = self.step

        def put(x):
            return to_device(x, device)
        return {
            "observations": {k: put(v[:T])
                             for k, v in self.observations.items()},
            "hidden0": put(self.hidden_states[0]),
            "actions": put(self.actions[:T]),
            "prev_actions": put(self.prev_actions[:T]),
            "value_preds": put(self.value_preds[:T]),
            "returns": put(self.returns[:T]),
            "masks": put(self.masks[:T]),
            "old_log_probs": put(self.action_log_probs[:T]),
        }
