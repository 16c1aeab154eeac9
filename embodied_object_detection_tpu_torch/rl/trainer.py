"""PPO trainer over a vector env (ref: habitat_baselines ppo_trainer.py).

Counterpart of the JAX package's `rl/trainer.py` (`PPOTrainer`,
ppo_trainer.py:38-647): rollouts from parallel envs, GAE returns, the PPO
update, windowed episode stats, checkpoints and an evaluation pass.
DD-PPO (`distributed=True`) runs each rank's envs and sums the gradients
over the started process group (`parallel/mesh.py:init_distributed`,
as `rl/run.py --distributed` starts it), with preemption save and
resume (`rl/ddppo.py`).

The policy runs on `device` (the card unless the caller asks for the
CPU). One env step makes one device-to-host copy: the value, action,
log-prob and new hidden state of every env, packed into one tensor. The
update runs with no host sync and makes one copy of its metrics.
Action sampling and the minibatch permutations draw from two seeded
`torch.Generator`s on the device: the first is seeded by rank, the
second is the same on every rank, so DD-PPO's ranks walk the same
minibatch schedule.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.vector_env import ThreadedVectorEnv
from ..models.detector import resolve_device
from .policy import make_policy
from .ppo import PPO, PPOConfig
from .rollout import RolloutStorage, to_device

__all__ = ["PPOTrainerConfig", "PPOTrainer"]


@dataclass
class PPOTrainerConfig:
    num_envs: int = 4              # this rank's envs
    num_steps: int = 32            # rollout length T
    num_updates: int = 10
    hidden_size: int = 128
    with_rgb: bool = False
    ppo: PPOConfig = field(default_factory=PPOConfig)
    reward_window_size: int = 50
    seed: int = 0
    checkpoint_folder: Optional[str] = None
    checkpoint_interval: int = 0   # updates between checkpoints; 0 = off
    distributed: bool = False


def _stack_obs(obs_list: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = obs_list[0].keys()
    return {k: np.stack([np.asarray(o[k], np.float32) for o in obs_list])
            for k in keys}


def _params_numpy(policy: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy()
            for k, v in policy.state_dict().items()}


def _load_params(policy: torch.nn.Module, params: Dict) -> None:
    policy.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in params.items()})


class PPOTrainer:
    """Collect rollouts -> PPO update loop (ppo_trainer.py:217-420).

    `env_fn(i)` makes env i of this rank (the caller offsets i by the
    rank's first env under DD-PPO)."""

    def __init__(self, cfg: PPOTrainerConfig,
                 env_fn: Callable[[int], object],
                 vector_env_cls=ThreadedVectorEnv,
                 device: "torch.device | str" = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank, self.world_size, group = 0, 1, None
        if cfg.distributed:
            import torch.distributed as dist
            if not dist.is_initialized():
                raise RuntimeError("distributed=True needs a started process "
                                   "group (parallel.mesh.init_distributed)")
            self.rank, self.world_size = dist.get_rank(), \
                dist.get_world_size()
            group = dist.group.WORLD
        self.envs = vector_env_cls(
            [(lambda i=i: env_fn(i)) for i in range(cfg.num_envs)],
            auto_reset_done=True)
        # spaces from the pool's own env 0 (habitat's VectorEnv CALL
        # pattern): a throwaway env_fn(0) would build its dataset again
        self._obs_space = self.envs.call("observation_space")[0]
        self._num_actions = self.envs.call("action_space")[0].n

        # linear decay schedules pace themselves by ppo.num_updates;
        # default it to the trainer's plan (ppo_trainer.py:328-343)
        if (cfg.ppo.use_linear_lr_decay or cfg.ppo.use_linear_clip_decay) \
                and cfg.ppo.num_updates == 0:
            cfg.ppo = dataclasses.replace(cfg.ppo,
                                          num_updates=cfg.num_updates)

        self.policy = make_policy(self._obs_space, self._num_actions,
                                  cfg.hidden_size, blind=not cfg.with_rgb,
                                  seed=cfg.seed).to(self.device)
        if group is not None:        # rank 0's weights on every rank
            from ..parallel.mesh import Mesh, replicate
            replicate(Mesh(data_group=group), list(self.policy.parameters()))
        self.ppo = PPO(self.policy, cfg.ppo, group, self.world_size)
        self._act_gen = torch.Generator(self.device).manual_seed(
            cfg.seed * 1000 + self.rank)
        self._perm_gen = torch.Generator(self.device).manual_seed(
            cfg.seed * 1000 + 999)

        self.rollouts = RolloutStorage(cfg.num_steps, cfg.num_envs,
                                       self._obs_space, cfg.hidden_size)
        self.window_episode_reward = deque(maxlen=cfg.reward_window_size)
        self.window_episode_metrics: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=cfg.reward_window_size))
        self._episode_rewards = np.zeros(cfg.num_envs)
        self.metrics_log: List[dict] = []
        self.num_steps_done = 0

    def _fingerprint(self) -> str:
        """Identifies the experiment an interrupted state belongs to."""
        c = self.cfg
        return (f"envs{c.num_envs}-steps{c.num_steps}-hid{c.hidden_size}-"
                f"rgb{int(c.with_rgb)}-acts{self._num_actions}")

    def _obs(self, t: int) -> Dict[str, torch.Tensor]:
        return {k: to_device(v[t], self.device)
                for k, v in self.rollouts.observations.items()}

    @torch.no_grad()
    def act(self, obs, hidden, prev_actions, masks, deterministic=False):
        """The policy step on the device -> (value, action, log_prob,
        hidden) as one host copy of [N, 3 + H] (numpy) and the hidden state
        left on the device."""
        value, action, log_prob, hidden = self.policy.act(
            obs, hidden, prev_actions, masks, self._act_gen, deterministic)
        packed = torch.cat([value[:, None], action[:, None].float(),
                            log_prob[:, None], hidden], dim=1).cpu().numpy()
        return packed[:, 0], packed[:, 1].astype(np.int64), packed[:, 2], \
            packed[:, 3:], hidden

    # -- rollout collection (ppo_trainer.py:217-280) -----------------------
    def _collect_rollout_step(self, hidden, prev_actions, masks):
        value, actions_np, log_prob, hidden_np, hidden = self.act(
            self._obs(self.rollouts.step), hidden, prev_actions, masks)

        results = self.envs.step([int(a) for a in actions_np])
        obs_list, rewards, dones, infos = zip(*results)
        rewards = np.asarray(rewards, np.float32)
        dones = np.asarray(dones, bool)

        self._episode_rewards += rewards
        for i, d in enumerate(dones):
            if d:
                self.window_episode_reward.append(self._episode_rewards[i])
                self._episode_rewards[i] = 0.0
                for k, v in infos[i].items():
                    if np.isscalar(v) and np.isfinite(v):
                        self.window_episode_metrics[k].append(float(v))

        new_masks = (~dones).astype(np.float32)
        self.rollouts.insert(_stack_obs(list(obs_list)), hidden_np,
                             actions_np, log_prob, value, rewards, new_masks)
        self.num_steps_done += self.cfg.num_envs
        return (hidden, to_device(actions_np, self.device),
                to_device(new_masks, self.device))

    def _state(self, update: int) -> dict:
        return {"params": _params_numpy(self.policy),
                "opt_state": self.ppo.state_dict(),
                "fingerprint": self._fingerprint(),
                "update": update, "steps": self.num_steps_done}

    def _resume(self) -> int:
        """Load an interrupted state of this experiment (and consume the
        state file either way: a state of another experiment must not
        take over later runs); returns the update to start from."""
        from . import ddppo
        interrupted = ddppo.load_interrupted_state()
        start_update = 0
        if interrupted is not None and \
                interrupted.get("fingerprint") == self._fingerprint():
            _load_params(self.policy, interrupted["params"])
            self.ppo.load_state_dict(interrupted["opt_state"])
            start_update = int(interrupted.get("update", 0))
            # update_idx paces the linear clip decay: a requeue must not
            # snap clip_param back to its full value
            self.ppo.update_idx = start_update
            self.num_steps_done = int(interrupted.get("steps", 0))
        if interrupted is not None:
            f = ddppo._interrupted_state_file()
            if os.path.exists(f):
                os.remove(f)
        return start_update

    # -- train loop (ppo_trainer.py:282-420; DD-PPO preemption wiring per
    # ddppo_trainer.py:150-180, 330-380) -----------------------------------
    def train(self, num_updates: Optional[int] = None,
              handle_preemption: bool = False) -> List[dict]:
        cfg = self.cfg
        num_updates = num_updates or cfg.num_updates
        if (cfg.ppo.use_linear_lr_decay or cfg.ppo.use_linear_clip_decay) \
                and cfg.ppo.num_updates not in (0, num_updates):
            print(f"warning: lr/clip decay paced by ppo.num_updates="
                  f"{cfg.ppo.num_updates}, training {num_updates} updates")
        start_update = 0
        if handle_preemption:
            from . import ddppo
            ddppo.add_signal_handlers()
            start_update = self._resume()

        self.rollouts.set_first_observations(_stack_obs(self.envs.reset()))
        n, dev = cfg.num_envs, self.device
        hidden = torch.zeros((n, cfg.hidden_size), device=dev)
        prev_actions = torch.zeros((n,), dtype=torch.int64, device=dev)
        masks = torch.zeros((n,), device=dev)

        for update in range(start_update, num_updates):
            if handle_preemption:
                from . import ddppo
                if ddppo.EXIT.is_set():
                    ddppo.save_interrupted_state(self._state(update))
                    ddppo.requeue_job()
                    return self.metrics_log
            for _ in range(cfg.num_steps):
                hidden, prev_actions, masks = self._collect_rollout_step(
                    hidden, prev_actions, masks)
            metrics = self.update(hidden, prev_actions, masks)
            row = {
                "update": update,
                "steps": self.num_steps_done,
                "reward": (float(np.mean(self.window_episode_reward))
                           if self.window_episode_reward else 0.0),
                **metrics,
                **{f"metrics/{k}": float(np.mean(v))
                   for k, v in self.window_episode_metrics.items() if v},
            }
            self.metrics_log.append(row)
            if cfg.checkpoint_interval and cfg.checkpoint_folder and \
                    (update + 1) % cfg.checkpoint_interval == 0:
                self.save_checkpoint(f"ckpt.{update}.pkl")
        return self.metrics_log

    def update(self, hidden, prev_actions, masks) -> Dict[str, float]:
        """Bootstrap value, returns, the PPO update and one host copy of
        its metrics."""
        cfg = self.cfg
        with torch.no_grad():
            next_value = self.policy.get_value(
                self._obs(self.rollouts.step), hidden, prev_actions, masks)
        self.rollouts.compute_returns(next_value.cpu().numpy(),
                                      cfg.ppo.use_gae, cfg.ppo.gamma,
                                      cfg.ppo.tau)
        metrics = self.ppo.update(self.rollouts.batch(self.device),
                                  self._perm_gen)
        self.rollouts.after_update()
        values = torch.stack(list(metrics.values())).cpu().numpy()
        return {k: float(v) for k, v in zip(metrics, values)}

    # -- checkpointing (ppo_trainer.py:64-101) -----------------------------
    def save_checkpoint(self, name: str) -> str:
        os.makedirs(self.cfg.checkpoint_folder, exist_ok=True)
        path = os.path.join(self.cfg.checkpoint_folder, name)
        blob = {"params": _params_numpy(self.policy),
                "update_idx": self.ppo.update_idx,
                "num_steps_done": self.num_steps_done}
        with open(path, "wb") as f:
            pickle.dump(blob, f)
        return path

    def load_checkpoint(self, path: str) -> None:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        _load_params(self.policy, blob["params"])
        self.num_steps_done = blob.get("num_steps_done", 0)

    # -- eval (ppo_trainer.py:422-647 _eval_checkpoint) --------------------
    def evaluate(self, env, num_episodes: int = 4,
                 max_steps: int = 200) -> Dict[str, float]:
        """Rollouts over `num_episodes`; returns mean metrics. Actions are
        sampled from the trainer's generator, as the JAX package's
        evaluation samples them (its docstring says deterministic, but its
        step never asks for the argmax)."""
        totals: Dict[str, List[float]] = defaultdict(list)
        dev = self.device
        for _ in range(num_episodes):
            obs = env.reset()
            hidden = torch.zeros((1, self.cfg.hidden_size), device=dev)
            prev = torch.zeros((1,), dtype=torch.int64, device=dev)
            mask = torch.zeros((1,), device=dev)
            done = False
            steps = 0
            ep_reward = 0.0
            info: dict = {}
            while not done and steps < max_steps:
                bobs = {k: to_device(np.asarray(v, np.float32)[None], dev)
                        for k, v in obs.items()}
                _, action, _, _, hidden = self.act(bobs, hidden, prev, mask)
                obs, reward, done, info = env.step(int(action[0]))
                ep_reward += reward
                mask = torch.ones((1,), device=dev)
                steps += 1
            totals["reward"].append(ep_reward)
            for k, v in info.items():
                if np.isscalar(v) and np.isfinite(v):
                    totals[k].append(float(v))
        return {k: float(np.mean(v)) for k, v in totals.items()}

    def close(self) -> None:
        self.envs.close()
