"""Agents + Benchmark (habitat/core/agent.py, benchmark.py,
habitat_baselines/agents/simple_agents.py + ppo_agents.py analogs).

Counterpart of the JAX package's `rl/agents.py`. An Agent maps
observations -> action with per-episode reset; Benchmark drives an Agent
over a dataset's episodes and averages task metrics (the habitat
challenge-evaluation protocol, local mode — the grpc remote_evaluate path
in benchmark.py:41-115 is challenge-server infrastructure, out of scope).
`PPOAgent` runs its policy on the card unless asked for the CPU, with its
hidden state, previous action and mask kept on the device.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from ..models.detector import resolve_device
from .core import Env
from .rollout import to_device

__all__ = ["Agent", "RandomAgent", "ForwardOnlyAgent", "RandomForwardAgent",
           "GoalFollower", "PPOAgent", "Benchmark", "Challenge"]

# nav action indices (rl/nav.py NavigationTask.build order)
STOP, FORWARD, LEFT, RIGHT = 0, 1, 2, 3


class Agent:
    """habitat/core/agent.py:10-37."""

    def reset(self) -> None:
        raise NotImplementedError

    def act(self, observations: Dict[str, np.ndarray]) -> int:
        raise NotImplementedError


class RandomAgent(Agent):
    """simple_agents.py:18-41: random walk, stop at the goal."""

    def __init__(self, success_distance: float = 0.2,
                 goal_sensor_uuid: str = "pointgoal_with_gps_compass",
                 seed: int = 0):
        self.dist_threshold = success_distance
        self.goal_sensor_uuid = goal_sensor_uuid
        self._rng = np.random.RandomState(seed)

    def reset(self):
        pass

    def is_goal_reached(self, observations) -> bool:
        return observations[self.goal_sensor_uuid][0] <= self.dist_threshold

    def act(self, observations) -> int:
        if self.is_goal_reached(observations):
            return STOP
        return int(self._rng.choice([FORWARD, LEFT, RIGHT]))


class ForwardOnlyAgent(RandomAgent):
    """simple_agents.py:44-51."""

    def act(self, observations) -> int:
        return STOP if self.is_goal_reached(observations) else FORWARD


class RandomForwardAgent(RandomAgent):
    """simple_agents.py:53-70: 80% forward, 20% turn."""

    FORWARD_PROBABILITY = 0.8

    def act(self, observations) -> int:
        if self.is_goal_reached(observations):
            return STOP
        if self._rng.uniform(0, 1, 1) < self.FORWARD_PROBABILITY:
            return FORWARD
        return int(self._rng.choice([LEFT, RIGHT]))


class GoalFollower(RandomAgent):
    """simple_agents.py:72-107: turn toward the goal bearing, then walk."""

    def __init__(self, success_distance: float = 0.2,
                 goal_sensor_uuid: str = "pointgoal_with_gps_compass",
                 angle_th: float = float(np.deg2rad(15)), seed: int = 0):
        super().__init__(success_distance, goal_sensor_uuid, seed)
        self.angle_th = angle_th

    @staticmethod
    def normalize_angle(angle: float) -> float:
        return float((angle + np.pi) % (2 * np.pi) - np.pi)

    def turn_towards_goal(self, angle_to_goal: float) -> int:
        return LEFT if angle_to_goal > 0 else RIGHT

    def act(self, observations) -> int:
        if self.is_goal_reached(observations):
            return STOP
        rho_phi = observations[self.goal_sensor_uuid]
        angle_to_goal = self.normalize_angle(float(rho_phi[1]))
        if abs(angle_to_goal) < self.angle_th:
            return FORWARD
        return self.turn_towards_goal(angle_to_goal)


class PPOAgent(Agent):
    """Trained-policy agent (agents/ppo_agents.py:40-166): a policy module
    (`rl.policy.PointNavPolicy` or `rl.resnet_policy.PointNavResNetPolicy`)
    stepped with a persistent hidden state. `act` makes one host copy, of
    the action."""

    def __init__(self, policy: torch.nn.Module, hidden_size: int,
                 deterministic: bool = False, seed: int = 0,
                 device: "torch.device | str" = "cuda"):
        self.device = resolve_device(device)
        self.policy = policy.to(self.device).eval()
        self.hidden_size = hidden_size
        self.deterministic = deterministic
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self.reset()

    @classmethod
    def from_checkpoint(cls, path: str, policy, **kw) -> "PPOAgent":
        """A `PPOTrainer` checkpoint (pickled numpy parameters)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        policy.load_state_dict({k: torch.from_numpy(np.asarray(v))
                                for k, v in blob["params"].items()})
        return cls(policy, hidden_size=policy.hidden_size, **kw)

    @classmethod
    def from_habitat_checkpoint(cls, path: str, policy,
                                **kw) -> "PPOAgent":
        """A reference habitat ppo_trainer .pth checkpoint, through
        rl/convert.py."""
        from .convert import load_habitat_checkpoint
        policy.load_state_dict(load_habitat_checkpoint(
            path, blind=getattr(policy, "blind", True)))
        return cls(policy, hidden_size=policy.hidden_size, **kw)

    def reset(self):
        self._hidden = torch.zeros((1, self.hidden_size), device=self.device)
        self._prev = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._mask = torch.zeros((1,), device=self.device)

    @torch.no_grad()
    def act(self, observations) -> int:
        obs = {k: to_device(np.asarray(v, np.float32)[None], self.device)
               for k, v in observations.items()}
        _, action, _, self._hidden = self.policy.act(
            obs, self._hidden, self._prev, self._mask, self._gen,
            self.deterministic)
        self._prev = action
        self._mask = torch.ones((1,), device=self.device)
        return int(action.cpu()[0])


class Benchmark:
    """Run an Agent over episodes, average metrics
    (habitat/core/benchmark.py:116-162 local_evaluate)."""

    def __init__(self, env: Env):
        self._env = env

    def evaluate(self, agent: Agent,
                 num_episodes: Optional[int] = None) -> Dict[str, float]:
        num_episodes = num_episodes or len(self._env.episodes)
        if num_episodes <= 0:
            raise ValueError("Benchmark.evaluate: no episodes")
        agg: Dict[str, list] = defaultdict(list)
        for _ in range(num_episodes):
            obs = self._env.reset()
            agent.reset()
            while not self._env.episode_over:
                obs = self._env.step(agent.act(obs))
            for k, v in self._env.get_metrics().items():
                if np.isscalar(v) and np.isfinite(v):
                    agg[k].append(float(v))
        return {k: float(np.mean(v)) for k, v in agg.items()}


class Challenge(Benchmark):
    """Challenge-submission wrapper (habitat/core/challenge.py:13-21):
    evaluate an agent and print the metric table. The reference's remote
    grpc evaluation-server mode (benchmark.py:41-115) is challenge
    infrastructure outside the framework; local evaluation is complete."""

    def submit(self, agent: Agent,
               num_episodes: Optional[int] = None) -> Dict[str, float]:
        metrics = self.evaluate(agent, num_episodes)
        for k, v in metrics.items():
            print(f"{k}: {v}")
        return metrics
