"""PointNav task: sensors, measures, actions, RL env.

Re-designs the reference's navigation task layer
(habitat/tasks/nav/nav.py: PointGoalSensor:109,
IntegratedPointGoalGPSAndCompassSensor:281, HeadingSensor:321,
EpisodicCompassSensor:364, EpisodicGPSSensor:386, ProximitySensor:444,
Success:490, SPL:533, SoftSPL:594, Collisions:641, DistanceToGoal:953,
actions :1009-1070, NavigationTask:1120) and the reward-shaped `NavRLEnv`
(habitat_baselines/common/environments.py:32-90) over the 2-D
GridSimulator. Goal vectors use the polar [rho, phi] format (habitat
GOAL_FORMAT=POLAR, DIMENSIONALITY=2).

The port's copy of the JAX package's `rl/nav.py` (host-side numpy,
no JAX), with the package path changed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from embodied_object_detection_tpu_torch.rl.core import (
    Action, Box, Dataset, EmbodiedTask, Env, Episode, Measure, RLEnv,
    Sensor, registry)
from embodied_object_detection_tpu_torch.rl.sim import GridSimulator

__all__ = [
    "PointGoalSensor", "IntegratedPointGoalGPSAndCompassSensor",
    "HeadingSensor", "EpisodicCompassSensor", "EpisodicGPSSensor",
    "ProximitySensor", "RGBSensor", "DepthSensor",
    "DistanceToGoal", "Success", "SPL", "SoftSPL", "Collisions",
    "StopAction", "MoveForwardAction", "TurnLeftAction", "TurnRightAction",
    "NavigationTask", "NavRLEnv", "make_nav_rl_env",
]


def _goal_of(episode: Episode) -> np.ndarray:
    return np.asarray(episode.info["goal"], np.float32)


def _wrap_angle(a: float) -> float:
    return float((a + np.pi) % (2 * np.pi) - np.pi)


def _polar_to(agent_pos, agent_heading, goal) -> np.ndarray:
    d = np.asarray(goal, np.float64) - np.asarray(agent_pos, np.float64)
    rho = float(np.hypot(d[0], d[1]))
    phi = _wrap_angle(float(np.arctan2(d[1], d[0])) - float(agent_heading))
    return np.array([rho, phi], np.float32)


# --------------------------------------------------------------------------
# Sensors
# --------------------------------------------------------------------------

@registry.register_sensor()
class PointGoalSensor(Sensor):
    """Goal in the *episodic start* frame — static over the episode
    (nav.py:109-205)."""
    uuid = "pointgoal"
    observation_space = Box(-np.inf, np.inf, (2,))

    def get_observation(self, sim, episode, task):
        return _polar_to(episode.start_position, episode.start_rotation,
                         _goal_of(episode))


@registry.register_sensor()
class IntegratedPointGoalGPSAndCompassSensor(Sensor):
    """Goal relative to the *current* agent pose (nav.py:281-318) — the
    sensor the baseline pointnav policy trains on."""
    uuid = "pointgoal_with_gps_compass"
    observation_space = Box(-np.inf, np.inf, (2,))

    def get_observation(self, sim, episode, task):
        st = sim.get_agent_state()
        return _polar_to(st.position, st.rotation, _goal_of(episode))


@registry.register_sensor()
class HeadingSensor(Sensor):
    uuid = "heading"
    observation_space = Box(-np.pi, np.pi, (1,))

    def get_observation(self, sim, episode, task):
        return np.array([_wrap_angle(sim.get_agent_state().rotation)],
                        np.float32)


@registry.register_sensor()
class EpisodicCompassSensor(Sensor):
    """Heading relative to the episode start heading (nav.py:364)."""
    uuid = "compass"
    observation_space = Box(-np.pi, np.pi, (1,))

    def get_observation(self, sim, episode, task):
        return np.array([_wrap_angle(sim.get_agent_state().rotation
                                     - episode.start_rotation)], np.float32)


@registry.register_sensor()
class EpisodicGPSSensor(Sensor):
    """Agent position in the episode-start frame (nav.py:386)."""
    uuid = "gps"
    observation_space = Box(-np.inf, np.inf, (2,))

    def get_observation(self, sim, episode, task):
        st = sim.get_agent_state()
        d = st.position.astype(np.float64) - np.asarray(
            episode.start_position, np.float64)
        c, s = np.cos(-episode.start_rotation), np.sin(-episode.start_rotation)
        return np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]],
                        np.float32)


@registry.register_sensor()
class ProximitySensor(Sensor):
    """Distance to the nearest obstacle within max_detection_radius
    (nav.py:444-487); probed over 16 directions on the grid sim."""
    uuid = "proximity"
    observation_space = Box(0.0, 2.0, (1,))
    MAX_RADIUS = 2.0

    def get_observation(self, sim, episode, task):
        st = sim.get_agent_state()
        best = self.MAX_RADIUS
        for ang in np.linspace(0, 2 * np.pi, 16, endpoint=False):
            d = np.array([np.cos(ang), np.sin(ang)])
            for t in np.arange(0.05, self.MAX_RADIUS, 0.05):
                if not sim.is_navigable(st.position + t * d):
                    best = min(best, float(t))
                    break
        return np.array([best], np.float32)


@registry.register_sensor()
class RGBSensor(Sensor):
    uuid = "rgb"

    def __init__(self, config=None, image_hw=(64, 64)):
        super().__init__(config)
        self.observation_space = Box(0, 255, (*image_hw, 3), np.uint8)

    def get_observation(self, sim, episode, task):
        return sim.render_rgb()


@registry.register_sensor()
class DepthSensor(Sensor):
    uuid = "depth"

    def __init__(self, config=None, image_hw=(64, 64), max_depth=10.0):
        super().__init__(config)
        self.max_depth = max_depth
        self.observation_space = Box(0.0, 1.0, (*image_hw, 1))

    def get_observation(self, sim, episode, task):
        # Normalized to [0, 1] like habitat's NORMALIZE_DEPTH default.
        return (sim.render_depth() / self.max_depth).astype(np.float32)


# --------------------------------------------------------------------------
# Measures
# --------------------------------------------------------------------------

@registry.register_measure()
class DistanceToGoal(Measure):
    """Geodesic distance to the goal (nav.py:953-1006)."""
    uuid = "distance_to_goal"

    def reset_metric(self, sim, episode, task):
        self._start = float(sim.geodesic_distance(
            np.asarray(episode.start_position), _goal_of(episode)))
        self._metric = self._start

    def update_metric(self, sim, episode, task, action):
        self._metric = float(sim.geodesic_distance(
            sim.get_agent_state().position, _goal_of(episode)))

    @property
    def start_distance(self) -> float:
        return self._start


@registry.register_measure()
class Success(Measure):
    """1.0 iff STOP was called within SUCCESS_DISTANCE of the goal
    (nav.py:490-530)."""
    uuid = "success"
    SUCCESS_DISTANCE = 0.2

    def reset_metric(self, sim, episode, task):
        task.measurements.check_measure_dependencies(
            self.uuid, [DistanceToGoal.uuid])
        self._metric = 0.0

    def update_metric(self, sim, episode, task, action):
        d = task.measurements.measures[DistanceToGoal.uuid].get_metric()
        self._metric = float(task.is_stop_called
                             and d < self.SUCCESS_DISTANCE)


@registry.register_measure()
class SPL(Measure):
    """Success weighted by path length (nav.py:533-591)."""
    uuid = "spl"

    def reset_metric(self, sim, episode, task):
        task.measurements.check_measure_dependencies(
            self.uuid, [DistanceToGoal.uuid, Success.uuid])
        self._start_dist = task.measurements.measures[
            DistanceToGoal.uuid].start_distance
        self._agent_distance = 0.0
        self._prev_pos = sim.get_agent_state().position.copy()
        self._metric = 0.0

    def update_metric(self, sim, episode, task, action):
        pos = sim.get_agent_state().position
        self._agent_distance += float(np.linalg.norm(pos - self._prev_pos))
        self._prev_pos = pos.copy()
        success = task.measurements.measures[Success.uuid].get_metric()
        self._metric = success * self._start_dist / max(
            self._start_dist, self._agent_distance, 1e-8)


@registry.register_measure()
class SoftSPL(SPL):
    """SPL with soft success = progress toward goal (nav.py:594-638)."""
    uuid = "softspl"

    def reset_metric(self, sim, episode, task):
        task.measurements.check_measure_dependencies(
            self.uuid, [DistanceToGoal.uuid])
        self._start_dist = task.measurements.measures[
            DistanceToGoal.uuid].start_distance
        self._agent_distance = 0.0
        self._prev_pos = sim.get_agent_state().position.copy()
        self._metric = 0.0

    def update_metric(self, sim, episode, task, action):
        pos = sim.get_agent_state().position
        self._agent_distance += float(np.linalg.norm(pos - self._prev_pos))
        self._prev_pos = pos.copy()
        d = task.measurements.measures[DistanceToGoal.uuid].get_metric()
        ep_soft_success = max(0.0, 1.0 - d / max(self._start_dist, 1e-8))
        self._metric = ep_soft_success * self._start_dist / max(
            self._start_dist, self._agent_distance, 1e-8)


@registry.register_measure()
class Collisions(Measure):
    """{'count', 'is_collision'} (nav.py:641-661)."""
    uuid = "collisions"

    def reset_metric(self, sim, episode, task):
        self._metric = {"count": 0, "is_collision": False}

    def update_metric(self, sim, episode, task, action):
        hit = bool(sim.previous_step_collided)
        self._metric = {"count": self._metric["count"] + int(hit),
                        "is_collision": hit}


# --------------------------------------------------------------------------
# Actions (nav.py:1009-1070)
# --------------------------------------------------------------------------

@registry.register_action()
class StopAction(Action):
    name = "stop"

    def step(self, sim, task):
        task.is_stop_called = True


@registry.register_action()
class MoveForwardAction(Action):
    name = "move_forward"

    def step(self, sim, task):
        sim.move_forward()


@registry.register_action()
class TurnLeftAction(Action):
    name = "turn_left"

    def step(self, sim, task):
        sim.turn(+1)


@registry.register_action()
class TurnRightAction(Action):
    name = "turn_right"

    def step(self, sim, task):
        sim.turn(-1)


# --------------------------------------------------------------------------
# Task + RL env
# --------------------------------------------------------------------------

@registry.register_task()
class NavigationTask(EmbodiedTask):
    """PointNav (nav.py:1120-1140): episode ends when STOP is called."""

    DEFAULT_SENSORS = ("pointgoal_with_gps_compass",)
    DEFAULT_MEASURES = ("distance_to_goal", "success", "spl", "softspl",
                        "collisions")

    @classmethod
    def build(cls, sim, sensors: Optional[Sequence[Sensor]] = None,
              measures: Optional[Sequence[Measure]] = None):
        sensors = list(sensors) if sensors is not None else [
            IntegratedPointGoalGPSAndCompassSensor()]
        measures = list(measures) if measures is not None else [
            DistanceToGoal(), Success(), SPL(), SoftSPL(), Collisions()]
        actions = [StopAction(), MoveForwardAction(), TurnLeftAction(),
                   TurnRightAction()]
        return cls(sim, sensors, measures, actions)


@registry.register_env()
class NavRLEnv(RLEnv):
    """Reward-shaped nav env (environments.py:32-90): slack reward + delta
    of the reward measure + success bonus."""

    SLACK_REWARD = -0.01
    SUCCESS_REWARD = 2.5
    REWARD_MEASURE = DistanceToGoal.uuid
    SUCCESS_MEASURE = Success.uuid

    def __init__(self, env: Env):
        super().__init__(env)
        self._previous_measure: Optional[float] = None

    def reset(self):
        obs = super().reset()
        self._previous_measure = self._env.get_metrics()[self.REWARD_MEASURE]
        return obs

    def get_reward_range(self):
        return (self.SLACK_REWARD - 1.0, self.SUCCESS_REWARD + 1.0)

    def get_reward(self, observations):
        reward = self.SLACK_REWARD
        current = self._env.get_metrics()[self.REWARD_MEASURE]
        reward += self._previous_measure - current
        self._previous_measure = current
        if self._episode_success():
            reward += self.SUCCESS_REWARD
        return float(reward)

    def _episode_success(self) -> bool:
        return bool(self._env.get_metrics()[self.SUCCESS_MEASURE])

    def get_done(self, observations) -> bool:
        return self._env.episode_over or self._episode_success()


def make_nav_rl_env(scene_ids: Sequence[str] = ("scene0",),
                    episodes_per_scene: int = 8, seed: int = 0,
                    max_episode_steps: int = 100,
                    with_rgb: bool = False,
                    image_hw=(64, 64)) -> NavRLEnv:
    """Build sim -> dataset -> task -> Env -> NavRLEnv (the get_env_class +
    construct path of habitat_baselines.common.environments)."""
    from embodied_object_detection_tpu_torch.rl.sim import (
        make_pointnav_dataset)
    sim = GridSimulator(image_hw=image_hw, render_rgb=with_rgb)
    dataset = make_pointnav_dataset(sim, list(scene_ids),
                                    episodes_per_scene, seed=seed)
    sensors: List[Sensor] = [IntegratedPointGoalGPSAndCompassSensor()]
    if with_rgb:
        sensors.append(RGBSensor(image_hw=image_hw))
    task = NavigationTask.build(sim, sensors=sensors)
    env = Env(task, dataset, max_episode_steps=max_episode_steps,
              shuffle_episodes=True, seed=seed)
    return NavRLEnv(env)
