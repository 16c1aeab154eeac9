"""RL config tree (habitat/config/default.py + habitat_baselines config
analog).

The reference exposes a yacs CN tree (TASK_CONFIG.{SIMULATOR,TASK,
ENVIRONMENT,DATASET} + RL.{PPO,DDPPO}); here the same knob surface is
typed dataclasses with the package's `a.b=c` override convention
(config.py:apply_opts style), used by rl/run.py and make_nav_rl_env.

The port's copy of the JAX package's `rl/config.py`, with `PPOConfig` from
the port's `rl/ppo.py`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

from embodied_object_detection_tpu_torch.rl.ppo import PPOConfig

__all__ = ["SimulatorConfig", "TaskConfig", "EnvironmentConfig",
           "DatasetConfig", "DDPPOConfig", "RLConfig", "ExperimentConfig",
           "get_config"]


@dataclass
class SimulatorConfig:
    # habitat SIMULATOR.{FORWARD_STEP_SIZE, TURN_ANGLE, RGB_SENSOR...}
    forward_step_size: float = 0.25
    turn_angle_deg: float = 10.0
    image_height: int = 64
    image_width: int = 64
    hfov_deg: float = 90.0
    max_depth_m: float = 10.0
    rgb_sensor: bool = False
    depth_sensor: bool = False
    scene_size_m: float = 12.8
    cell_m: float = 0.1


@dataclass
class TaskConfig:
    # habitat TASK.{TYPE, SUCCESS_DISTANCE, SENSORS, MEASUREMENTS}
    type: str = "Nav-v0"
    success_distance: float = 0.2
    goal_sensor_uuid: str = "pointgoal_with_gps_compass"
    measurements: Tuple[str, ...] = ("distance_to_goal", "success", "spl",
                                     "softspl", "collisions")


@dataclass
class EnvironmentConfig:
    # habitat ENVIRONMENT.{MAX_EPISODE_STEPS, MAX_EPISODE_SECONDS}
    max_episode_steps: int = 500
    max_episode_seconds: float = 0.0


@dataclass
class DatasetConfig:
    # habitat DATASET.{TYPE, SPLIT, SCENES...}; scenes are synthetic ids
    scenes: Tuple[str, ...] = ("scene0",)
    episodes_per_scene: int = 8
    seed: int = 0
    shuffle: bool = True


@dataclass
class DDPPOConfig:
    # habitat_baselines RL.DDPPO.{sync_frac, distrib_backend, backbone...}
    sync_frac: float = 0.6
    backbone: str = "resnet18"
    rnn_type: str = "GRU"
    num_recurrent_layers: int = 1
    reset_critic: bool = True


@dataclass
class RLConfig:
    # habitat_baselines RL.{REWARD_MEASURE, SLACK_REWARD, PPO, DDPPO}
    reward_measure: str = "distance_to_goal"
    success_measure: str = "success"
    success_reward: float = 2.5
    slack_reward: float = -0.01
    ppo: PPOConfig = field(default_factory=PPOConfig)
    ddppo: DDPPOConfig = field(default_factory=DDPPOConfig)


@dataclass
class ExperimentConfig:
    simulator: SimulatorConfig = field(default_factory=SimulatorConfig)
    task: TaskConfig = field(default_factory=TaskConfig)
    environment: EnvironmentConfig = field(default_factory=EnvironmentConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    rl: RLConfig = field(default_factory=RLConfig)
    num_envs: int = 4
    num_steps: int = 64
    num_updates: int = 20
    hidden_size: int = 512


def _set_by_path(cfg, path: str, value: str):
    parts = path.split(".")
    chain = [cfg]
    for p in parts[:-1]:
        chain.append(getattr(chain[-1], p))
    cur = getattr(chain[-1], parts[-1])
    if isinstance(cur, bool):
        value = value.lower() in ("1", "true", "yes")
    elif isinstance(cur, int):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    elif isinstance(cur, tuple):
        value = tuple(type(cur[0])(v) if cur else v
                      for v in value.split(","))
    # frozen dataclasses (PPOConfig) are replaced up the parent chain
    new = value
    for obj, name in zip(reversed(chain), reversed(parts)):
        try:
            setattr(obj, name, new)
            return
        except dataclasses.FrozenInstanceError:
            new = dataclasses.replace(obj, **{name: new})
    raise ValueError(f"cannot set {path}")


def get_config(opts: Optional[Sequence[str]] = None) -> ExperimentConfig:
    """Build the default tree and apply `a.b.c=value` overrides (the
    habitat `get_config(..., opts)` surface)."""
    cfg = ExperimentConfig()
    for opt in opts or []:
        path, value = opt.split("=", 1)
        _set_by_path(cfg, path, value)
    return cfg


def make_env_from_config(cfg: ExperimentConfig, rank: int = 0):
    """Config tree -> NavRLEnv (the get_env_class + construct path)."""
    from embodied_object_detection_tpu_torch.rl import nav
    from embodied_object_detection_tpu_torch.rl.core import Env
    from embodied_object_detection_tpu_torch.rl.sim import (
        GridSimulator, make_pointnav_dataset)

    sim = GridSimulator(
        size_m=cfg.simulator.scene_size_m, cell_m=cfg.simulator.cell_m,
        image_hw=(cfg.simulator.image_height, cfg.simulator.image_width),
        hfov_deg=cfg.simulator.hfov_deg,
        max_depth_m=cfg.simulator.max_depth_m)
    sim.FORWARD_STEP_M = cfg.simulator.forward_step_size
    sim.TURN_ANGLE_RAD = float(__import__("numpy").deg2rad(
        cfg.simulator.turn_angle_deg))
    dataset = make_pointnav_dataset(
        sim, list(cfg.dataset.scenes), cfg.dataset.episodes_per_scene,
        seed=cfg.dataset.seed + rank)
    measure_reg = {
        "distance_to_goal": nav.DistanceToGoal, "success": nav.Success,
        "spl": nav.SPL, "softspl": nav.SoftSPL,
        "collisions": nav.Collisions,
    }
    measures = [measure_reg[m]() for m in cfg.task.measurements]
    for m in measures:
        if isinstance(m, nav.Success):
            m.SUCCESS_DISTANCE = cfg.task.success_distance
    sensors = [nav.IntegratedPointGoalGPSAndCompassSensor()]
    if cfg.simulator.rgb_sensor:
        sensors.append(nav.RGBSensor(
            image_hw=(cfg.simulator.image_height,
                      cfg.simulator.image_width)))
    if cfg.simulator.depth_sensor:
        sensors.append(nav.DepthSensor(
            image_hw=(cfg.simulator.image_height, cfg.simulator.image_width),
            max_depth=cfg.simulator.max_depth_m))
    task = nav.NavigationTask.build(sim, sensors=sensors, measures=measures)
    env = Env(task, dataset,
              max_episode_steps=cfg.environment.max_episode_steps,
              max_episode_seconds=cfg.environment.max_episode_seconds,
              shuffle_episodes=cfg.dataset.shuffle,
              seed=cfg.dataset.seed + rank)
    rl_env = nav.NavRLEnv(env)
    rl_env.SLACK_REWARD = cfg.rl.slack_reward
    rl_env.SUCCESS_REWARD = cfg.rl.success_reward
    rl_env.REWARD_MEASURE = cfg.rl.reward_measure
    rl_env.SUCCESS_MEASURE = cfg.rl.success_measure
    return rl_env
