"""Core embodied-task abstractions (habitat/core analog).

Re-expresses the reference's habitat/core layer — `Env`
(habitat/core/env.py:25-307), `RLEnv` (:310-420), `EmbodiedTask` /
`Measure` / `Measurements` (habitat/core/embodied_task.py), `Sensor` /
`SensorSuite` (habitat/core/simulator.py), `Episode` / `Dataset` /
`EpisodeIterator` (habitat/core/dataset.py) and the global `registry`
(habitat/core/registry.py) — as a compact host-side substrate.

Everything here is deliberately host-side Python: simulation and task
bookkeeping are CPU work in the reference too (habitat-sim is external
C++). The device boundary is the policy step, which consumes the stacked
numpy observations this layer produces (see rl/policy.py).

The port's copy of the JAX package's `rl/core.py`, which imports no JAX:
the same episodes, observations and measures for the same seeds.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Space", "Box", "Discrete", "DictSpace", "Sensor", "SensorSuite",
    "Measure", "Metrics", "Measurements", "Episode", "Dataset",
    "EpisodeIterator", "Action", "EmbodiedTask", "Env", "RLEnv", "Registry",
    "registry",
]


# --------------------------------------------------------------------------
# Minimal observation/action spaces (gym.spaces analog; gym is not a dependency)
# --------------------------------------------------------------------------

class Space:
    """Base space; mirrors the subset of gym.Space the reference uses."""

    def sample(self, rng: Optional[np.random.RandomState] = None):
        raise NotImplementedError

    def contains(self, x) -> bool:  # pragma: no cover - debugging aid
        raise NotImplementedError


@dataclass
class Box(Space):
    low: float
    high: float
    shape: Tuple[int, ...]
    dtype: Any = np.float32

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == tuple(self.shape) and bool(
            np.all(x >= self.low) and np.all(x <= self.high))


@dataclass
class Discrete(Space):
    n: int

    def sample(self, rng=None):
        rng = rng or np.random
        return int(rng.randint(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n


class DictSpace(Space):
    """Dict-of-spaces (gym.spaces.Dict / habitat SensorSuite observation space)."""

    def __init__(self, spaces: Dict[str, Space]):
        self.spaces = dict(spaces)

    def sample(self, rng=None):
        return {k: s.sample(rng) for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return all(k in x and s.contains(x[k]) for k, s in self.spaces.items())


# --------------------------------------------------------------------------
# Sensors (habitat/core/simulator.py Sensor/SensorSuite)
# --------------------------------------------------------------------------

class Sensor:
    """Produces one named observation per step.

    Subclasses set `uuid` and `observation_space` and implement
    `get_observation(sim, episode, task)` (reference passes *args/**kwargs;
    we fix the signature — every habitat sensor ultimately reads these three).
    """

    uuid: str = "sensor"
    observation_space: Space = Box(-np.inf, np.inf, (1,))

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}

    def get_observation(self, sim, episode, task) -> np.ndarray:
        raise NotImplementedError


class SensorSuite:
    """Ordered collection of sensors -> observation dict.

    Ref: habitat/core/simulator.py SensorSuite.get_observations.
    """

    def __init__(self, sensors: Sequence[Sensor]):
        self.sensors: Dict[str, Sensor] = {}
        spaces: Dict[str, Space] = {}
        for s in sensors:
            if s.uuid in self.sensors:
                raise ValueError(f"duplicate sensor uuid {s.uuid!r}")
            self.sensors[s.uuid] = s
            spaces[s.uuid] = s.observation_space
        self.observation_spaces = DictSpace(spaces)

    def get_observations(self, sim, episode, task) -> Dict[str, np.ndarray]:
        return {uuid: s.get_observation(sim, episode, task)
                for uuid, s in self.sensors.items()}


# --------------------------------------------------------------------------
# Measures (habitat/core/embodied_task.py:82-201)
# --------------------------------------------------------------------------

class Measure:
    """A per-episode metric with reset/update lifecycle."""

    uuid: str = "measure"

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self._metric: Any = None

    def reset_metric(self, sim, episode, task) -> None:
        raise NotImplementedError

    def update_metric(self, sim, episode, task, action) -> None:
        raise NotImplementedError

    def get_metric(self):
        return self._metric


class Metrics(dict):
    """Dict of measure uuid -> value (habitat/core/embodied_task.py:128)."""


class Measurements:
    """Ordered measure collection with dependency checking.

    Ref: habitat/core/embodied_task.py:144-201. Measures run in insertion
    order, so a measure may read earlier measures' metrics (e.g. SPL reads
    DistanceToGoal + Success); `check_measure_dependencies` enforces the
    ordering like the reference does.
    """

    def __init__(self, measures: Sequence[Measure]):
        self.measures: Dict[str, Measure] = {}
        for m in measures:
            if m.uuid in self.measures:
                raise ValueError(f"duplicate measure uuid {m.uuid!r}")
            self.measures[m.uuid] = m

    def reset_measures(self, sim, episode, task) -> None:
        for m in self.measures.values():
            m.reset_metric(sim, episode, task)

    def update_measures(self, sim, episode, task, action) -> None:
        for m in self.measures.values():
            m.update_metric(sim, episode, task, action)

    def check_measure_dependencies(self, measure_name: str,
                                   dependencies: Sequence[str]) -> None:
        order = list(self.measures)
        idx = order.index(measure_name)
        for dep in dependencies:
            if dep not in order or order.index(dep) > idx:
                raise ValueError(
                    f"measure {measure_name!r} requires {dep!r} to be "
                    "registered before it")

    def get_metrics(self) -> Metrics:
        return Metrics({u: m.get_metric() for u, m in self.measures.items()})


# --------------------------------------------------------------------------
# Episodes / dataset (habitat/core/dataset.py)
# --------------------------------------------------------------------------

@dataclass
class Episode:
    episode_id: str
    scene_id: str
    start_position: np.ndarray  # [2] or [3]
    start_rotation: float       # heading radians (reference uses quaternion)
    info: dict = field(default_factory=dict)


class Dataset:
    """Episode container (habitat/core/dataset.py Dataset, trimmed to the
    surface the Env/trainers consume + JSON (de)serialization per
    dataset.py:168-208 — habitat datasets ship as episode JSON files)."""

    def __init__(self, episodes: Sequence[Episode]):
        self.episodes: List[Episode] = list(episodes)

    def get_scenes(self) -> List[str]:
        return sorted({e.scene_id for e in self.episodes})

    def to_json(self) -> str:
        import json

        def default(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            raise TypeError(f"not serializable: {type(o)}")

        return json.dumps(
            {"episodes": [{
                "episode_id": e.episode_id, "scene_id": e.scene_id,
                "start_position": np.asarray(e.start_position).tolist(),
                "start_rotation": float(e.start_rotation),
                "info": e.info,
            } for e in self.episodes]}, default=default)

    @classmethod
    def from_json(cls, json_str: str) -> "Dataset":
        import json
        blob = json.loads(json_str)
        return cls([Episode(
            episode_id=str(d["episode_id"]), scene_id=str(d["scene_id"]),
            start_position=np.asarray(d["start_position"], np.float32),
            start_rotation=float(d["start_rotation"]),
            info=d.get("info", {})) for d in blob["episodes"]])

    def get_episode_iterator(self, cycle: bool = True, shuffle: bool = False,
                             group_by_scene: bool = False,
                             max_scene_repeat_episodes: int = -1,
                             seed: Optional[int] = None) -> "EpisodeIterator":
        return EpisodeIterator(
            self.episodes, cycle=cycle, shuffle=shuffle,
            group_by_scene=group_by_scene,
            max_scene_repeat_episodes=max_scene_repeat_episodes, seed=seed)


class EpisodeIterator(Iterator[Episode]):
    """Cycling/shuffling episode iterator (habitat/core/dataset.py:330-430).

    `group_by_scene` keeps each scene's episodes contiguous (habitat does
    this because scene switching is expensive in habitat-sim; it is free
    on the synthetic simulator but the ordering contract is preserved);
    shuffling then permutes scene groups, not individual episodes.
    `max_scene_repeat_episodes` forces a scene switch after N consecutive
    episodes of one scene by rotating the remaining group order
    (dataset.py `_forced_scene_switch`)."""

    def __init__(self, episodes: Sequence[Episode], cycle: bool = True,
                 shuffle: bool = False, group_by_scene: bool = False,
                 max_scene_repeat_episodes: int = -1,
                 seed: Optional[int] = None):
        self.episodes = list(episodes)
        self.cycle = cycle
        self.shuffle = shuffle
        self.group_by_scene = group_by_scene or max_scene_repeat_episodes > 0
        self.max_scene_repeat = max_scene_repeat_episodes
        self._rng = random.Random(seed)
        self._idx = 0
        self._same_scene_count = 0
        self._prev_scene: Optional[str] = None
        if self.group_by_scene:
            self._regroup(shuffle_groups=shuffle)
        elif shuffle:
            self._rng.shuffle(self.episodes)

    def _regroup(self, shuffle_groups: bool) -> None:
        groups: Dict[str, List[Episode]] = {}
        for e in self.episodes:
            groups.setdefault(e.scene_id, []).append(e)
        keys = list(groups)
        if shuffle_groups:
            self._rng.shuffle(keys)
            for g in groups.values():  # habitat reshuffles within groups
                self._rng.shuffle(g)
        self.episodes = [e for k in keys for e in groups[k]]

    def _forced_scene_switch(self) -> None:
        """Rotate the remaining episodes so a new scene comes next."""
        rest = self.episodes[self._idx:]
        cur = rest[0].scene_id
        pivot = next((i for i, e in enumerate(rest) if e.scene_id != cur),
                     None)
        if pivot is not None:
            self.episodes = (self.episodes[:self._idx] + rest[pivot:] +
                             rest[:pivot])

    def __iter__(self):
        return self

    def __next__(self) -> Episode:
        if self._idx >= len(self.episodes):
            if not self.cycle:
                raise StopIteration
            self._idx = 0
            if self.group_by_scene:
                self._regroup(shuffle_groups=self.shuffle)
            elif self.shuffle:
                self._rng.shuffle(self.episodes)
        if (self.max_scene_repeat > 0 and self._prev_scene is not None and
                self._same_scene_count >= self.max_scene_repeat and
                self._idx < len(self.episodes) and
                self.episodes[self._idx].scene_id == self._prev_scene):
            self._forced_scene_switch()
        ep = self.episodes[self._idx]
        self._idx += 1
        if ep.scene_id == self._prev_scene:
            self._same_scene_count += 1
        else:
            self._prev_scene = ep.scene_id
            self._same_scene_count = 1
        return ep


# --------------------------------------------------------------------------
# Actions + task (habitat/core/embodied_task.py:22-360)
# --------------------------------------------------------------------------

class Action:
    """A named task action. `step(sim, task)` mutates sim state and returns
    sim observations (reference SimulatorTaskAction.step)."""

    name: str = "action"

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}

    def reset(self, sim, task) -> None:
        pass

    def step(self, sim, task) -> None:
        raise NotImplementedError


class EmbodiedTask:
    """Task = sensors + measures + actions + episode-termination logic.

    Ref: habitat/core/embodied_task.py:204-360. Subclasses provide the
    entity lists; `step` dispatches an integer/str action, updates measures
    and computes observations.
    """

    def __init__(self, sim, sensors: Sequence[Sensor],
                 measures: Sequence[Measure], actions: Sequence[Action],
                 config: Optional[dict] = None):
        self.sim = sim
        self.config = config or {}
        self.sensor_suite = SensorSuite(list(sensors))
        self.measurements = Measurements(list(measures))
        self.actions: Dict[str, Action] = {a.name: a for a in actions}
        self._action_order = [a.name for a in actions]
        self.is_stop_called = False
        self._is_episode_active = True

    @property
    def action_space(self) -> Discrete:
        return Discrete(len(self._action_order))

    def action_name(self, index: int) -> str:
        return self._action_order[int(index)]

    def reset(self, episode: Episode) -> Dict[str, np.ndarray]:
        self.sim.reset(episode)
        self.is_stop_called = False
        self._is_episode_active = True
        for a in self.actions.values():
            a.reset(self.sim, self)
        return self.sensor_suite.get_observations(self.sim, episode, self)

    def step(self, action, episode: Episode) -> Dict[str, np.ndarray]:
        name = action if isinstance(action, str) else self.action_name(action)
        if name not in self.actions:
            raise ValueError(f"unknown action {name!r}")
        self.actions[name].step(self.sim, self)
        self._is_episode_active = self._check_episode_is_active(episode)
        return self.sensor_suite.get_observations(self.sim, episode, self)

    def _check_episode_is_active(self, episode: Episode) -> bool:
        return not self.is_stop_called

    @property
    def is_episode_active(self) -> bool:
        return self._is_episode_active


# --------------------------------------------------------------------------
# Env / RLEnv (habitat/core/env.py)
# --------------------------------------------------------------------------

class Env:
    """Fundamental episode-stepping environment (habitat/core/env.py:25).

    Owns a simulator, a task and an episode iterator; enforces the
    max-episode-steps/seconds limits (:181-192) and exposes task metrics.
    """

    def __init__(self, task: EmbodiedTask, dataset: Dataset,
                 max_episode_steps: int = 500,
                 max_episode_seconds: float = 0.0,
                 shuffle_episodes: bool = False, seed: Optional[int] = None):
        self.task = task
        self._dataset = dataset
        self._episode_iterator = dataset.get_episode_iterator(
            cycle=True, shuffle=shuffle_episodes, seed=seed)
        self._max_episode_steps = max_episode_steps
        self._max_episode_seconds = max_episode_seconds
        self._current_episode: Optional[Episode] = None
        self._elapsed_steps = 0
        self._episode_start_time: Optional[float] = None
        self._episode_over = False

    # -- properties mirroring env.py:128-178 --
    @property
    def sim(self):
        return self.task.sim

    @property
    def current_episode(self) -> Episode:
        assert self._current_episode is not None
        return self._current_episode

    @property
    def episodes(self) -> List[Episode]:
        return self._dataset.episodes

    @property
    def episode_over(self) -> bool:
        return self._episode_over

    @property
    def observation_space(self) -> DictSpace:
        return self.task.sensor_suite.observation_spaces

    @property
    def action_space(self) -> Discrete:
        return self.task.action_space

    def get_metrics(self) -> Metrics:
        return self.task.measurements.get_metrics()

    def _past_limit(self) -> bool:
        if 0 < self._max_episode_steps <= self._elapsed_steps:
            return True
        if (self._max_episode_seconds > 0 and self._episode_start_time and
                time.time() - self._episode_start_time
                > self._max_episode_seconds):
            return True
        return False

    def reset(self) -> Dict[str, np.ndarray]:
        self._current_episode = next(self._episode_iterator)
        self._elapsed_steps = 0
        self._episode_start_time = time.time()
        self._episode_over = False
        obs = self.task.reset(self._current_episode)
        self.task.measurements.reset_measures(
            self.sim, self._current_episode, self.task)
        return obs

    def step(self, action) -> Dict[str, np.ndarray]:
        assert self._episode_start_time is not None, "call reset before step"
        assert not self._episode_over, "episode over; call reset"
        obs = self.task.step(action, self._current_episode)
        self.task.measurements.update_measures(
            self.sim, self._current_episode, self.task, action)
        self._elapsed_steps += 1
        self._episode_over = (not self.task.is_episode_active
                              or self._past_limit())
        return obs

    def seed(self, seed: int) -> None:
        np.random.seed(seed)
        random.seed(seed)
        if hasattr(self.sim, "seed"):
            self.sim.seed(seed)

    def close(self) -> None:
        if hasattr(self.sim, "close"):
            self.sim.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RLEnv:
    """Gym-style (obs, reward, done, info) wrapper over Env
    (habitat/core/env.py:310-420). Subclasses define get_reward/get_done/
    get_info like the reference."""

    def __init__(self, env: Env):
        self._env = env

    @property
    def habitat_env(self) -> Env:
        return self._env

    @property
    def observation_space(self) -> DictSpace:
        return self._env.observation_space

    @property
    def action_space(self) -> Discrete:
        return self._env.action_space

    @property
    def current_episode(self) -> Episode:
        return self._env.current_episode

    @property
    def num_actions(self) -> int:
        return self._env.action_space.n

    def reset(self) -> Dict[str, np.ndarray]:
        return self._env.reset()

    def get_reward_range(self) -> Tuple[float, float]:
        raise NotImplementedError

    def get_reward(self, observations) -> float:
        raise NotImplementedError

    def get_done(self, observations) -> bool:
        raise NotImplementedError

    def get_info(self, observations) -> dict:
        return dict(self._env.get_metrics())

    def step(self, action):
        obs = self._env.step(action)
        return (obs, self.get_reward(obs), self.get_done(obs),
                self.get_info(obs))

    def seed(self, seed: int) -> None:
        self._env.seed(seed)

    def close(self) -> None:
        self._env.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# --------------------------------------------------------------------------
# Registry (habitat/core/registry.py + baseline_registry)
# --------------------------------------------------------------------------

class Registry:
    """Name -> class registry with decorator registration."""

    def __init__(self):
        self._store: Dict[str, Dict[str, type]] = {}

    def _register(self, kind: str, name: Optional[str], cls: type):
        self._store.setdefault(kind, {})[name or cls.__name__] = cls
        return cls

    def _make_decorator(self, kind: str, name: Optional[str]):
        def deco(cls):
            return self._register(kind, name, cls)
        return deco

    def register_task(self, name: Optional[str] = None):
        return self._make_decorator("task", name)

    def register_sensor(self, name: Optional[str] = None):
        return self._make_decorator("sensor", name)

    def register_measure(self, name: Optional[str] = None):
        return self._make_decorator("measure", name)

    def register_action(self, name: Optional[str] = None):
        return self._make_decorator("action", name)

    def register_env(self, name: Optional[str] = None):
        return self._make_decorator("env", name)

    def register_simulator(self, name: Optional[str] = None):
        return self._make_decorator("simulator", name)

    def get(self, kind: str, name: str) -> type:
        try:
            return self._store[kind][name]
        except KeyError:
            raise KeyError(f"no {kind} registered under {name!r}; have "
                           f"{sorted(self._store.get(kind, {}))}")

    def get_task(self, name): return self.get("task", name)
    def get_sensor(self, name): return self.get("sensor", name)
    def get_measure(self, name): return self.get("measure", name)
    def get_action(self, name): return self.get("action", name)
    def get_env(self, name): return self.get("env", name)
    def get_simulator(self, name): return self.get("simulator", name)


registry = Registry()
