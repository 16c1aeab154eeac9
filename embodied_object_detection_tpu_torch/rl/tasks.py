"""ObjectNav / EQA / VLN task variants over the grid-world simulator.

Re-designs the reference's non-pointnav embodied tasks:

- ObjectNav (habitat/tasks/nav/object_nav_task.py:50-173):
  `ObjectGoalSensor` emits the goal category id; success = STOP near any
  instance of the category; DistanceToGoal is the min geodesic distance
  over instances.
- EQA (habitat/tasks/eqa/eqa.py:21-212): `QuestionSensor`,
  `AnswerAction` terminating the episode, `CorrectAnswer` /
  `AnswerAccuracy` measures. Questions are synthesized over the scene's
  object instances ("what is near the <object>?" style token ids) — the
  reference's questions come from the MP3D-EQA dataset asset.
- VLN (habitat/tasks/vln/vln.py:23-92): `InstructionSensor` (token ids)
  + reference-path episodes; the task itself is pointnav with the
  instruction observation attached.

Scenes get deterministic object instances via `place_objects` so all
three tasks run on the same synthetic substrate.

The port's copy of the JAX package's `rl/tasks.py` (host-side numpy,
no JAX), with the package path changed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from embodied_object_detection_tpu_torch.rl.core import (
    Action, Box, Dataset, Episode, Measure, Sensor, registry)
from embodied_object_detection_tpu_torch.rl import nav
from embodied_object_detection_tpu_torch.rl.sim import GridSimulator

__all__ = [
    "ObjectInstance", "place_objects", "ObjectGoalSensor",
    "ObjectNavigationTask", "make_objectnav_dataset", "ObjectNavDistance",
    "QuestionSensor", "AnswerAction", "CorrectAnswer", "AnswerAccuracy",
    "EQATask", "make_eqa_dataset",
    "InstructionSensor", "VLNTask", "make_vln_dataset",
]

CATEGORIES = ("chair", "table", "bed", "sofa", "plant", "sink")


@dataclass
class ObjectInstance:
    category: str
    category_id: int
    position: np.ndarray


def place_objects(sim: GridSimulator, scene_id: str,
                  num_objects: int = 6) -> List[ObjectInstance]:
    """Deterministic object instances on free cells of a scene (the
    semantic-annotation analog of habitat-sim scenes)."""
    from embodied_object_detection_tpu_torch.rl.sim import _scene_seed
    rng = np.random.RandomState(_scene_seed(scene_id, salt=7))
    out = []
    for i in range(num_objects):
        cat_id = int(rng.randint(len(CATEGORIES)))
        pos = sim.sample_navigable_point(scene_id, rng)
        out.append(ObjectInstance(CATEGORIES[cat_id], cat_id, pos))
    return out


# --------------------------------------------------------------------------
# ObjectNav
# --------------------------------------------------------------------------

@registry.register_sensor()
class ObjectGoalSensor(Sensor):
    """Goal category id (object_nav_task.py:110-165, GOAL_SPEC =
    TASK_CATEGORY_ID)."""
    uuid = "objectgoal"
    observation_space = Box(0, len(CATEGORIES) - 1, (1,), np.int64)

    def get_observation(self, sim, episode, task):
        return np.array([episode.info["category_id"]], np.int64)


@registry.register_measure()
class ObjectNavDistance(nav.DistanceToGoal):
    """Min geodesic distance over all instances of the goal category."""

    def _dist(self, sim, episode, pos) -> float:
        return min(sim.geodesic_distance(pos, g)
                   for g in episode.info["goal_positions"])

    def reset_metric(self, sim, episode, task):
        self._start = float(self._dist(
            sim, episode, np.asarray(episode.start_position)))
        self._metric = self._start

    def update_metric(self, sim, episode, task, action):
        self._metric = float(self._dist(
            sim, episode, sim.get_agent_state().position))


@registry.register_task()
class ObjectNavigationTask(nav.NavigationTask):
    """object_nav_task.py:168-173."""

    @classmethod
    def build(cls, sim, sensors=None, measures=None):
        sensors = list(sensors) if sensors is not None else [
            nav.IntegratedPointGoalGPSAndCompassSensor(), ObjectGoalSensor()]
        measures = list(measures) if measures is not None else [
            ObjectNavDistance(), nav.Success(), nav.SPL(), nav.SoftSPL(),
            nav.Collisions()]
        actions = [nav.StopAction(), nav.MoveForwardAction(),
                   nav.TurnLeftAction(), nav.TurnRightAction()]
        return cls(sim, sensors, measures, actions)


def make_objectnav_dataset(sim: GridSimulator, scene_ids: Sequence[str],
                           episodes_per_scene: int = 8,
                           seed: int = 0) -> Dataset:
    rng = np.random.RandomState(seed)
    episodes = []
    for scene in scene_ids:
        objs = place_objects(sim, scene)
        sim._scene_id = scene
        sim._occ = sim.scene_occupancy(scene)
        made = 0
        attempts = 0
        # Reachability gate, as in make_pointnav_dataset (sim.py): random
        # rectangle scenes can enclose free pockets, and a start (or every
        # goal instance) inside one yields inf geodesic distance ->
        # DistanceToGoal=inf -> NaN rewards poisoning PPO. Require at least
        # one reachable instance and drop the unreachable ones.
        while made < episodes_per_scene and \
                attempts < 200 * episodes_per_scene:
            attempts += 1
            target = objs[rng.randint(len(objs))]
            goals = [o.position for o in objs
                     if o.category_id == target.category_id]
            start = sim.sample_navigable_point(scene, rng)
            dists = [sim.geodesic_distance(start, g) for g in goals]
            goals = [g for g, d in zip(goals, dists) if np.isfinite(d)]
            dists = [d for d in dists if np.isfinite(d)]
            if not goals:
                continue
            # pointgoal sensor still needs a single reference goal: use
            # the nearest instance (the sensor is auxiliary in objectnav)
            nearest = goals[int(np.argmin(dists))]
            episodes.append(Episode(
                episode_id=f"{scene}:on{made}", scene_id=scene,
                start_position=start,
                start_rotation=float(rng.uniform(0, 2 * np.pi)),
                info={"goal": nearest.tolist(),
                      "goal_positions": [g.tolist() for g in goals],
                      "category": target.category,
                      "category_id": target.category_id}))
            made += 1
    if not episodes:
        raise RuntimeError("failed to sample any objectnav episodes")
    return Dataset(episodes)


# --------------------------------------------------------------------------
# EQA
# --------------------------------------------------------------------------

VOCAB = ("<pad>", "what", "is", "near", "the", "color", "where") + CATEGORIES
ANSWERS = CATEGORIES + ("nothing",)
MAX_QUESTION_LEN = 8


def _tokenize(words: Sequence[str]) -> np.ndarray:
    ids = [VOCAB.index(w) for w in words][:MAX_QUESTION_LEN]
    out = np.zeros(MAX_QUESTION_LEN, np.int64)
    out[:len(ids)] = ids
    return out


@registry.register_sensor()
class QuestionSensor(Sensor):
    """Token-id question (eqa.py:50-74)."""
    uuid = "question"
    observation_space = Box(0, len(VOCAB) - 1, (MAX_QUESTION_LEN,), np.int64)

    def get_observation(self, sim, episode, task):
        return np.asarray(episode.info["question_tokens"], np.int64)


@registry.register_action()
class AnswerAction(Action):
    """Terminal answer action (eqa.py:147-170 EQATask.answer). The chosen
    answer id is set via `task.pending_answer` before stepping."""
    name = "answer"

    def reset(self, sim, task):
        task.answer = None
        task.pending_answer = None

    def step(self, sim, task):
        # no answer chosen -> 'nothing' (an id-0 default would spuriously
        # score whenever the ground truth happens to be category 0)
        default = ANSWERS.index("nothing")
        task.answer = (task.pending_answer
                       if getattr(task, "pending_answer", None) is not None
                       else default)
        task.is_stop_called = True


@registry.register_measure()
class CorrectAnswer(Measure):
    """Ground-truth answer id (eqa.py:77-93)."""
    uuid = "correct_answer"

    def reset_metric(self, sim, episode, task):
        self._metric = episode.info["answer_id"]

    def update_metric(self, sim, episode, task, action):
        pass


@registry.register_measure()
class AnswerAccuracy(Measure):
    """1 iff the agent's answer matches (eqa.py:117-144)."""
    uuid = "answer_accuracy"

    def reset_metric(self, sim, episode, task):
        self._metric = 0.0

    def update_metric(self, sim, episode, task, action):
        if getattr(task, "answer", None) is not None:
            self._metric = float(task.answer == episode.info["answer_id"])


@registry.register_task()
class EQATask(nav.NavigationTask):
    """eqa.py:147-212: navigation + a terminal answer action; the episode
    is only successful through AnswerAction."""

    @classmethod
    def build(cls, sim, sensors=None, measures=None):
        sensors = list(sensors) if sensors is not None else [
            nav.IntegratedPointGoalGPSAndCompassSensor(), QuestionSensor()]
        measures = list(measures) if measures is not None else [
            nav.DistanceToGoal(), CorrectAnswer(), AnswerAccuracy()]
        actions = [nav.StopAction(), nav.MoveForwardAction(),
                   nav.TurnLeftAction(), nav.TurnRightAction(),
                   AnswerAction()]
        return cls(sim, sensors, measures, actions)


def make_eqa_dataset(sim: GridSimulator, scene_ids: Sequence[str],
                     episodes_per_scene: int = 4, seed: int = 0) -> Dataset:
    """Synthesized 'what is near the X?' QA pairs: the answer is the
    category of the object instance closest to the asked one."""
    rng = np.random.RandomState(seed)
    episodes = []
    for scene in scene_ids:
        objs = place_objects(sim, scene)
        sim._scene_id = scene
        sim._occ = sim.scene_occupancy(scene)
        made = 0
        attempts = 0
        while made < episodes_per_scene and \
                attempts < 200 * episodes_per_scene:
            attempts += 1
            k = made
            qi = rng.randint(len(objs))
            others = [o for i, o in enumerate(objs) if i != qi]
            if not others:
                break
            d = [np.linalg.norm(o.position - objs[qi].position)
                 for o in others]
            answer = others[int(np.argmin(d))]
            start = sim.sample_navigable_point(scene, rng)
            # reachability gate (see make_objectnav_dataset)
            if not np.isfinite(
                    sim.geodesic_distance(start, objs[qi].position)):
                continue
            made += 1
            episodes.append(Episode(
                episode_id=f"{scene}:eqa{k}", scene_id=scene,
                start_position=start,
                start_rotation=float(rng.uniform(0, 2 * np.pi)),
                info={"goal": objs[qi].position.tolist(),
                      "question_tokens": _tokenize(
                          ("what", "is", "near", "the", objs[qi].category)),
                      "question": f"what is near the {objs[qi].category}?",
                      "answer": answer.category,
                      "answer_id": int(ANSWERS.index(answer.category))}))
    return Dataset(episodes)


# --------------------------------------------------------------------------
# VLN
# --------------------------------------------------------------------------

@registry.register_sensor()
class InstructionSensor(Sensor):
    """Instruction token ids (vln.py:57-80)."""
    uuid = "instruction"
    observation_space = Box(0, len(VOCAB) - 1, (MAX_QUESTION_LEN,), np.int64)

    def get_observation(self, sim, episode, task):
        return np.asarray(episode.info["instruction_tokens"], np.int64)


@registry.register_task()
class VLNTask(nav.NavigationTask):
    """vln.py:82-92: pointnav with an instruction observation."""

    @classmethod
    def build(cls, sim, sensors=None, measures=None):
        sensors = list(sensors) if sensors is not None else [
            nav.IntegratedPointGoalGPSAndCompassSensor(),
            InstructionSensor()]
        return super().build(sim, sensors=sensors, measures=measures)


def make_vln_dataset(sim: GridSimulator, scene_ids: Sequence[str],
                     episodes_per_scene: int = 4, seed: int = 0) -> Dataset:
    """Instruction episodes: 'where is the X' + the reference path (start
    -> goal waypoints along the geodesic), vln.py VLNEpisode.reference_path."""
    rng = np.random.RandomState(seed)
    episodes = []
    for scene in scene_ids:
        objs = place_objects(sim, scene)
        sim._scene_id = scene
        sim._occ = sim.scene_occupancy(scene)
        made = 0
        attempts = 0
        while made < episodes_per_scene and \
                attempts < 200 * episodes_per_scene:
            attempts += 1
            k = made
            target = objs[rng.randint(len(objs))]
            start = sim.sample_navigable_point(scene, rng)
            # reachability gate (see make_objectnav_dataset)
            if not np.isfinite(
                    sim.geodesic_distance(start, target.position)):
                continue
            made += 1
            mid = (np.asarray(start) + np.asarray(target.position)) / 2.0
            episodes.append(Episode(
                episode_id=f"{scene}:vln{k}", scene_id=scene,
                start_position=start,
                start_rotation=float(rng.uniform(0, 2 * np.pi)),
                info={"goal": target.position.tolist(),
                      "instruction_tokens": _tokenize(
                          ("where", "is", "the", target.category)),
                      "instruction": f"where is the {target.category}",
                      "reference_path": [list(map(float, start)),
                                         [float(mid[0]), float(mid[1])],
                                         target.position.tolist()]}))
    return Dataset(episodes)
