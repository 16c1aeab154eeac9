"""Habitat-sim-backed Simulator for the RL stack (import-guarded glue).

ref: habitat/sims/habitat_simulator/habitat_simulator.py:368 (`HabitatSim`)
— the reference's wrapper over the external C++ renderer. In-env the RL
stack runs on the self-contained GridSimulator (rl/sim.py); this adapter
makes the same task/measure surface run against a real habitat-sim
installation: it exposes the exact interface the nav tasks consume
(`reset(episode)`, `get_agent_state`, `move_forward`/`turn`,
`geodesic_distance`, `is_navigable`, `previous_step_collided`,
`render_rgb`/`render_depth`, `sample_navigable_point`, `seed`, `close`),
converting between the 2-D nav plane (x, z, heading) and habitat's 3-D
position + quaternion agent states.

habitat-api/habitat-sim are not dependencies of the package (external
C++, SURVEY §7.8): the adapter is tested against a fake `habitat` module
(tests/test_rl_habitat_sim.py, tests/test_torch_slice18_env.py); use with
a real simulator is untested.

The port's copy of the JAX package's `rl/habitat_sim.py` (host-side numpy,
no JAX), with the package path changed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np

from .sim import AgentState

__all__ = ["HabitatSim"]


def _yaw_from_quat(q: Sequence[float]) -> float:
    """[x, y, z, w] quaternion (rotation about +Y) -> yaw radians."""
    x, y, z, w = [float(v) for v in q]
    return 2.0 * math.atan2(y, w)


def _quat_from_yaw(h: float) -> List[float]:
    return [0.0, math.sin(h / 2.0), 0.0, math.cos(h / 2.0)]


def nav_heading_from_yaw(yaw: float) -> float:
    """habitat yaw (about +Y, forward = local -Z) -> nav-plane heading.

    The nav tasks (rl/nav.py, rl/sim.py) assume forward = [cos h, sin h]
    in the (x, z) plane. A habitat agent at yaw t moves along
    (-sin t, -cos t) in (x, z), so h = -t - pi/2 makes
    [cos h, sin h] == [-sin t, -cos t]."""
    return -yaw - math.pi / 2.0


def yaw_from_nav_heading(h: float) -> float:
    return -h - math.pi / 2.0


class HabitatSim:
    """`GridSimulator`-interface adapter over habitat-sim.

    The nav plane is (x, z): habitat's y (up) is carried as `agent_height`
    and re-attached on every 3-D call.
    """

    # habitat-sim discrete action ids under the default action space
    _MOVE_FORWARD = 1
    _TURN_LEFT = 2
    _TURN_RIGHT = 3

    def __init__(self, scene: str, height: int = 256, width: int = 256,
                 forward_step: float = 0.25, turn_angle: int = 10,
                 agent_height: float = 0.88):
        try:
            from habitat import get_config
            from habitat.sims import make_sim
        except ImportError as e:      # pragma: no cover - exercised via fake
            raise ImportError(
                "HabitatSim needs habitat-api + habitat-sim (external C++ "
                "renderer). Use rl.sim.GridSimulator without it."
            ) from e
        config = get_config()
        config.defrost()
        config.SIMULATOR.SCENE = scene
        config.SIMULATOR.AGENT_0.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
        config.SIMULATOR.FORWARD_STEP_SIZE = forward_step
        config.SIMULATOR.TURN_ANGLE = turn_angle
        for sensor in ("RGB_SENSOR", "DEPTH_SENSOR"):
            getattr(config.SIMULATOR, sensor).HEIGHT = height
            getattr(config.SIMULATOR, sensor).WIDTH = width
        config.freeze()
        self._sim = make_sim(id_sim=config.SIMULATOR.TYPE,
                             config=config.SIMULATOR)
        self.agent_height = agent_height
        self._scene_id = scene
        self._obs = self._sim.reset()
        self.previous_step_collided = False

    # ---------------------------------------------------- state conversion
    def _to3d(self, pos2: np.ndarray) -> List[float]:
        return [float(pos2[0]), self.agent_height, float(pos2[1])]

    def _to2d(self, pos3: Sequence[float]) -> np.ndarray:
        return np.asarray([pos3[0], pos3[2]], np.float32)

    # ------------------------------------------------------- sim interface
    def reset(self, episode) -> None:
        self._sim.reset()
        pos = np.asarray(episode.start_position, np.float32)
        if pos.shape[0] == 2:
            pos3 = self._to3d(pos)
        else:
            pos3 = [float(v) for v in pos]
            self.agent_height = pos3[1]
        self._sim.set_agent_state(
            pos3, _quat_from_yaw(
                yaw_from_nav_heading(float(episode.start_rotation))))
        self._scene_id = episode.scene_id
        self.previous_step_collided = False

    def get_agent_state(self) -> AgentState:
        s = self._sim.get_agent_state()
        rot = s.rotation
        if hasattr(rot, "components"):       # np.quaternion: w, x, y, z
            w, x, y, z = rot.components
            rot = [x, y, z, w]
        return AgentState(position=self._to2d(s.position),
                          rotation=nav_heading_from_yaw(_yaw_from_quat(rot)))

    def move_forward(self) -> None:
        self._obs = self._sim.step(self._MOVE_FORWARD)
        self.previous_step_collided = bool(
            getattr(self._sim, "previous_step_collided", False))

    def turn(self, sign: int) -> None:
        # GridSimulator's turn(+1) INCREASES the nav heading h; under
        # h = -yaw - pi/2 that means DECREASING habitat yaw, which is
        # habitat's TURN_RIGHT (TURN_LEFT increases yaw about +Y)
        self._obs = self._sim.step(
            self._TURN_RIGHT if sign > 0 else self._TURN_LEFT)
        self.previous_step_collided = False

    def geodesic_distance(self, position: np.ndarray,
                          goals: Union[np.ndarray, Sequence[np.ndarray]]
                          ) -> float:
        pos3 = self._to3d(np.asarray(position, np.float32))
        gl = np.asarray(goals, np.float32)
        if gl.ndim == 1:
            gl = gl[None]
        goals3 = [self._to3d(g) for g in gl]
        d = self._sim.geodesic_distance(pos3, goals3)
        return float(d)

    def is_navigable(self, pos: np.ndarray) -> bool:
        return bool(self._sim.is_navigable(
            self._to3d(np.asarray(pos, np.float32))))

    def sample_navigable_point(self, scene_id: Optional[str] = None,
                               rng: Optional[np.random.RandomState] = None
                               ) -> np.ndarray:
        return self._to2d(self._sim.sample_navigable_point())

    # ---------------------------------------------------------- rendering
    def render_rgb(self) -> np.ndarray:
        buf = np.asarray(self._obs["rgb"])
        return buf[..., :3].astype(np.uint8)

    def render_depth(self) -> np.ndarray:
        # [H, W, 1] — the GridSimulator/StreamSim contract that
        # nav.DepthSensor's observation_space (*image_hw, 1) and the
        # RolloutStorage buffers allocated from it both rely on.
        buf = np.asarray(self._obs["depth"], np.float32)
        return buf.reshape(buf.shape[0], buf.shape[1], 1)

    # ------------------------------------------------------------- misc
    def seed(self, seed: int) -> None:
        if hasattr(self._sim, "seed"):
            self._sim.seed(seed)

    def close(self) -> None:
        if hasattr(self._sim, "close"):
            self._sim.close()
