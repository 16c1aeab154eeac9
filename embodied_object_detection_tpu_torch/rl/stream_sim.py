"""Real-robot / external-stream simulator binding (sims/pyrobot analog).

The reference binds a physical robot through `PyRobotSimulator`
(habitat/sims/pyrobot/pyrobot_simulator.py): observations come from the
robot's sensors, actions go to its base controller, and the habitat Env/
task machinery runs unchanged on top. This module provides the same
adapter for this framework: a `StreamSimulator` that consumes
externally-fed (rgb, depth, pose) frames — e.g. from the robot bridge
that feeds demo/robot_demo.py — and exposes the Simulator surface the
nav tasks consume. Actions are forwarded to a user callback (the base
controller hook); pose updates arrive with the next frame.

Euclidean distance stands in for geodesic distance (no map is available
from a raw stream — pyrobot's binding does the same, pyrobot
`base_controller` has no navmesh).

The port's copy of the JAX package's `rl/stream_sim.py` (host-side numpy,
no JAX), with the package path changed.
"""

from __future__ import annotations

import queue
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from embodied_object_detection_tpu_torch.rl.core import Episode, registry
from embodied_object_detection_tpu_torch.rl.sim import AgentState

__all__ = ["StreamSimulator"]


class StreamSimulator:
    """Simulator driven by an external frame stream.

    feed(rgb, depth, position, heading) pushes a frame (from any thread);
    the task-facing surface (get_agent_state / render_* / move_forward /
    turn) reads the latest frame and forwards actions to `action_sink`.
    """

    def __init__(self, image_hw: Tuple[int, int] = (480, 640),
                 max_depth_m: float = 10.0,
                 action_sink: Optional[Callable[[str], None]] = None,
                 frame_timeout_s: float = 10.0):
        self.image_hw = image_hw
        self.max_depth = max_depth_m
        self._sink = action_sink or (lambda name: None)
        self._timeout = frame_timeout_s
        self._frames: "queue.Queue" = queue.Queue()
        self._latest: Optional[Dict[str, np.ndarray]] = None
        self.previous_step_collided = False

    # -- stream side -------------------------------------------------------
    def feed(self, rgb: np.ndarray, depth: np.ndarray,
             position: np.ndarray, heading: float,
             collided: bool = False) -> None:
        self._frames.put({
            "rgb": np.asarray(rgb, np.uint8),
            "depth": np.asarray(depth, np.float32),
            "position": np.asarray(position, np.float32).reshape(2),
            "heading": float(heading),
            "collided": bool(collided),
        })

    def _advance(self) -> None:
        try:
            frame = self._frames.get(timeout=self._timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no frame from the robot stream in {self._timeout}s")
        self._latest = frame
        self.previous_step_collided = frame["collided"]

    # -- simulator surface -------------------------------------------------
    def reset(self, episode: Episode) -> None:
        self._advance()

    def get_agent_state(self) -> AgentState:
        assert self._latest is not None, "reset() before get_agent_state"
        return AgentState(self._latest["position"], self._latest["heading"])

    def geodesic_distance(self, position, goal) -> float:
        a = np.asarray(position, np.float64)
        b = np.asarray(goal, np.float64)
        return float(np.hypot(*(a - b)))

    def is_navigable(self, pos) -> bool:
        return True  # no map; the robot's own safety layer decides

    def render_rgb(self) -> np.ndarray:
        return self._latest["rgb"]

    def render_depth(self) -> np.ndarray:
        d = self._latest["depth"]
        return d[..., None] if d.ndim == 2 else d

    def move_forward(self) -> None:
        self._sink("move_forward")
        self._advance()

    def turn(self, sign: int) -> None:
        self._sink("turn_left" if sign > 0 else "turn_right")
        self._advance()

    def seed(self, seed: int) -> None:
        pass

    def close(self) -> None:
        pass


registry.register_simulator("StreamSimulator")(StreamSimulator)
