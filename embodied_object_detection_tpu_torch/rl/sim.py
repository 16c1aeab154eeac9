"""Navigation simulator (habitat-sim stand-in).

The reference binds the external C++ habitat-sim renderer through
`HabitatSim` (habitat/sims/habitat_simulator/habitat_simulator.py:368).
habitat-sim itself is out of scope here (SURVEY §2.3: host-side external
C++); this module provides the same *interface* backed by a
self-contained 2-D occupancy-grid world with a column raycaster, so the
whole RL stack (tasks, measures, PPO/DD-PPO) runs end-to-end without it.

Agent state is continuous (x, z position in metres + heading); the
occupancy grid only mediates collisions, geodesic distance and
rendering — matching the shape of habitat-sim's navmesh role.

The port's copy of the JAX package's `rl/sim.py` (host-side numpy,
no JAX), with the package path changed.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from embodied_object_detection_tpu_torch.rl.core import (
    Box, Dataset, Episode, registry)

__all__ = ["AgentState", "GridSimulator", "make_pointnav_dataset"]


@dataclass
class AgentState:
    """Position [x, z] metres + heading radians (habitat AgentState analog;
    reference uses 3-D position + quaternion, the nav plane is 2-D)."""
    position: np.ndarray
    rotation: float


def _scene_seed(scene_id: str, salt: int = 0) -> int:
    """Process-stable scene seed (hash() is randomized per interpreter)."""
    import zlib
    return (zlib.crc32(scene_id.encode()) + salt) % (2 ** 31)


def _build_scene(scene_id: str, size_m: float, cell_m: float) -> np.ndarray:
    """Deterministic occupancy grid for a scene id: border walls + a few
    rectangular obstacles (True = occupied)."""
    n = int(round(size_m / cell_m))
    rng = np.random.RandomState(_scene_seed(scene_id))
    occ = np.zeros((n, n), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    for _ in range(rng.randint(2, 6)):
        h = rng.randint(n // 10, n // 4)
        w = rng.randint(n // 10, n // 4)
        r = rng.randint(1, n - h - 1)
        c = rng.randint(1, n - w - 1)
        occ[r:r + h, c:c + w] = True
    # Keep the centre free so sampled starts have somewhere to live.
    c0, c1 = n // 2 - n // 8, n // 2 + n // 8
    occ[c0:c1, c0:c1] = False
    return occ


class GridSimulator:
    """Occupancy-grid navigation simulator.

    Interface parity with the reference's `HabitatSim` wrapper surface the
    nav task consumes: `reset`, `step_agent`, `get_agent_state`,
    `geodesic_distance`, `previous_step_collided`, `render_rgb`/`render_depth`,
    `seed`, `close`.
    """

    FORWARD_STEP_M = 0.25      # habitat default FORWARD_STEP_SIZE
    TURN_ANGLE_RAD = np.deg2rad(10.0)  # habitat default TURN_ANGLE
    AGENT_RADIUS_M = 0.1

    def __init__(self, size_m: float = 12.8, cell_m: float = 0.1,
                 image_hw: Tuple[int, int] = (64, 64),
                 hfov_deg: float = 90.0, max_depth_m: float = 10.0,
                 render_rgb: bool = True):
        self.size_m = size_m
        self.cell_m = cell_m
        self.image_hw = image_hw
        self.hfov = np.deg2rad(hfov_deg)
        self.max_depth = max_depth_m
        self.render_rgb_enabled = render_rgb
        self._scenes: Dict[str, np.ndarray] = {}
        self._dist_cache: Dict[Tuple[str, Tuple[int, int]], np.ndarray] = {}
        self._occ: Optional[np.ndarray] = None
        self._scene_id: Optional[str] = None
        self.agent = AgentState(np.zeros(2, np.float32), 0.0)
        self.previous_step_collided = False
        self._rng = np.random.RandomState(0)

    # -- scene/geometry ----------------------------------------------------
    def scene_occupancy(self, scene_id: str) -> np.ndarray:
        if scene_id not in self._scenes:
            self._scenes[scene_id] = _build_scene(
                scene_id, self.size_m, self.cell_m)
        return self._scenes[scene_id]

    def _to_cell(self, pos: np.ndarray) -> Tuple[int, int]:
        n = self._occ.shape[0]
        r = int(np.clip(pos[1] / self.cell_m, 0, n - 1))
        c = int(np.clip(pos[0] / self.cell_m, 0, n - 1))
        return r, c

    def is_navigable(self, pos: np.ndarray) -> bool:
        occ = self._occ
        if occ is None:
            raise RuntimeError("reset() before querying navigability")
        if not (0 <= pos[0] < self.size_m and 0 <= pos[1] < self.size_m):
            return False
        return not occ[self._to_cell(pos)]

    def _distance_field(self, scene_id: str, goal: np.ndarray) -> np.ndarray:
        """Dijkstra geodesic distance (metres) from every free cell to the
        goal cell, 8-connected. Cached per (scene, goal-cell)."""
        occ = self.scene_occupancy(scene_id)
        gcell = (int(goal[1] / self.cell_m), int(goal[0] / self.cell_m))
        key = (scene_id, gcell)
        if key in self._dist_cache:
            return self._dist_cache[key]
        n = occ.shape[0]
        dist = np.full((n, n), np.inf, np.float64)
        if not occ[gcell]:
            dist[gcell] = 0.0
            pq = [(0.0, gcell)]
            diag = np.sqrt(2.0)
            while pq:
                d, (r, c) = heapq.heappop(pq)
                if d > dist[r, c]:
                    continue
                for dr in (-1, 0, 1):
                    for dc in (-1, 0, 1):
                        if dr == 0 and dc == 0:
                            continue
                        rr, cc = r + dr, c + dc
                        if 0 <= rr < n and 0 <= cc < n and not occ[rr, cc]:
                            nd = d + (diag if dr and dc else 1.0)
                            if nd < dist[rr, cc]:
                                dist[rr, cc] = nd
                                heapq.heappush(pq, (nd, (rr, cc)))
        dist = dist * self.cell_m
        self._dist_cache[key] = dist
        return dist

    def geodesic_distance(self, position: np.ndarray,
                          goal: np.ndarray) -> float:
        """Shortest-path distance through free space (habitat-sim
        `geodesic_distance` analog)."""
        field = self._distance_field(self._scene_id, np.asarray(goal))
        r, c = self._to_cell(np.asarray(position, np.float64))
        return float(field[r, c])

    # -- lifecycle ---------------------------------------------------------
    def reset(self, episode: Episode) -> None:
        self._scene_id = episode.scene_id
        self._occ = self.scene_occupancy(episode.scene_id)
        self.agent = AgentState(
            np.asarray(episode.start_position, np.float32).copy(),
            float(episode.start_rotation))
        self.previous_step_collided = False

    def get_agent_state(self) -> AgentState:
        return self.agent

    def seed(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)

    def close(self) -> None:
        pass

    # -- agent motion ------------------------------------------------------
    def move_forward(self) -> None:
        """Step FORWARD_STEP_M along heading; slide is not modelled — a
        blocked move leaves the agent in place and flags a collision, like
        habitat-sim with sliding disabled."""
        heading = self.agent.rotation
        delta = np.array([np.cos(heading), np.sin(heading)], np.float32)
        target = self.agent.position + self.FORWARD_STEP_M * delta
        probe = target + self.AGENT_RADIUS_M * delta
        if self.is_navigable(target) and self.is_navigable(probe):
            self.agent.position = target
            self.previous_step_collided = False
        else:
            self.previous_step_collided = True

    def turn(self, sign: int) -> None:
        self.agent.rotation = float(
            (self.agent.rotation + sign * self.TURN_ANGLE_RAD)
            % (2 * np.pi))
        self.previous_step_collided = False

    # -- rendering ---------------------------------------------------------
    def _raycast(self) -> np.ndarray:
        """Per-column PLANAR depth (forward z to the nearest occupied cell,
        DDA raycast over the grid) -> [W] metres.

        Pinhole convention: tan-linear columns with fx = (W/2)/tan(hfov/2)
        and cx = int(W/2)-1, matching habitat-sim's depth camera and the
        SLAM mapper's back-projection (slam.py DirectDepthMapper /
        mappers.py:18-36 — x = z*(u-cx)/fx assumes z is the forward
        component at tan-linear pixels). Returning the raw Euclidean march
        distance at angle-linear columns would misregister obstacles ~41%
        too far at the image edge under the 90-degree hfov; planar depth is
        also the classic fisheye correction for the column render."""
        h, w = self.image_hw
        fx = (w / 2.0) / np.tan(self.hfov / 2.0)
        cx = int(w / 2) - 1
        # relative angle per column: +~hfov/2 (left) at u=0, negative right
        rel = np.arctan2(cx - np.arange(w, dtype=np.float64), fx)
        angles = self.agent.rotation + rel
        occ = self._occ
        n = occ.shape[0]
        step = self.cell_m * 0.5
        nsteps = int(self.max_depth / step)
        # Vectorized march: all rays advance together.
        dx = np.cos(angles)
        dz = np.sin(angles)
        ts = (np.arange(1, nsteps + 1) * step)[:, None]        # [S, 1]
        xs = self.agent.position[0] + ts * dx[None, :]         # [S, W]
        zs = self.agent.position[1] + ts * dz[None, :]
        cs = np.clip((xs / self.cell_m).astype(np.int32), 0, n - 1)
        rs = np.clip((zs / self.cell_m).astype(np.int32), 0, n - 1)
        hit = occ[rs, cs]                                      # [S, W]
        first = np.argmax(hit, axis=0)                         # 0 if none hit
        any_hit = hit.any(axis=0)
        depth = np.where(any_hit, (first + 1) * step * np.cos(rel),
                         self.max_depth)
        return depth.astype(np.float32)

    def render_depth(self) -> np.ndarray:
        """[H, W, 1] float metres — column depth replicated over rows with a
        vertical wall profile (cheap doom-style projection)."""
        h, w = self.image_hw
        col = self._raycast()
        return np.broadcast_to(col[None, :, None], (h, w, 1)).astype(
            np.float32).copy()

    def render_rgb(self) -> np.ndarray:
        """[H, W, 3] uint8 column-raycast render: walls shaded by distance,
        floor/ceiling bands sized by wall height."""
        h, w = self.image_hw
        depth = self._raycast()                            # [W]
        wall_h = np.clip((h * 0.8) / np.maximum(depth, 0.3), 2, h)
        top = ((h - wall_h) / 2).astype(np.int32)          # [W]
        bot = (top + wall_h).astype(np.int32)
        shade = np.clip(255.0 / (1.0 + depth), 20, 255).astype(np.uint8)
        img = np.zeros((h, w, 3), np.uint8)
        img[:, :, 2] = 60   # floor/ceiling base tint
        rows = np.arange(h)[:, None]
        wall_mask = (rows >= top[None, :]) & (rows < bot[None, :])
        for ch, scale in ((0, 1.0), (1, 0.8), (2, 0.6)):
            chan = img[:, :, ch]
            chan[wall_mask] = np.broadcast_to(
                (shade * scale).astype(np.uint8)[None, :], (h, w))[wall_mask]
        return img

    # -- sampling helpers --------------------------------------------------
    def sample_navigable_point(self, scene_id: str,
                               rng: np.random.RandomState) -> np.ndarray:
        occ = self.scene_occupancy(scene_id)
        n = occ.shape[0]
        free = np.argwhere(~occ)
        r, c = free[rng.randint(len(free))]
        return np.array([(c + 0.5) * self.cell_m, (r + 0.5) * self.cell_m],
                        np.float32)


def make_pointnav_dataset(sim: GridSimulator, scene_ids: List[str],
                          episodes_per_scene: int = 8, seed: int = 0,
                          min_dist_m: float = 1.0,
                          max_dist_m: float = 30.0) -> Dataset:
    """Sample reachable (start, goal) pairs per scene — the pointnav episode
    generator analog (habitat datasets ship pre-sampled episodes; we sample
    on the fly against the synthetic scenes)."""
    rng = np.random.RandomState(seed)
    episodes: List[Episode] = []
    for scene in scene_ids:
        occ = sim.scene_occupancy(scene)
        made = 0
        attempts = 0
        while made < episodes_per_scene and attempts < 200 * episodes_per_scene:
            attempts += 1
            start = sim.sample_navigable_point(scene, rng)
            goal = sim.sample_navigable_point(scene, rng)
            # Reachability + distance gate via the sim's own metric.
            sim._scene_id = scene
            sim._occ = occ
            d = sim.geodesic_distance(start, goal)
            if not (min_dist_m <= d <= max_dist_m) or not np.isfinite(d):
                continue
            episodes.append(Episode(
                episode_id=f"{scene}:{made}", scene_id=scene,
                start_position=start,
                start_rotation=float(rng.uniform(0, 2 * np.pi)),
                info={"goal": goal.tolist(), "geodesic_distance": d}))
            made += 1
    if not episodes:
        raise RuntimeError("failed to sample any pointnav episodes")
    return Dataset(episodes)


registry.register_simulator("GridSimulator")(GridSimulator)
