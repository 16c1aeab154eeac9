"""SLAM-based navigation: depth mapper + planner + agent (PyTorch).

Counterpart of the JAX package's `rl/slam.py` (ref: habitat_baselines
slambased/mappers.py:18-140, path_planners.py:66-300 and
agents/slam_agents.py:171-560):

- `depth2local3d` / `pcl_to_obstacles` / `DirectDepthMapper`: depth ->
  camera-frame point cloud -> height-filtered obstacle histogram. The
  per-cell point count is `ops/segment_sum.segment_sum` over the
  flattened cell ids, the custom op `eodt::segment_sum`: on the card the
  hand-written kernel 1 (`csrc/segment_sum.cu`), on the CPU its plain
  version; ids out of range are dropped, as the JAX package's spare
  segment drops them. The counts are sums of 1.0 in f32, exact below
  2^24, so the kernel's atomics give the plain version's counts bit for
  bit in any order.
- `plan_distance_field`: the 8-neighbour cost relaxation to a fixed point
  (the JAX package's `lax.while_loop`) on the device: the neighbours are
  slices of the field padded with 1e7, the JAX package's stand-in for
  infinity at the edges; each iteration stops changing the field once an
  iteration moved no cell by more than 1e-6, as the JAX loop's condition
  stops it, and the host reads that flag only every CHECK_EVERY
  iterations, never past `max_steps` in all.
- `DepthMapperAndPlannerAgent`: map update -> replan -> waypoint-follow
  act loop, with the pose from the simulator's agent state. The map and
  the plan stay on the device; one copy of the cost field comes to the
  host a step for the path's greedy descent.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.detector import resolve_device
from ..ops.segment_sum import segment_sum
from .agents import Agent, FORWARD, LEFT, RIGHT, STOP
from .policy import full_f32

__all__ = ["depth2local3d", "pcl_to_obstacles", "DirectDepthMapper",
           "plan_distance_field", "trace_path", "DepthMapperAndPlannerAgent"]


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """`x` as a 0-d f32 tensor on `like`'s device: dividing by a tensor
    divides on the card too (a Python scalar divisor there becomes a
    product with its reciprocal)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def depth2local3d(depth: torch.Tensor, fx: float, fy: float, cx: float,
                  cy: float) -> torch.Tensor:
    """Depth [H, W] -> camera-frame point cloud [H*W, 3] (x right, y down,
    z forward). mappers.py:18-36."""
    h, w = depth.shape
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)
    yv, xv = torch.meshgrid(ys, xs, indexing="ij")      # [H, W]
    d = depth
    return torch.stack([(d * (xv - cx) / _scalar(fx, d)).reshape(-1),
                        (d * (yv - cy) / _scalar(fy, d)).reshape(-1),
                        d.reshape(-1)], dim=1)


def pcl_to_obstacles(pts2d: torch.Tensor, weights: torch.Tensor,
                     map_size_m: float, cell_m: float,
                     map_size_cells: int) -> torch.Tensor:
    """Weighted point count per map cell (mappers.py:38-61).

    pts2d: [N, 2] (z, x) world-plane coords in metres, the map centred at
    0; weights: [N] 0/1 validity. Returns [S, S] f32 counts."""
    del map_size_m                  # the JAX signature's; unused there too
    s = map_size_cells
    ij = torch.round(pts2d / _scalar(cell_m, pts2d) + s / 2.0).to(torch.int32)
    valid = (weights > 0) & ((ij >= 0) & (ij < s)).all(dim=1)
    flat = torch.where(valid, ij[:, 0] * s + ij[:, 1],
                       torch.full_like(ij[:, 0], s * s))
    counts = segment_sum(valid[:, None].float(), flat.contiguous(), s * s)
    return counts.reshape(s, s)


class DirectDepthMapper:
    """Depth -> pose-registered obstacle map (mappers.py:64-140). fx/fy
    follow the reference's FOV=90 convention (fx = W/2). The camera-to-
    world product is f32 (TF32 off)."""

    def __init__(self, camera_height: float = 0.0, near_th: float = 0.1,
                 far_th: float = 4.0, h_min: float = 0.0,
                 h_max: float = 1.0, map_size_m: float = 40.0,
                 cell_m: float = 0.1):
        self.near_th = near_th
        self.far_th = far_th
        self.h_min = h_min
        self.h_max = h_max
        self.camera_height = camera_height
        self.map_size_m = map_size_m
        self.cell_m = cell_m
        self.map_cells = int(np.ceil(map_size_m / cell_m)) - 1

    @full_f32()
    def __call__(self, depth: torch.Tensor,
                 pose4x4: torch.Tensor) -> torch.Tensor:
        """depth [H, W] metres; pose4x4 camera-to-world. -> [S, S]."""
        h, w = depth.shape
        fx, fy = w / 2.0, h / 2.0
        cx, cy = int(fx) - 1, int(fy) - 1
        pcl = depth2local3d(depth, fx, fy, cx, cy)          # [N, 3]
        rng_ok = (pcl[:, 2].abs() >= self.near_th) & \
                 (pcl[:, 2].abs() < self.far_th)
        ones = torch.ones((pcl.shape[0], 1), dtype=pcl.dtype,
                          device=pcl.device)
        world = (torch.cat([pcl, ones], 1) @ pose4x4.T)[:, :3]
        height = -world[:, 1] + self.camera_height
        h_ok = (height > self.h_min) & (height < self.h_max)
        pts2d = torch.stack([world[:, 2], world[:, 0]], dim=1)  # (z, x)
        return pcl_to_obstacles(pts2d, (rng_ok & h_ok).float(),
                                self.map_size_m, self.cell_m, self.map_cells)


# --------------------------------------------------------------------------
# Planner
# --------------------------------------------------------------------------

_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
           (1, 1)]
_STEP_COSTS = np.asarray([np.sqrt(2.0), 1.0, np.sqrt(2.0), 1.0, 1.0,
                          np.sqrt(2.0), 1.0, np.sqrt(2.0)], np.float32)
_INF = 1e7
CHECK_EVERY = 16       # relaxations between two reads of the stop flag


def plan_distance_field(obstacles: torch.Tensor, goal_map: torch.Tensor,
                        ob_cost: float = 10000.0, max_steps: int = 500,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """Shortest-path cost-to-goal field over an obstacle grid [H, W].

    Entering a cell costs 1 (or sqrt(2) diagonally) plus
    ob_cost * obstacles[cell]; goal cells cost 0. Iterates the relaxation
    until an iteration moves no cell by more than 1e-6 (that iteration's
    field is the result) or `max_steps` iterations ran. `stats`, when
    given, receives "iterations" (as the JAX loop counts them) and
    "host_checks"."""
    h, w = obstacles.shape
    dev = obstacles.device
    cell_cost = 1.0 + ob_cost * obstacles
    costs = torch.stack([cell_cost * float(c) for c in _STEP_COSTS])
    g0 = torch.where(goal_map > 0, torch.zeros_like(goal_map),
                     torch.full_like(goal_map, _INF))
    g = g0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    ran = checks = 0
    while ran < max_steps:
        for _ in range(min(CHECK_EVERY, max_steps - ran)):
            padded = torch.nn.functional.pad(g, (1, 1, 1, 1), value=_INF)
            # the neighbour at (r - dy, c - dx), as jnp.roll(g, (dy, dx))
            shifted = torch.stack([
                padded[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
                for dy, dx in _SHIFTS])
            new = torch.minimum(torch.minimum(g, (shifted + costs).amin(0)),
                                g0)
            iterations += (~done).int()
            moved = (new - g).abs().amax() > 1e-6
            g = torch.where(done, g, new)
            done = done | ~moved
            ran += 1
        checks += 1
        if bool(done):
            break
    if stats is not None:
        stats["iterations"] = int(iterations)
        stats["host_checks"] = checks
    return g


def trace_path(g: np.ndarray, start_rc: Tuple[int, int],
               max_len: int = 1000) -> np.ndarray:
    """Greedy descent on the cost field -> [K, 2] (row, col) path
    (path_planners.py backtracking phase, on the host: the path is tiny)."""
    g = np.asarray(g)
    h, w = g.shape
    r, c = start_rc
    path = [(r, c)]
    for _ in range(max_len):
        best, best_rc = g[r, c], None
        for dy, dx in _SHIFTS:
            rr, cc = r + dy, c + dx
            if 0 <= rr < h and 0 <= cc < w and g[rr, cc] < best:
                best, best_rc = g[rr, cc], (rr, cc)
        if best_rc is None:
            break
        r, c = best_rc
        path.append((r, c))
        if g[r, c] <= 0:
            break
    return np.asarray(path)


# --------------------------------------------------------------------------
# Agent
# --------------------------------------------------------------------------

class DepthMapperAndPlannerAgent(Agent):
    """Map-and-plan nav agent (slam_agents.py ORBSLAM2Agent act loop with
    simulator pose; angle/waypoint following per :320-424). Runs on
    `device`, the card unless the caller asks for the CPU."""

    def __init__(self, sim, success_distance: float = 0.2,
                 goal_sensor_uuid: str = "pointgoal_with_gps_compass",
                 map_size_m: Optional[float] = None,
                 cell_m: float = 0.1, obstacle_th: float = 10.0,
                 waypoint_lookahead: int = 5,
                 angle_th: float = float(np.deg2rad(15)),
                 monodepth=None, device: "torch.device | str" = "cuda"):
        self.device = resolve_device(device)
        self._sim = sim
        self.success_distance = success_distance
        self.goal_uuid = goal_sensor_uuid
        self.map_size_m = map_size_m or sim.size_m
        self.cell_m = cell_m
        self.obstacle_th = obstacle_th
        self.lookahead = waypoint_lookahead
        self.angle_th = angle_th
        self.mapper = DirectDepthMapper(map_size_m=self.map_size_m,
                                        cell_m=cell_m)
        # RGB-only fallback (ref: ORBSLAM2MonodepthAgent,
        # slam_agents.py:565-645 — monodepth stands in for the depth
        # sensor): an rl.monodepth.MonoDepthEstimator (or any object with
        # compute_depth(rgb_uint8) -> [H, W] metres)
        self.monodepth = monodepth
        self.plan_stats: dict = {}
        self.reset()

    def reset(self):
        s = self.mapper.map_cells
        self._obstacle_counts = torch.zeros((s, s), device=self.device)
        self._steps = 0

    def _pose4x4(self) -> np.ndarray:
        """Camera-to-world from the 2-D agent state (x-east, z-north plane;
        y is the height axis, unused by the planar sim)."""
        st = self._sim.get_agent_state()
        cth, sth = np.cos(st.rotation), np.sin(st.rotation)
        p = np.eye(4, dtype=np.float32)
        p[0, 0], p[0, 2] = sth, cth    # world x from cam x/z
        p[2, 0], p[2, 2] = -cth, sth   # world z
        p[0, 3] = st.position[0] - self.map_size_m / 2.0
        p[2, 3] = st.position[1] - self.map_size_m / 2.0
        return p

    def _to_cell(self, xz: np.ndarray) -> Tuple[int, int]:
        """World coords -> map cell, registered to pcl_to_obstacles'
        rasterisation: round(coord/cell - size/(2*cell) + s/2)."""
        s = self.mapper.map_cells
        off = s / 2.0 - self.map_size_m / (2.0 * self.cell_m)
        r = int(round(xz[1] / self.cell_m + off))
        c = int(round(xz[0] / self.cell_m + off))
        return (int(np.clip(r, 0, s - 1)), int(np.clip(c, 0, s - 1)))

    def update_map(self, observations: Dict[str, np.ndarray]) -> None:
        if "depth" in observations:
            depth = np.asarray(observations["depth"], np.float32)
            if depth.ndim == 3:
                depth = depth[..., 0]
            if depth.max() <= 1.0 + 1e-6:   # normalised sensor -> metres
                depth = depth * self._sim.max_depth
        elif self.monodepth is not None and "rgb" in observations:
            depth = np.asarray(self.monodepth.compute_depth(
                np.asarray(observations["rgb"], np.uint8)), np.float32)
        else:
            return
        counts = self.mapper(torch.from_numpy(depth).to(self.device),
                             torch.from_numpy(self._pose4x4()).to(
                                 self.device))
        self._obstacle_counts += counts

    @torch.no_grad()
    def act(self, observations: Dict[str, np.ndarray]) -> int:
        rho_phi = observations[self.goal_uuid]
        if rho_phi[0] <= self.success_distance:
            return STOP
        self.update_map(observations)
        self._steps += 1

        st = self._sim.get_agent_state()
        ang = st.rotation + float(rho_phi[1])
        goal_xz = st.position + rho_phi[0] * np.array(
            [np.cos(ang), np.sin(ang)], np.float32)
        s = self.mapper.map_cells
        goal_map = torch.zeros((s, s), device=self.device)
        goal_map[self._to_cell(goal_xz)] = 1.0
        obstacles = (self._obstacle_counts > self.obstacle_th).float()
        g = plan_distance_field(obstacles, goal_map, stats=self.plan_stats)
        path = trace_path(g.cpu().numpy(), self._to_cell(st.position))
        if len(path) <= 1:
            return FORWARD  # no plan; probe ahead
        wp = path[min(self.lookahead, len(path) - 1)]
        off = s / 2.0 - self.map_size_m / (2.0 * self.cell_m)
        wp_xz = np.array([(wp[1] - off) * self.cell_m,
                          (wp[0] - off) * self.cell_m])
        to_wp = wp_xz - st.position
        angle = float((np.arctan2(to_wp[1], to_wp[0]) - st.rotation + np.pi)
                      % (2 * np.pi) - np.pi)
        if abs(angle) > self.angle_th:
            return LEFT if angle > 0 else RIGHT
        return FORWARD
