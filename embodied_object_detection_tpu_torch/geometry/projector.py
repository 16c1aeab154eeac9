"""Pinhole geometry: egocentric depth + pose -> allocentric map cells.

Counterpart of the JAX package's `geometry/projector.py` (ref:
SMNet/projector/core.py:6-271, projector.py:66-106, point_cloud.py:8-56,
and the inline copy in robot_demo.py:92-321), as functions on tensors on
the caller's device. Coordinates follow the reference (Habitat/MP3D): y
is up, and the top-down map discretises world (x, z).

Precision: everything is f32. The camera-to-world product is written as
four explicit multiply-adds a coordinate, so that it never runs on a
tensor core (TF32 would misplace a 40 m point by more than half a 0.2 m
cell), and every division divides by a tensor on the operands' device
(PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which moves a value an ulp and a pixel on a cell's rounding boundary).
Rounding is half to even, as `jnp.round`; cell ids are cast to int only
after the outlier mask is formed.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def transform3d(xyzhe: torch.Tensor) -> torch.Tensor:
    """[N, 5] [x, y, z, heading, elevation] -> [N, 4, 4] camera-to-world
    matrices (ref: SMNet/projector/core.py:6-34, _transform3D): rotation
    R_y(heading) @ R_x(elevation) with the reference's signs."""
    x, y, z, heading, elevation = xyzhe.float().unbind(-1)
    cx, sx = torch.cos(elevation), torch.sin(elevation)
    cy, sy = torch.cos(heading), torch.sin(heading)
    zeros, ones = torch.zeros_like(cx), torch.ones_like(cx)
    rows = [torch.stack([cy, sx * sy, cx * sy, x], dim=-1),
            torch.stack([zeros, cx, -sx, y], dim=-1),
            torch.stack([-sy, cy * sx, cy * cx, z], dim=-1),
            torch.stack([zeros, zeros, zeros, ones], dim=-1)]
    return torch.stack(rows, dim=-2)


def pose_to_xyzhe(position, rotation) -> np.ndarray:
    """(position [3], rotation) -> the [1, 5] float32 xyzhe row of
    `transform3d`. Rotation dialects:
      * quaternion [x, y, z, w], the reference's habitat convention:
        rotvec -> (elevation, heading, bank), and xyzhe takes elevation +
        pi ("in Habitat y is up", SMNet build_data.py:186-194)
      * euler [elevation, heading, bank], the synthetic renderer's: no
        offset."""
    rotation = np.asarray(rotation, np.float64).reshape(-1)
    if rotation.shape[0] == 4:
        from scipy.spatial.transform import Rotation
        elevation, heading, _bank = Rotation.from_quat(rotation).as_rotvec()
        elevation = elevation + math.pi
    else:
        heading, elevation = float(rotation[1]), float(rotation[0])
    p = np.asarray(position, np.float64).reshape(3)
    return np.asarray([[p[0], p[1], p[2], heading, elevation]], np.float32)


def intrinsic_matrix(width: int, height: int, vfov: float,
                     device: "torch.device | str" = "cuda") -> torch.Tensor:
    """[3, 3] f32 pinhole K from the vertical field of view in radians
    (ref: core.py:68-77; the reference's hfov = width / height * vfov is
    kept)."""
    hfov = width / height * vfov
    f_x = width / (2.0 * math.tan(hfov / 2.0))
    f_y = height / (2.0 * math.tan(vfov / 2.0))
    return torch.tensor([[f_x, 0.0, width / 2.0],
                         [0.0, f_y, height / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32,
                        device=device)


def pixel_scales(width: int, height: int, vfov: float,
                 device: "torch.device | str" = "cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (x_scale, y_scale) = ((u + 0.5 - cx) / fx, (v + 0.5 - cy)
    / fy), each [H, W] f32 (ref: core.py:80-114; through pixel centres)."""
    k = intrinsic_matrix(width, height, vfov, device)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    u = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    x_scale = (u.expand(height, width) + 0.5 - cx) / fx
    y_scale = (v.expand(height, width) + 0.5 - cy) / fy
    return x_scale, y_scale


def depth_to_point_cloud(depth: torch.Tensor, vfov: float,
                         depth_scaling: float = 1.0) -> torch.Tensor:
    """[H, W] (or [B, H, W]) depth -> [..., H, W, 4] homogeneous
    camera-frame xyz1 (ref: core.py:116-149): z = d / scale, x = z *
    x_scale, y = z * y_scale."""
    h, w = depth.shape[-2], depth.shape[-1]
    x_scale, y_scale = pixel_scales(w, h, vfov, depth.device)
    z = depth.float() / torch.tensor(depth_scaling, dtype=torch.float32,
                                     device=depth.device)
    return torch.stack([z * x_scale, z * y_scale, z, torch.ones_like(z)],
                       dim=-1)


def camera_to_world(xyz1: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """[..., 4] points through the [4, 4] camera-to-world transform
    (ref: core.py:151-175, an f32 bmm), as four multiply-adds a
    coordinate in f32, never on a tensor core."""
    T = T.float()
    p = xyz1.float()
    rows = []
    for i in range(4):
        acc = T[i, 0] * p[..., 0]
        for j in range(1, 4):
            acc = acc + T[i, j] * p[..., j]
        rows.append(acc)
    return torch.stack(rows, dim=-1)


def pixel_to_world(depth: torch.Tensor, T: torch.Tensor, vfov: float,
                   world_shift_origin: torch.Tensor,
                   depth_scaling: float = 1.0) -> torch.Tensor:
    """[H, W] depth + pose -> [H, W, 3] world xyz, origin-shifted (ref:
    core.py:177-225, pixel_to_world_mapping)."""
    xyz1 = depth_to_point_cloud(depth, vfov, depth_scaling)
    world = camera_to_world(xyz1, T)[..., :3]
    return world - world_shift_origin


def discretize_point_cloud(point_cloud: torch.Tensor,
                           camera_height: torch.Tensor, gridcellsize: float,
                           map_height: int, map_width: int,
                           z_clip_threshold: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World xyz -> top-down map cells (x, z) [..., 2] int32 and the
    outlier mask [...] bool: outside the map, or above camera_y + z_clip
    (y is up in MP3D) (ref: core.py:227-271)."""
    device = point_cloud.device
    cell = torch.tensor(gridcellsize, dtype=torch.float32, device=device)
    xz = torch.round(point_cloud[..., [0, 2]] / cell)
    outside = ((xz[..., 0] >= map_width) | (xz[..., 1] >= map_height) |
               (xz[..., 0] < 0) | (xz[..., 1] < 0))
    clip = torch.as_tensor(camera_height, dtype=torch.float32,
                           device=device) + z_clip_threshold
    above = point_cloud[..., 1] > clip
    return xz.to(torch.int32), outside | above


def world_to_map_indices(point_cloud: torch.Tensor,
                         camera_height: torch.Tensor, gridcellsize: float,
                         map_height: int, map_width: int,
                         z_clip_threshold: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened per-pixel map indices z * W + x, the `proj_indices` the
    memory read and write take (ref: SMNet/build_memory_data.py:136-144,
    robot_demo.py:527-534); outlier pixels map to cell 0 with mask True.
    -> (int32 ids [...], bool outliers [...])."""
    xz, outliers = discretize_point_cloud(
        point_cloud, camera_height, gridcellsize, map_height, map_width,
        z_clip_threshold)
    x = xz[..., 0].clamp(0, map_width - 1)
    z = xz[..., 1].clamp(0, map_height - 1)
    flat = z * map_width + x
    return torch.where(outliers, torch.zeros_like(flat),
                       flat).to(torch.int32), outliers
