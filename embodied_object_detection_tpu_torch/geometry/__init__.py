"""Pinhole geometry: depth + pose -> map cells (`projector.py`)."""

from .projector import (
    transform3d,
    pose_to_xyzhe,
    intrinsic_matrix,
    pixel_scales,
    depth_to_point_cloud,
    camera_to_world,
    pixel_to_world,
    discretize_point_cloud,
    world_to_map_indices,
)
