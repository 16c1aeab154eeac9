"""Streaming RGB-D + pose robot demo with a live memory map.

Counterpart of the JAX package's `demo/robot_demo.py` (ref:
Detic/robot_demo.py):
  * a directory of timestamped RGB frames, depth maps and a pose log
  * nearest-timestamp depth and pose matching (robot_demo.py:491-496)
  * pinhole intrinsics from a 58 degree vertical field of view (:124-126)
  * a 40 m x 40 m top-down map of 0.2 m cells, 200 x 200 (:470-476)
  * per frame: depth + pose -> world xyz -> flattened cell ids (:527-534),
    computed on the device by `geometry/projector.py`
  * the detector frame with its persistent memory, and the drawn frame
    and map (:556-601)

Headless: writes the drawn frames and the live semantic map to an output
directory (cv2 windows with --show). Runs on the card unless `--device
cpu` is given.

  python -m embodied_object_detection_tpu_torch.demo.robot_demo \
      --data-dir <dir> --output out_demo [--zs-weight mp3d_clip.npy]
  <dir>/rgb/<t>.jpg|png, <dir>/depth/<t>.npy|png (mm), <dir>/poses.txt
  with lines: <t> x y z heading elevation
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Tuple

import numpy as np
import torch

DEFAULT_VFOV_DEG = 58.0
MAP_SIZE_M = 40.0                 # ref: robot_demo.py:470-476
GRID_CELL_M = 0.2
MAP_CELLS = int(MAP_SIZE_M / GRID_CELL_M)   # 200
Z_CLIP_M = 0.5
DEPTH_SCALING = 1000.0            # depth in mm (ref: depth / 1000)


def _list_timestamped(directory: str) -> List[Tuple[float, str]]:
    out = []
    for f in sorted(os.listdir(directory)):
        try:
            out.append((float(os.path.splitext(f)[0]),
                        os.path.join(directory, f)))
        except ValueError:
            continue
    return out


def _nearest(items: List[Tuple[float, str]], t: float):
    """ref: robot_demo.py:491-496, nearest-timestamp matching."""
    return min(items, key=lambda x: abs(x[0] - t))[1]


def _load_depth(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import cv2
    return cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)


def _load_poses(path: str) -> List[Tuple[float, np.ndarray]]:
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(x) for x in line.split()]
            if len(vals) >= 6:
                poses.append((vals[0], np.asarray(vals[1:6], np.float32)))
    return poses


def compute_proj_indices(depth_mm, xyzhe, vfov_rad: float,
                         map_cells: int = MAP_CELLS,
                         device: "torch.device | str" = "cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth in mm [H, W] + the pose's xyzhe [5] -> (cell ids [H, W]
    int32, outlier mask [H, W] bool) on `device` (ref:
    robot_demo.py:491-534). The map is centred on the trajectory's
    origin; pixels with no depth (<= 0 mm) are outliers."""
    from ..geometry import (pixel_to_world, transform3d,
                            world_to_map_indices)
    from ..models.detector import resolve_device
    device = resolve_device(device)
    depth = torch.as_tensor(np.asarray(depth_mm, np.float32)).to(device) \
        if not isinstance(depth_mm, torch.Tensor) \
        else depth_mm.to(device, torch.float32)
    pose = torch.as_tensor(np.asarray(xyzhe, np.float32)).to(device) \
        if not isinstance(xyzhe, torch.Tensor) \
        else xyzhe.to(device, torch.float32)
    T = transform3d(pose[None])[0]
    # derived from map_cells: a fixed MAP_SIZE_M / 2 would put a smaller
    # map wholly outside the grid
    half = map_cells * GRID_CELL_M / 2.0
    shift = torch.tensor([-half, 0.0, -half], dtype=torch.float32,
                         device=device)
    world = pixel_to_world(depth, T, vfov_rad, shift,
                           depth_scaling=DEPTH_SCALING)
    proj, outliers = world_to_map_indices(world, pose[1], GRID_CELL_M,
                                          map_cells, map_cells, Z_CLIP_M)
    return proj, outliers | (depth <= 0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--output", default="out_demo")
    parser.add_argument("--zs-weight", default="",
                        help=".npy CLIP class embeddings (e.g. mp3d_clip.npy)")
    parser.add_argument("--checkpoint", default="",
                        help="a checkpoint of the port or a detectron2 .pth "
                             "(optional)")
    parser.add_argument("--stride", type=int, default=2,
                        help="frame stride (ref: robot_demo.py:489)")
    parser.add_argument("--map-cells", type=int, default=MAP_CELLS,
                        help="top-down map side length in cells")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; raises without a card) "
                             "or 'cpu'")
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--opts", nargs="*", default=[],
                        help="config overrides: section.field=value")
    args = parser.parse_args(argv)

    import dataclasses
    import time
    from ..config import DetectorConfig, apply_opts
    from ..models.detector import resolve_device
    from .demo import load_model
    from .predictor import EmbodiedPredictor, load_zs_weight_npy

    device = resolve_device(args.device)
    import cv2
    map_cells = args.map_cells
    cfg = DetectorConfig()
    # demo knobs (ref: robot_demo.py:344-359 setup_cfg)
    cfg = cfg.replace(
        roi=dataclasses.replace(cfg.roi, one_class_per_proposal=True),
        memory=dataclasses.replace(cfg.memory,
                                   max_cells=map_cells * map_cells))
    cfg = apply_opts(cfg, args.opts)

    zs = load_zs_weight_npy(args.zs_weight) if args.zs_weight else None
    model = load_model(cfg, args.checkpoint, device)
    predictor = EmbodiedPredictor(cfg, model=model, zs_weight=zs,
                                  device=device)

    rgbs = _list_timestamped(os.path.join(args.data_dir, "rgb"))
    depths = _list_timestamped(os.path.join(args.data_dir, "depth"))
    poses = _load_poses(os.path.join(args.data_dir, "poses.txt"))
    os.makedirs(args.output, exist_ok=True)
    vfov = math.radians(DEFAULT_VFOV_DEG)
    h, w = cfg.input.height, cfg.input.width
    for n, (t, rgb_path) in enumerate(rgbs[::args.stride]):
        t0 = time.perf_counter()
        image = cv2.cvtColor(cv2.imread(rgb_path), cv2.COLOR_BGR2RGB)
        depth = _load_depth(_nearest(depths, t))
        pose = _nearest(poses, t)
        if depth.shape != (h, w):
            depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST)

        proj, outliers = compute_proj_indices(depth, pose, vfov, map_cells,
                                              device)
        dets = predictor(image, proj, outliers)

        overlay = predictor.render_detections(
            np.asarray(predictor._prep_image(image), np.uint8), dets)
        semmap = predictor.render_map(map_cells, map_cells, scale=2)
        cv2.imwrite(os.path.join(args.output, f"frame_{n:05d}.jpg"),
                    cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(args.output, f"map_{n:05d}.png"),
                    cv2.cvtColor(semmap, cv2.COLOR_RGB2BGR))
        print(f"frame {n} ({time.perf_counter() - t0:.3f}s) "
              f"dets={int(np.asarray(dets.valid).sum())}")
        if args.show:  # pragma: no cover
            cv2.imshow("detections", cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            cv2.imshow("map", cv2.cvtColor(semmap, cv2.COLOR_RGB2BGR))
            cv2.waitKey(1)


if __name__ == "__main__":
    main()
