"""Sensor-data generation: render agent trajectories into the h5 episode
format the loader reads (the reference's build_data.py).

The port's copy of the JAX package's `data/build_data.py` (ref:
Detic/SMNet/build_data.py:56-292): a renderer (`Renderer`, four render
methods and an agent-state setter) is driven over an agent path; each
frame's rgb, depth, semantic map and GT boxes are kept, the depth is
projected to per-pixel world xyz, and one h5 is written a sample, with
the keys rgb / depth / sensor_positions / sensor_rotations /
positions / orientations / projection_indices (the world xyz) /
masks_outliers / detection_data (stringified dicts) /
segmentation_data, and one JPEG a frame.

The projection runs on `device` (the card unless the caller asks for the
CPU) through the port's `geometry/projector.py`, as a function on arrays
(`world_xyz`), so it runs without h5py; the h5 and JPEG writing is host
work (h5py and PIL, imported where they are used). Renderers:
`data/synthetic.py:SyntheticRenderer` (no simulator) and
`data/habitat_renderer.py:HabitatRenderer` (habitat-sim).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np
import torch


class Renderer(Protocol):
    """The HabitatUtils surface the build script needs
    (ref: SMNet/utils/habitat_utils.py:14-284)."""

    def set_agent_state(self, position: np.ndarray, rotation: np.ndarray
                        ) -> None: ...
    def render_rgb(self) -> np.ndarray: ...            # [H, W, 3] uint8
    def render_depth(self) -> np.ndarray: ...          # [H, W] float meters
    def render_semantic(self) -> np.ndarray: ...       # [H, W] int class+1
    def render_boxes(self) -> List[dict]: ...          # per-instance dicts


def require_h5py():
    """The h5py module; the tools that write or read h5 raise without it
    (there is no other format to fall back on)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the dataset build tools read and write h5 files: "
                          "they need h5py") from e
    return h5py


def detection_record_str(file_name: str,
                         boxes_xyxy: Sequence[Sequence[float]],
                         classes: Sequence[int]) -> str:
    """The stringified-dict GT record the loader parses back
    (ref: build_data.py:230; loader.py:255-267): gt_boxes are stored
    xywh."""
    xywh = [[float(b[0]), float(b[1]),
             float(b[2] - b[0]), float(b[3] - b[1])] for b in boxes_xyxy]
    return str({"file_name": file_name, "image": 0,
                "gt_boxes": xywh, "gt_classes": [int(c) for c in classes]})


def world_xyz(depth: np.ndarray, positions: np.ndarray,
              rotations: np.ndarray, vfov_deg: float = 67.5,
              depth_scale: float = 1.0,
              device: "torch.device | str" = "cuda") -> np.ndarray:
    """[T, H, W, 3] float32 world xyz of each pixel from depth [T, H, W]
    (scaled by `depth_scale`) and the camera poses: positions [T, 3],
    rotations [T, 3] euler or [T, 4] quaternion xyzw (`pose_to_xyzhe`'s
    dialects), computed on `device` frame by frame."""
    from ..geometry.projector import (pixel_to_world, pose_to_xyzhe,
                                      transform3d)
    from ..models.detector import resolve_device
    device = resolve_device(device)
    vfov = math.radians(vfov_deg)
    shift = torch.zeros(3, dtype=torch.float32, device=device)
    scale = np.float32(depth_scale)
    out = []
    for i in range(len(depth)):
        cam2world = transform3d(torch.from_numpy(
            pose_to_xyzhe(positions[i], rotations[i])).to(device))[0]
        d = torch.from_numpy(np.asarray(depth[i], np.float32) * scale)
        out.append(pixel_to_world(d.to(device), cam2world, vfov, shift))
    return torch.stack(out).cpu().numpy()


def _default_jpeg_dir(out_h5: str) -> str:
    """The JPEGImages directory of a sensor h5: beside sensor_data/ when
    the h5 lives there (the EpisodeDataset layout), else beside the h5."""
    d = os.path.dirname(os.path.abspath(out_h5))
    root = os.path.dirname(d) if os.path.basename(d) == "sensor_data" else d
    return os.path.join(root, "JPEGImages")


def build_sample_h5(renderer: Renderer, positions: np.ndarray,
                    rotations: np.ndarray, out_h5: str,
                    vfov_deg: float = 67.5, min_box_edge: int = 15,
                    jpeg_dir: Optional[str] = None,
                    device: "torch.device | str" = "cuda") -> dict:
    """Render one multi-frame sample and write its sensor h5 and the
    per-frame JPEGs its records name.

    positions [T, 3], rotations [T, 3] euler or [T, 4] quaternion xyzw
    (the agent's states along the path). The projection uses the sensor
    pose where the renderer has get_sensor_pos / get_sensor_ori (the
    reference does, SMNet build_data.py:179-190: the sensor sits ~1.25 m
    above the agent), else the agent's. The depth is scaled by
    `renderer.depth_scale` for the projection (habitat's depth is [0, 1]
    over MAX_DEPTH 10, :205-206) while the h5 keeps the raw render. GT
    boxes with an edge under `min_box_edge` px are dropped
    (habitat_utils.py:12, 273). `jpeg_dir` defaults to the dataset's
    JPEGImages/ (`jpeg_dir=""` writes none). Returns summary stats."""
    h5py = require_h5py()

    depth_scale = float(getattr(renderer, "depth_scale", 1.0))
    t = len(positions)
    rgb_all, depth_all, outlier_all = [], [], []
    sensor_pos_all, sensor_rot_all = [], []
    det_strs, seg_all = [], []
    base = os.path.splitext(os.path.basename(out_h5))[0]
    for i in range(t):
        renderer.set_agent_state(positions[i], rotations[i])
        rgb = renderer.render_rgb()
        depth = renderer.render_depth()
        if hasattr(renderer, "get_sensor_pos"):
            s_pos = np.asarray(renderer.get_sensor_pos(), np.float64)
            s_rot = np.asarray(renderer.get_sensor_ori(), np.float64)
        else:
            s_pos = np.asarray(positions[i], np.float64)
            s_rot = np.asarray(rotations[i], np.float64)
        sensor_pos_all.append(s_pos)
        sensor_rot_all.append(s_rot)
        # pixels without depth are the outliers at this stage
        # (ref: projector/point_cloud.py:8-56, no_depth)
        outlier_all.append(np.asarray(depth) <= 0.0)
        boxes, classes = [], []
        for r in renderer.render_boxes():
            x1, y1, x2, y2 = r["box"]
            if min(x2 - x1, y2 - y1) >= min_box_edge:
                boxes.append([x1, y1, x2, y2])
                classes.append(r["id"])
        rgb_all.append(rgb)
        depth_all.append(depth)
        det_strs.append(detection_record_str(f"{base}_{i}.jpg", boxes,
                                             classes))
        seg_all.append(renderer.render_semantic())
    xyz = world_xyz(np.stack(depth_all), np.stack(sensor_pos_all),
                    np.stack(sensor_rot_all), vfov_deg, depth_scale, device)

    os.makedirs(os.path.dirname(out_h5) or ".", exist_ok=True)
    if jpeg_dir is None:
        jpeg_dir = _default_jpeg_dir(out_h5)
    if jpeg_dir:
        from PIL import Image
        os.makedirs(jpeg_dir, exist_ok=True)
        for i, rgb in enumerate(rgb_all):
            Image.fromarray(np.asarray(rgb, np.uint8)).save(
                os.path.join(jpeg_dir, f"{base}_{i}.jpg"), quality=90)
    with h5py.File(out_h5, "w") as f:
        f.create_dataset("rgb", data=np.stack(rgb_all).astype(np.uint8))
        f.create_dataset("depth", data=np.stack(depth_all).astype(np.float32))
        # the reference schema's keys: the sensor pose the projection used
        f.create_dataset("sensor_positions",
                         data=np.asarray(sensor_pos_all, np.float32))
        f.create_dataset("sensor_rotations",
                         data=np.asarray(sensor_rot_all, np.float32))
        # the agent's pose
        f.create_dataset("positions", data=np.asarray(positions, np.float32))
        f.create_dataset("orientations",
                         data=np.asarray(rotations, np.float32))
        f.create_dataset("projection_indices", data=xyz.astype(np.float32))
        f.create_dataset("masks_outliers",
                         data=np.stack(outlier_all).astype(bool))
        f.create_dataset("detection_data", data=np.asarray(det_strs, object),
                         dtype=h5py.special_dtype(vlen=str))
        f.create_dataset("segmentation_data",
                         data=np.stack(seg_all).astype(np.int32))
    return dict(frames=t, path=out_h5)


def build_env_samples(renderer: Renderer, env: str, path: Dict[str, list],
                      output_dir: str, nb_samples: int = 50,
                      nb_frames: int = 20, seed: int = 0,
                      random_starts: bool = False, **kw) -> List[str]:
    """Cut `nb_samples` windows of `nb_frames` from an env's path and
    render each (`kw` goes to `build_sample_h5`). Starts are evenly
    spaced (reproducible), or with `random_starts` seeded uniform draws,
    the reference's sampling (build_data.py:139-141)."""
    positions = np.asarray(path["positions"], np.float32)
    rotations = np.asarray(path["orientations"], np.float32)
    n = len(positions)
    assert n >= nb_frames, (env, n)
    if random_starts:
        starts = np.random.RandomState(seed).randint(
            0, n - nb_frames + 1, size=nb_samples)
    else:
        starts = np.linspace(0, n - nb_frames,
                             num=min(nb_samples, n - nb_frames + 1),
                             dtype=int)
    out = []
    for m, start in enumerate(starts):
        fn = os.path.join(output_dir, f"{env}_{m}.h5")
        build_sample_h5(renderer, positions[start: start + nb_frames],
                        rotations[start: start + nb_frames], fn, **kw)
        out.append(fn)
    return out


def main(argv: Optional[list] = None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--paths-json", required=True,
                   help="env -> {positions, orientations} trajectories")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--renderer", default="synthetic",
                   choices=["synthetic", "habitat"],
                   help="'habitat' drives habitat-sim through "
                        "data.habitat_renderer; 'synthetic' needs nothing")
    p.add_argument("--scene-data-path", default="",
                   help="Matterport root for --renderer habitat: scenes "
                        "resolve to <root>/habitat_data/v1/tasks/mp3d/"
                        "<house>/<house>.glb (SMNet/build_data.py:132)")
    p.add_argument("--samples-per-env", type=int, default=50)
    p.add_argument("--frames-per-sample", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="device of the projection: 'cuda' (the default) or "
                        "'cpu'")
    args = p.parse_args(argv)
    with open(args.paths_json) as f:
        paths = json.load(f)
    for env, path in paths.items():
        if args.renderer == "habitat":
            from .habitat_renderer import HabitatRenderer
            # env names are '<house>_<level>'; the scene .glb is the
            # house's (ref: build_data.py:128-133)
            house = env.rsplit("_", 1)[0]
            scene = os.path.join(args.scene_data_path, "habitat_data", "v1",
                                 "tasks", "mp3d", house, house + ".glb")
            renderer = HabitatRenderer(scene)
        else:
            import zlib
            from .synthetic import SyntheticRenderer
            renderer = SyntheticRenderer(
                seed=zlib.crc32(env.encode()) % (2 ** 31))
        try:
            files = build_env_samples(renderer, env, path, args.output_dir,
                                      args.samples_per_env,
                                      args.frames_per_sample,
                                      device=args.device)
        finally:
            getattr(renderer, "close", lambda: None)()
        print(f"{env}: {len(files)} samples")


if __name__ == "__main__":
    main()
