"""Memory-data builder: sensor h5 -> memory h5 (cell ids, an empty memory
and the GT semantic map).

The port's copy of the JAX package's `data/build_memory.py` (ref:
Detic/SMNet/build_memory_data.py): each sensor h5's per-pixel world xyz
(build_data.py's `projection_indices`, or, where they are absent,
recomputed from depth and pose on `device` through
`data/build_data.py:world_xyz`) is shifted by the scene's
map_world_shift, divided by the cell size (0.2 m, :84-86, 113-115),
rounded half to even, clipped to the map and flattened y * W + x
(:136-144); the memory h5 gets memory_features (zeros, :147),
proj_indices and semmap_gt (each cell's majority object class). Without
a map-info json, one grid is derived a scene from the union of its
chunks' extents, never one a chunk. h5py is imported where it is used:
the tools raise without it.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .build_data import require_h5py, world_xyz


def world_to_proj_indices(world, map_world_shift, resolution: float,
                          map_w: int, map_h: int):
    """[..., 3] world xyz -> [...] flat map indices (y up, the map over
    (x, z); ref: build_memory_data.py:113-144), int64. An array is
    indexed on the host, a tensor on its device with the same float64
    arithmetic (a division by a tensor, rounding half to even)."""
    if isinstance(world, torch.Tensor):
        shifted = world.double() - torch.as_tensor(
            np.asarray(map_world_shift, np.float64), device=world.device)
        res = torch.tensor(resolution, dtype=torch.float64,
                           device=world.device)
        x = torch.round(shifted[..., 0] / res).long().clamp(0, map_w - 1)
        z = torch.round(shifted[..., 2] / res).long().clamp(0, map_h - 1)
        return z * map_w + x
    shifted = world - np.asarray(map_world_shift)
    x = np.round(shifted[..., 0] / resolution).astype(np.int64)
    z = np.round(shifted[..., 2] / resolution).astype(np.int64)
    x = np.clip(x, 0, map_w - 1)
    z = np.clip(z, 0, map_h - 1)
    return z * map_w + x


def _world_xyz_from_sensor(f, vfov_deg: float = 67.5,
                           device: "torch.device | str" = "cuda"
                           ) -> np.ndarray:
    """[T, H, W, 3] per-pixel world coordinates of one open sensor h5: its
    `projection_indices` (build_data.py's output), else recomputed on
    `device` from its depth and pose (the sensor pose of the reference
    schema, quaternions, else the agent pose keys, euler)."""
    if "projection_indices" in f:
        return np.array(f["projection_indices"])
    if "depth" not in f:
        raise KeyError(
            "sensor h5 lacks projection_indices AND the depth/pose keys "
            "needed to recompute them")
    if "sensor_positions" in f:
        pos, rot = np.array(f["sensor_positions"]), \
            np.array(f["sensor_rotations"])
    elif all(k in f for k in ("positions", "orientations")):
        pos, rot = np.array(f["positions"]), np.array(f["orientations"])
    else:
        raise KeyError("sensor h5 lacks pose keys "
                       "(sensor_positions/sensor_rotations or "
                       "positions/orientations)")
    return world_xyz(np.array(f["depth"]), pos, rot, vfov_deg,
                     device=device)


def _semmap_majority(proj: np.ndarray, semmap_gt, cells: int) -> np.ndarray:
    """[cells] int32: each cell's most frequent object class (ids > 0) of
    the pixels that map to it, 0 where none does; the ids compacted
    first, so that sparse instance ids cannot blow up the counts."""
    cell_gt = np.zeros((cells,), np.int32)
    if semmap_gt is None:
        return cell_gt
    flat_proj = proj.reshape(-1)
    classes = np.asarray(semmap_gt).reshape(-1).astype(np.int64)
    obj = classes > 0
    uniq, inv = np.unique(classes[obj], return_inverse=True)
    if uniq.size:
        counts = np.zeros((cells, uniq.size), np.int64)
        np.add.at(counts, (flat_proj[obj], inv), 1)
        has_obj = counts.sum(axis=1) > 0
        cell_gt[has_obj] = uniq[counts.argmax(axis=1)[has_obj]]
    return cell_gt


def build_memory_file(sensor_h5: str, out_h5: str,
                      map_world_shift: Optional[np.ndarray] = None,
                      resolution: float = 0.2,
                      map_dims: Optional[Tuple[int, int]] = None,
                      memory_dim: int = 512,
                      world: Optional[np.ndarray] = None,
                      device: "torch.device | str" = "cuda"
                      ) -> Tuple[int, int]:
    """Convert one sensor h5 into the memory h5 schema; returns (map_w,
    map_h). The shift and dims default to the chunk's own extent.

    The reference's quirk is kept: `masks_outliers` is not read
    (build_memory_data.py:124 loads it and never uses it, and the
    runtime write uses the raw clipped ids, custom_rcnn.py:903-936)."""
    h5py = require_h5py()
    with h5py.File(sensor_h5, "r") as f:
        if world is None:
            world = _world_xyz_from_sensor(f, device=device)
        semmap_gt = np.array(f["segmentation_data"]) \
            if "segmentation_data" in f else None

    if map_world_shift is None:
        map_world_shift = world.reshape(-1, 3).min(axis=0)
    if map_dims is None:
        extent = world.reshape(-1, 3).max(axis=0) - \
            np.asarray(map_world_shift)
        map_w = int(np.ceil(extent[0] / resolution)) + 1
        map_h = int(np.ceil(extent[2] / resolution)) + 1
    else:
        map_w, map_h = map_dims

    proj = world_to_proj_indices(world, map_world_shift, resolution,
                                 map_w, map_h)[..., None]
    if semmap_gt is not None and np.asarray(semmap_gt).size != proj.size:
        semmap_gt = None          # another sensor layout: no pixel mapping
    cell_gt = _semmap_majority(proj, semmap_gt, map_h * map_w)

    os.makedirs(os.path.dirname(out_h5) or ".", exist_ok=True)
    with h5py.File(out_h5, "w") as f:
        # a zero memory, as the reference writes (build_memory_data.py:147)
        f.create_dataset("memory_features",
                         data=np.zeros((map_h * map_w, memory_dim),
                                       np.float16))
        f.create_dataset("proj_indices", data=proj.astype(np.int64))
        d = f.create_dataset("semmap_gt", data=cell_gt)
        # these ids are lvis-20 + 1 (0 = void), not SMNet's 13 classes:
        # the map_gt baseline must not remap them (semmap_dialect)
        d.attrs["class_space"] = "lvis21"
    return map_w, map_h


def map_shift_from_info(env: str, info: dict,
                        dataset: str = "mp3d") -> np.ndarray:
    """A scene's map_world_shift from the dataset's map-info json: mp3d's
    semmap_GT_info.json has it (build_memory_data.py:128-131); replica's
    replica_map_info.json has x/y extents, shift [x_min - 1, 0, y_min -
    1] (build_replica_memory_data.py:131)."""
    entry = info[env]
    if dataset == "replica":
        return np.array([entry["x_min"] - 1.0, 0.0, entry["y_min"] - 1.0],
                        np.float64)
    return np.asarray(entry["map_world_shift"], np.float64)


def map_dims_from_info(env: str, info: dict, dataset: str,
                       resolution: float) -> Optional[Tuple[int, int]]:
    """A scene's map dims, so that its chunks share one grid: replica's
    from the x/y extents with the shift's 1 m margins, in 0.02 m cells
    and one ceil after the downsampling (build_replica_memory_data.py:
    132-146); mp3d's from semmap_GT_info's `dim` in 0.02 m cells,
    downsampled by resolution / 0.02 (custom_rcnn.py:362-364)."""
    entry = info[env]
    if dataset == "replica" and "x_max" in entry:
        ds = resolution / 0.02
        w = math.ceil(((2 + entry["x_max"] - entry["x_min"]) / 0.02) / ds)
        h = math.ceil(((2 + entry["y_max"] - entry["y_min"]) / 0.02) / ds)
        return int(w), int(h)
    if "dim" in entry:
        ds = resolution / 0.02
        return (int(np.ceil(entry["dim"][0] / ds)),
                int(np.ceil(entry["dim"][2] / ds))
                if len(entry["dim"]) > 2 else
                int(np.ceil(entry["dim"][1] / ds)))
    return None


def _scene_of(filename: str, info: dict) -> Optional[str]:
    """The longest info key that prefixes the file name (scene ids hold
    underscores: apartment_0, frl_apartment_1, ...)."""
    stem = filename[:-3] if filename.endswith(".h5") else filename
    best = None
    for k in info:
        if stem == k or stem.startswith(k + "_"):
            if best is None or len(k) > len(best):
                best = k
    return best


def _scene_stem(filename: str) -> str:
    """{scene}_{chunk}.h5 -> scene (a trailing _<int> stripped)."""
    stem = filename[:-3] if filename.endswith(".h5") else filename
    head, _, tail = stem.rpartition("_")
    return head if head and tail.isdigit() else stem


def build_dataset_memories(sensor_dir: str, out_dir: str,
                           map_info_json: Optional[str] = None,
                           dataset: str = "mp3d", resolution: float = 0.2,
                           device: "torch.device | str" = "cuda") -> dict:
    """Convert every sensor h5 of `sensor_dir`, each scene's chunks on
    one grid: its shift and dims from the map-info json when given (the
    build_memory_data / build_replica_memory_data drivers), else from the
    union of the scene's chunks' world extents (a first pass a scene; the
    memory carries across a scene's chunks, so per-chunk grids would mean
    different world positions). Worlds recomputed from depth and pose are
    kept between the passes; precomputed ones are read again. Returns
    {file: (map_w, map_h)}."""
    h5py = require_h5py()
    info = None
    if map_info_json:
        with open(map_info_json) as fp:
            info = json.load(fp)
    files = [f for f in sorted(os.listdir(sensor_dir)) if f.endswith(".h5")]

    dims = {}
    if info is not None:
        for f in files:
            env = _scene_of(f, info)
            if env is None:
                raise ValueError(
                    f"{f}: no scene entry in {map_info_json} — a chunk "
                    f"built against a private grid would desync from its "
                    f"scene's carried memory")
            dims[f] = build_memory_file(
                os.path.join(sensor_dir, f), os.path.join(out_dir, f),
                map_world_shift=map_shift_from_info(env, info, dataset),
                map_dims=map_dims_from_info(env, info, dataset, resolution),
                resolution=resolution, device=device)
        return dims

    by_scene: dict = {}
    for f in files:
        by_scene.setdefault(_scene_stem(f), []).append(f)
    for scene_files in by_scene.values():
        worlds: dict = {}
        lo = hi = None
        for f in scene_files:
            with h5py.File(os.path.join(sensor_dir, f), "r") as h:
                cheap = "projection_indices" in h
                world = _world_xyz_from_sensor(h, device=device)
            if not cheap:
                worlds[f] = world
            flat = world.reshape(-1, 3)
            lo = flat.min(axis=0) if lo is None \
                else np.minimum(lo, flat.min(axis=0))
            hi = flat.max(axis=0) if hi is None \
                else np.maximum(hi, flat.max(axis=0))
        extent = hi - lo
        mdims = (int(np.ceil(extent[0] / resolution)) + 1,
                 int(np.ceil(extent[2] / resolution)) + 1)
        for f in scene_files:
            dims[f] = build_memory_file(
                os.path.join(sensor_dir, f), os.path.join(out_dir, f),
                map_world_shift=lo, map_dims=mdims, resolution=resolution,
                world=worlds.pop(f, None), device=device)
    return dims


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sensor-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--resolution", type=float, default=0.2)
    p.add_argument("--dataset", choices=["mp3d", "replica"], default="mp3d")
    p.add_argument("--map-info-json", default=None,
                   help="semmap_GT_info.json / replica_map_info.json")
    p.add_argument("--device", default="cuda",
                   help="device of the depth + pose projection: 'cuda' (the "
                        "default) or 'cpu'")
    args = p.parse_args(argv)
    dims = build_dataset_memories(args.sensor_dir, args.out_dir,
                                  args.map_info_json, args.dataset,
                                  args.resolution, args.device)
    for f, d in dims.items():
        print(f, "->", d)


if __name__ == "__main__":
    main()
