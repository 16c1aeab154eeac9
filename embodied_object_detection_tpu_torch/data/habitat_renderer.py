"""Habitat-sim-backed Renderer for the data-generation pipeline.

The port's copy of the JAX package's `data/habitat_renderer.py`: glue,
guarded at import, so that `data/build_data.py` runs unchanged on a
machine with habitat-sim and habitat-api installed. habitat-sim is an
external C++ renderer; the adapter is held to a fake `habitat` module in
tests/test_torch_slice17_data.py and has not been run against the real
simulator.

ref: Detic/SMNet/utils/habitat_utils.py:14-284 — the `HabitatUtils`
surface the reference build scripts drive: make_sim over a scene with
RGB/DEPTH/SEMANTIC sensors (:22-62), semantic_annotations object lookup
(:346-348), agent-state setters (:113-127), `render(mode=...)` (:197),
`render_semantic_lvis_20` (:247-258) and `render_bbox_lvis_20` (:261-284)
with the mpcat40 -> fine-category -> lvis-20 name mapping
(semantic_utils.py:109-115).

The adapter exposes the `Renderer` protocol `build_data.py` reads in
place of the reference's mode-string render(); class ids in
`render_semantic` are lvis-20 index + 1 (0 = void) and `render_boxes`
records carry 0-based lvis ids, as data/synthetic.py's renderer does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from .episode_dataset import OBJECT_LVIS

# mpcat40 categories whose raw (fine) name should be used instead
# (ref: semantic_utils.py:109)
USE_FINE = ("appliances", "furniture")


def _lvis_index(obj) -> Optional[int]:
    """0-based lvis-20 index for a habitat semantic object, or None.

    ref: habitat_utils.py:249-257 — mpcat40 name, refined to the raw name
    for the USE_FINE categories, looked up in the 20-class lvis list."""
    name = obj.category.name(mapping="mpcat40")
    if name in USE_FINE:
        name = obj.category.name(mapping="raw")
    if name in OBJECT_LVIS:
        return OBJECT_LVIS.index(name)
    return None


def heading_to_quaternion(heading: float) -> List[float]:
    """[x, y, z, w] quaternion for a rotation of `heading` rad about +Y
    (habitat's up axis) — the form `sim.set_agent_state` accepts."""
    return [0.0, math.sin(heading / 2.0), 0.0, math.cos(heading / 2.0)]


class HabitatRenderer:
    """`Renderer`-protocol adapter over a habitat-sim scene.

    Parameters mirror HabitatUtils (habitat_utils.py:15-62): `scene` is the
    .glb path, sensors default to the reference's 480x640; depth range
    stays at the habitat config defaults.
    """

    def __init__(self, scene: str, height: int = 480, width: int = 640,
                 forward_step: float = 0.1, turn_angle: int = 9):
        try:
            from habitat import get_config
            from habitat.sims import make_sim
        except ImportError as e:      # pragma: no cover - exercised via fake
            raise ImportError(
                "HabitatRenderer needs habitat-api + habitat-sim "
                "(external C++ renderer; install per the reference README). "
                "Use data.synthetic.SyntheticRenderer for fixture data."
            ) from e

        config = get_config()
        config.defrost()
        config.SIMULATOR.SCENE = scene
        config.SIMULATOR.AGENT_0.SENSORS = [
            "RGB_SENSOR", "DEPTH_SENSOR", "SEMANTIC_SENSOR"]
        config.SIMULATOR.FORWARD_STEP_SIZE = forward_step
        config.SIMULATOR.TURN_ANGLE = turn_angle
        for sensor in ("RGB_SENSOR", "DEPTH_SENSOR", "SEMANTIC_SENSOR"):
            getattr(config.SIMULATOR, sensor).HEIGHT = height
            getattr(config.SIMULATOR, sensor).WIDTH = width
        config.freeze()

        self.scene = scene
        # habitat DEPTH_SENSOR buffers are [0,1]-normalized over MAX_DEPTH
        # (default 10 m) — the reference multiplies by 10.0 before
        # projecting (SMNet build_data.py:205-206); build_sample_h5 reads
        # this attribute to scale the projection while the h5 'depth' key
        # keeps the raw normalized render (the reference schema)
        self.depth_scale = float(
            getattr(config.SIMULATOR.DEPTH_SENSOR, "MAX_DEPTH", 10.0))
        self.sim = make_sim(id_sim=config.SIMULATOR.TYPE,
                            config=config.SIMULATOR)
        self.semantic_annotations = self.sim.semantic_annotations()
        self.sim.reset()
        # instance-id -> semantic object (ref: habitat_utils.py:346-348)
        self.objects = {
            int(o.id.split("_")[-1]): o
            for o in self.semantic_annotations.objects if o is not None}

    # ------------------------------------------------------------ protocol
    def set_agent_state(self, position: Sequence[float],
                        rotation: Sequence[float]) -> None:
        """position [3]; rotation either a 4-vector quaternion (the
        reference paths.json orientation format, passed through verbatim)
        or a 3-vector euler [elevation, heading, roll] from which only the
        heading is realized (habitat agents rotate about +Y; sensor
        elevation is a config-time orientation, habitat_utils.py:42-46)."""
        rotation = list(np.asarray(rotation, np.float64).reshape(-1))
        if len(rotation) == 3:
            rotation = heading_to_quaternion(rotation[1])
        self.sim.set_agent_state(list(np.asarray(position, np.float64)),
                                 rotation)

    def get_sensor_pos(self) -> np.ndarray:
        """Depth-sensor world position — the POSE THE PROJECTION NEEDS
        (the sensor sits ~1.25 m above the agent; ref:
        habitat_utils.py get_sensor_pos via SMNet build_data.py:179)."""
        state = self.sim.get_agent_state()
        s = state.sensor_states["depth"]
        return np.asarray(s.position, np.float64)

    def get_sensor_ori(self) -> np.ndarray:
        """Depth-sensor orientation quaternion [x, y, z, w]
        (ref: build_data.py:180-186)."""
        state = self.sim.get_agent_state()
        q = state.sensor_states["depth"].rotation
        return np.asarray([q.x, q.y, q.z, q.w], np.float64)

    def render_rgb(self) -> np.ndarray:
        # habitat rgb buffers may carry an alpha channel; drop it
        buf = np.asarray(self.sim.render(mode="rgb"))
        return buf[..., :3].astype(np.uint8)

    def render_depth(self) -> np.ndarray:
        buf = np.asarray(self.sim.render(mode="depth"))
        return buf.reshape(buf.shape[0], buf.shape[1]).astype(np.float32)

    def render_semantic(self) -> np.ndarray:
        """lvis-20 class map, 0 = void (ref: render_semantic_lvis_20,
        habitat_utils.py:247-258)."""
        buf = np.asarray(self.sim.render(mode="semantic"))
        out = np.zeros(buf.shape, np.uint8)
        for oid in np.unique(buf):
            obj = self.objects.get(int(oid))
            if obj is None:
                continue
            idx = _lvis_index(obj)
            if idx is not None:
                out[buf == oid] = idx + 1
        return out

    def render_boxes(self) -> List[dict]:
        """Per-instance GT boxes with 0-based lvis ids; xyxy `box` plus the
        reference's xywh `bbox` record fields (ref: render_bbox_lvis_20,
        habitat_utils.py:261-284 — the >=15px edge filter stays in
        build_data, habitat_utils.py:12 + build_data min_box_edge)."""
        buf = np.asarray(self.sim.render(mode="semantic"))
        out = []
        for oid in np.unique(buf):
            obj = self.objects.get(int(oid))
            if obj is None:
                continue
            idx = _lvis_index(obj)
            if idx is None:
                continue
            ys, xs = np.where(buf == oid)
            x0, x1 = int(xs.min()), int(xs.max())
            y0, y1 = int(ys.min()), int(ys.max())
            out.append({
                "id": idx,
                "box": [x0, y0, x1, y1],
                "category_id": idx,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "iscrowd": 0,
                "area": 0,
            })
        return out

    # ------------------------------------------------- extra sim utilities
    def sample_navigable_point(self):
        return self.sim.sample_navigable_point()

    def step(self, action):
        return self.sim.step(action)

    def reset(self):
        return self.sim.reset()

    def close(self):
        if hasattr(self.sim, "close"):
            self.sim.close()
