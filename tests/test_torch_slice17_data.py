"""Slice 17 of the port on the CPU: the dataset build tools against the
JAX package's, on the same seeded `SyntheticRenderer` frames, each
package writing its own temporary root.

  * `SyntheticRenderer`: the same frames, depth, semantic maps and boxes
    from the same seed;
  * `build_sample_h5` (euler and quaternion poses) and `build_data.main`:
    rgb, depth, semantic maps, the detection records, poses, outlier
    masks and JPEGs equal; the world xyz (`projection_indices`, the
    port's projector on the CPU) within 1e-5 m;
  * `build_dataset_memories` (the scene-consistent grids without a
    map-info json, from the h5 xyz and from depth + pose) and
    `build_memory_file`: grids equal, `proj_indices` equal or, where a
    pixel differs, explained: its cell coordinate lies within 1e-5 m of
    a rounding boundary in both packages; the semmap majority, the
    Replica driver and the map-info helpers equal;
  * `create_coco_annotations`: the json equal;
  * `HabitatRenderer` against a fake `habitat` module (the fake built as
    tests/test_habitat_renderer.py builds it), through `build_sample_h5`
    and `build_data.main --renderer habitat`;
  * `VectorEnv` / `ThreadedVectorEnv` on toy envs defined here (this
    module imports no JAX at its top, so spawned workers do not): reset,
    step and call, async step and pause, every start method, auto-reset
    and draining on close;
  * the tools raise without h5py.
"""

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from embodied_object_detection_tpu_torch.data import build_data as tbd
from embodied_object_detection_tpu_torch.data import build_memory as tbm
from embodied_object_detection_tpu_torch.data.create_coco import (
    create_coco_annotations)
from embodied_object_detection_tpu_torch.data.episode_dataset import (
    parse_detection_record)
from embodied_object_detection_tpu_torch.data.synthetic import (
    SyntheticRenderer)
from embodied_object_detection_tpu_torch.data.vector_env import (
    ThreadedVectorEnv, VectorEnv)

F32 = np.float32
SENSOR_KEYS = ("rgb", "depth", "sensor_positions", "sensor_rotations",
               "positions", "orientations", "masks_outliers",
               "segmentation_data")


def _h5(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: np.array(f[k][()]) for k in f}


def _poses(t, kind, x0=0.0, z0=0.0):
    pos = np.asarray([[x0 + 0.13 * i, 1.2, z0 + 0.05 * i]
                      for i in range(t)], F32)
    if kind == "euler":
        rot = np.asarray([[0.02 * i, 0.11 * i, 0.0] for i in range(t)], F32)
    else:
        # quaternions xyzw about +y, with a small tilt
        h = 0.11 * np.arange(t)
        rot = np.stack([0.01 * np.ones(t), np.sin(h / 2), np.zeros(t),
                        np.cos(h / 2)], 1).astype(F32)
        rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return pos, rot


def _both(tmp_path, build):
    """build(module of build_data, module of synthetic, root, package)
    for the port and for the JAX package, in two roots."""
    from embodied_object_detection_tpu.data import build_data as jbd
    from embodied_object_detection_tpu.data import synthetic as jsyn
    from embodied_object_detection_tpu_torch.data import synthetic as tsyn
    roots = {}
    for name, bd, syn in (("port", tbd, tsyn), ("jax", jbd, jsyn)):
        roots[name] = str(tmp_path / name)
        build(bd, syn, roots[name], name)
    return roots["port"], roots["jax"]


def _device_kw(name):
    return {"device": "cpu"} if name == "port" else {}


# ------------------------------------------------------------ renderer

def test_synthetic_renderer_frames_vs_jax():
    from embodied_object_detection_tpu.data.synthetic import (
        SyntheticRenderer as JaxRenderer)
    a = SyntheticRenderer(height=48, width=64, seed=9, num_objects=7)
    b = JaxRenderer(height=48, width=64, seed=9, num_objects=7)
    pos, rot = _poses(5, "euler")
    for p, r in zip(pos, rot):
        a.set_agent_state(p, r)
        b.set_agent_state(p, r)
        # the semantic map and boxes first: the frame renders once a pose
        np.testing.assert_array_equal(a.render_semantic(),
                                      b.render_semantic())
        assert a.render_boxes() == b.render_boxes()
        np.testing.assert_array_equal(a.render_rgb(), b.render_rgb())
        np.testing.assert_array_equal(a.render_depth(), b.render_depth())
    assert any(a.render_boxes() for _ in range(1))


def test_detection_record_vs_jax():
    from embodied_object_detection_tpu.data.build_data import (
        detection_record_str)
    args = ("f.jpg", [[1, 2, 30, 40], [5.5, 6, 70, 80]], [3, 7])
    s = tbd.detection_record_str(*args)
    assert s == detection_record_str(*args)
    name, boxes, classes = parse_detection_record(s)
    assert name == "f.jpg" and list(classes) == [3, 7]
    np.testing.assert_allclose(boxes, [[1, 2, 30, 40], [5.5, 6, 70, 80]])


# ------------------------------------------------------------ build_data

def _hold_sensor(port_h5, jax_h5):
    got, want = _h5(port_h5), _h5(jax_h5)
    assert sorted(got) == sorted(want)
    for k in SENSOR_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(got["detection_data"]) == list(want["detection_data"])
    np.testing.assert_allclose(got["projection_indices"],
                               want["projection_indices"], rtol=0,
                               atol=1e-5)
    return got, want


@pytest.mark.parametrize("kind", ["euler", "quaternion"])
def test_build_sample_h5_vs_jax(tmp_path, kind):
    pos, rot = _poses(4, kind)

    def build(bd, syn, root, name):
        bd.build_sample_h5(syn.SyntheticRenderer(height=48, width=64,
                                                 seed=1), pos, rot,
                           os.path.join(root, "sensor_data", "env0_0.h5"),
                           min_box_edge=10, **_device_kw(name))

    port, jax_root = _both(tmp_path, build)
    got, _ = _hold_sensor(os.path.join(port, "sensor_data", "env0_0.h5"),
                          os.path.join(jax_root, "sensor_data", "env0_0.h5"))
    assert got["projection_indices"].shape == (4, 48, 64, 3)
    assert sum(len(parse_detection_record(r)[1])
               for r in got["detection_data"]) > 0
    for i in range(4):
        name = f"env0_0_{i}.jpg"
        with open(os.path.join(port, "JPEGImages", name), "rb") as a, \
                open(os.path.join(jax_root, "JPEGImages", name), "rb") as b:
            assert a.read() == b.read()


def test_world_xyz_on_arrays_vs_jax_projector():
    """The device part alone (no h5): world xyz of depth + poses against
    the JAX projector's, frame by frame, depth scaled."""
    import jax.numpy as jnp
    from embodied_object_detection_tpu.geometry.projector import (
        pixel_to_world, pose_to_xyzhe, transform3d)
    rng = np.random.RandomState(4)
    depth = rng.uniform(0.0, 1.0, (3, 24, 32)).astype(F32)
    pos, rot = _poses(3, "quaternion", x0=-2.0, z0=7.0)
    got = tbd.world_xyz(depth, pos, rot, 67.5, depth_scale=10.0,
                        device="cpu")
    for i in range(3):
        want = pixel_to_world(
            jnp.asarray(depth[i] * F32(10.0)),
            transform3d(jnp.asarray(pose_to_xyzhe(pos[i], rot[i])))[0],
            np.radians(67.5), jnp.zeros((3,), jnp.float32))
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_build_data_main_vs_jax(tmp_path):
    from embodied_object_detection_tpu.data.build_data import main as jmain
    paths = {"houseA_0": {
        "positions": [[0.1 * i, 1.0, 0.0] for i in range(5)],
        "orientations": [[0.0, 0.15 * i, 0.0] for i in range(5)]}}
    pj = tmp_path / "paths.json"
    pj.write_text(json.dumps(paths))
    for name, main in (("port", tbd.main), ("jax", jmain)):
        out = tmp_path / name / "sensor_data"
        out.mkdir(parents=True)
        main(["--paths-json", str(pj), "--output-dir", str(out),
              "--samples-per-env", "2", "--frames-per-sample", "3"] +
             (["--device", "cpu"] if name == "port" else []))
    for f in ("houseA_0_0.h5", "houseA_0_1.h5"):
        _hold_sensor(tmp_path / "port" / "sensor_data" / f,
                     tmp_path / "jax" / "sensor_data" / f)


# ------------------------------------------------------------ build_memory

def _cells(world, shift, res):
    """(x, z) in cells of each pixel's world point."""
    v = (world.reshape(-1, 3).astype(np.float64) - shift) / res
    return v[:, 0], v[:, 2]


def _explain(got, want, world_p, world_j, dims, res=0.2):
    """Pixels whose cell ids differ: each must have, in both packages, an
    x or z coordinate within 1e-5 m of a rounding boundary (k + 1/2 cells)
    where the two round apart. Returns the count."""
    shift_p = world_p.reshape(-1, 3).min(0)
    shift_j = world_j.reshape(-1, 3).min(0)
    got, want = got.reshape(-1), want.reshape(-1)
    bad = np.nonzero(got != want)[0]
    xp, zp = _cells(world_p, shift_p, res)
    xj, zj = _cells(world_j, shift_j, res)
    for i in bad:
        explained = False
        for p, j in ((xp[i], xj[i]), (zp[i], zj[i])):
            if np.round(p) != np.round(j):
                near = [abs(v - np.floor(v) - 0.5) * res for v in (p, j)]
                explained |= max(near) <= 1e-5
        assert explained, (i, xp[i], xj[i], zp[i], zj[i])
    return len(bad)


def _scene_chunks(bd, syn, root, name, strip=False):
    """Two chunks of scene_0 apart and a chunk of another scene, as
    tests/test_build_data.py builds them; `strip` drops their xyz so the
    memory builder projects depth + pose."""
    import h5py
    sensor = os.path.join(root, "sensor_data")
    renderer = syn.SyntheticRenderer(height=24, width=32, seed=2)
    jobs = [("scene_0_0.h5", *_poses(3, "euler", 0.0, 0.0)),
            ("scene_0_1.h5", *_poses(3, "quaternion", 3.0, 0.5)),
            ("other_1_0.h5", *_poses(3, "euler", 10.0, 10.0))]
    for fn, pos, rot in jobs:
        bd.build_sample_h5(renderer, pos, rot, os.path.join(sensor, fn),
                           jpeg_dir="", **_device_kw(name))
        if strip:
            path = os.path.join(sensor, fn)
            with h5py.File(path, "a") as f:
                del f["projection_indices"]


@pytest.mark.parametrize("strip", [False, True])
def test_build_dataset_memories_vs_jax(tmp_path, strip):
    from embodied_object_detection_tpu.data import build_memory as jbm
    build_dataset_memories = jbm.build_dataset_memories

    def build(bd, syn, root, name):
        _scene_chunks(bd, syn, root, name, strip)
        fn = tbm.build_dataset_memories if name == "port" else \
            build_dataset_memories
        dims[name] = fn(os.path.join(root, "sensor_data"),
                        os.path.join(root, "memory_data"),
                        **_device_kw(name))

    dims = {}
    port, jax_root = _both(tmp_path, build)
    assert dims["port"] == dims["jax"]
    assert dims["port"]["scene_0_0.h5"] == dims["port"]["scene_0_1.h5"]
    flipped = 0
    for scene in ("scene_0", "other_1"):
        files = sorted(f for f in dims["port"] if f.startswith(scene))
        worlds = {}
        for name, root, recompute in (
                ("port", port, lambda f: tbm._world_xyz_from_sensor(
                    f, device="cpu")),
                ("jax", jax_root, jbm._world_xyz_from_sensor)):
            worlds[name] = np.concatenate([
                recompute(_FakeH5(os.path.join(root, "sensor_data", f)))
                if strip else _h5(os.path.join(root, "sensor_data", f))[
                    "projection_indices"] for f in files])
        got = np.concatenate([_h5(os.path.join(port, "memory_data", f))[
            "proj_indices"] for f in files])
        want = np.concatenate([_h5(os.path.join(jax_root, "memory_data",
                                                f))["proj_indices"]
                               for f in files])
        flipped += _explain(got, want, worlds["port"], worlds["jax"],
                            dims["port"][files[0]])
        for f in files:
            a = _h5(os.path.join(port, "memory_data", f))
            b = _h5(os.path.join(jax_root, "memory_data", f))
            assert a["memory_features"].shape == b["memory_features"].shape
            assert a["memory_features"].dtype == b["memory_features"].dtype
            np.testing.assert_array_equal(a["semmap_gt"], b["semmap_gt"])
    assert flipped <= 0.001 * 9 * 24 * 32


class _FakeH5(dict):
    """An h5 file's arrays as a dict, for `_world_xyz_from_sensor`."""

    def __init__(self, path):
        super().__init__(_h5(path))


def test_build_memory_file_vs_jax_semmap_and_dims(tmp_path):
    """The majority class a cell (objects outvote void; sparse ids
    compacted), on given and on derived grids."""
    import h5py
    from embodied_object_detection_tpu.data.build_memory import (
        build_memory_file)
    rng = np.random.RandomState(5)
    world = rng.uniform(0.0, 3.0, (2, 6, 8, 3)).astype(F32)
    seg = rng.choice([0, 0, 3, 7, 1000], (2, 6, 8)).astype(np.int32)
    src = tmp_path / "s.h5"
    with h5py.File(src, "w") as f:
        f.create_dataset("projection_indices", data=world)
        f.create_dataset("segmentation_data", data=seg)
    for kw in (dict(), dict(map_world_shift=np.zeros(3), resolution=1.0,
                            map_dims=(3, 3)),
               dict(resolution=0.5, memory_dim=16)):
        dims = tbm.build_memory_file(str(src), str(tmp_path / "a.h5"),
                                     device="cpu", **kw)
        assert dims == build_memory_file(str(src), str(tmp_path / "b.h5"),
                                         **kw)
        a, b = _h5(tmp_path / "a.h5"), _h5(tmp_path / "b.h5")
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["semmap_gt"] > 0).any()
    with h5py.File(tmp_path / "a.h5") as f:
        assert f["semmap_gt"].attrs["class_space"] == "lvis21"


def test_world_to_proj_indices_tensor_path_equals_numpy():
    rng = np.random.RandomState(6)
    world = rng.uniform(-3, 9, (4, 5, 6, 3)).astype(F32)
    world[0, 0, :, 0] = np.arange(6) * F32(0.2) + F32(0.1)   # on .5 cells
    shift = world.reshape(-1, 3).min(0)
    want = tbm.world_to_proj_indices(world, shift, 0.2, 40, 30)
    got = tbm.world_to_proj_indices(torch.from_numpy(world), shift, 0.2,
                                    40, 30)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_replica_driver_and_info_helpers_vs_jax(tmp_path):
    import h5py
    from embodied_object_detection_tpu.data import build_memory as jbm
    sensor = tmp_path / "sensors"
    sensor.mkdir()
    rng = np.random.RandomState(0)
    for fn in ("frl_apartment_1_0.h5", "frl_apartment_1_1.h5",
               "apartment_0_0.h5"):
        with h5py.File(sensor / fn, "w") as f:
            f.create_dataset("projection_indices", data=rng.uniform(
                3.0, 6.0, (2, 8, 10, 3)).astype(F32))
    info = {"frl_apartment_1": {"x_min": 3.0, "y_min": 3.0, "x_max": 6.1,
                                "y_max": 6.4},
            "apartment_0": {"x_min": 2.5, "y_min": 2.0},
            "apartment": {"x_min": 0.0, "y_min": 0.0}}
    path = tmp_path / "replica_map_info.json"
    path.write_text(json.dumps(info))
    dims = tbm.build_dataset_memories(str(sensor), str(tmp_path / "a"),
                                      str(path), "replica", 0.2,
                                      device="cpu")
    assert dims == jbm.build_dataset_memories(str(sensor),
                                              str(tmp_path / "b"),
                                              str(path), "replica", 0.2)
    for fn in dims:
        a, b = _h5(tmp_path / "a" / fn), _h5(tmp_path / "b" / fn)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    mp3d = {"env1": {"map_world_shift": [1.5, 0.0, -2.0],
                     "dim": [500, 40, 350]},
            "env2": {"map_world_shift": [0, 0, 0], "dim": [100, 60]}}
    for env, table, ds in [("env1", mp3d, "mp3d"), ("env2", mp3d, "mp3d"),
                           ("frl_apartment_1", info, "replica"),
                           ("apartment_0", info, "replica")]:
        np.testing.assert_array_equal(tbm.map_shift_from_info(env, table,
                                                              ds),
                                      jbm.map_shift_from_info(env, table,
                                                              ds))
        for res in (0.2, 0.1):
            assert tbm.map_dims_from_info(env, table, ds, res) == \
                jbm.map_dims_from_info(env, table, ds, res)
    for fn in ("apartment_0_3.h5", "frl_apartment_1_0.h5", "office_2_0.h5",
               "apartment_7.h5", "scene"):
        assert tbm._scene_of(fn, info) == jbm._scene_of(fn, info)
        assert tbm._scene_stem(fn) == jbm._scene_stem(fn)
    with pytest.raises(ValueError, match="no scene entry"):
        (sensor / "office_2_0.h5").write_bytes(
            (sensor / "apartment_0_0.h5").read_bytes())
        tbm.build_dataset_memories(str(sensor), str(tmp_path / "c"),
                                   str(path), "replica", device="cpu")


def test_build_memory_without_projections_or_depth_raises(tmp_path):
    import h5py
    bare = str(tmp_path / "bare.h5")
    with h5py.File(bare, "w") as f:
        f.create_dataset("rgb", data=np.zeros((1, 4, 4, 3), np.uint8))
    with pytest.raises(KeyError, match="projection_indices"):
        tbm.build_memory_file(bare, str(tmp_path / "m.h5"), device="cpu")


def test_tools_raise_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="need h5py"):
        tbm.build_memory_file(str(tmp_path / "x.h5"),
                              str(tmp_path / "y.h5"), device="cpu")
    with pytest.raises(ImportError, match="need h5py"):
        create_coco_annotations(str(tmp_path))
    pos, rot = _poses(1, "euler")
    with pytest.raises(ImportError, match="need h5py"):
        tbd.build_sample_h5(SyntheticRenderer(16, 16), pos, rot,
                            str(tmp_path / "z.h5"), device="cpu")


# ------------------------------------------------------------ create_coco

def test_create_coco_vs_jax(tmp_path):
    from embodied_object_detection_tpu.data.create_coco import (
        create_coco_annotations as jax_coco)

    def build(bd, syn, root, name):
        r = syn.SyntheticRenderer(height=48, width=64, seed=4)
        for k in range(2):
            pos, rot = _poses(7, "euler", x0=k)
            bd.build_sample_h5(r, pos, rot, os.path.join(
                root, "sensor_data", f"scene0000_lvl0_{k}.h5"),
                min_box_edge=8, jpeg_dir="", **_device_kw(name))

    port, jax_root = _both(tmp_path, build)
    for kw in (dict(), dict(every=2), dict(height=480, width=640)):
        got = create_coco_annotations(port, str(tmp_path / "a.json"), **kw)
        want = jax_coco(jax_root, str(tmp_path / "b.json"), **kw)
        assert got == want
        assert (tmp_path / "a.json").read_text() == \
            (tmp_path / "b.json").read_text()
    assert len(got["images"]) == 4 and got["annotations"]


# ------------------------------------------------------------ habitat

class _Node(dict):
    """yacs-lite: attribute access, defrost / freeze no-ops."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v

    def defrost(self):
        pass

    def freeze(self):
        pass


class _Category:
    def __init__(self, mpcat40, raw=None):
        self._names = {"mpcat40": mpcat40, "raw": raw or mpcat40}

    def name(self, mapping="mpcat40"):
        return self._names[mapping]


class _SemObject:
    def __init__(self, oid, mpcat40, raw=None):
        self.id = f"scene_region_{oid}"
        self.category = _Category(mpcat40, raw)


class FakeSim:
    """A bed (id 1), a 'furniture' whose raw name is shelving (id 2, the
    USE_FINE path) and a wall (id 3, no lvis class); depth a 2 m plane;
    the depth sensor 1.25 m above the agent."""

    def __init__(self, config):
        self.config = config
        h, w = config.RGB_SENSOR.HEIGHT, config.RGB_SENSOR.WIDTH
        self.h, self.w = h, w
        self.states = []
        sem = np.zeros((h, w), np.int32)
        sem[h // 4: h // 2, w // 8: w // 2] = 1
        sem[h // 2: 3 * h // 4, w // 2: 7 * w // 8] = 2
        sem[0:2, 0:2] = 3
        self.sem = sem

        class _Annotations:
            objects = [None, _SemObject(1, "bed"),
                       _SemObject(2, "furniture", raw="shelving"),
                       _SemObject(3, "wall")]
        self._annotations = _Annotations()

    def semantic_annotations(self):
        return self._annotations

    def reset(self):
        self.did_reset = True

    def set_agent_state(self, position, rotation):
        assert len(position) == 3 and len(rotation) == 4
        self.states.append((list(position), list(rotation)))

    def get_agent_state(self):
        pos, rot = self.states[-1]

        class _Q:
            x, y, z, w = rot

        class _Sensor:
            position = np.asarray(pos) + np.asarray([0.0, 1.25, 0.0])
            rotation = _Q

        class _State:
            sensor_states = {"depth": _Sensor}
        return _State

    def render(self, mode="rgb"):
        if mode == "rgb":
            rgba = np.zeros((self.h, self.w, 4), np.uint8)
            rgba[..., 0] = 17
            rgba[..., 3] = 255
            return rgba
        if mode == "depth":
            return np.full((self.h, self.w, 1), 0.2, np.float32)
        if mode == "semantic":
            return self.sem
        raise ValueError(mode)

    def sample_navigable_point(self):
        return [0.0, 0.5, 0.0]

    def step(self, action):
        return {"action": action}

    def close(self):
        self.closed = True


@pytest.fixture
def fake_habitat(monkeypatch):
    def get_config():
        sensors = {s: _Node(HEIGHT=0, WIDTH=0)
                   for s in ("RGB_SENSOR", "DEPTH_SENSOR", "SEMANTIC_SENSOR")}
        sim = _Node(TYPE="Sim-v0", SCENE="", AGENT_0=_Node(SENSORS=[]),
                    FORWARD_STEP_SIZE=0.25, TURN_ANGLE=10, **sensors)
        return _Node(SIMULATOR=sim)

    made = {}

    def make_sim(id_sim, config):
        assert id_sim == "Sim-v0"
        made["sim"] = FakeSim(config)
        return made["sim"]

    habitat = types.ModuleType("habitat")
    habitat.get_config = get_config
    sims = types.ModuleType("habitat.sims")
    sims.make_sim = make_sim
    habitat.sims = sims
    monkeypatch.setitem(sys.modules, "habitat", habitat)
    monkeypatch.setitem(sys.modules, "habitat.sims", sims)
    return made


def test_habitat_renderer_contract(fake_habitat):
    from embodied_object_detection_tpu_torch.data.habitat_renderer import (
        HabitatRenderer, heading_to_quaternion)
    r = HabitatRenderer("scenes/h/h.glb", height=64, width=96)
    sim = fake_habitat["sim"]
    assert sim.config.SCENE == "scenes/h/h.glb" and sim.did_reset
    assert set(sim.config.AGENT_0.SENSORS) == {
        "RGB_SENSOR", "DEPTH_SENSOR", "SEMANTIC_SENSOR"}
    assert sim.config.RGB_SENSOR.HEIGHT == 64
    assert r.depth_scale == 10.0
    r.set_agent_state([1.0, 0.5, -2.0], [0.1, np.pi / 2, 0.0])
    pos, quat = sim.states[-1]
    assert pos == [1.0, 0.5, -2.0]
    np.testing.assert_allclose(quat, heading_to_quaternion(np.pi / 2),
                               atol=1e-12)
    r.set_agent_state([0, 0, 0], [0.0, 1.0, 0.0, 0.0])
    assert sim.states[-1][1] == [0.0, 1.0, 0.0, 0.0]
    np.testing.assert_allclose(r.get_sensor_pos(), [0, 1.25, 0])
    np.testing.assert_allclose(r.get_sensor_ori(), [0.0, 1.0, 0.0, 0.0])
    rgb = r.render_rgb()
    assert rgb.shape == (64, 96, 3) and rgb.dtype == np.uint8
    assert r.render_depth().shape == (64, 96)
    # bed -> lvis 0 -> class 1; shelving (USE_FINE) -> lvis 10 -> 11
    assert set(np.unique(r.render_semantic())) == {0, 1, 11}
    by_id = {b["id"]: b for b in r.render_boxes()}
    assert set(by_id) == {0, 10}
    x0, y0, x1, y1 = by_id[0]["box"]
    assert (x0, y0, x1, y1) == (96 // 8, 64 // 4, 96 // 2 - 1, 64 // 2 - 1)
    assert by_id[0]["bbox"] == [x0, y0, x1 - x0, y1 - y0]
    assert r.sample_navigable_point() == [0.0, 0.5, 0.0]
    assert r.step(2) == {"action": 2}
    r.close()
    assert sim.closed


def test_habitat_renderer_through_build_data_vs_jax(fake_habitat,
                                                    tmp_path):
    """`build_sample_h5` drives the habitat adapter as the synthetic one:
    the sensor pose, the depth scaled by MAX_DEPTH; the outputs equal to
    the JAX package's adapter and builder on the same fake."""
    from embodied_object_detection_tpu.data.build_data import (
        build_sample_h5 as jax_build)
    from embodied_object_detection_tpu.data.habitat_renderer import (
        HabitatRenderer as JaxHabitat)
    from embodied_object_detection_tpu_torch.data.habitat_renderer import (
        HabitatRenderer)
    pos = np.tile(np.asarray([[0.0, 1.0, 0.0]], F32), (3, 1))
    rot = np.asarray([[0.0, 0.3 * i, 0.0] for i in range(3)], F32)
    a, b = tmp_path / "port" / "env_0.h5", tmp_path / "jax" / "env_0.h5"
    tbd.build_sample_h5(HabitatRenderer("h.glb", 64, 96), pos, rot, str(a),
                        min_box_edge=5, jpeg_dir="", device="cpu")
    jax_build(JaxHabitat("h.glb", 64, 96), pos, rot, str(b), min_box_edge=5,
              jpeg_dir="")
    got, _ = _hold_sensor(a, b)
    assert sorted(eval(got["detection_data"][0])["gt_classes"]) == [0, 10]
    # the sensor 1.25 m above the agent, depth 0.2 x 10 m ahead
    np.testing.assert_allclose(got["sensor_positions"][:, 1], 2.25)


def test_build_data_cli_habitat_backend(fake_habitat, tmp_path):
    paths = {"houseA_0": {"positions": [[0.0, 1.0, 0.0]] * 4,
                          "orientations": [[0.0, 0.2 * i, 0.0]
                                           for i in range(4)]}}
    pj = tmp_path / "paths.json"
    pj.write_text(json.dumps(paths))
    out = tmp_path / "out"
    out.mkdir()
    tbd.main(["--paths-json", str(pj), "--output-dir", str(out),
              "--renderer", "habitat", "--scene-data-path", str(tmp_path),
              "--samples-per-env", "1", "--frames-per-sample", "3",
              "--device", "cpu"])
    sim = fake_habitat["sim"]
    assert sim.config.SCENE == str(tmp_path / "habitat_data" / "v1" /
                                   "tasks" / "mp3d" / "houseA" /
                                   "houseA.glb")
    assert sim.closed
    assert _h5(out / "houseA_0_0.h5")["rgb"].shape == (3, 480, 640, 3)


# ------------------------------------------------------------ vector env

class CounterEnv:
    def __init__(self, base):
        self.base = base
        self.t = 0

    def reset(self):
        self.t = 0
        return self.base

    def step(self, action):
        self.t += 1
        return self.base + self.t * action

    def get_state(self):
        return (self.base, self.t)


class CounterEnvFactory:
    def __init__(self, base):
        self.base = base

    def __call__(self):
        return CounterEnv(self.base)


class GymTupleEnv:
    """(obs, reward, done, info), done every 2 steps."""

    def __init__(self):
        self.t = 0
        self.label = "gym"

    def reset(self):
        self.t = 0
        return {"t": 0}

    def step(self, action):
        self.t += 1
        return ({"t": self.t}, 1.0, self.t >= 2, {"steps": self.t})


class BigObsEnvFactory:
    """step returns 2 MB (beyond a pipe's buffer); close() writes a
    sentinel file in the worker."""

    def __init__(self, sentinel):
        self.sentinel = sentinel

    def __call__(self):
        return self

    def reset(self):
        return 0

    def step(self, action):
        return np.zeros(2 * 1024 * 1024, np.uint8)

    def close(self):
        with open(self.sentinel, "w") as f:
            f.write("closed")


@pytest.mark.parametrize("cls", [VectorEnv, ThreadedVectorEnv])
def test_vector_env_reset_step_call(cls):
    with cls([CounterEnvFactory(i * 100) for i in range(3)]) as envs:
        assert envs.num_envs == 3
        assert envs.reset() == [0, 100, 200]
        assert envs.step([1, 2, 3]) == [1, 102, 203]
        assert envs.step([1, 2, 3]) == [2, 104, 206]
        assert envs.call("get_state") == [(0, 2), (100, 2), (200, 2)]
        assert envs.call("base") == [0, 100, 200]


@pytest.mark.parametrize("cls", [VectorEnv, ThreadedVectorEnv])
def test_vector_env_async_step_and_pause(cls):
    envs = cls([CounterEnvFactory(i * 100) for i in range(3)])
    envs.reset()
    envs.async_step([1, 1, 1])
    assert envs.wait_step() == [1, 101, 201]
    envs.pause_at(1)
    assert envs.num_envs == 2
    assert envs.step([1, 1]) == [2, 202]
    envs.resume_all()
    assert envs.num_envs == 3
    assert envs.step([1, 1, 1]) == [3, 102, 203]
    envs.close()


@pytest.mark.parametrize("start_method", ["fork", "spawn", "forkserver"])
def test_vector_env_start_methods(start_method):
    with VectorEnv([CounterEnvFactory(i * 100) for i in range(2)],
                   start_method=start_method) as envs:
        assert envs.reset() == [0, 100]
        assert envs.step([2, 2]) == [2, 102]
        assert envs.call("get_state", [((), {}), ((), {})]) == \
            [(0, 1), (100, 1)]


@pytest.mark.parametrize("cls", [VectorEnv, ThreadedVectorEnv])
def test_vector_env_auto_reset(cls):
    envs = cls([GymTupleEnv for _ in range(2)], auto_reset_done=True)
    envs.reset()
    envs.step([0, 0])
    obs, reward, done, info = envs.step([0, 0])[0]
    assert done and obs == {"t": 0} and info == {"steps": 2}
    obs, _, done2, _ = envs.step([0, 0])[0]
    assert obs == {"t": 1} and not done2
    envs.close()
    plain = cls([GymTupleEnv])
    plain.reset()
    plain.step([0])
    assert plain.step([0])[0][0] == {"t": 2}
    plain.close()


def test_vector_env_close_drains_an_inflight_step(tmp_path):
    sentinels = [str(tmp_path / f"closed_{i}") for i in range(2)]
    envs = VectorEnv([BigObsEnvFactory(s) for s in sentinels])
    envs.reset()
    envs.async_step([0, 0])
    t0 = time.monotonic()
    envs.close()
    assert time.monotonic() - t0 < 4.0
    for s in sentinels:
        deadline = time.monotonic() + 2.0
        while not os.path.exists(s) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert os.path.exists(s)
