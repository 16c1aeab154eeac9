"""Slice 18, the RL stack's host modules: the port's copies of `rl/core.py`,
`sim.py`, `nav.py`, `tasks.py`, `habitat_sim.py`, `stream_sim.py` and
`config.py` against the JAX package's, on the same seeds and actions.

Equality is exact (numpy): episodes, observations, rewards, done flags
and measures. No JAX model is built here.
"""

import numpy as np
import pytest

from embodied_object_detection_tpu.rl import config as jcfg
from embodied_object_detection_tpu.rl import core as jcore
from embodied_object_detection_tpu.rl import nav as jnav
from embodied_object_detection_tpu.rl import sim as jsim
from embodied_object_detection_tpu.rl import stream_sim as jstream
from embodied_object_detection_tpu.rl import tasks as jtasks
from embodied_object_detection_tpu_torch.rl import config as tcfg
from embodied_object_detection_tpu_torch.rl import core as tcore
from embodied_object_detection_tpu_torch.rl import nav as tnav
from embodied_object_detection_tpu_torch.rl import sim as tsim
from embodied_object_detection_tpu_torch.rl import stream_sim as tstream
from embodied_object_detection_tpu_torch.rl import tasks as ttasks

from test_rl_habitat_sim import fake_habitat  # noqa: F401  (fixture)


def _same(a, b, where=""):
    """Exact equality of nested observations / infos."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


def _roll(env, actions):
    """Reset, then step through `actions` (resetting at each done):
    [(obs, reward, done, info), ...]."""
    out = [(env.reset(), 0.0, False, {})]
    for a in actions:
        obs, r, done, info = env.step(int(a))
        out.append((obs, r, done, info))
        if done:
            out.append((env.reset(), 0.0, False, {}))
    return out


@pytest.mark.parametrize("seed,with_rgb", [(0, False), (3, True),
                                           (7, False)])
def test_nav_env_episodes_equal(seed, with_rgb):
    """Seeded PointNav envs step through the same actions: the same
    episodes, observations (incl. the raycast RGB), rewards and measures."""
    kw = dict(scene_ids=(f"pscene{seed}", f"qscene{seed}"),
              episodes_per_scene=3, seed=seed, max_episode_steps=25,
              with_rgb=with_rgb, image_hw=(16, 24))
    actions = np.random.RandomState(seed).randint(0, 4, 60)
    actions[actions == 0] = 1                 # few STOPs: long episodes
    actions[::23] = 0
    jenv, tenv = jnav.make_nav_rl_env(**kw), tnav.make_nav_rl_env(**kw)
    for i, (j, t) in enumerate(zip(_roll(jenv, actions),
                                   _roll(tenv, actions))):
        _same(j, t, f"step {i}")
    je, te = jenv.habitat_env.episodes, tenv.habitat_env.episodes
    assert [e.episode_id for e in je] == [e.episode_id for e in te]
    for a, b in zip(je, te):
        _same(a.start_position, b.start_position)
        assert a.start_rotation == b.start_rotation and a.info == b.info
    jenv.close(), tenv.close()


def test_sim_depth_and_geodesics_equal():
    ep = dict(episode_id="e", scene_id="dscene",
              start_position=np.array([6.0, 6.4], np.float32),
              start_rotation=0.3)
    js, ts = jsim.GridSimulator(image_hw=(12, 20)), \
        tsim.GridSimulator(image_hw=(12, 20))
    js.reset(jcore.Episode(**ep)), ts.reset(tcore.Episode(**ep))
    for act in (lambda s: s.move_forward(), lambda s: s.turn(1),
                lambda s: s.move_forward(), lambda s: s.turn(-1)):
        act(js), act(ts)
        _same(js.render_depth(), ts.render_depth())
        _same(js.render_rgb(), ts.render_rgb())
        assert js.previous_step_collided == ts.previous_step_collided
    a, b = np.array([2.0, 3.0], np.float32), np.array([9.0, 8.5], np.float32)
    assert js.geodesic_distance(a, b) == ts.geodesic_distance(a, b)


@pytest.mark.parametrize("kind", ["objectnav", "eqa", "vln"])
def test_task_variants_equal(kind):
    """ObjectNav / EQA / VLN datasets and episodes from both packages."""
    task, make = {
        "objectnav": ("ObjectNavigationTask", "make_objectnav_dataset"),
        "eqa": ("EQATask", "make_eqa_dataset"),
        "vln": ("VLNTask", "make_vln_dataset")}[kind]
    rolls = []
    for core, sim, tasks in ((jcore, jsim, jtasks), (tcore, tsim, ttasks)):
        s = sim.GridSimulator(render_rgb=False)
        ds = getattr(tasks, make)(s, ["tscene1"], episodes_per_scene=3)
        env = core.Env(getattr(tasks, task).build(s), ds,
                       max_episode_steps=12, seed=0)
        rolls.append([(o, env.get_metrics()) for o in
                      [env.reset()] + [env.step(a) for a in (1, 2, 1, 3, 1)]])
        env.close()
    _same(rolls[0], rolls[1])


def test_config_and_env_factory_equal():
    opts = ["simulator.image_height=16", "simulator.image_width=16",
            "simulator.rgb_sensor=true", "simulator.depth_sensor=true",
            "rl.ppo.lr=0.001", "rl.ppo.ppo_epoch=3",
            "dataset.scenes=cfga,cfgb", "environment.max_episode_steps=9"]
    jc, tc = jcfg.get_config(opts), tcfg.get_config(opts)
    assert tc.rl.ppo.lr == jc.rl.ppo.lr == 0.001
    assert tc.rl.ppo.ppo_epoch == 3 and tc.dataset.scenes == ("cfga", "cfgb")
    je, te = jcfg.make_env_from_config(jc, 1), tcfg.make_env_from_config(tc, 1)
    actions = [1, 1, 2, 1, 3, 1, 1, 1, 1, 1, 2]
    for i, (j, t) in enumerate(zip(_roll(je, actions), _roll(te, actions))):
        _same(j, t, f"step {i}")


def _stream_run(core, nav, stream):
    sent = []
    sim = stream.StreamSimulator(image_hw=(8, 8), action_sink=sent.append,
                                 frame_timeout_s=1.0)
    ep = core.Episode("e0", "robot", np.array([0.0, 0.0], np.float32), 0.0,
                      info={"goal": [1.0, 0.0]})
    task = nav.NavigationTask.build(
        sim, sensors=[nav.IntegratedPointGoalGPSAndCompassSensor()])
    env = core.Env(task, core.Dataset([ep]), max_episode_steps=10)
    out = []
    for pos, action in (([0.0, 0.0], None), ([0.25, 0.0], 1),
                        ([0.6, 0.1], 2), ([0.95, 0.0], 1)):
        sim.feed(rgb=np.zeros((8, 8, 3), np.uint8),
                 depth=np.ones((8, 8), np.float32),
                 position=np.asarray(pos, np.float32), heading=0.0)
        out.append(env.reset() if action is None else env.step(action))
    env.step(0)
    out.append(env.get_metrics())
    env.close()
    return out, sent


def test_stream_sim_equal():
    j, t = _stream_run(jcore, jnav, jstream), _stream_run(tcore, tnav,
                                                          tstream)
    _same(j[0], t[0])
    assert j[1] == t[1] and len(j[1]) >= 3


def test_habitat_sim_adapter_equal(fake_habitat):  # noqa: F811
    """The PointNav stack over the habitat-sim adapter (a fake `habitat`
    module), both packages on the same actions."""
    from embodied_object_detection_tpu.rl.habitat_sim import HabitatSim as J
    from embodied_object_detection_tpu_torch.rl.habitat_sim import (
        HabitatSim as T)
    rolls = []
    for core, nav, cls in ((jcore, jnav, J), (tcore, tnav, T)):
        sim = cls("scenes/x.glb", height=16, width=24)
        eps = [core.Episode(episode_id=str(i), scene_id="scenes/x.glb",
                            start_position=np.asarray([0.0, 0.5], np.float32),
                            start_rotation=0.2,
                            info={"goal": [1.0, -0.5],
                                  "geodesic_distance": 1.2})
               for i in range(2)]
        env = core.Env(nav.NavigationTask.build(sim), core.Dataset(eps),
                       max_episode_steps=20, seed=0)
        rolls.append([env.reset()] + [
            (env.step(a), env.get_metrics()) for a in (2, 1, 1, 3, 1, 0)])
        env.close()
    _same(rolls[0], rolls[1])


def test_rl_env_in_port_subprocess_pool():
    """The port's nav env in the port's `VectorEnv` worker processes (the
    counterpart of tests/test_vector_env.py::test_rl_env_in_subprocess_pool):
    the same observations as the same envs stepped in this process."""
    from embodied_object_detection_tpu_torch.data.vector_env import VectorEnv
    kw = [dict(scene_ids=(f"vp{i}",), episodes_per_scene=2, seed=i,
               max_episode_steps=5) for i in range(2)]
    envs = VectorEnv([lambda k=k: tnav.make_nav_rl_env(**k) for k in kw],
                     auto_reset_done=True)
    local = [tnav.make_nav_rl_env(**k) for k in kw]
    try:
        _same(envs.reset(), [e.reset() for e in local])
        for _ in range(6):
            results = envs.step([1, 2])
            want = []
            for e, a in zip(local, (1, 2)):
                obs, r, done, info = e.step(a)
                want.append((e.reset() if done else obs, r, done, info))
            _same([tuple(r) for r in results], want)
    finally:
        envs.close()
        for e in local:
            e.close()


def test_spaces_and_registry_equal():
    rng_j, rng_t = np.random.RandomState(4), np.random.RandomState(4)
    for make in (lambda m: m.Box(-1.0, 1.0, (3,)), lambda m: m.Discrete(5),
                 lambda m: m.DictSpace({"a": m.Box(0.0, 2.0, (2, 2)),
                                        "b": m.Discrete(3)})):
        _same(make(jcore).sample(rng_j), make(tcore).sample(rng_t))
    # the same names registered under each kind
    assert {k: sorted(v) for k, v in jcore.registry._store.items()} == \
        {k: sorted(v) for k, v in tcore.registry._store.items()}
