"""Slice 18, the vision side of the RL stack: the port's
`rl/resnet_policy.py`, `rl/monodepth.py` and `rl/slam.py` against the JAX
package's.

Tolerances: the ResNet policy's outputs within 1e-4 of JAX (absolute, on
values of order 1; flax's one-pass GroupNorm on both sides); MonoDepth's
depth within 1e-4 of the output's largest magnitude (f32 convolutions
summed in other orders); `depth2local3d` and `pcl_to_obstacles` bit-equal;
`plan_distance_field` within 1e-5 relative; the SLAM agent's actions
equal. Each JAX function is jitted once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_object_detection_tpu.rl import monodepth as jmono
from embodied_object_detection_tpu.rl import nav as jnav
from embodied_object_detection_tpu.rl import slam as jslam
from embodied_object_detection_tpu.rl.resnet_policy import (
    PointNavResNetPolicy as JResNetPolicy)
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.rl import monodepth as tmono
from embodied_object_detection_tpu_torch.rl import nav as tnav
from embodied_object_detection_tpu_torch.rl import slam as tslam
from embodied_object_detection_tpu_torch.rl.resnet_policy import (
    FlaxGroupNorm, PointNavResNetPolicy)

from test_monodepth import TorchMonoDepth, _randomize
from test_torch_slice18_ppo import random_tree

GOAL = "pointgoal_with_gps_compass"
T = torch.from_numpy


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_flax_group_norm_vs_flax():
    import flax.linen as nn
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 7, 12) * 3 + 2).astype(np.float32)     # NHWC
    scale = rng.rand(12).astype(np.float32) + 0.5
    bias = rng.randn(12).astype(np.float32)
    want = nn.GroupNorm(num_groups=4).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    gn = FlaxGroupNorm(4, 12)
    gn.load_state_dict({"weight": T(scale), "bias": T(bias)})
    with torch.no_grad():
        got = gn(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("backbone,hw,sensors", [
    ("resnet18", 32, ("rgb",)), ("resnet50", 32, ("rgb",)),
    ("resnet18", 64, ("rgb", "depth"))])
def test_resnet_policy_vs_jax(backbone, hw, sensors):
    """act (deterministic) and evaluate_actions at baseplanes 8, hidden 32
    (at 64 x 64 the compression map is 2 x 2: its HWC flatten counts)."""
    rng = np.random.RandomState(1)
    n, steps, hidden = 2, 3, 32

    def obs(lead):
        o = {GOAL: (rng.rand(*lead, 2) * [5, 6] - [0, 3]).astype(np.float32)}
        if "rgb" in sensors:
            o["rgb"] = rng.randint(0, 256, lead + (hw, hw, 3)).astype(
                np.float32)
        if "depth" in sensors:
            o["depth"] = rng.rand(*lead, hw, hw, 1).astype(np.float32)
        return o

    jpol = JResNetPolicy(dim_actions=4, hidden_size=hidden,
                         backbone=backbone, baseplanes=8)
    o1 = obs((n,))
    params = random_tree(jax.eval_shape(
        jpol.init, jax.random.PRNGKey(0), o1, jnp.zeros((n, hidden)),
        jnp.ones((n,))), rng)
    tpol = PointNavResNetPolicy(4, hidden, backbone, 8, sensors=sensors,
                                image_hw=(hw, hw))
    tpol.load_state_dict(load_jax_params(params))

    h = rng.randn(n, hidden).astype(np.float32)
    prev = np.asarray([0, 2], np.int32)
    masks = np.asarray([0.0, 1.0], np.float32)
    seq = obs((steps, n))
    seq_masks = (rng.rand(steps, n) > 0.3).astype(np.float32)
    actions = rng.randint(0, 4, (steps, n)).astype(np.int32)

    @jax.jit
    def j_all(p, o1, seq):
        act = jpol.apply(p, o1, h, prev, masks, jax.random.PRNGKey(0), True,
                         method=JResNetPolicy.act)
        ev = jpol.apply(p, seq, h, actions, seq_masks, actions,
                        method=JResNetPolicy.evaluate_actions)
        return act, ev

    (jv, ja, jlp, jh), (jvals, jlps, jent) = j_all(params, o1, seq)
    with torch.no_grad():
        tv, ta, tlp, th = tpol.act({k: T(v) for k, v in o1.items()}, T(h),
                                   T(prev), T(masks), deterministic=True)
        tvals, tlps, tent = tpol.evaluate_actions(
            {k: T(v) for k, v in seq.items()}, T(h), T(actions),
            T(seq_masks), T(actions))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for got, want in ((tv, jv), (tlp, jlp), (th, jh), (tvals, jvals),
                      (tlps, jlps), (tent, jent)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def monodepth_pair():
    """A synthetic reference checkpoint (the `module.E/D/MFF/R` naming of
    tests/test_monodepth.py) through both packages' converters."""
    ref = TorchMonoDepth()
    _randomize(ref, 3)
    sd = ref.reference_state_dict()
    jparams = jmono.convert_monodepth_torch(sd)
    net = tmono.MonoDepthNet(depths=(1, 1, 1, 1)).eval()
    net.load_state_dict(tmono.convert_monodepth_torch(sd))
    return jparams, net


def test_monodepth_net_vs_jax(monodepth_pair):
    jparams, net = monodepth_pair
    rng = np.random.RandomState(2)
    x = rng.randn(64, 96, 3).astype(np.float32)
    jnet = jmono.MonoDepthNet(depths=(1, 1, 1, 1))
    want = np.asarray(jax.jit(jnet.apply)(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = net(T(x)).numpy()
    assert got.shape == want.shape == (32, 48)
    assert _rel(got, want) < 1e-4
    # the JAX tree through load_jax_params gives the converter's weights
    again = tmono.MonoDepthNet(depths=(1, 1, 1, 1))
    again.load_state_dict(load_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams)))
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_monodepth_estimator_vs_jax(monodepth_pair):
    """Normalise, predict at half resolution, resize back (an upsample,
    as every resize of the net)."""
    jparams, net = monodepth_pair
    rgb = np.random.RandomState(3).randint(0, 256, (64, 96, 3)).astype(
        np.uint8)
    jest = jmono.MonoDepthEstimator(params=jparams, depths=(1, 1, 1, 1))
    want = jest.compute_depth(rgb)
    got = tmono.MonoDepthEstimator(net, device="cpu").compute_depth(rgb)
    assert got.shape == want.shape == (64, 96)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("h,w", [(48, 64), (228, 304)])
def test_depth2local3d_bit_equal(h, w):
    depth = (np.random.RandomState(h).rand(h, w) * 6 + 0.05).astype(
        np.float32)
    fx, fy = w / 2.0, h / 2.0
    cx, cy = int(fx) - 1, int(fy) - 1
    want = np.asarray(jslam.depth2local3d(jnp.asarray(depth), fx, fy, cx,
                                          cy))
    got = tslam.depth2local3d(T(depth), fx, fy, cx, cy).numpy()
    np.testing.assert_array_equal(got, want)


def test_pcl_to_obstacles_bit_equal():
    """Points on cell edges (round half to even on both sides), outside
    the map and masked; 127 x 127 cells of 0.1 m."""
    rng = np.random.RandomState(4)
    pts = (rng.randn(5000, 2) * 4).astype(np.float32)
    pts[:500] = np.round(pts[:500] * 20) / 20        # on cell edges
    pts[500:600] = 9.0                               # beyond the map
    weights = (rng.rand(5000) > 0.2).astype(np.float32)
    want = np.asarray(jslam.pcl_to_obstacles(
        jnp.asarray(pts), jnp.asarray(weights), 12.8, 0.1, 127))
    got = tslam.pcl_to_obstacles(T(pts), T(weights), 12.8, 0.1, 127)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 3000


def _depth_view():
    sim = jnav.GridSimulator(image_hw=(64, 64))
    from embodied_object_detection_tpu.rl.core import Episode
    sim.reset(Episode("e", "slamscene", np.array([1.5, 6.4], np.float32),
                      float(np.pi) - 0.3))
    return sim.render_depth()[..., 0]


def test_mapper_vs_jax():
    """The whole mapper on a rendered view (pose product, height filter,
    counts): equal counts."""
    depth = _depth_view()
    pose = np.eye(4, dtype=np.float32)
    pose[0, 0], pose[0, 2], pose[2, 0], pose[2, 2] = 0.3, 0.95, -0.95, 0.3
    pose[0, 3], pose[2, 3] = -4.9, 0.2
    jm = jslam.DirectDepthMapper(map_size_m=12.8, cell_m=0.1, far_th=10.0)
    tm = tslam.DirectDepthMapper(map_size_m=12.8, cell_m=0.1, far_th=10.0)
    want = np.asarray(jm(jnp.asarray(depth), jnp.asarray(pose)))
    got = tm(T(depth), T(pose)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_planner_vs_jax():
    rng = np.random.RandomState(5)
    obstacles = (rng.rand(40, 40) < 0.2).astype(np.float32)
    goal = np.zeros((40, 40), np.float32)
    goal[30, 7] = 1.0
    obstacles[30, 7] = 0.0
    want = np.asarray(jslam.plan_distance_field(jnp.asarray(obstacles),
                                                jnp.asarray(goal)))
    stats = {}
    got = tslam.plan_distance_field(T(obstacles), T(goal), stats=stats)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert 0 < stats["iterations"] < 500
    # never more host checks than blocks of 16 iterations (+ the last)
    assert stats["host_checks"] <= stats["iterations"] // 16 + 1
    path = tslam.trace_path(got.numpy(), (2, 35))
    np.testing.assert_array_equal(path, jslam.trace_path(want, (2, 35)))


def _slam_env(nav):
    env = nav.make_nav_rl_env(scene_ids=("slam0",), episodes_per_scene=4,
                              seed=0, max_episode_steps=20)
    task = env.habitat_env.task
    task.sensor_suite.sensors["depth"] = nav.DepthSensor(
        image_hw=env.habitat_env.sim.image_hw)
    task.sensor_suite.observation_spaces.spaces["depth"] = \
        task.sensor_suite.sensors["depth"].observation_space
    return env


def test_slam_agent_episode_vs_jax():
    """A seeded depth-sensor episode of at most 20 steps: the port's
    agent takes JAX's actions, on JAX's map."""
    runs = []
    for nav, slam, kw in ((jnav, jslam, {}), (tnav, tslam,
                                              {"device": "cpu"})):
        env = _slam_env(nav)
        agent = slam.DepthMapperAndPlannerAgent(env.habitat_env.sim, **kw)
        obs, actions = env.habitat_env.reset(), []
        agent.reset()
        while not env.habitat_env.episode_over:
            actions.append(agent.act(obs))
            obs = env.habitat_env.step(actions[-1])
        runs.append((actions, np.asarray(agent._obstacle_counts),
                     env.habitat_env.get_metrics()))
        env.close()
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) >= 5
    np.testing.assert_array_equal(runs[1][1], runs[0][1])
    assert runs[0][1].sum() > 0
    assert runs[0][2] == runs[1][2]


def _tf32_calls():
    """Each RL call that runs f32 convolutions or products, at a tiny
    size: (label, thunk)."""
    from embodied_object_detection_tpu_torch.rl.policy import PointNavPolicy
    from embodied_object_detection_tpu_torch.rl.ppo import PPO, PPOConfig
    from test_torch_slice18_ppo import _batch, _torch_batch
    rng = np.random.RandomState(18)
    obs = {GOAL: T(rng.randn(2, 2).astype(np.float32)),
           "rgb": T(rng.randint(0, 256, (2, 44, 44, 3)).astype(np.float32))}
    h, prev, masks = torch.zeros(2, 32), torch.zeros(2, dtype=torch.int64), \
        torch.ones(2)
    policy = PointNavPolicy(4, 32, blind=False, image_hw=(44, 44))
    resnet = PointNavResNetPolicy(4, 32, "resnet18", 8, image_hw=(32, 32))
    robs = {GOAL: obs[GOAL], "rgb": obs["rgb"][:, :32, :32]}
    net = tmono.MonoDepthNet(depths=(1, 1, 1, 1)).eval()
    mapper = tslam.DirectDepthMapper(map_size_m=12.8, cell_m=0.1)
    blind = PointNavPolicy(4, 32)
    return {
        "policy": lambda: policy.act(obs, h, prev, masks, deterministic=True),
        "resnet": lambda: resnet.act(robs, h, prev, masks,
                                     deterministic=True),
        "update": lambda: PPO(blind, PPOConfig(ppo_epoch=1)).update(
            _torch_batch(_batch(rng)), torch.Generator().manual_seed(0)),
        "monodepth": lambda: net(T(rng.randn(32, 64, 3).astype(np.float32))),
        "mapper": lambda: mapper(T(_depth_view()), torch.eye(4)),
    }


@pytest.mark.parametrize("call", ["policy", "resnet", "update", "monodepth",
                                  "mapper"])
def test_tf32_off_inside_rl_calls_only(call):
    """Under a caller's TF32 on, every convolution and product of an RL
    call (backward included) runs with both TF32 flags off, and the
    caller's flags are back when the call returns: the RL paths never pass
    through `build_detector`, and must not change other models' numerics.
    The flags are read on the CPU too, so this holds what the card sees."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in (
                    "convolution", "convolution_backward", "mm", "addmm",
                    "bmm"):
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))
            return func(*args, **(kwargs or {}))

    fn = _tf32_calls()[call]
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with Probe():
            fn()
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert seen and not any(any(flags) for flags in seen), seen
    assert after == (True, True)
