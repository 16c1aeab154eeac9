"""Slice 18, PPO on the PointNav policies: the port's `rl/policy.py`,
`rollout.py`, `ppo.py`, `trainer.py`, `agents.py`, `convert.py`,
`ddppo.py` (its host utilities) and `run.py` against the JAX package's.

Tolerances: policy outputs within 1e-5 (absolute, on values of order 1);
GAE within 1e-6 relative; after a PPO update every parameter tensor
within 1e-5 of its largest magnitude and the losses within 1e-5. JAX
weights cross through `convert.from_jax.load_jax_params`; each JAX
function is jitted once.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embodied_object_detection_tpu.rl import agents as jagents
from embodied_object_detection_tpu.rl import convert as jconvert
from embodied_object_detection_tpu.rl import nav as jnav
from embodied_object_detection_tpu.rl.policy import PointNavPolicy as JPolicy
from embodied_object_detection_tpu.rl.ppo import PPOConfig as JPPOConfig
from embodied_object_detection_tpu.rl.ppo import make_ppo as jmake_ppo
from embodied_object_detection_tpu.rl.rollout import compute_gae as jgae
from embodied_object_detection_tpu_torch.convert.from_jax import (
    load_jax_params)
from embodied_object_detection_tpu_torch.rl import agents as tagents
from embodied_object_detection_tpu_torch.rl import convert as tconvert
from embodied_object_detection_tpu_torch.rl import ddppo as tddppo
from embodied_object_detection_tpu_torch.rl import nav as tnav
from embodied_object_detection_tpu_torch.rl.policy import PointNavPolicy
from embodied_object_detection_tpu_torch.rl.ppo import PPO, PPOConfig
from embodied_object_detection_tpu_torch.rl.rollout import compute_gae
from embodied_object_detection_tpu_torch.rl.trainer import (
    PPOTrainer, PPOTrainerConfig)

GOAL = "pointgoal_with_gps_compass"
IMAGE_HW = (44, 44)       # SimpleCNN's last map is 2 x 2 x 32 here
T = torch.from_numpy


def random_tree(shapes, rng):
    """Seeded parameters of the JAX tree `shapes` (from `jax.eval_shape`
    of the model's init, so that no init is compiled): kernels
    normal / sqrt(fan-in), embeddings normal, GroupNorm scales 1 + 0.1
    normal, biases 0.1 normal."""
    def leaf(path, v):
        name = path[-1].key
        x = rng.randn(*v.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(v.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * x
        return x if name == "embedding" else 0.1 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _obs(rng, lead, blind):
    obs = {GOAL: rng.randn(*lead, 2).astype(np.float32)}
    if not blind:
        obs["rgb"] = rng.randint(0, 256, lead + IMAGE_HW + (3,)).astype(
            np.float32)
    return obs


def _policies(blind, hidden=32, seed=0):
    """(JAX policy, seeded params, the port's policy holding them)."""
    jpol = JPolicy(dim_actions=4, hidden_size=hidden, blind=blind)
    rng = np.random.RandomState(seed)
    obs = {k: jnp.asarray(v) for k, v in _obs(rng, (2,), blind).items()}
    params = random_tree(jax.eval_shape(
        jpol.init, jax.random.PRNGKey(seed), obs, jnp.zeros((2, hidden)),
        jnp.ones((2,))), rng)
    tpol = PointNavPolicy(4, hidden, blind, image_hw=IMAGE_HW)
    tpol.load_state_dict(load_jax_params(params))
    return jpol, params, tpol


def _close(got, want, atol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("blind", [True, False])
def test_policy_vs_jax(blind):
    """act (deterministic), get_value and evaluate_actions."""
    jpol, params, tpol = _policies(blind)
    rng = np.random.RandomState(1)
    n, steps, hidden = 3, 5, 32
    obs = _obs(rng, (n,), blind)
    h = rng.randn(n, hidden).astype(np.float32)
    masks = np.asarray([1.0, 0.0, 1.0], np.float32)
    prev = np.zeros(n, np.int32)

    @jax.jit
    def j_all(p, obs, h, masks, seq_obs, seq_masks, actions):
        act = jpol.apply(p, obs, h, prev, masks, jax.random.PRNGKey(0), True,
                         method=JPolicy.act)
        value = jpol.apply(p, obs, h, prev, masks, method=JPolicy.get_value)
        ev = jpol.apply(p, seq_obs, h, actions, seq_masks, actions,
                        method=JPolicy.evaluate_actions)
        return act, value, ev

    seq_obs = _obs(rng, (steps, n), blind)
    seq_masks = (rng.rand(steps, n) > 0.3).astype(np.float32)
    actions = rng.randint(0, 4, (steps, n))
    (jv, ja, jlp, jh), jval, (jvals, jlps, jent) = j_all(
        params, obs, h, masks, seq_obs, seq_masks, actions)

    tobs = {k: T(v) for k, v in obs.items()}
    with torch.no_grad():
        tv, ta, tlp, th = tpol.act(tobs, T(h), T(prev), T(masks),
                                   deterministic=True)
        tval = tpol.get_value(tobs, T(h), T(prev), T(masks))
        tvals, tlps, tent = tpol.evaluate_actions(
            {k: T(v) for k, v in seq_obs.items()}, T(h), T(actions),
            T(seq_masks), T(actions))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for got, want, what in ((tv, jv, "value"), (tlp, jlp, "log_prob"),
                            (th, jh, "hidden"), (tval, jval, "get_value"),
                            (tvals, jvals, "values"), (tlps, jlps, "lps"),
                            (tent, jent, "entropy")):
        _close(got, want, what=what)


def test_sampled_actions_follow_the_policy():
    """Gumbel-max draws from a torch.Generator: seeded, and distributed
    as the softmax."""
    from embodied_object_detection_tpu_torch.rl.policy import sample_actions
    logits = torch.tensor([[2.0, 0.0, -1.0, 0.5]]).repeat(20000, 1)
    a = sample_actions(logits, torch.Generator().manual_seed(3))
    b = sample_actions(logits, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=4).double() / a.numel()
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0].double(), 0).numpy(),
                               atol=0.015)


@pytest.mark.parametrize("use_gae", [True, False])
def test_gae_vs_jax(use_gae):
    rng = np.random.RandomState(2)
    steps, n = 13, 5
    rewards = rng.randn(steps, n).astype(np.float32)
    values = rng.randn(steps + 1, n).astype(np.float32)
    masks = (rng.rand(steps + 1, n) > 0.2).astype(np.float32)
    want = np.asarray(jgae(jnp.asarray(rewards), jnp.asarray(values),
                           jnp.asarray(masks), 0.99, 0.95, use_gae=use_gae))
    got = compute_gae(T(rewards), T(values), T(masks), 0.99, 0.95,
                      use_gae=use_gae).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _batch(rng, steps=8, n=4, hidden=32):
    return {
        "observations": {GOAL: rng.randn(steps, n, 2).astype(np.float32)},
        "hidden0": rng.randn(n, hidden).astype(np.float32),
        "actions": rng.randint(0, 4, (steps, n)),
        "prev_actions": rng.randint(0, 4, (steps, n)),
        "value_preds": rng.randn(steps, n).astype(np.float32),
        "returns": rng.randn(steps, n).astype(np.float32),
        "masks": (rng.rand(steps, n) > 0.2).astype(np.float32),
        "old_log_probs": (np.log(0.25) + 0.3 * rng.randn(steps, n)).astype(
            np.float32),
    }


def _torch_batch(b):
    return {k: ({kk: T(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else T(v)) for k, v in b.items()}


def _jax_perms(key, cfg, n):
    """The minibatch env indices the JAX `make_ppo` update draws from
    `key`."""
    keys = jax.random.split(key, cfg.ppo_epoch)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in keys])
    return perms.reshape(cfg.ppo_epoch * cfg.num_mini_batch,
                         n // cfg.num_mini_batch)


def _hold_params(tpol, jparams, what):
    want = load_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    got = tpol.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= 1e-5 * max(float(w.abs().max()), 1e-30), \
            f"{what}: {k} off by {err}"


def _run_updates(kw, updates, seed):
    """`updates` PPO updates of the blind policy, JAX's (one jit) and the
    port's on JAX's permutations; both held after each update."""
    jpol, params, tpol = _policies(True, seed=seed)
    jcfg, tcfg = JPPOConfig(**kw), PPOConfig(**kw)

    def evaluate_actions(p, obs, h0, prev, masks, actions):
        return jpol.apply(p, obs, h0, prev, masks, actions,
                          method=JPolicy.evaluate_actions)

    init_state, update = jmake_ppo(evaluate_actions, jcfg)
    state, jupdate = init_state(params), jax.jit(update)
    ppo = PPO(tpol, tcfg)
    batch = _batch(np.random.RandomState(seed))
    norms = []
    for i in range(updates):
        key = jax.random.PRNGKey(10 + i)
        state, jm = jupdate(state, jax.tree_util.tree_map(jnp.asarray, batch),
                            key)
        tm = ppo.update(_torch_batch(batch),
                        mb_indices=T(_jax_perms(key, jcfg, 4)))
        _hold_params(tpol, state.params, f"update {i}")
        for k in ("value_loss", "action_loss", "dist_entropy"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * max(1.0, abs(float(jm[k]))), (i, k)
        norms.append(ppo.last_grad_norm)
    assert ppo.count == updates * kw["ppo_epoch"] * kw["num_mini_batch"]
    assert ppo.update_idx == int(state.update_idx) == updates
    return norms


def test_one_ppo_update_vs_jax():
    """T=8, N=4, E=2, M=2, hidden 32, on the permutations JAX draws."""
    _run_updates(dict(ppo_epoch=2, num_mini_batch=2, lr=1e-3), 1, seed=3)


def test_decay_and_clipping_vs_jax():
    """Three updates with the linear lr and clip decays on, and a gradient
    norm above max_grad_norm (the global-norm clip acts)."""
    norms = _run_updates(dict(ppo_epoch=2, num_mini_batch=2, lr=1e-2,
                              max_grad_norm=0.05, use_linear_lr_decay=True,
                              use_linear_clip_decay=True, num_updates=4),
                         3, seed=4)
    assert min(norms) > 0.05


def _habitat_state_dict(blind, hidden=32, seed=5):
    """A synthetic reference PointNavBaselinePolicy state dict (the layout
    of habitat's checkpoints), as torch modules build it."""
    torch.manual_seed(seed)
    sd = {}
    gru = torch.nn.GRU(2 if blind else hidden + 2, hidden)
    parts = {"net.state_encoder.rnn": gru,
             "action_distribution.linear": torch.nn.Linear(hidden, 4),
             "critic.fc": torch.nn.Linear(hidden, 1)}
    if not blind:
        parts["net.visual_encoder.cnn"] = torch.nn.Sequential(
            torch.nn.Conv2d(3, 32, 8, 4), torch.nn.ReLU(),
            torch.nn.Conv2d(32, 64, 4, 2), torch.nn.ReLU(),
            torch.nn.Conv2d(64, 32, 3, 1), torch.nn.Flatten(),
            torch.nn.Linear(32 * 2 * 2, hidden))
    for prefix, m in parts.items():
        for k, v in m.state_dict().items():
            sd[f"actor_critic.{prefix}.{k}"] = v.detach().numpy() + \
                (0.05 if k.endswith("bias") else 0.0)
    return sd


@pytest.mark.parametrize("blind", [True, False])
def test_habitat_checkpoint_vs_jax(blind, tmp_path):
    """Both packages' converters on one reference state dict give equal
    outputs; the RGB fc goes in without reordering its CHW columns (the
    JAX package's divergence from the reference, reproduced): loading it
    reordered to HWC would change the outputs."""
    sd = _habitat_state_dict(blind)
    jpol = JPolicy(dim_actions=4, hidden_size=32, blind=blind)
    jparams = jconvert.convert_pointnav_policy(sd, blind=blind)
    path = tmp_path / "habitat.pth"
    torch.save({"state_dict": {k: T(v) for k, v in sd.items()}}, path)
    tsd = tconvert.load_habitat_checkpoint(str(path), blind=blind)
    tpol = PointNavPolicy(4, 32, blind, image_hw=IMAGE_HW)
    tpol.load_state_dict(tsd)

    rng = np.random.RandomState(6)
    obs = _obs(rng, (4, 3), blind)
    h = rng.randn(3, 32).astype(np.float32)
    masks = np.ones((4, 3), np.float32)
    actions = rng.randint(0, 4, (4, 3))
    want = jax.jit(lambda p, o: jpol.apply(
        p, o, h, actions, masks, actions,
        method=JPolicy.evaluate_actions))(jparams, obs)
    with torch.no_grad():
        got = tpol.evaluate_actions({k: T(v) for k, v in obs.items()}, T(h),
                                    T(actions), T(masks), T(actions))
    for g, w in zip(got, want):
        _close(g, w)
    if not blind:
        w = sd["actor_critic.net.visual_encoder.cnn.6.weight"]
        hwc = w.reshape(-1, 32, 2, 2).transpose(0, 2, 3, 1).reshape(
            w.shape[0], -1)
        tpol.load_state_dict(dict(tsd, **{
            "net.SimpleCNN_0.Dense_0.weight": T(np.ascontiguousarray(hwc))}))
        with torch.no_grad():
            moved = tpol.evaluate_actions(
                {k: T(v) for k, v in obs.items()}, T(h), T(actions),
                T(masks), T(actions))[0]
        assert float((moved - got[0]).abs().max()) > 1e-3


def _env_fn(i, scene="ck", steps=10):
    return tnav.make_nav_rl_env(scene_ids=(scene,), episodes_per_scene=2,
                                seed=i, max_episode_steps=steps)


def test_trainer_checkpoint_agent_and_benchmark(tmp_path):
    """Two updates, a checkpoint, then a PPOAgent from it (and from a
    habitat checkpoint) through Benchmark on the CPU."""
    cfg = PPOTrainerConfig(num_envs=2, num_steps=8, num_updates=2,
                           hidden_size=32,
                           ppo=PPOConfig(ppo_epoch=1, num_mini_batch=1),
                           checkpoint_folder=str(tmp_path),
                           checkpoint_interval=1)
    trainer = PPOTrainer(cfg, _env_fn, device="cpu")
    log = trainer.train()
    assert [r["update"] for r in log] == [0, 1]
    assert all(np.isfinite(r["value_loss"]) for r in log)
    assert (tmp_path / "ckpt.1.pkl").exists()
    stats = trainer.evaluate(_env_fn(9, "ev", 12), num_episodes=2,
                             max_steps=12)
    assert np.isfinite(stats["reward"])
    path = trainer.save_checkpoint("final.pkl")
    trainer.close()

    policy = PointNavPolicy(4, 32, blind=True)
    agent = tagents.PPOAgent.from_checkpoint(path, policy, device="cpu")
    env = _env_fn(5)
    assert "success" in tagents.Benchmark(env.habitat_env).evaluate(
        agent, num_episodes=1)
    torch.save({"state_dict": {k: T(v) for k, v in
                               _habitat_state_dict(True).items()}},
               tmp_path / "h.pth")
    agent = tagents.PPOAgent.from_habitat_checkpoint(
        str(tmp_path / "h.pth"), PointNavPolicy(4, 32, blind=True),
        deterministic=True, device="cpu")
    assert "spl" in tagents.Challenge(env.habitat_env).submit(
        agent, num_episodes=1)
    env.close()


@pytest.mark.parametrize("name", ["GoalFollower", "RandomAgent",
                                  "RandomForwardAgent", "ForwardOnlyAgent"])
def test_simple_agents_vs_jax(name):
    kw = dict(scene_ids=("bench0",), episodes_per_scene=3, seed=0,
              max_episode_steps=40)
    stats = []
    for nav, agents in ((jnav, jagents), (tnav, tagents)):
        env = nav.make_nav_rl_env(**kw)
        stats.append(agents.Benchmark(env.habitat_env).evaluate(
            getattr(agents, name)(seed=1) if name != "GoalFollower"
            else agents.GoalFollower(), num_episodes=3))
        env.close()
    assert stats[0] == stats[1]


def test_rl_cli_train_eval_and_card_refusal(tmp_path, capsys):
    from embodied_object_detection_tpu_torch.rl.run import main
    common = ["--num-envs", "2", "--hidden-size", "32",
              "--max-episode-steps", "10", "--cpu"]
    assert main(["--run-type", "train", "--num-steps", "8",
                 "--num-updates", "2", "--checkpoint-dir", str(tmp_path)]
                + common) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["update"] for r in rows] == [0, 1]
    ckpt = tmp_path / "ckpt.final.pkl"
    with open(ckpt, "rb") as f:
        assert pickle.load(f)["update_idx"] == 2
    assert main(["--run-type", "eval", "--eval-episodes", "1",
                 "--checkpoint", str(ckpt)] + common) == 0
    assert "distance_to_goal" in json.loads(
        capsys.readouterr().out.splitlines()[-1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--num-updates", "1"])


def test_preemption_save_and_resume(tmp_path, monkeypatch):
    """ddppo_trainer.py:150-180: EXIT -> the interrupted state is saved;
    the next train() resumes from its update, with its parameters, Adam
    state and update index."""
    state_file = str(tmp_path / "int.pkl")
    monkeypatch.setattr(tddppo, "_interrupted_state_file",
                        lambda: state_file)
    cfg = PPOTrainerConfig(num_envs=2, num_steps=4, num_updates=3,
                           hidden_size=32,
                           ppo=PPOConfig(ppo_epoch=1, num_mini_batch=1,
                                         use_linear_clip_decay=True))

    def env_fn(i):
        return _env_fn(i, "pre", 8)

    t1 = PPOTrainer(cfg, env_fn, device="cpu")
    t1.train(num_updates=1)
    tddppo.EXIT.set()
    try:
        assert t1.train(handle_preemption=True) == t1.metrics_log
    finally:
        tddppo.EXIT.clear()
    t1.close()
    saved = tddppo.load_interrupted_state(state_file)
    assert saved["update"] == 0 and saved["opt_state"]["count"] == 1
    saved["update"] = 2
    tddppo.save_interrupted_state(saved, state_file)

    t2 = PPOTrainer(cfg, env_fn, device="cpu")
    assert t2._resume() == 2 and not os.path.exists(state_file)
    assert t2.ppo.update_idx == 2 and t2.ppo.count == 1
    for k, v in t2.policy.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved["params"][k])
    tddppo.save_interrupted_state(saved, state_file)
    log = t2.train(handle_preemption=True)
    t2.close()
    assert [r["update"] for r in log] == [2] and t2.ppo.update_idx == 3


def test_interrupted_state_and_rollout_store(tmp_path):
    f = str(tmp_path / "int.pkl")
    tddppo.save_interrupted_state({"params": {"w": torch.arange(4.0)},
                                   "step": 7}, f)
    back = tddppo.load_interrupted_state(f)
    assert back["step"] == 7
    np.testing.assert_array_equal(back["params"]["w"], np.arange(4.0))
    assert tddppo.load_interrupted_state(str(tmp_path / "none.pkl")) is None
    store = tddppo.NumRolloutsDoneStore(str(tmp_path / "ctr"))
    store.add(1), store.add(2)
    assert store.get() == 3
    store.reset()
    assert store.get() == 0
