"""Slice 18, DD-PPO on `torch.distributed`: the port's `rl/ddppo.py`
update at world size 2 (gloo, two child processes) against world size 1.

This file is also its own child script: at the module's first test the
parent starts `python tests/test_torch_slice18_ddppo.py RANK PORT OUT`
for ranks 0 and 1 (one thread each, a 60 s rendezvous timeout), which
write OUT/rank_RANK.json; the parametrised tests read them. Each rank
holds half of the rollout's envs. Checks, each within 1e-6 of every
parameter tensor's largest magnitude:
  * one epoch and one minibatch: the update of the two ranks (gradients
    summed over the group and divided by 2, advantages normalised by the
    global mean and variance) equals world size 1's on all the envs;
  * two epochs of two minibatches on given indices, each rank's
    minibatch one of its envs, equals world size 1's minibatches of the
    two envs together;
  * the DD-PPO trainer keeps the ranks' parameters equal, and the CLI's
    `--distributed` trains over the same group.
In this process, a one-rank gloo group's update is bit-equal to the
plain update.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":      # a child: the repository on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from embodied_object_detection_tpu_torch.rl.ddppo import (  # noqa: E402
    make_ddppo)
from embodied_object_detection_tpu_torch.rl.policy import (  # noqa: E402
    PointNavPolicy)
from embodied_object_detection_tpu_torch.rl.ppo import (  # noqa: E402
    PPO, PPOConfig)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD_TIMEOUT_S = 240
N_ENVS, STEPS, HIDDEN = 4, 6, 32


def _batch(seed=7):
    rng = np.random.RandomState(seed)
    t = torch.from_numpy
    return {
        "observations": {"pointgoal_with_gps_compass": t(
            rng.randn(STEPS, N_ENVS, 2).astype(np.float32))},
        "hidden0": t(rng.randn(N_ENVS, HIDDEN).astype(np.float32)),
        "actions": t(rng.randint(0, 4, (STEPS, N_ENVS))),
        "prev_actions": t(rng.randint(0, 4, (STEPS, N_ENVS))),
        "value_preds": t(rng.randn(STEPS, N_ENVS).astype(np.float32)),
        "returns": t(rng.randn(STEPS, N_ENVS).astype(np.float32)),
        "masks": t((rng.rand(STEPS, N_ENVS) > 0.2).astype(np.float32)),
        "old_log_probs": t((np.log(0.25) + 0.3 * rng.randn(
            STEPS, N_ENVS)).astype(np.float32)),
    }


def _envs(batch, lo, hi):
    """The batch of envs lo..hi-1."""
    return {k: ({kk: vv[:, lo:hi] for kk, vv in v.items()}
                if isinstance(v, dict) else
                (v[lo:hi] if k == "hidden0" else v[:, lo:hi]))
            for k, v in batch.items()}


def _policy():
    """The blind policy with every parameter moved by 0.1 normal (no
    zero biases: a tensor's largest magnitude is not the update's)."""
    policy = PointNavPolicy(4, HIDDEN, blind=True, seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in policy.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return policy


def _update(cfg, batch, mb_indices, group):
    policy = _policy()
    ppo = make_ddppo(policy, cfg) if group else PPO(policy, cfg)
    metrics = ppo.update(batch, mb_indices=mb_indices)
    return policy.state_dict(), {k: float(v) for k, v in metrics.items()}


def _max_rel(got, want):
    return max(float((got[k] - w).abs().max()) /
               max(float(w.abs().max()), 1e-30) for k, w in want.items())


CASES = {
    # name: (config, world-1 minibatch indices, each rank's indices)
    "one_minibatch": (PPOConfig(ppo_epoch=1, num_mini_batch=1, lr=1e-3),
                      [[0, 1, 2, 3]], [[0, 1]]),
    "two_epochs_two_minibatches": (
        PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=1e-3,
                  max_grad_norm=0.05),
        [[0, 2], [1, 3], [1, 3], [0, 2]], [[0], [1], [1], [0]]),
}


def _child(rank, port, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    res = {}
    batch = _batch()
    half = N_ENVS // 2
    for name, (cfg, world1, local) in CASES.items():
        got, got_m = _update(cfg, _envs(batch, rank * half,
                                        (rank + 1) * half),
                             torch.tensor(local), dist.group.WORLD)
        want, want_m = _update(cfg, batch, torch.tensor(world1), None)
        res[f"{name}_params"] = _max_rel(got, want)
        res[f"{name}_losses"] = max(abs(got_m[k] - want_m[k]) /
                                    max(1.0, abs(want_m[k])) for k in want_m)

    # the DD-PPO trainer: one update on each rank's own envs
    from embodied_object_detection_tpu_torch.rl.nav import make_nav_rl_env
    from embodied_object_detection_tpu_torch.rl.trainer import (
        PPOTrainer, PPOTrainerConfig)
    cfg = PPOTrainerConfig(num_envs=2, num_steps=4, num_updates=1,
                           hidden_size=HIDDEN, distributed=True,
                           ppo=PPOConfig(ppo_epoch=2, num_mini_batch=2))
    trainer = PPOTrainer(cfg, lambda i: make_nav_rl_env(
        scene_ids=(f"dd{rank}",), episodes_per_scene=2, seed=2 * rank + i,
        max_episode_steps=6), device="cpu")
    row = trainer.train()[0]
    trainer.close()
    flat = torch.cat([p.detach().reshape(-1)
                      for p in trainer.policy.parameters()])
    both = [torch.zeros_like(flat) for _ in range(2)]
    dist.all_gather(both, flat)
    res["trainer_params_equal_across_ranks"] = float(
        not torch.equal(both[0], both[1]))
    res["trainer_losses_finite"] = float(not np.isfinite(row["value_loss"]))

    # the CLI over the same group (it destroys the group at its end)
    from embodied_object_detection_tpu_torch.rl.run import main
    rc = main(["--distributed", "--cpu", "--coordinator",
               f"127.0.0.1:{port}", "--num-envs", "4", "--num-steps", "4",
               "--num-updates", "1", "--hidden-size", str(HIDDEN),
               "--max-episode-steps", "6"])
    res["cli_returncode"] = float(rc)
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


# ------------------------------------------------------------ the parent

CHECKS = [f"{name}_{what}" for name in CASES
          for what in ("params", "losses")] + \
    ["trainer_params_equal_across_ranks", "trainer_losses_finite",
     "cli_returncode"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("slice18_ddppo"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), port, out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_children(launched):
    """Start the children before the module's first test."""
    yield


@pytest.fixture(scope="module")
def results(launched):
    out, procs = launched
    for r, p in enumerate(procs):
        try:
            text = p.communicate(timeout=CHILD_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r}: timed out")
        assert p.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    return [json.load(open(os.path.join(out, f"rank_{r}.json")))
            for r in (0, 1)]


def test_world_one_group_is_bit_equal_to_plain():
    """A one-rank gloo group: the DD-PPO update (its collectives the
    identity) is bit-equal to the plain update."""
    import torch.distributed as dist
    cfg = PPOConfig(ppo_epoch=2, num_mini_batch=2, lr=1e-3)
    idx = torch.tensor([[0, 2], [1, 3], [3, 0], [2, 1]])
    want, want_m = _update(cfg, _batch(), idx, None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got, got_m = _update(cfg, _batch(), idx, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert got_m == want_m


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("check", CHECKS)
def test_world_two(results, rank, check):
    """Relative errors of world size 2 against world size 1 (or a 0/1
    failure flag): each at most 1e-6."""
    assert results[rank][check] <= 1e-6, (check, results[rank][check])
