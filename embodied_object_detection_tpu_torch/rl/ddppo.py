"""Decentralized Distributed PPO (DD-PPO) on `torch.distributed`.

Counterpart of the JAX package's `rl/ddppo.py`, which shards the PPO
update over a mesh axis under `shard_map`. The port runs one process a
device (`parallel/mesh.py:init_distributed`; NCCL on cards, gloo on the
CPU):

- `make_ddppo` (ref: `DDPPO` / `DecentralizedDistributedMixin`,
  habitat_baselines/rl/ddppo/algo/ddppo.py:45-96): each rank runs the
  whole epoch and minibatch schedule on its own envs, with the same
  permutations on every rank; each minibatch's gradient is summed over
  the group and divided by its size (DDP's average), the advantages are
  normalised by their global mean and variance
  (`ppo.distributed_mean_and_var`, ddppo.py:18-42) and the metrics are
  averaged.
- Preemption and requeue (ddp_utils.py:26-110): EXIT/REQUEUE signal
  events, interrupted-state save/load, SLURM requeue, and
  `NumRolloutsDoneStore`, the counter behind sync-frac early stopping
  (ddppo_trainer.py:335-340), backed by a locked file.
"""

from __future__ import annotations

import os
import pickle
import signal
import threading
from typing import Dict, Optional

import torch

from .ppo import PPO, PPOConfig, distributed_mean_and_var

__all__ = [
    "make_ddppo", "distributed_mean_and_var", "EXIT", "REQUEUE",
    "add_signal_handlers", "save_interrupted_state",
    "load_interrupted_state", "requeue_job", "NumRolloutsDoneStore",
]


# --------------------------------------------------------------------------
# Distributed update
# --------------------------------------------------------------------------

def make_ddppo(policy: torch.nn.Module, cfg: PPOConfig) -> PPO:
    """The PPO update of `policy` over the ranks of the started default
    process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_ddppo needs a started process group "
                           "(parallel.mesh.init_distributed)")
    return PPO(policy, cfg, dist.group.WORLD, dist.get_world_size())


# --------------------------------------------------------------------------
# Preemption / requeue (ddp_utils.py analog)
# --------------------------------------------------------------------------

EXIT = threading.Event()
REQUEUE = threading.Event()

SLURM_JOBID = os.environ.get("SLURM_JOB_ID", None)


def _interrupted_state_file() -> str:
    base = os.path.join(os.path.expanduser("~"), ".interrupted_states")
    job = SLURM_JOBID or "local"
    return os.path.join(base, f"{job}.pkl")


def _clean_exit_handler(signum, frame):
    EXIT.set()
    print("Exiting cleanly", flush=True)


def _requeue_handler(signum, frame):
    print("Got signal to requeue", flush=True)
    EXIT.set()
    REQUEUE.set()


def add_signal_handlers() -> None:
    """SIGINT/SIGTERM/SIGUSR2 -> clean exit; SIGUSR1 -> requeue
    (ddp_utils.py:42-56)."""
    signal.signal(signal.SIGINT, _clean_exit_handler)
    signal.signal(signal.SIGTERM, _clean_exit_handler)
    signal.signal(signal.SIGUSR2, _clean_exit_handler)
    signal.signal(signal.SIGUSR1, _requeue_handler)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def save_interrupted_state(state: Dict, filename: Optional[str] = None):
    """Persist trainer state at preemption (ddp_utils.py:59-72); tensors
    are converted to numpy first."""
    filename = filename or _interrupted_state_file()
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    with open(filename, "wb") as f:
        pickle.dump(_to_numpy(state), f)


def load_interrupted_state(filename: Optional[str] = None) -> Optional[Dict]:
    filename = filename or _interrupted_state_file()
    if not os.path.exists(filename):
        return None
    with open(filename, "rb") as f:
        return pickle.load(f)


def requeue_job() -> None:
    """Re-queue the SLURM job if REQUEUE was signalled
    (ddp_utils.py:86-96)."""
    if not (REQUEUE.is_set() and SLURM_JOBID):
        return
    import subprocess
    print(f"Requeueing job {SLURM_JOBID}", flush=True)
    subprocess.check_call(["scontrol", "requeue", SLURM_JOBID])


class NumRolloutsDoneStore:
    """Counter letting workers see how many peers finished their rollout,
    for sync-frac early stopping (ddppo_trainer.py:143-146, 335-340).

    Multi-process backing uses a shared file with advisory locking (the
    TCPStore analog); single-process uses a plain int.
    """

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._local = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if not os.path.exists(path):
                with open(path, "w") as f:
                    f.write("0")

    def add(self, n: int = 1) -> None:
        if self._path is None:
            self._local += n
            return
        import fcntl
        with open(self._path, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            v = int(f.read() or 0) + n
            f.seek(0), f.truncate(), f.write(str(v))
            fcntl.flock(f, fcntl.LOCK_UN)

    def get(self) -> int:
        if self._path is None:
            return self._local
        with open(self._path) as f:
            return int(f.read() or 0)

    def reset(self) -> None:
        if self._path is None:
            self._local = 0
        else:
            with open(self._path, "w") as f:
                f.write("0")
