"""RL / embodied-navigation substrate (habitat-lab analog), on PyTorch.

Counterpart of the JAX package's `rl/`: host-side env/task/simulator
abstractions (copied, numpy only) feeding a PyTorch actor-critic trained
with (DD-)PPO on the card, plus the SLAM map-and-plan agent, whose
mapper counts points per cell with kernel 1 (`ops/segment_sum`).

Layout:
  core.py           habitat/core analog — Sensor/Measure/Task/Env/RLEnv
  sim.py            Simulator protocol + GridSimulator (habitat-sim stand-in)
  nav.py            PointNav task: sensors, measures, actions, NavRLEnv
  tasks.py          ObjectNav / EQA / VLN variants
  habitat_sim.py    adapter to a real habitat-sim installation
  stream_sim.py     externally fed frames (a robot bridge)
  config.py         the config tree and its env factory
  policy.py         actor-critic (SimpleCNN + GRU state encoder)
  resnet_policy.py  the DD-PPO GroupNorm ResNet policy
  rollout.py        host rollout storage + GAE
  ppo.py            the PPO update (clipped Adam, no host sync)
  ddppo.py          DD-PPO over torch.distributed + preemption utilities
  trainer.py        PPO trainer loop over a vector env
  agents.py         agents, Benchmark, Challenge
  convert.py        habitat checkpoint -> the port's policy
  monodepth.py      monocular depth net for the SLAM agent
  slam.py           depth mapper, planner, map-and-plan agent
  run.py            the train/eval CLI
"""

from embodied_object_detection_tpu_torch.rl import (  # noqa: F401
    agents, config, core, nav, sim, slam, stream_sim, tasks)
from embodied_object_detection_tpu_torch.rl.agents import (  # noqa: F401
    Agent, Benchmark)
from embodied_object_detection_tpu_torch.rl.core import (  # noqa: F401
    Env, RLEnv, registry)
