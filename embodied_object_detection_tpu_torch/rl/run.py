"""RL train/eval entry point (habitat_baselines/run.py analog).

    python -m embodied_object_detection_tpu_torch.rl.run --run-type train \\
        --num-envs 4 --num-updates 50 --checkpoint-dir ckpts
    python -m embodied_object_detection_tpu_torch.rl.run --run-type eval \\
        --checkpoint ckpts/ckpt.final.pkl

Counterpart of the JAX package's `rl/run.py`, with the same flags. The
policy runs on the card unless `--cpu` asks for the CPU; without a card
and without `--cpu` the CLI raises. `--distributed` runs DD-PPO over
`torch.distributed`, one process a device, with the rank and world size
`torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK) and the process group at
`--coordinator host:port`, by default torchrun's MASTER_ADDR:MASTER_PORT
(under torchrun the group's store is torchrun's own, so another address
would wait for a store that never starts):

    torchrun --nproc-per-node 2 \\
        -m embodied_object_detection_tpu_torch.rl.run --distributed \\
        --cpu --num-envs 4

`--num-envs` counts the envs of all ranks, as the JAX package's mesh
splits them; rank r runs envs r * n / world ... (r + 1) * n / world - 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run-type", choices=["train", "eval"], default="train")
    p.add_argument("--num-envs", type=int, default=4)
    p.add_argument("--num-steps", type=int, default=64)
    p.add_argument("--num-updates", type=int, default=20)
    p.add_argument("--hidden-size", type=int, default=128)
    p.add_argument("--rgb", action="store_true",
                   help="use the rgb raycast sensor + CNN encoder")
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--max-episode-steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--ppo-epoch", type=int, default=2)
    p.add_argument("--num-mini-batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-interval", type=int, default=10)
    p.add_argument("--checkpoint", default=None, help="eval checkpoint path")
    p.add_argument("--eval-episodes", type=int, default=8)
    p.add_argument("--distributed", action="store_true",
                   help="DD-PPO over torch.distributed (one process a "
                        "device, started by torchrun)")
    p.add_argument("--coordinator", default="",
                   help="host:port of the process group for --distributed "
                        "(default MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card; raises without "
                        "one)")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    from ..models.detector import resolve_device
    from .nav import make_nav_rl_env
    from .ppo import PPOConfig
    from .trainer import PPOTrainer, PPOTrainerConfig

    device = resolve_device("cpu" if args.cpu else "cuda")
    rank, world = 0, 1
    if args.distributed:
        from ..parallel.mesh import init_distributed
        coordinator = args.coordinator or (
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
            if "MASTER_ADDR" in os.environ else "")
        if not coordinator:
            raise SystemExit("--distributed needs --coordinator host:port "
                             "(or torchrun's MASTER_ADDR / MASTER_PORT)")
        rank, world = init_distributed(coordinator, device)
        if args.num_envs % world or \
                (args.num_envs // world) % args.num_mini_batch:
            raise SystemExit(
                f"num_envs ({args.num_envs}) must be a multiple of the world "
                f"size ({world}), and each rank's envs of --num-mini-batch "
                f"({args.num_mini_batch}), for DD-PPO")
    per_rank = args.num_envs // world

    def env_fn(i: int):
        return make_nav_rl_env(
            scene_ids=(f"scene{i % args.scenes}",), episodes_per_scene=8,
            seed=args.seed + i, max_episode_steps=args.max_episode_steps,
            with_rgb=args.rgb)

    cfg = PPOTrainerConfig(
        num_envs=per_rank, num_steps=args.num_steps,
        num_updates=args.num_updates, hidden_size=args.hidden_size,
        with_rgb=args.rgb,
        ppo=PPOConfig(lr=args.lr, ppo_epoch=args.ppo_epoch,
                      num_mini_batch=args.num_mini_batch),
        seed=args.seed, checkpoint_folder=args.checkpoint_dir,
        checkpoint_interval=(args.checkpoint_interval
                             if args.checkpoint_dir and rank == 0 else 0),
        distributed=args.distributed)
    trainer = PPOTrainer(cfg, lambda i: env_fn(rank * per_rank + i),
                         device=device)
    try:
        if args.run_type == "train":
            log = trainer.train()
            if rank == 0:
                for row in log[-5:]:
                    print(json.dumps(row))
                if args.checkpoint_dir:
                    path = trainer.save_checkpoint("ckpt.final.pkl")
                    print(f"saved {path}")
        else:
            if args.checkpoint:
                trainer.load_checkpoint(args.checkpoint)
            stats = trainer.evaluate(env_fn(997),
                                     num_episodes=args.eval_episodes,
                                     max_steps=args.max_episode_steps)
            print(json.dumps(stats))
    finally:
        trainer.close()
        if args.distributed:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
