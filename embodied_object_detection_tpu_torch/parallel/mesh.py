"""The process mesh and its collectives, on `torch.distributed`.

Counterpart of the JAX package's `parallel/mesh.py`. The JAX package runs
one program over a `jax.sharding.Mesh` and lets XLA insert the
collectives; the port runs one process per device, the PyTorch idiom
(the reference's launch + DDP, train_mp3d.py:747-857), and calls the
collectives itself:
  * `init_distributed` starts the process group (NCCL on the card, gloo
    on the CPU) from `torchrun`'s RANK / WORLD_SIZE / LOCAL_RANK and a
    `host:port` coordinator;
  * `make_mesh` factors the world into data x model (rank = data_index *
    model_size + model_index, the JAX package's device order) and makes
    the data groups (one per model index) and the model groups (one per
    data index). Without a process group it is a world of one, and the
    collectives are the identity;
  * `shard_batch` keeps this rank's rows of a leading axis, `replicate`
    broadcasts rank 0's tensors, `shard_zs_weight` keeps this rank's
    column block of the [D, C+1] classifier, and `column_matmul` is the
    classifier's product over such a block: a local product and an
    all-gather of the logit columns, whose backward sums the features'
    gradient over the model group;
  * `all_reduce_sum`, `gather_rows` (with a gradient) and
    `all_reduce_gradients` (one flat bucket a dtype) serve the
    data-parallel training step, and `gather_into` the sharded
    evaluation's detections.
Every collective raises when it fails: nothing here falls back.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ParallelConfig


def init_distributed(coordinator: str, device: "torch.device | str" = "cuda",
                     timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Start the default process group at `tcp://<coordinator>` (host:port)
    with the rank and world size `torchrun` sets (RANK, WORLD_SIZE; a
    world of one without them): NCCL for a CUDA device, with the process
    on card LOCAL_RANK, gloo for the CPU. Returns (rank, world size); a
    started group is kept."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def mesh_shape(cfg: Optional[ParallelConfig], world_size: int
               ) -> Tuple[int, int]:
    """(data size, model size) of `world_size` ranks; raises where they do
    not factor, as the JAX package's `make_mesh` does."""
    cfg = cfg or ParallelConfig()
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world_size // mp
    if dp * mp != world_size:
        raise ValueError(
            f"{world_size} devices do not factor into data_parallel={dp} x "
            f"model_parallel={mp}; silently dropping devices would lose "
            "throughput (set parallel.data_parallel/model_parallel "
            "explicitly)")
    return dp, mp


class Mesh(NamedTuple):
    """This rank's place on the data x model mesh. The groups are None
    without a process group (a world of one)."""
    data_axis: str = "data"
    model_axis: str = "model"
    data_size: int = 1
    model_size: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None      # the ranks of this model index
    model_group: Any = None     # the ranks of this data index

    @property
    def rank(self) -> int:
        return self.data_index * self.model_size + self.model_index

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data_axis: self.data_size,
                self.model_axis: self.model_size}

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return {self.data_axis: self.data_index,
                self.model_axis: self.model_index}[axis]

    def group(self, axis: str):
        return {self.data_axis: self.data_group,
                self.model_axis: self.model_group}[axis]


def make_mesh(cfg: Optional[ParallelConfig] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The mesh of the running process group (of `world_size` ranks,
    which must be its size when given); without a process group, a world
    of one. Every rank must call it, in the same order, as it makes the
    groups."""
    cfg = cfg or ParallelConfig()
    started = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if started else 1
    if world_size is not None and world_size != world:
        raise ValueError(f"world_size={world_size}, but the process group "
                         f"has {world} ranks")
    dp, mp = mesh_shape(cfg, world)
    if not started:
        return Mesh(cfg.data_axis, cfg.model_axis, dp, mp)
    rank = dist.get_rank()

    def new_group(ranks):
        return dist.group.WORLD if len(ranks) == world else \
            dist.new_group(ranks)

    data_groups = [new_group([d * mp + m for d in range(dp)])
                   for m in range(mp)]
    model_groups = [new_group([d * mp + m for m in range(mp)])
                    for d in range(dp)]
    return Mesh(cfg.data_axis, cfg.model_axis, dp, mp, rank // mp, rank % mp,
                data_groups[rank % mp], model_groups[rank // mp])


def _rows(x, size: int, index: int, axis: str):
    if x is None or size == 1:
        return x
    n = x.shape[0]
    if n % size:
        raise ValueError(f"leading axis {n} is not a multiple of the "
                         f"'{axis}' axis size {size}")
    k = n // size
    return x[index * k:(index + 1) * k]


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's rows of the leading axis of every array or tensor of
    `batch` (one, a NamedTuple or a dict of them; None stays None): the
    block of the axis's size at this rank's coordinate."""
    size, index = mesh.shape[axis], mesh.index(axis)
    if isinstance(batch, (torch.Tensor, np.ndarray)) or batch is None:
        return _rows(batch, size, index, axis)
    if isinstance(batch, dict):
        return {k: _rows(v, size, index, axis) for k, v in batch.items()}
    return type(batch)(*(_rows(v, size, index, axis) for v in batch))


def _coalesced(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors in buckets of one dtype and device, in order."""
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    return list(buckets.values())


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]
              ) -> Sequence[torch.Tensor]:
    """Overwrite `tensors` in place with rank 0's, over every rank of the
    mesh: one broadcast a dtype, of the tensors flattened together."""
    if mesh.data_group is None:
        return tensors
    for bucket in _coalesced(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in bucket])
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return tensors


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group` (a new tensor; `x` itself when there is
    no group). No gradient flows through it."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def all_reduce_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Sum each parameter's `.grad` over `group` in place, in one
    all-reduce a dtype; a missing gradient counts as zeros (as the
    optimizer reads it) and is set where any rank has one."""
    if group is None:
        return
    params = [p for p in params if p.requires_grad]
    for bucket in _coalesced(params):
        flat = torch.cat([torch.zeros(p.numel(), dtype=p.dtype,
                                      device=p.device) if p.grad is None
                          else p.grad.reshape(-1) for p in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for p in bucket:
            g = flat[offset:offset + p.numel()].view_as(p)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
            offset += p.numel()


def gather_into(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """[size * n, ...]: the ranks' [n, ...] tensors in rank order, in one
    collective."""
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """The rows of every rank; the gradient of this rank's rows is the
    sum over the ranks of their gradient."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index, ctx.n = group, index, x.shape[0]
        return gather_into(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None, \
            None, None


def gather_rows(mesh: Mesh, x: torch.Tensor, axis: str = "data"
                ) -> torch.Tensor:
    """The global rows of `x` (this rank's rows, [n, ...]) over `axis`,
    [size * n, ...] in rank order, with a gradient back to `x`."""
    group = mesh.group(axis)
    if group is None:
        return x
    return _GatherRows.apply(x, group, mesh.shape[axis], mesh.index(axis))


class ColumnShard(NamedTuple):
    """This rank's column block of a [D, C+1] classifier sharded over a
    model group (`shard_zs_weight`)."""
    block: torch.Tensor         # [D, (C+1) / size]
    group: Any
    size: int
    index: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.block.shape[0], self.block.shape[1] * self.size)


def shard_zs_weight(mesh: Mesh, zs_weight: torch.Tensor,
                    axis: str = "model"):
    """This rank's column block of the [D, C+1] classifier over `axis`
    (a `ColumnShard`): the classifier's product computes its logit
    columns and gathers the rest (`column_matmul`). The whole matrix is
    kept where the class count does not divide the axis, or the axis has
    one rank."""
    n = mesh.shape[axis]
    if n == 1 or zs_weight.shape[-1] % n:
        return zs_weight
    k = zs_weight.shape[-1] // n
    i = mesh.index(axis)
    return ColumnShard(zs_weight[:, i * k:(i + 1) * k].contiguous(),
                       mesh.group(axis), n, i)


class _ColumnMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block, shard):
        ctx.save_for_backward(x, block)
        ctx.shard = shard
        return gather_into((x @ block).t(), shard.group, shard.size).t()

    @staticmethod
    def backward(ctx, grad):
        x, block = ctx.saved_tensors
        k, i = block.shape[1], ctx.shard.index
        local = grad[:, i * k:(i + 1) * k]
        gx = local @ block.t()
        dist.all_reduce(gx, group=ctx.shard.group)
        gb = x.t() @ local if ctx.needs_input_grad[1] else None
        return gx, gb, None


def column_matmul(x: torch.Tensor, zs: ColumnShard) -> torch.Tensor:
    """x [R, D] @ the whole classifier, [R, C+1] in f32, from this rank's
    block: the block's logit columns, then an all-gather of the others
    over the model group. The backward returns the features' gradient of
    this rank's columns summed over the group (the block's own gradient
    where it asks for one)."""
    return _ColumnMatmul.apply(x.float(), zs.block.float(), zs)
