"""The two names of the port's `parallel/mesh.py` that the copied ROI heads
import. The reference runs on one device and never shards the zero-shot
classifier, so `column_matmul` is never called."""

from typing import Any, NamedTuple

import torch


class ColumnShard(NamedTuple):
    block: torch.Tensor
    group: Any
    size: int
    index: int


def column_matmul(x: torch.Tensor, zs: ColumnShard) -> torch.Tensor:
    raise NotImplementedError("the reference keeps the whole classifier")
