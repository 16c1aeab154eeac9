"""The FLOPs behind `mfu`: PyTorch's own formulas
(`torch.utils.flop_counter.flop_registry`: matmuls, convolutions and
their backward, attention) applied to every op a call dispatches, kept
apart by the type the op computes in, so that the share of f32 work can
be stated."""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class CountFlops(TorchDispatchMode):
    """Counts the FLOPs of the ops dispatched inside it, by dtype of the
    op's first tensor argument; the ops run as usual."""

    def __init__(self):
        super().__init__()
        self.by_dtype = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            first = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
            dtype = str(first.dtype).replace("torch.", "") \
                if first is not None else "none"
            self.by_dtype[dtype] += int(formula(*args, **kwargs, out_val=out))
        return out

    @property
    def total(self) -> int:
        return sum(self.by_dtype.values())

    def f32_share(self) -> float:
        return self.by_dtype.get("float32", 0) / max(self.total, 1)
