"""The bytes and operations of kernel 8 (`eodt::ms_deform_attn`, the
multi-scale deformable attention's forward) from each launch's own
arguments, and a recorder that adds that count to `kernels.RecordBounds`'.

The count is `chip_smoke.py`'s for kernel 8 (`time_ms_deform_attn`, the
row of PERF.md's kernel table): the value, the sampling locations and the
attention weights read once and the output written once, against 10 f32
operations a sample element, a (query, head, level, point, channel):
the bilinear weights, the four corners' multiply-adds and the attention
weight."""

from __future__ import annotations

import torch

from . import kernels
from .peaks import bound_s

OPS_PER_SAMPLE = 10


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """(bytes, operations) of one launch: value [S, M, D], the levels'
    (H, W) flattened, locations [Q, M, L, P, 2], weights [Q, M, L, P];
    the output is [Q, M * D] in value's type."""
    q, m, nl, p, _ = sampling_locations.shape
    d = value.shape[-1]
    read = (value.numel() * value.element_size() +
            sampling_locations.numel() * sampling_locations.element_size() +
            attention_weights.numel() * attention_weights.element_size())
    out = q * m * d * value.element_size()
    return read + out, OPS_PER_SAMPLE * q * m * nl * p * d


class RecordBounds(kernels.RecordBounds):
    """`kernels.RecordBounds` with kernel 8 counted: inside it each
    `eodt::ms_deform_attn` call runs as usual and its bound is added to
    `calls`."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "eodt" and \
                func.__name__.split(".")[0] == "ms_deform_attn":
            out = func(*args, **(kwargs or {}))
            with torch.no_grad():
                self.calls.append(("ms_deform_attn",
                                   bound_s(*ms_deform_attn(*args))))
            return out
        return super().__torch_dispatch__(func, types, args, kwargs)
