"""Whole step: FLOPs of a training step (bounds/flops.py) over its host
time without the profiler and the bf16 dense peak, in percent."""

from benchmark.bounds.peaks import BF16_FLOPS_PER_S


def read(t):
    return 100.0 * t.flops / t.plain_s / BF16_FLOPS_PER_S
