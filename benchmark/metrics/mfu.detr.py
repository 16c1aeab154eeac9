"""Whole step: FLOPs of a batch (bounds/flops.py; nearly all f32, the
share printed beside it) over its host time without the profiler (the
mean of several batches, `frame_batches.PLAIN_BATCHES`) and the bf16
dense peak, in percent, as `mfu.eval` states it."""

from benchmark.bounds.peaks import BF16_FLOPS_PER_S


def read(t):
    return 100.0 * t.flops / t.plain_s / BF16_FLOPS_PER_S
