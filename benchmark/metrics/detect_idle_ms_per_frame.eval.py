"""Frame: detect: milliseconds a frame in which no device op ran while the
main thread was in the port's `eodt.frame.detect` span: the score
combination and `multiclass_nms`. `benchmark/program_spans.py` splits
the traced unit's idle time by the main thread's innermost `eodt.` span.
Read from the profiled unit, whose host time the profiler stretches by
40-45 %: compare it only with other traced readings."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.frame.detect", "idle_s", "frame")
