"""Lane runner: carry: milliseconds a frame in which no device op ran while
the main thread was in the port's `eodt.stream_step` span outside its
children: the runner's per-frame carry: the self part of
`eodt.stream_step` (the reset and the read memory's choice before the
frame, the memory update after it). `benchmark/program_spans.py` splits
the traced unit's idle time by the main thread's innermost `eodt.` span.
Read from the profiled unit, whose host time the profiler stretches by
40-45 %: compare it only with other traced readings."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.stream_step", "idle_s", "frame", whole=False)
