"""Train step: optimizer: milliseconds a step in which no device op ran
while the main thread was in the port's `eodt.train.optimizer` span: the
gradient clipping and AdamW. `benchmark/program_spans.py` splits the
traced unit's idle time by the main thread's innermost `eodt.` span.
Read from the profiled unit, whose host time the profiler stretches by
40-45 %: compare it only with other traced readings."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.train.optimizer", "idle_s", "step")
