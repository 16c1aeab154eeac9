"""Frame: cascade: CUDA kernels launched inside the port's
`eodt.frame.cascade` span, a frame: the cascade heads (`run_cascade`);
in the traced unit, each device op tied to the main thread's innermost
`eodt.` span at its launch (`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.frame.cascade", "launches", "frame")
