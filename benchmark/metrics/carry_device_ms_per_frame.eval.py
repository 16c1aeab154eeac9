"""Lane runner: carry: device milliseconds of the ops launched in the self
part of the port's `eodt.stream_step` span, a frame: the runner's per-
frame carry: the self part of `eodt.stream_step` (the reset and the read
memory's choice before the frame, the memory update after it); in the
traced unit, each device op tied to the main thread's innermost `eodt.`
span at its launch (`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.stream_step", "device_s", "frame", whole=False)
