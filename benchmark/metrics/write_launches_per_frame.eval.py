"""Frame: write: CUDA kernels launched inside the port's `eodt.frame.write`
span, a frame: the memory write (write NMS, mask head, paste, write
selection, segment-sum); in the traced unit, each device op tied to the
main thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.frame.write", "launches", "frame")
