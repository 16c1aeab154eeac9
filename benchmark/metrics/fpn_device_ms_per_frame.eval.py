"""Frame: fpn: device milliseconds of the ops launched inside the port's
`eodt.frame.fpn` span, a frame: the memory read and the FPN with its
memory merge; in the traced unit, each device op tied to the main
thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.frame.fpn", "device_s", "frame")
