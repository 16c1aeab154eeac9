"""Frame: detect: device milliseconds of the ops launched inside the port's
`eodt.frame.detect` span, a frame: the score combination and
`multiclass_nms`; in the traced unit, each device op tied to the main
thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.frame.detect", "device_s", "frame")
