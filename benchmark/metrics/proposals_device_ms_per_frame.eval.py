"""Frame: proposals: device milliseconds of the ops launched inside the
port's `eodt.frame.proposals` span, a frame: CenterNet and
`decode_proposals`; in the traced unit, each device op tied to the main
thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.frame.proposals", "device_s", "frame")
