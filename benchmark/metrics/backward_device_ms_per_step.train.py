"""Train step: backward: device milliseconds of the ops launched inside the
port's `eodt.train.backward` span, a step: `total.backward()`, launched
from autograd's device thread while the main thread waits in the span;
in the traced unit, each device op tied to the main thread's innermost
`eodt.` span at its launch (`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.train.backward", "device_s", "step")
