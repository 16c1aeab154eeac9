"""Train step: forward: device milliseconds of the ops launched inside the
port's `eodt.train.forward` span, a step: the step's loss function (the
batched memory read, the trunk, the heads and the losses of its frames);
in the traced unit, each device op tied to the main thread's innermost
`eodt.` span at its launch (`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.train.forward", "device_s", "step")
