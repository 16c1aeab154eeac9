"""Train step: optimizer: CUDA kernels launched inside the port's
`eodt.train.optimizer` span, a step: the gradient clipping and AdamW; in
the traced unit, each device op tied to the main thread's innermost
`eodt.` span at its launch (`benchmark/program_spans.py`)."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.train.optimizer", "launches", "step")
