"""Detr: post: device milliseconds a frame of the ops launched inside the
port's `eodt.detr.post` span: the top-300 of the batch's (query, class)
scores (`detr_inference`); in the traced unit, each device op tied to
the main thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`). None where the program has no such span."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.detr.post", "device_s", "frame")
