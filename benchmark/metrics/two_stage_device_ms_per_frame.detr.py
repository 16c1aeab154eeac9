"""Detr: two_stage: device milliseconds a frame of the ops launched inside
the port's `eodt.detr.two_stage` span: the two-stage head over every
encoder token, the top-300 and the query seeding
(`DeformableDETR._seed_queries`); in the traced unit, each device op
tied to the main thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`). None where the program has no such span."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.detr.two_stage", "device_s", "frame")
