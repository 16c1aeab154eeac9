"""Detr: decoder: CUDA kernels launched inside the port's `eodt.detr.decoder`
span, a frame: the 6 decoder layers with their class and box heads (`DeformableDETR._decode`); in the traced unit, each device op tied to the
main thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`). None where the program has no such span."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.detr.decoder", "launches", "frame")
