"""Detr: encoder: CUDA kernels launched inside the port's `eodt.detr.encoder`
span, a frame: the input projections, position embeddings and the 6 encoder layers (`DeformableDETR._encode`); in the traced unit, each device op tied to the
main thread's innermost `eodt.` span at its launch
(`benchmark/program_spans.py`). None where the program has no such span."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.detr.encoder", "launches", "frame")
