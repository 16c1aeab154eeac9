"""Detr: encoder: milliseconds a frame in which no device op ran while the
main thread was in the port's `eodt.detr.encoder` span: the input projections, position embeddings and the 6 encoder layers (`DeformableDETR._encode`).
`benchmark/program_spans.py` splits the traced unit's idle time by the
main thread's innermost `eodt.` span. Read from the profiled unit, whose
host time the profiler stretches: compare it only with other traced
readings. None where the program has no such span."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.detr.encoder", "idle_s", "frame")
