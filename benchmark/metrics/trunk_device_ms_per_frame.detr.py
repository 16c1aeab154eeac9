"""Detr: trunk: device milliseconds a frame of the ops launched inside the
port's `eodt.detr.trunk` span: the ResNet-50 trunk over the batch and
the extra level (`DeformableDetrDetector.levels`); in the traced unit,
each device op tied to the main thread's innermost `eodt.` span at its
launch (`benchmark/program_spans.py`). None where the program has no
such span."""

from benchmark.program_spans import per_unit


def read(t):
    return per_unit(t, "eodt.detr.trunk", "device_s", "frame")
