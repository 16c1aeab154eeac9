"""Kernels: the port's kernels' bound time (bounds/kernels.py, counted on
the traced chunk-step's replay) over their device time in the traced
chunk-step, in percent; None when no kernel ran."""


def read(t):
    pairs = t.eodt_by_kernel().values()
    device = sum(d for _, d in pairs)
    return 100.0 * sum(b for b, _ in pairs) / device if device else None
