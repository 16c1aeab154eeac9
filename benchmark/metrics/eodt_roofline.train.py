"""Kernels: the port's kernels' bound time (bounds/kernels.py, counted on
the traced step's batch; each ROIAlign forward also counts its backward,
kernel 4b) over their device time in the traced step, in percent; None
when no kernel ran."""


def read(t):
    pairs = t.eodt_by_kernel().values()
    device = sum(d for _, d in pairs)
    return 100.0 * sum(b for b, _ in pairs) / device if device else None
