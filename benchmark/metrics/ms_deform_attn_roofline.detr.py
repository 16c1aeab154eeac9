"""Kernels: kernel 8's (`eodt::ms_deform_attn`) bound time
(`benchmark/bounds/ms_deform_attn.py`, counted on the traced batch's
replay) over its device time in the traced batch, in percent; None where
no such kernel ran."""


def read(t):
    bound, device = t.eodt_by_kernel().get("ms_deform_attn", (0.0, 0.0))
    return 100.0 * bound / device if device else None
