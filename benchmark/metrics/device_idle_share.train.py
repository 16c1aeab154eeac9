"""Device: the share of an unprofiled unit's host time in which no
device op ran, in percent: 100 (1 - busy / unit), with busy the union of
kernel, copy and set intervals of the traced unit (its device work is an
equal unit's) and the unit's time taken without the profiler, which
slows the host."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.plain_s)
