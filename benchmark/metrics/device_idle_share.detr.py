"""Device: the share of an unprofiled batch's host time in which no
device op ran, in percent: 100 (1 - busy / unit), with busy the union of
kernel, copy and set intervals of the traced batch (its device work is an
equal batch's) and the unit's time the mean of several batches timed
without the profiler, which slows the host
(`frame_batches.PLAIN_BATCHES`)."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.plain_s)
