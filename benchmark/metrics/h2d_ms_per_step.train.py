"""Input: host milliseconds of `batch_to_device` (the pinned batch's
copies issued) a step, in the step run without the profiler just before
the traced one."""


def read(t):
    return t.clock["h2d"] / t.steps * 1e3
