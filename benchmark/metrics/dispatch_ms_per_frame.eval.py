"""Lane runner: host milliseconds inside the runner call (staging copies
included) a frame, in the chunk-step run without the profiler just
before the traced one."""


def read(t):
    return t.clock["runner"] / t.frames * 1e3
