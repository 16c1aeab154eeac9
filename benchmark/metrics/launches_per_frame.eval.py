"""Frame: CUDA kernels the device ran in the traced window, a frame."""


def read(t):
    return t.launches / t.frames
