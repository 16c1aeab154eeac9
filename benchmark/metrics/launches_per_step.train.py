"""Train step: CUDA kernels the device ran in the traced step."""


def read(t):
    return t.launches / t.steps
