"""Detr: CUDA kernels the device ran in the traced batch, a frame."""


def read(t):
    return t.launches / t.frames
