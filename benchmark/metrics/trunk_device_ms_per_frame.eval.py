"""Trunk: device milliseconds of the ops launched inside the model's
`backbone_raw` calls, a frame."""


def read(t):
    return t.device_s(r"bench\.trunk$") / t.frames * 1e3
