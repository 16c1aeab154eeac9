"""Frame: device milliseconds of the ops launched inside the model's
`frame_step` calls (FPN with the memory read, CenterNet, cascade, NMS,
mask head, paste, write), a frame."""


def read(t):
    return t.device_s(r"bench\.frame$") / t.frames * 1e3
