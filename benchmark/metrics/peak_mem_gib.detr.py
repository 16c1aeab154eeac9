"""Device: the peak of allocated device memory over the run, GiB."""


def read(t):
    return t.peak_bytes / 2 ** 30
