"""Kernel launches a frame in the traced window."""


def read(t):
    return t.launches_per_iter()
