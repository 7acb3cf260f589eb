"""Kernel launches a train step in the traced window."""


def read(t):
    return t.launches_per_iter()
