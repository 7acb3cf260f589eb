"""Kernel launches a batch in the traced window."""


def read(t):
    return t.launches_per_iter()
