"""The device's idle share of the traced window, in %: 1 - the union of its
operations' intervals over the window."""


def read(t):
    return 100.0 * t.idle_share()
