"""The median frame of the run's untraced frames, host ms."""


def read(t):
    return t.frame_ms_p50()
