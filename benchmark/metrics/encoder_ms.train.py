"""Voxelize and the sparse encoder (K1-K3): the stream's ms a train step, between the
CUDA events of its stage (``bench_trace.StageClock``)."""


def read(t):
    return t.stage_ms("encoder")
