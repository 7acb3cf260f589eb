"""Decode and per-class NMS (N1, N2): the stream's ms a batch, between the
CUDA events of its stage (``bench_trace.StageClock``)."""


def read(t):
    return t.stage_ms("postprocess")
