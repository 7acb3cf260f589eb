"""SECOND3D and the FPN (cuDNN): the stream's ms a train step, between the
CUDA events of its stage (``bench_trace.StageClock``)."""


def read(t):
    return t.stage_ms("backbone_neck")
