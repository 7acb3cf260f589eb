"""SECOND3D and the FPN (cuDNN) in the OV cell: the stream's ms a batch,
between the CUDA events of its stage (``bench_trace.StageClock``; the
stages: ``families/ov_uni3detr.py``)."""


def read(t):
    return t.stage_ms("backbone_neck")
