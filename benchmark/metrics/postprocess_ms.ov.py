"""Decode and per-class NMS over 46 classes (N1, N2) in the OV cell: the
stream's ms a batch, between the CUDA events of its stage
(``bench_trace.StageClock``; the stages: ``families/ov_uni3detr.py``)."""


def read(t):
    return t.stage_ms("postprocess")
