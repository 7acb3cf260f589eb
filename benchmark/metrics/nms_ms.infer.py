"""The per-class NMS (N1 + N2, or N1 + N3): the stream's ms a batch in the
port's span ``nms`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "nms")
