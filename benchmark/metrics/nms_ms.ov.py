"""The per-class NMS over 46 classes (N1 + N2) in the OV cell: the stream's
ms a batch in the port's span ``nms`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "nms")
