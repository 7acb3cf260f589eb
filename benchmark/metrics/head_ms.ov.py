"""OV's CLIP decoder head: the stream's ms a batch in the port's span
``head`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "head")
