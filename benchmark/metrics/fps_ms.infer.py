"""K4 and the seed gathers: the stream's ms a batch in the port's span
``fps`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "fps")
