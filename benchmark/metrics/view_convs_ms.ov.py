"""OV's three view convs on the lifted volume: the stream's ms a batch in
the port's span ``view_convs`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "view_convs")
