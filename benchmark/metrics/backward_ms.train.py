"""The backward pass: the stream's ms a train step in the port's span
``backward`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "backward")
