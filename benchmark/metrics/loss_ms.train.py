"""The set losses without the matching: the stream's self ms a train step
of the port's span ``loss``, its child ``matching`` left out
(``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "loss", "self_stream_ms")
