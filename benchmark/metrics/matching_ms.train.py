"""The matching costs of every decoder layer and K12's auction: the stream's
ms a train step in the port's span ``matching`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "matching")
