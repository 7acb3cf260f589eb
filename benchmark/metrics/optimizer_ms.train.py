"""The gradients' all-reduce, the global-norm clip and AdamW: the
stream's ms a train step in the port's span ``optimizer`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "optimizer")
