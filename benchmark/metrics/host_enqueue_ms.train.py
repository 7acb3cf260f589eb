"""The host's ms a train step inside the port's span ``train_step``: the
time to enqueue a step, against its period (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "train_step", "host_ms")
