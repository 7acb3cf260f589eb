"""The host's ms a batch inside the port's spans ``forward``, ``decode`` and
``post_process``: the time to enqueue a batch, against its period
(``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.host_ms(t)
