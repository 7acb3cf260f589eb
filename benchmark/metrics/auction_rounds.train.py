"""K12's auction rounds a train step: the most of any instance, from the
counts the kernel writes (the port's counter ``auction_rounds``,
``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.counter(t, "auction_rounds")
