"""OV's fusion (the [points, image] concatenation and
``conv_trans_head_1``): the stream's ms a batch in the port's span
``fusion`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "fusion")
