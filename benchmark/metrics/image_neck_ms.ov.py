"""OV's image neck (FPN, ``input_proj``, ``depth_net`` and its softmax):
the stream's ms a batch in the port's span ``image_neck``
(``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "image_neck")
