"""OV's image backbone (ResNet-50 with its 13 DCNs): the stream's ms a
batch in the port's span ``image_backbone`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "image_backbone")
