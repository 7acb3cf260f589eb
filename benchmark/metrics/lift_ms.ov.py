"""OV's lift (the voxels' projection, the per-level 2D and depth samples):
the stream's ms a batch in the port's span ``lift`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "lift")
