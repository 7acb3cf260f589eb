"""The voxelizer (``ops/voxelize.py``) in the OV cell: the stream's ms a
batch in the port's span ``voxelize`` (``bench_spans``)."""
import bench_spans


def read(t):
    return bench_spans.span_ms(t, "voxelize")
