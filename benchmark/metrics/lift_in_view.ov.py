"""The share of (camera, voxel) pairs inside the camera's frustum in the
traced batches, in %: the port's counters ``lift_in_view`` over
``lift_pairs`` (``bench_spans``)."""
import bench_spans


def read(t):
    pairs = bench_spans.counter(t, "lift_pairs")
    seen = bench_spans.counter(t, "lift_in_view")
    return 100.0 * seen / pairs if pairs and seen is not None else None
