"""K1-K3 (the sparse encoder's kernels): the benchmark's least time of them
(``bench_count.sparse_conv_least_s``) over their device time in the
trace, in %."""
import bench_count

# the kernels' names as the profiler shows them (``csrc/sparse_conv*.cu``)
KERNELS = ("u3d_match_positions", "u3d_gather_conv", "u3d_dw_sum_chunks")


def read(t):
    return t.roofline(KERNELS, bench_count.sparse_conv_least_s)
