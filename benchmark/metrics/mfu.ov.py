"""The model FLOPs a batch (the benchmark's own count,
``bench_count.model_flops``) over the traced window's seconds times 989
TFLOP/s, in %."""
import bench_count


def read(t):
    return t.mfu(bench_count.model_flops)
