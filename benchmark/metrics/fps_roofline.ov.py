"""K4, the paired FPS: the benchmark's least time of it
(``bench_count.fps_least_s``) over its device time in the trace, in %."""
import bench_count

# the kernel's names as the profiler shows them (``csrc/fps.cu``)
KERNELS = ("u3d_fps",)


def read(t):
    return t.roofline(KERNELS, bench_count.fps_least_s)
