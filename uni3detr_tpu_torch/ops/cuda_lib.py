"""Build and load the port's CUDA kernels.

Every source under ``uni3detr_tpu_torch/csrc/`` compiles with its own
``nvcc`` process, all started together, and the objects link into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/uni3detr_tpu_torch/`` at the repository root,
named after a hash of the sources, so an edit rebuilds and an unchanged
tree reuses the library. Nothing builds at import: the first kernel
launch calls :func:`library`. Every kernel's name starts with
``KERNEL_PREFIX``, which picks them out of a profile
(:func:`print_kernel_times`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uni3detr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "u3d_match_positions": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "u3d_gather_conv_f32": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "u3d_gather_conv_bf16": [_P, _P, _P, _P] + [_I] * 6 + [_P],
    "u3d_gather_conv_ids_f32": [_P, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "u3d_gather_conv_ids_bf16": [_P, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "u3d_gather_conv_dw_f32": [_P] * 5 + [_I] * 7 + [_P],
    "u3d_gather_conv_dw_bf16": [_P] * 5 + [_I] * 7 + [_P],
    "u3d_gather_conv_ids_dw_f32": [_P] * 6 + [_I] * 7 + [_P],
    "u3d_gather_conv_ids_dw_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "u3d_fps_pair": [_P] * 7 + [_I] * 6 + [_P],
    "u3d_fps": [_P] * 7 + [_I] * 5 + [_P],
    "u3d_fps_limits": [_P],
    "u3d_auction_lap": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I,
                        _P, _P],
    "u3d_iou_rotated_sets": [_P, _P, _P] + [_I] * 5 + [_P],
    "u3d_iou3d_rotated_mask": [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I,
                               _P],
    "u3d_nms_greedy": [_P, _P, _P, _P, _I, _I, _P],
    "u3d_iou3d_class_blocks": [_P, _P, _P, _I, _I, _I, _P],
    "u3d_soft_nms": [_P] * 4 + [_I] * 3 + [ctypes.c_float] * 2
    + [_I] + [_P] * 4,
    "u3d_grid_sample_3d": [_P] * 3 + [_I] * 8 + [_P],
    "u3d_grid_sample_3d_backward": [_P] * 5 + [_I] * 8 + [_P],
}
_ERROR_STRING = "u3d_error_string"
KERNEL_PREFIX = "u3d_"
# the wrapper (``ops.kernel_wrappers()``) behind each forward kernel, by
# the names a profiler shows (demangled, template arguments included): K2
# and K3 share their templates and differ in the first argument (IDMATCH);
# K11 runs K4's kernel, so a trace of a forward reads its launches as K4's
FORWARD_KERNELS = {
    "match_positions": ("u3d_match_positions_kernel",),
    "gather_conv": ("u3d_gather_conv_mma_kernel<false",
                    "u3d_gather_conv_f32_kernel<false"),
    "gather_conv_ids": ("u3d_gather_conv_mma_kernel<true",
                        "u3d_gather_conv_f32_kernel<true"),
    "fps_pair": ("u3d_fps_grid_kernel",),
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "uni3detr_tpu_torch need the CUDA toolkit")
    return found


def _build(srcs, so: Path) -> None:
    """Compile each ``.cu`` source to an object in its own ``nvcc``
    process (all at once), link them into ``so``; the compiler's output
    goes to ``build.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for p in srcs:
        if p.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{p.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(p)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    tmp = so.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(f"link ({r.returncode}):\n{r.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libu3d_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build(srcs, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    getattr(lib, _ERROR_STRING).argtypes = [_I]
    getattr(lib, _ERROR_STRING).restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise on a refused or failed launch (the C side returns
    cudaGetLastError())."""
    if status != 0:
        msg = getattr(library(), _ERROR_STRING)(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {msg}")


def forward_launches(kernel_counts) -> dict:
    """Launches by forward wrapper (``FORWARD_KERNELS``) from launches by
    kernel name (``utils.profiling.trace_kernel_counts``)."""
    return {w: sum(n for name, n in kernel_counts.items()
                   if any(p in name for p in pats))
            for w, pats in FORWARD_KERNELS.items()}


def print_kernel_times(key_averages, n: int, unit: str) -> None:
    """Print the device time of each of the port's kernels in a
    profiler's ``key_averages()`` over ``n`` scenes or steps: launches
    and ms per ``unit``."""
    import torch

    for e in key_averages:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and KERNEL_PREFIX in e.key):
            print(f"port kernel {e.key[:90]}: {e.count / n:g} launches and "
                  f"{e.self_device_time_total / 1e3 / n:.3f} ms per {unit}")
