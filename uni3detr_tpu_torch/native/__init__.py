"""Native (C++) host data ops of the port: build and ctypes bindings
(a copy of ``uni3detr_tpu/native/__init__.py`` without its fallback).

``data_ops.cpp`` is one translation unit of ``extern "C"`` loops
(points in rotated boxes, the BEV collision test, the ObjectNoise
rejection loop), compiled with g++ on first use, never at import, into
``build/uni3detr_tpu_torch/`` at the repository root as
``_data_ops_<hash>.so``: the hash covers the source, the flags and the
host (``-march=native``), so an edit or another machine rebuilds. The
compiler is ``$CXX`` or ``g++``. A failed build raises with the
compiler's output; nothing falls back to numpy behind the caller's back.
The numpy versions in ``data/box_np_ops.py`` are the plain versions,
which a caller selects with ``native=False``.

This is host code: the data pipeline's loader threads call it, the card
never does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "data_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uni3detr_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native"]

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "points_in_rbbox": [_f32p, _i64, _i64, _f32p, _i64, _i64, ctypes.c_int,
                        _u8p],
    "points_in_any_rbbox": [_f32p, _i64, _i64, _f32p, _i64, _i64,
                            ctypes.c_int, _u8p],
    "box_collision_test": [_f32p, _i64, _i64, _f32p, _i64, _i64, _u8p],
    "object_noise": [_f32p, _i64, _i64, _f32p, _i64, _i64, _f32p, _f32p,
                     _i64, _i32p],
}


def build(src: Path = SRC, out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` with ``$CXX`` (default g++) into ``out_dir``
    (unless that build exists) and return the shared object's path.
    Raises RuntimeError naming the compiler's stderr when the compiler
    cannot run or fails."""
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(Path(src).read_bytes())
    digest.update(" ".join([cxx, *CXX_FLAGS, platform.machine(),
                            platform.node()]).encode())
    so = Path(out_dir) / f"_data_ops_{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native data ops: cannot run {cxx!r}: {e}") \
            from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native data ops: {' '.join(cmd)} failed "
                           f"({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)  # atomic against a concurrent build
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The ctypes library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def _c32(a):
    return np.ascontiguousarray(a, np.float32)


def points_in_rbbox(points, boxes, z_origin="bottom"):
    """(P, >=3) x (N, >=7) -> (P, N) bool membership mask."""
    pts, bxs = _c32(points), _c32(boxes)
    out = np.zeros((len(pts), len(bxs)), np.uint8)
    if len(pts) and len(bxs):
        library().points_in_rbbox(pts, pts.shape[0], pts.shape[1],
                                  bxs, bxs.shape[0], bxs.shape[1],
                                  0 if z_origin == "bottom" else 1, out)
    return out.astype(bool)


def points_in_any_rbbox(points, boxes, z_origin="bottom"):
    """(P, >=3) x (N, >=7) -> (P,) bool: the point is inside any box."""
    pts, bxs = _c32(points), _c32(boxes)
    out = np.zeros(len(pts), np.uint8)
    if len(pts) and len(bxs):
        library().points_in_any_rbbox(pts, pts.shape[0], pts.shape[1],
                                      bxs, bxs.shape[0], bxs.shape[1],
                                      0 if z_origin == "bottom" else 1, out)
    return out.astype(bool)


def box_collision_test(boxes_a, boxes_b):
    """(Na, >=7) x (Nb, >=7) -> (Na, Nb) bool BEV SAT overlap matrix."""
    a, b = _c32(boxes_a), _c32(boxes_b)
    out = np.zeros((len(a), len(b)), np.uint8)
    if len(a) and len(b):
        library().box_collision_test(a, a.shape[0], a.shape[1],
                                     b, b.shape[0], b.shape[1], out)
    return out.astype(bool)


def object_noise(points, boxes, trans, rots):
    """The ObjectNoise rejection loop, in place on ``points`` (P, pdim)
    and ``boxes`` (G, bdim), both float32 and C-contiguous; ``trans``
    (G, T, 3) and ``rots`` (G, T) are the pre-drawn trials. Returns the
    (G,) accepted trial indices (-1: the box is left as it was)."""
    if points.dtype != np.float32 or not points.flags.c_contiguous \
            or boxes.dtype != np.float32 or not boxes.flags.c_contiguous:
        raise ValueError("object_noise works in place: points and boxes "
                         "must be C-contiguous float32")
    t, r = _c32(trans), _c32(rots)
    G = len(boxes)
    acc = np.full(G, -1, np.int32)
    if G and len(points):
        library().object_noise(points, points.shape[0], points.shape[1],
                               boxes, G, boxes.shape[1], t, r, r.shape[1],
                               acc)
    return acc
