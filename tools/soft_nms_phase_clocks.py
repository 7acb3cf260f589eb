#!/usr/bin/env python3
"""Where a step of the soft-NMS kernel (N3) goes, on one GPU.

    python3 tools/soft_nms_phase_clocks.py [WORKDIR]

Copies ``uni3detr_tpu_torch`` into WORKDIR (default
``build/soft_nms_phase_clocks``, git-ignored), adds ``clock64()``
counters between the phases of each step of
``u3d_soft_nms_segments_kernel`` in that copy (the warp's argmax and its
candidate's store, the barrier, the argmax over the warps up to the prune
test, the wait for the kept box's row, the decay pass), builds it, and
runs ``ops.nms.soft_nms`` on the decoded boxes of a seeded random-weight
forward at the flagship's eval batch (4 scenes, 1000 boxes of 10
classes; scene 0 read), at ScanNet's (5000 boxes of 18 classes) and on
ScanNet's boxes with every label 0. Prints, per class of scene 0, its
boxes, threads and steps and the cycles a step of each phase, read by
thread 0, and the SM clock beside it. The counters cost a few cycles a
phase; the checkout's own kernel is not changed.
"""
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = Path(sys.argv[1] if len(sys.argv) > 1 else
            ROOT / "build" / "soft_nms_phase_clocks").resolve()
PHASES = ("warp_argmax", "barrier", "block_argmax", "row_wait", "decay")
CLASSES = 128   # classes whose counters are kept (scene 0)

# (anchor in csrc/nms.cu, its replacement)
PATCHES = [
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     f"__device__ unsigned long long g_soft_clocks[{CLASSES}][8];\n"
     "#define U3D_TICK(k) do { c1 = clock64(); acc[k] += c1 - c0; "
     "c0 = c1; } while (0)\n"),
    ("  int buf = 0;\n  for (int k = 0; k < max_out; ++k) {\n",
     "  int buf = 0;\n  unsigned long long c0 = clock64(), c1, "
     "acc[5] = {0, 0, 0, 0, 0};\n  int steps = 0;\n"
     "  for (int k = 0; k < max_out; ++k) {\n    U3D_TICK(4);\n"),
    ("    bar_sync(T);\n",
     "    U3D_TICK(0);\n    bar_sync(T);\n    U3D_TICK(1);\n"),
    ("    if (mhi == 0u || !(v > prune)) break;\n",
     "    if (mhi == 0u || !(v > prune)) break;\n    U3D_TICK(2);\n"
     "    ++steps;\n"),
    ("        r[j] = row[base + j * T];\n      }\n",
     "        r[j] = row[base + j * T];\n      }\n"
     "      if (base < n) {\n        unsigned d;\n"
     "        asm volatile(\"mov.b32 %0, %1;\" : \"=r\"(d) : \"f\"(r[0]));\n"
     "      }\n      U3D_TICK(3);\n"),
    ("        fold(best, bpos, x, s_tie[i], i);\n      }\n    }\n  }\n}\n",
     "        fold(best, bpos, x, s_tie[i], i);\n      }\n    }\n  }\n"
     f"  if (tid == 0 && b == 0 && c < {CLASSES}) {{\n"
     "    for (int q = 0; q < 5; ++q) g_soft_clocks[c][q] = acc[q];\n"
     "    g_soft_clocks[c][5] = steps;\n    g_soft_clocks[c][6] = n;\n"
     "    g_soft_clocks[c][7] = T;\n  }\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\n'
     "int u3d_soft_clocks(void* host, int reset) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(host, g_soft_clocks, "
     "sizeof(g_soft_clocks));\n"
     "  if (e == cudaSuccess && reset) {\n"
     f"    static unsigned long long zero[{CLASSES}][8];\n"
     "    e = cudaMemcpyToSymbol(g_soft_clocks, zero, sizeof(zero));\n"
     "  }\n  return (int)e;\n}\n"),
]


def patch(src: str) -> str:
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in nms.cu: "
                             f"{anchor[:60]!r}")
        src = src.replace(anchor, text)
    return src


def sm_clock():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main():
    if WORK.exists():
        shutil.rmtree(WORK)
    shutil.copytree(ROOT / "uni3detr_tpu_torch", WORK / "uni3detr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = WORK / "uni3detr_tpu_torch" / "csrc" / "nms.cu"
    cu.write_text(patch(cu.read_text()))
    sys.path.insert(0, str(WORK))

    import torch

    from uni3detr_tpu_torch.geom.boxes import bottom_center_boxes
    from uni3detr_tpu_torch.models.detector import Uni3DETR
    from uni3detr_tpu_torch.ops import cuda_lib, nms
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import clustered_scene
    from uni3detr_tpu_torch.train.coder import decode_predictions
    from uni3detr_tpu_torch.weights import random_state_dict

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not cuda_lib.CSRC.is_relative_to(WORK):
        raise SystemExit(f"imported {cuda_lib.CSRC}, not the copy")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    clocks = cuda_lib.library().u3d_soft_clocks
    clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    for label, preset, B, one_class in (
            ("flagship", "uni3detr_sunrgbd", 4, False),
            ("scannet", "uni3detr_scannet", 1, False),
            ("scannet one class", "uni3detr_scannet", 1, True)):
        cfg = dataclasses.replace(PRESETS[preset], post_processing="soft_nms")
        model = Uni3DETR(cfg).eval()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               random_state_dict(model, 0).items()})
        model.to(dev)
        inputs = [clustered_scene(seed, cfg) for seed in range(B)]
        pts, rnd = (torch.from_numpy(np.concatenate(a)).to(dev)
                    for a in zip(*inputs))
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
        with torch.inference_mode():
            boxes, scores, labels, valid = decode_predictions(
                model(pts, mask, rnd), cfg)
        del model
        if one_class:
            labels = torch.zeros_like(labels)
        N = scores.shape[1]
        args = (bottom_center_boxes(boxes)[..., :7].contiguous(), scores,
                labels, valid, cfg.num_classes, cfg.soft_nms_sigma,
                cfg.soft_nms_prune, min(cfg.max_num, N))
        buf = (ctypes.c_ulonglong * (CLASSES * 8))()
        nms.soft_nms(*args)
        torch.cuda.synchronize()
        cuda_lib.check(clocks(ctypes.addressof(buf), 1), "clocks")
        nms.soft_nms(*args)
        torch.cuda.synchronize()
        cuda_lib.check(clocks(ctypes.addressof(buf), 1), "clocks")
        clock = sm_clock()
        rows = np.asarray(list(buf), dtype=np.float64).reshape(CLASSES, 8)
        print(f"[{label}] B={B} N={N} SM clock, max (MHz): {clock}")
        for c in range(min(cfg.num_classes, CLASSES)):
            a = rows[c]
            if a[6] == 0:
                continue
            n = max(a[5], 1)
            print(f"[{label}] class {c}: boxes={a[6]:.0f} threads={a[7]:.0f}"
                  f" steps={a[5]:.0f} cycles a step: " + " ".join(
                      f"{p}={a[k] / n:.0f}" for k, p in enumerate(PHASES))
                  + f" total={a[:5].sum() / n:.0f}")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
