#!/usr/bin/env python3
"""Time the port's post-processing (per-class rotated NMS, or soft-NMS)
on one GPU, without checks.

    python3 tools/time_nms.py [ROOT] [TAG] [PRESET ...] [--soft-nms]

ROOT (default: this checkout) is the tree whose ``uni3detr_tpu_torch`` is
imported, so that two trees (a parent commit unpacked into a git-ignored
directory, and the change) can be timed in turns in one call; each builds
its own library. Per preset (default: ``uni3detr_sunrgbd``,
``uni3detr_nuscenes``, ``uni3detr_scannet``; a tree without the ScanNet
preset gets it built here from its SUN RGB-D preset with the values of
``uni3detr_tpu/presets.py``): seeded random weights (bf16), one clustered
scene decoded to ``max_num`` boxes, then

- ``post_process`` on those boxes: CUDA-event ms on the stream and host
  ms (ended by a sync), median of the repeats;
- under ``torch.profiler``: the device ms per call of all kernels of
  ``post_process``, and of each of the port's NMS kernels (``u3d_iou3d``,
  ``u3d_nms``, ``u3d_soft``) with its launches.

``--soft-nms`` times ``post_process`` with ``post_processing=soft_nms``
instead, at three shapes: the flagship's eval batch (``uni3detr_sunrgbd``,
4 scenes of 1000 boxes, 10 classes), ``uni3detr_scannet`` (one scene of
5000 boxes, 18 classes) and the same ScanNet boxes with every label set
to 0 (one class of 5000 boxes); PRESET arguments are then ignored.

``chip_smoke.py`` checks the NMS kernels against their plain versions.
"""
import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

_parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
_parser.add_argument("root", nargs="?",
                     default=str(Path(__file__).resolve().parents[1]),
                     help="the tree whose uni3detr_tpu_torch is imported")
_parser.add_argument("tag", nargs="?", default="tree")
_parser.add_argument("presets", nargs="*")
_parser.add_argument("--soft-nms", action="store_true",
                     help="post_processing=soft_nms at the flagship (B=4), "
                     "ScanNet and ScanNet with one class")
ARGS = _parser.parse_args()
ROOT = Path(ARGS.root).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from uni3detr_tpu_torch.models.detector import Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.ops import cuda_lib  # noqa: E402
from uni3detr_tpu_torch import presets  # noqa: E402
from uni3detr_tpu_torch.synthetic import clustered_scene  # noqa: E402
from uni3detr_tpu_torch.train.coder import (  # noqa: E402
    decode_predictions, post_process)
from uni3detr_tpu_torch.weights import random_state_dict  # noqa: E402

PRESETS = ("uni3detr_sunrgbd", "uni3detr_nuscenes", "uni3detr_scannet")
# --soft-nms: (label, preset, scenes, every label set to 0)
SOFT_SHAPES = (("flagship", "uni3detr_sunrgbd", 4, False),
               ("scannet", "uni3detr_scannet", 1, False),
               ("scannet-one-class", "uni3detr_scannet", 1, True))


def config(name):
    if name in presets.PRESETS:
        return presets.PRESETS[name]
    if name != "uni3detr_scannet":
        raise SystemExit(f"{ROOT} has no preset {name}")
    return dataclasses.replace(   # uni3detr_tpu/presets.py:35-45
        presets.SUNRGBD, num_classes=18,
        pc_range=(-6.4, -6.4, -0.1, 6.4, 6.4, 2.46),
        grid_size=(128, 640, 640), max_num=5000,
        post_center_range=(-6.4, -6.4, -0.1, 6.4, 6.4, 2.46),
        encoder_budget_shrink=(0.85, 0.4, 0.16))


def time_post_process(cfg, dec, reps):
    """(stream ms, host ms) medians of ``post_process`` after a warm-up."""
    post_process(*dec, cfg)
    torch.cuda.synchronize()
    stream, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        post_process(*dec, cfg)
        b.record()
        b.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        stream.append(a.elapsed_time(b))
    return statistics.median(stream), statistics.median(host)


def device_ms(fn, reps):
    """Device ms per call of all kernels, and {kernel: (launches, ms)} of
    the port's NMS kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, mine = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += e.self_device_time_total
        if any(k in e.key for k in ("u3d_iou3d", "u3d_nms", "u3d_soft")):
            mine[e.key.replace("(anonymous namespace)::", "")
                 .split("(")[0][:60]] = (
                e.count / reps, e.self_device_time_total / 1e3 / reps)
    return total / 1e3 / reps, mine


def decoded(cfg, dev, scenes):
    """Seeded random weights (bf16), ``scenes`` clustered scenes (seeds
    0, 1, ...) decoded to ``max_num`` boxes each."""
    model = Uni3DETR(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 0).items()})
    model.to(dev)
    inputs = [clustered_scene(seed, cfg) for seed in range(scenes)]
    pts, rnd = (torch.from_numpy(np.concatenate(a)).to(dev)
                for a in zip(*inputs))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    with torch.inference_mode():
        dec = decode_predictions(model(pts, mask, rnd), cfg)
    del model
    torch.cuda.empty_cache()
    return dec


def report(tag, name, cfg, dec, reps, dev):
    with torch.inference_mode():
        stream, host = time_post_process(cfg, dec, reps)
        total, mine = device_ms(lambda: post_process(*dec, cfg), reps)
        torch.cuda.reset_peak_memory_stats(dev)
        post_process(*dec, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    B, N = dec[1].shape
    print(f"[{tag} {name}] post_process B={B} N={N} stream "
          f"ms={stream:.4f} host ms={host:.4f} device ms (all kernels)"
          f"={total:.4f} peak_mem_bytes={peak}")
    for k, (n, ms) in mine.items():
        print(f"[{tag} {name}]   {k}: {n:g} launches, device ms="
              f"{ms:.4f}")


def main(tag, names, soft):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not cuda_lib.CSRC.is_relative_to(ROOT):
        raise SystemExit(f"imported {cuda_lib.CSRC}, not from {ROOT}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    if soft:
        for label, name, scenes, one_class in SOFT_SHAPES:
            cfg = dataclasses.replace(config(name),
                                      post_processing="soft_nms")
            dec = decoded(cfg, dev, scenes)
            if one_class:
                dec = (dec[0], dec[1], torch.zeros_like(dec[2]), dec[3])
            report(tag, f"soft-nms {label}", cfg, dec, 5, dev)
            del dec
            torch.cuda.empty_cache()
        return
    for name in names or PRESETS:
        cfg = config(name)
        dec = decoded(cfg, dev, 1)
        report(tag, name, cfg, dec, 20 if cfg.max_num <= 1000 else 5, dev)
        del dec
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(ARGS.tag, ARGS.presets, ARGS.soft_nms)
