#!/usr/bin/env python3
"""Where the time of the port's inference goes, on one GPU.

    python3 tools/profile_torch_flagship.py [n_scenes] [preset] [distribution]

Runs a preset (default ``uni3detr_sunrgbd``; bf16, seeded random
weights) on clustered (or ``uniform``) scenes of its ``num_points``
points, points -> boxes, after two warm-up scenes (a box-merging preset
ends with its merged boxes on the host, ``eval.postprocess``, timed as
"host merge"):

- per stage, CUDA-event time on the stream (voxelize + FPS + glue is
  what the encoder, backbone, neck, head, decode and NMS leave of the
  scene), median over the scenes;
- ``torch.profiler``: the top device kernels by total time, the device
  busy share (summed kernel time over the wall time), and each of the
  port's own kernels with its launches and device ms per scene.

Needs a CUDA device; prints the card's name and power limit first.
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from uni3detr_tpu_torch.eval.postprocess import (  # noqa: E402
    postprocess_batch)
from uni3detr_tpu_torch.models.detector import Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.ops import cuda_lib  # noqa: E402
from uni3detr_tpu_torch.presets import PRESETS  # noqa: E402
from uni3detr_tpu_torch.synthetic import clustered_scene  # noqa: E402
from uni3detr_tpu_torch.train.coder import (  # noqa: E402
    decode_predictions, post_process)
from uni3detr_tpu_torch.weights import random_state_dict  # noqa: E402

STAGES = ("pts_middle_encoder", "pts_backbone", "pts_neck", "pts_bbox_head")


def main(n_scenes: int = 5, preset: str = "uni3detr_sunrgbd",
         distribution: str = "clustered"):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = PRESETS[preset]
    model = Uni3DETR(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 0).items()})
    model.to(dev)
    scenes = [tuple(torch.from_numpy(a).to(dev)
                    for a in clustered_scene(s, cfg, distribution))
              for s in range(n_scenes + 2)]
    mask = torch.ones(scenes[0][0].shape[:2], dtype=torch.bool, device=dev)

    events = {}

    def pre(name):
        def hook(mod, args):
            events.setdefault(name, []).append(
                [torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)])
            events[name][-1][0].record()
        return hook

    def post(name):
        def hook(mod, args, out):
            events[name][-1][1].record()
        return hook

    for name in STAGES:
        getattr(model, name).register_forward_pre_hook(pre(name))
        getattr(model, name).register_forward_hook(post(name))

    def scene(pts, rnd):
        s0 = torch.cuda.Event(enable_timing=True)
        s1, s2, s3 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        outs = model(pts, mask, rnd)
        s1.record()
        dec = decode_predictions(outs, cfg)
        s2.record()
        out = post_process(*dec, cfg)
        s3.record()
        if cfg.post_processing != "box_merging":
            return int(out[3].sum()), s0, s1, s2, s3, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(postprocess_batch(*out, cfg)[0]["scores"])
        return n, s0, s1, s2, s3, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        for pts, rnd in scenes[:2]:
            scene(pts, rnd)
        events.clear()
        rows = []
        for pts, rnd in scenes[2:]:
            t0 = time.perf_counter()
            n, s0, s1, s2, s3, merge = scene(pts, rnd)
            wall = (time.perf_counter() - t0) * 1e3
            rows.append(dict(wall=wall, total=s0.elapsed_time(s3),
                             decode=s1.elapsed_time(s2),
                             nms=s2.elapsed_time(s3), boxes=n, merge=merge))
        torch.cuda.synchronize()
        med = lambda xs: statistics.median(xs)
        stage = {k: med([a.elapsed_time(b) for a, b in v])
                 for k, v in events.items()}
        total = med([r["total"] for r in rows])
        print(f"scenes={n_scenes} wall ms/scene={med([r['wall'] for r in rows]):.3f}"
              f" stream ms/scene={total:.3f} boxes={[r['boxes'] for r in rows]}"
              f" host merge ms/scene={med([r['merge'] for r in rows]):.3f}")
        parts = dict(stage, decode=med([r["decode"] for r in rows]),
                     nms=med([r["nms"] for r in rows]))
        parts["voxelize+fps+glue"] = total - sum(parts.values())
        for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
            print(f"  {k:22s} {v:9.3f} ms  {100 * v / total:5.1f}%")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for pts, rnd in scenes[2:]:
                scene(pts, rnd)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    dev_total = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profiled wall {wall:.3f} ms for {n_scenes} scenes; device "
          f"kernel time {dev_total:.3f} ms; busy share "
          f"{dev_total / wall:.3f}")
    print(ka.table(sort_by="self_device_time_total", row_limit=25,
                   max_name_column_width=70))
    cuda_lib.print_kernel_times(ka, n_scenes, "scene")


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:2]], *sys.argv[2:4])
