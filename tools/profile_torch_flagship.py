#!/usr/bin/env python3
"""Where the time of the port's inference goes, on one GPU.

    python3 tools/profile_torch_flagship.py [n_scenes] [preset] [distribution]

Runs a preset (default ``uni3detr_sunrgbd``; bf16, seeded random
weights) on clustered (or ``uniform``) scenes of its ``num_points``
points (the OV presets: with the synthetic camera's 480x640 image,
``synthetic.ov_scene``), inputs -> boxes, after two warm-up scenes (a
box-merging preset ends with its merged boxes on the host,
``eval.postprocess``, timed as "host merge"):

- per stage, CUDA-event time on the stream, median over the scenes: the
  stages run from one boundary to the next (a module's entry or exit,
  ``BOUNDARIES``), so they add up to the forward; for the Lidar
  detector voxelize, encoder, backbone, neck, FPS + glue and head, for
  OV-Uni3DETR also image backbone (ResNet + DCN), FPN + proj + depth,
  lift, view convs and fusion; then decode and NMS;
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
from uni3detr_tpu_torch.models.ov_detector import OV_Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.ops import cuda_lib  # noqa: E402
from uni3detr_tpu_torch.presets import PRESETS  # noqa: E402
from uni3detr_tpu_torch.synthetic import (  # noqa: E402
    clustered_scene, ov_scene)
from uni3detr_tpu_torch.train.coder import (  # noqa: E402
    decode_predictions, post_process)
from uni3detr_tpu_torch.weights import random_state_dict  # noqa: E402

# (stage that ends here, module, "pre" = its entry | "post" = its exit), in
# the order the forward passes them; a model without the module skips it
BOUNDARIES = (
    ("voxelize", "pts_middle_encoder", "pre"),
    ("encoder", "pts_middle_encoder", "post"),
    ("backbone", "pts_backbone", "post"),
    ("neck", "pts_neck", "post"),
    ("FPS + glue", "img_backbone", "pre"),
    ("image backbone (ResNet + DCN)", "img_backbone", "post"),
    ("FPN + proj + depth", "view_trans", "pre"),
    ("lift", "view_trans.conv_trans_head_1", "pre"),
    ("view convs", "view_trans", "post"),
    ("fusion (no image: FPS) + glue", "pts_bbox_head", "pre"),
    ("head", "pts_bbox_head", "post"),
)


def main(n_scenes: int = 5, preset: str = "uni3detr_sunrgbd",
         distribution: str = "clustered"):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = PRESETS[preset]
    ov = preset.startswith("ov_")
    model = (OV_Uni3DETR if ov else Uni3DETR)(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 0).items()})
    model.to(dev)
    scenes = []
    for s in range(n_scenes + 2):
        inputs, rnd = (ov_scene if ov else clustered_scene)(s, cfg,
                                                             distribution)
        rnd = torch.from_numpy(rnd).to(dev)
        if ov:
            scenes.append(({k: torch.from_numpy(v).to(dev)
                            for k, v in inputs.items()}, rnd))
        else:
            pts = torch.from_numpy(inputs).to(dev)
            scenes.append((pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                           device=dev), rnd))

    events = []        # per scene: [(stage, event)] in the order recorded
    mods = dict(model.named_modules())
    for stage, name, kind in BOUNDARIES:
        if name not in mods:
            continue

        def hook(*args, _stage=stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[-1].append((_stage, ev))
        if kind == "pre":
            mods[name].register_forward_pre_hook(hook)
        else:
            mods[name].register_forward_hook(hook)

    def scene(*args):
        s0 = torch.cuda.Event(enable_timing=True)
        s1, s2, s3 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        events.append([("start", s0)])
        s0.record()
        outs = model(*args)
        s1.record()
        events[-1].append(("glue", s1))
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
        for args in scenes[:2]:
            scene(*args)
        events.clear()
        rows = []
        for args in scenes[2:]:
            t0 = time.perf_counter()
            n, s0, s1, s2, s3, merge = scene(*args)
            wall = (time.perf_counter() - t0) * 1e3
            rows.append(dict(wall=wall, total=s0.elapsed_time(s3),
                             decode=s1.elapsed_time(s2),
                             nms=s2.elapsed_time(s3), boxes=n, merge=merge))
        torch.cuda.synchronize()
        med = lambda xs: statistics.median(xs)
        per_scene = []
        for evs in events:
            d = {}
            for (_, a), (name, b) in zip(evs, evs[1:]):
                d[name] = d.get(name, 0.0) + a.elapsed_time(b)
            per_scene.append(d)
        stage = {k: med([d[k] for d in per_scene]) for k in per_scene[0]}
        total = med([r["total"] for r in rows])
        print(f"scenes={n_scenes} wall ms/scene={med([r['wall'] for r in rows]):.3f}"
              f" stream ms/scene={total:.3f} boxes={[r['boxes'] for r in rows]}"
              f" host merge ms/scene={med([r['merge'] for r in rows]):.3f}")
        parts = dict(stage, decode=med([r["decode"] for r in rows]),
                     nms=med([r["nms"] for r in rows]))
        for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
            print(f"  {k:38s} {v:9.3f} ms  {100 * v / total:5.1f}%")
        if ov and cfg.use_lidar and cfg.use_camera:
            pts = sum(parts[k] for k in ("voxelize", "encoder", "backbone",
                                         "neck", "FPS + glue"))
            print(f"  point branch (voxelize .. FPS + glue) {pts:9.3f} ms"
                  f"  {100 * pts / total:5.1f}%")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for args in scenes[2:]:
                scene(*args)
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
