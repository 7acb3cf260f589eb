#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one GPU.

    python3 tools/profile_torch_train.py [n_steps] [preset] [distribution]

Runs train steps of a preset (default ``uni3detr_sunrgbd``; bf16
compute, fp32 params, B=4 synthetic clustered, or ``uniform``, scenes,
seeded random weights, AdamW
lr 1e-4) on one fixed batch, after three warm-up steps:

- per phase, CUDA-event time on the stream, median over the steps:
  forward (voxelize, encoder, backbone, neck, FPS, head), loss (the
  matching included), backward, optimizer (clip + AdamW);
- ``torch.profiler`` over the steps: the top device kernels by total
  time, the device busy share (summed kernel time over wall time), and
  each of the port's own kernels with its launches and device ms per
  step.

Needs a CUDA device; prints the card's name and power limit first.
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from uni3detr_tpu_torch.geom.boxes import gravity_center_boxes  # noqa: E402
from uni3detr_tpu_torch.models.detector import Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.ops import cuda_lib  # noqa: E402
from uni3detr_tpu_torch.presets import PRESETS  # noqa: E402
from uni3detr_tpu_torch.synthetic import clustered_train_batch  # noqa: E402
from uni3detr_tpu_torch.train.losses import uni3detr_loss  # noqa: E402
from uni3detr_tpu_torch.train.step import make_optimizer  # noqa: E402
from uni3detr_tpu_torch.weights import random_state_dict  # noqa: E402

PHASES = ("forward", "loss", "backward", "optimizer")


def main(n_steps: int = 5, preset: str = "uni3detr_sunrgbd",
         distribution: str = "clustered"):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = PRESETS[preset]
    model = Uni3DETR(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 0).items()})
    model.to(dev).train()
    opt = make_optimizer(model, 1e-4)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             clustered_train_batch(0, cfg, 4, distribution).items()}
    gt = gravity_center_boxes(batch["gt_boxes"])

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        opt.zero_grad()
        outs = model(batch["points"], batch["pts_mask"])
        ev[1].record()
        total, _ = uni3detr_loss(outs, gt, batch["gt_labels"],
                                 batch["gt_mask"], cfg)
        ev[2].record()
        total.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        return ev

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    rows, walls = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ev = step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        rows.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    med = [statistics.median(r[i] for r in rows) for i in range(4)]
    total = sum(med)
    print(f"steps={n_steps} wall ms/step={statistics.median(walls):.3f} "
          f"stream ms/step={total:.3f} peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated(dev)}")
    for name, v in zip(PHASES, med):
        print(f"  {name:10s} {v:9.3f} ms  {100 * v / total:5.1f}%")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    dev_total = sum(e.self_device_time_total for e in ka
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profiled wall {wall:.3f} ms for {n_steps} steps; device kernel "
          f"time {dev_total:.3f} ms; busy share {dev_total / wall:.3f}")
    print(ka.table(sort_by="self_device_time_total", row_limit=25,
                   max_name_column_width=70))
    cuda_lib.print_kernel_times(ka, n_steps, "step")


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:2]], *sys.argv[2:4])
