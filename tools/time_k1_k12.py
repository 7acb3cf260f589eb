#!/usr/bin/env python3
"""Time the auction matcher (K12) on the train step's own costs and the
rulebook search (K1) of both presets, on one GPU, without checks.

    python3 tools/time_k1_k12.py [ROOT] [TAG]

ROOT (default: this checkout) is the tree whose ``uni3detr_tpu_torch`` is
imported, so that two trees (a parent commit unpacked into a git-ignored
directory, and the change) can be timed in turns in one call; each builds
its own library. Per preset (``uni3detr_nuscenes``, then
``uni3detr_sunrgbd``; seeded random weights, B=4, one clustered train
batch, train mode, dropout seeded):

- K12: the loss's calls of ``match_queries_to_gt`` are recorded on one
  forward (one call per decoder layer in a tree that matches layer by
  layer, one for all layers in one that stacks them) and replayed:
  launches and device ms per step of the ``u3d_auction`` kernels
  (``torch.profiler``), the event ms of the replayed calls (padding
  included), and, where the tree reports them, the rounds per instance;
- K1: device ms of ``match_positions`` per scene (the eval site sets of
  one clustered scene) and per train step (the train batch's), beside
  ``torch.searchsorted``'s on the same queries (positions only).

``chip_smoke.py`` checks the same kernels against their plain versions.
"""
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from uni3detr_tpu_torch.geom.boxes import gravity_center_boxes  # noqa: E402
from uni3detr_tpu_torch.models.detector import Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.ops import cuda_lib, matching  # noqa: E402
from uni3detr_tpu_torch.ops import sparse_conv_cuda as sc  # noqa: E402
from uni3detr_tpu_torch.presets import NUSCENES, SUNRGBD  # noqa: E402
from uni3detr_tpu_torch.synthetic import (  # noqa: E402
    clustered_scene, clustered_train_batch)
from uni3detr_tpu_torch.train import losses  # noqa: E402
from uni3detr_tpu_torch.weights import random_state_dict  # noqa: E402

REPS = 20


def device_ms(fn, names):
    """Device ms per call of ``fn`` of the kernels whose name holds one
    of ``names`` (after a warm-up call): {name: (launches, ms)}."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {n: [0.0, 0.0] for n in names}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in e.key:
                out[n][0] += e.count / REPS
                out[n][1] += e.self_device_time_total / 1e3 / REPS
    return out


def event_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def k1(tag, sets):
    def kern():
        for s in sets:
            sc.match_positions(s["ids"], s["qids"], s["n_sites"])

    def lib():
        for s in sets:
            torch.searchsorted(s["ids"], s["qids"].reshape(
                s["ids"].shape[0], -1))

    (n, ms), = device_ms(kern, ["u3d_match_positions"]).values()
    lib_ms = sum(v[1] for v in device_ms(lib, [""]).values())
    print(f"[{tag}] K1 launches={n:g} device_ms={ms:.4f} "
          f"torch.searchsorted device_ms={lib_ms:.4f} (positions only) "
          f"V={[s['n_sites'] for s in sets]} B={sets[0]['ids'].shape[0]}")


def main(tag: str = "tree"):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not cuda_lib.CSRC.is_relative_to(ROOT):
        raise SystemExit(f"imported {cuda_lib.CSRC}, not from {ROOT}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cuda_lib.library()
    dev = torch.device("cuda", 0)
    for name, cfg in (("nuscenes", NUSCENES), ("sunrgbd", SUNRGBD)):
        t = f"{tag} {name}"
        model = Uni3DETR(cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               random_state_dict(model, 0).items()})
        model.to(dev).train()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 clustered_train_batch(0, cfg, 4).items()}
        calls = []
        real = losses.match_queries_to_gt

        def record(*a, **k):
            calls.append((a, k))
            return real(*a, **k)

        with torch.no_grad():
            torch.manual_seed(0)
            outs = model(batch["points"], batch["pts_mask"])
            with mock.patch.object(losses, "match_queries_to_gt", record):
                losses.uni3detr_loss(outs, gravity_center_boxes(
                    batch["gt_boxes"]), batch["gt_labels"],
                    batch["gt_mask"], cfg)

            def replay():
                for a, k in calls:
                    real(*a, **k)

            (n, ms), = device_ms(replay, ["u3d_auction"]).values()
            ev = event_ms(replay)
            shapes = [tuple(a[0].shape) for a, _ in calls]
            print(f"[{t}] K12 per train step: {len(calls)} matching calls "
                  f"of costs {shapes}, launches={n:g} device_ms={ms:.4f} "
                  f"event_ms={ev:.4f} (padding included)")
            counts = getattr(matching.auction_lap, "counts", None)
            if counts is not None:
                replay()
                r = matching.auction_lap.counts[:, 0].tolist()
                print(f"[{t}] K12 rounds per instance ({len(r)} in the last "
                      f"call, {matching.auction_lap.variant}): min={min(r)} "
                      f"median={statistics.median(r)} max={max(r)}; device "
                      f"ms per round of the longest "
                      f"{ms / max(max(r), 1) * 1e3:.3f} us")
            _, coords, vmask = model.voxelize(batch["points"],
                                              batch["pts_mask"])
            k1(f"{t} train step",
               model.pts_middle_encoder.site_sets(coords, vmask))
            model.eval()
            pts = torch.from_numpy(clustered_scene(0, cfg)[0]).to(dev)
            mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
            _, coords, vmask = model.voxelize(pts, mask)
            k1(f"{t} scene", model.pts_middle_encoder.site_sets(coords,
                                                                vmask))
        del model, outs, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(*sys.argv[2:3])
