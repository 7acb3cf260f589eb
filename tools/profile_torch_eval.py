#!/usr/bin/env python3
"""Throughput of the port's evaluation entry point (``cli.test``) on one
GPU, over many warm batches.

    python3 tools/profile_torch_eval.py [--scenes 128] [--repeats 2] \\
        [--out result.json]

Writes two synthetic SUN RGB-D data roots of ``--scenes`` scenes under
``build/profile_torch_eval`` (``synthetic.write_sunrgbd_root``: 120000
points a scene on disk, of which ``PointSample`` keeps 100000; the second
root with a 480x640 PNG and calib a scene) and a seed-0 checkpoint of
``uni3detr_sunrgbd``. Then, ``--repeats`` times, it runs:

- ``cli.test configs/uni3detr/uni3detr_sunrgbd.py CKPT --eval bbox``
  ("flagship"), the same with ``--tta`` ("flagship-tta") and
  ``cli.test configs/ov_uni3detr/ov_uni3detr_sunrgbd_mm.py --eval bbox``
  ("ov-mm", random weights), each at its config's batch size;
- the same inference (``train.evaluator.run_inference``, same model and
  grid) on the dataset's samples loaded into memory beforehand
  ("...-preloaded"): the loader thread then only collates, so the gap
  between the two runs is what the loading costs the pace.

For each run, from the batches after the first (the first holds the
warm-up): scenes/s = (scenes - batch) / (the time the last batch was
done - the time the first was), the median load + collate ms a batch
(the loader thread) and stream ms a batch (CUDA events from the input
copy to the output copy: the device's work and any wait for the host
that issues it), and the stream share (their stream ms over that
window; near 1 when the stream always holds a batch, whether the device
or the host issuing it sets the pace); beside them the whole run's
scenes/s. One JSON object of every run is printed last (and written to
``--out``). Needs a CUDA device; prints the card's name and power limit
first.
"""
import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from uni3detr_tpu_torch.cli import test as cli_test  # noqa: E402
from uni3detr_tpu_torch.config_file import (  # noqa: E402
    build_model_config, load_config, merge_cfg_options)
from uni3detr_tpu_torch.data.datasets import build_dataset  # noqa: E402
from uni3detr_tpu_torch.models.detector import Uni3DETR  # noqa: E402
from uni3detr_tpu_torch.presets import PRESETS, SUNRGBD  # noqa: E402
from uni3detr_tpu_torch.synthetic import write_sunrgbd_root  # noqa: E402
from uni3detr_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from uni3detr_tpu_torch.train.evaluator import run_inference  # noqa: E402
from uni3detr_tpu_torch.train.tta import make_aug_grid  # noqa: E402
from uni3detr_tpu_torch.weights import random_state_dict  # noqa: E402

WORK = ROOT / "build" / "profile_torch_eval"
SUNRGBD_CONFIG = str(ROOT / "configs/uni3detr/uni3detr_sunrgbd.py")
OV_MM_CONFIG = str(ROOT / "configs/ov_uni3detr/ov_uni3detr_sunrgbd_mm.py")


class Preloaded:
    """A dataset's first ``n`` samples, loaded once, served from memory."""

    def __init__(self, dataset, n):
        self.samples = [dataset[i] for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def summary(stats, bs):
    """The run's numbers after its first batch, and the whole run's
    scenes/s."""
    done, n = stats["done_s"], stats["scenes"]
    window = done[-1] - done[0]
    stream = stats["stream_ms"][1:]
    return {"scenes": n, "batch": bs, "batches": len(done),
            "warm_batches": len(done) - 1,
            "scenes_per_s": (n - bs) / window,
            "load_ms_per_batch": statistics.median(stats["load_ms"][1:]),
            "stream_ms_per_batch": statistics.median(stream),
            "stream_share": sum(stream) / 1e3 / window,
            "first_batch_stream_ms": stats["stream_ms"][0],
            "whole_run_scenes_per_s": n / stats["wall_s"]}


def preloaded_run(config, root, ckpt, tta, n, dev):
    """``run_inference`` as ``cli.test`` calls it, on preloaded samples."""
    cfg = merge_cfg_options(load_config(config),
                            [f"data.data_root={root}"])
    mc = build_model_config(cfg)
    ds = Preloaded(build_dataset(cfg.data, cfg.class_names, mc.pc_range,
                                 "val"), n)
    model = cli_test.build_model(mc, ckpt, dev, log=lambda _: None)
    grid = None
    if tta:
        tcfg = cfg.get("tta", {})
        grid = make_aug_grid(rot_degrees=tcfg.get("rot_degrees", (0.0,)),
                             scales=tcfg.get("scales", (1.0,)),
                             flips=tcfg.get("flips", (False, True)))
    bs = cfg.data.get("samples_per_gpu", 1)
    stats = {}
    run_inference(ds, model, mc, device=dev, batch_size=bs, tta_grid=grid,
                  box_type=cfg.data.get("box_type", "Depth"), stats=stats)
    del model
    torch.cuda.empty_cache()
    return summary(stats, bs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scenes", type=int, default=128)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    shutil.rmtree(WORK, ignore_errors=True)
    root, ov_root, ckpt = (str(WORK / d) for d in ("sunrgbd", "ov",
                                                   "checkpoint"))
    t0 = time.perf_counter()
    write_sunrgbd_root(root, SUNRGBD, load_config(SUNRGBD_CONFIG).class_names,
                       args.scenes)
    write_sunrgbd_root(ov_root, PRESETS["ov_uni3detr_sunrgbd_mm"],
                       load_config(OV_MM_CONFIG).class_names, args.scenes,
                       camera=True)
    model = Uni3DETR(SUNRGBD)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_state_dict(model, 0).items()})
    save_checkpoint(ckpt, model)
    del model
    print(f"wrote 2 x {args.scenes} scenes and a checkpoint under {WORK} "
          f"({time.perf_counter() - t0:.1f} s)")

    runs = (("flagship", SUNRGBD_CONFIG, root, ckpt, False),
            ("flagship-tta", SUNRGBD_CONFIG, root, ckpt, True),
            ("ov-mm", OV_MM_CONFIG, ov_root, None, False))
    results = []
    for rep in range(args.repeats):
        for tag, config, data_root, weights, tta in runs:
            argv = [config] + ([weights] if weights else []) + [
                "--cfg-options", f"data.data_root={data_root}",
                "--eval", "bbox"] + (["--tta"] if tta else [])
            r = cli_test.main(argv)
            bs = load_config(config).data.get("samples_per_gpu", 1)
            res = dict(run=tag, repeat=rep, **summary(r["stats"], bs))
            results.append(res)
            print(json.dumps(res))
            res = dict(run=f"{tag}-preloaded", repeat=rep,
                       **preloaded_run(config, data_root, weights, tta,
                                       args.scenes, dev))
            results.append(res)
            print(json.dumps(res))
    shutil.rmtree(WORK, ignore_errors=True)
    out = {"card": card, "runs": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
