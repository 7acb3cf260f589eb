"""Offline evaluation of dumped detections (after
``uni3detr_tpu/cli/eval_metric.py``):

    python -m uni3detr_tpu_torch.cli.eval_metric CONFIG RESULTS.pkl \\
        [--cfg-options k=v ...] [--device cuda|cpu]

Re-scores a detections pkl written by ``cli.test --out`` against the
config's val split without running the model. The metric is
``train.evaluator.evaluate``'s, the one ``cli.test`` prints, for every
dataset type (the JAX package's CLI scores nuScenes with indoor AP and
KITTI without the 2D boxes). The metrics' overlaps run on ``--device``.
"""
from __future__ import annotations

import argparse
import json
import pickle
import sys

import torch


def main(argv=None):
    """Run the CLI; returns the metric dict."""
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("results")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("cli.eval_metric: no CUDA device; pass --device cpu")

    from ..config_file import build_model_config, load_config, \
        merge_cfg_options
    from ..data.datasets import build_dataset
    from ..train.evaluator import evaluate

    cfg = load_config(args.config)
    cfg = merge_cfg_options(cfg, args.cfg_options)
    mc = build_model_config(cfg)
    with open(args.results, "rb") as f:
        dets = pickle.load(f)
    dataset = build_dataset(cfg.data, cfg.class_names, mc.pc_range, "val")
    gts = []
    for i in range(len(dets)):
        s = dataset[i]
        gt = {"boxes": s["gt_boxes"], "labels": s["gt_labels"]}
        if "gt_attrs" in s.get("meta", {}):
            gt["attrs"] = s["meta"]["gt_attrs"]
        gts.append(gt)
    metrics = evaluate(dets, gts, cfg, dataset, device=args.device)
    print(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
