"""Evaluation CLI of the port (after ``uni3detr_tpu/cli/test.py``):

    python -m uni3detr_tpu_torch.cli.test CONFIG [CKPT] --eval bbox \\
        [--tta] [--out dets.pkl] [--format-only] [--show-dir DIR] \\
        [--batch-size N] [--max-samples N] [--cfg-options k=v ...] \\
        [--num-processes W --process-id R --coordinator HOST:PORT] \\
        [--device cuda|cpu]
    torchrun --nproc_per_node W -m uni3detr_tpu_torch.cli.test CONFIG ...

Loads a config file and a checkpoint of the port (``train.checkpoint``;
without one the weights are random, seed 0), runs batched inference over
the val split (``train.evaluator.run_inference``) and evaluates it: indoor
AP for SUN RGB-D / ScanNet and the synthetic sets, KITTI AP, nuScenes
metrics, or with ``--format-only`` the KITTI label txts / nuScenes JSON.
It runs on the card (``--device cuda``, the default) and exits with an
error when there is none; ``--device cpu`` runs the kernels' plain
versions on the CPU.

Data parallel (torchrun's environment or the JAX CLI's flags, as
``cli.train``): each rank runs a round-robin shard of the split
(``train.evaluator.run_inference_distributed``) and prints its own
timings; rank 0 gathers the detections in dataset order and alone writes
``--out``, ``--show-dir`` and the submission files and computes the
metric. The other ranks return without writing.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np
import torch

from .train import add_dist_args, start_distributed


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a uni3detr_tpu_torch model")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="a checkpoint directory of train.checkpoint "
                        "(random weights, seed 0, when omitted)")
    p.add_argument("--eval", default=None, help="e.g. bbox")
    p.add_argument("--out", default=None, help="dump detections pkl")
    p.add_argument("--format-only", action="store_true",
                   help="write submission files (KITTI txts / nuScenes "
                        "json) without computing metrics")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="eval batch size (default cfg samples_per_gpu)")
    p.add_argument("--show-dir", default=None,
                   help="write per-sample BEV PNGs (points + GT + dets) "
                        "to this directory")
    p.add_argument("--show-score-thr", type=float, default=0.3)
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation over the cfg 'tta' grid "
                        "(flips by default)")
    add_dist_args(p)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) runs the kernels on the card; "
                        "cpu runs their plain versions")
    return p.parse_args(argv)


def build_model(model_cfg, checkpoint=None, device="cuda", log=print,
                seed=0, init=None):
    """The config's model in eval mode on ``device``: a checkpoint's
    weights, or ``init(model, seed)``'s (default
    ``weights.random_state_dict``: random ones); the CLIP text embeddings
    from ``zeroshot_path`` where the config names one."""
    from ..models.detector import Uni3DETR
    from ..models.ov_detector import OV_Uni3DETR
    from ..train.checkpoint import load_checkpoint, restore
    from ..train.evaluator import is_ov
    from ..weights import random_state_dict

    model = (OV_Uni3DETR if is_ov(model_cfg) else Uni3DETR)(model_cfg)
    if checkpoint:
        tree, _ = load_checkpoint(checkpoint)
        restore(model, tree)
        log(f"loaded checkpoint {checkpoint}")
    else:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               (init or random_state_dict)(
                                   model, seed).items()}, strict=True)
    zs_path = getattr(model_cfg, "zeroshot_path", None)
    if zs_path:
        zs = torch.from_numpy(np.load(zs_path).astype(np.float32))
        model.pts_bbox_head.zs_weights.copy_(
            (zs / zs.norm(dim=-1, keepdim=True)).T)
    return model.eval().to(device)


def main(argv=None):
    """Run the CLI; returns {"dets", "gts", "metrics", "stats", "rank",
    "world_size"} for callers in the same process (on a rank other than
    0 empty detections, GT and metrics, and the rank's own ``stats``)."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("cli.test: no CUDA device; pass --device cpu to run the "
                 "plain versions of the kernels on the CPU")
    from ..parallel import dist

    device, started = start_distributed(args)
    try:
        return _test(args, device)
    finally:
        if started:
            dist.destroy_distributed()


def _test(args, device):
    from ..config_file import build_model_config, load_config, \
        merge_cfg_options
    from ..data.datasets import box_type_of, build_dataset
    from ..parallel import dist
    from ..train import evaluator

    W, rank = dist.world_size(), dist.rank()
    cfg = load_config(args.config)
    cfg = merge_cfg_options(cfg, args.cfg_options)
    model_cfg = build_model_config(cfg)
    dataset = build_dataset(cfg.data, cfg.class_names, model_cfg.pc_range,
                            "val")
    model = build_model(model_cfg, args.checkpoint, device,
                        log=print if rank == 0 else (lambda *a: None))

    tta_grid = None
    if args.tta:
        from ..train.tta import make_aug_grid
        tcfg = cfg.get("tta", {})
        tta_grid = make_aug_grid(
            rot_degrees=tcfg.get("rot_degrees", (0.0,)),
            scales=tcfg.get("scales", (1.0,)),
            flips=tcfg.get("flips", (False, True)))
        if rank == 0:
            print(f"TTA over {len(tta_grid)} augmentations")

    bs = args.batch_size or cfg.data.get("samples_per_gpu", 1)
    stats = {}
    # the shared directory of UNI3DETR_GATHER=file
    tmpdir = os.path.join(os.path.dirname(os.path.abspath(args.out))
                          if args.out else "work_dirs", ".dist_eval")
    dets, gts = evaluator.run_inference_distributed(
        dataset, model, model_cfg, device=device, batch_size=bs,
        max_samples=args.max_samples, tta_grid=tta_grid,
        box_type=box_type_of(cfg.data), log=print if rank == 0 else None,
        stats=stats, tmpdir=tmpdir)
    n, wall = stats["scenes"], stats["wall_s"]
    line = (f"rank {rank} of {W}: " if W > 1 else "") + (
            f"{n} scenes in {wall:.3f} s ({n / wall:.3f} scenes/s) at "
            f"batch {bs}: load + collate "
            f"{sum(stats['load_ms']) / max(n, 1):.3f} ms a scene")
    if stats["stream_ms"]:
        share = sum(stats["stream_ms"]) / 1e3 / wall
        line += (f", stream {np.median(stats['stream_ms']):.3f} ms a batch "
                 f"(median of {len(stats['stream_ms'])}), stream share "
                 f"{share:.3f}")
    done = stats["done_s"]
    if len(done) > 2:
        # the first batch holds the warm-up: time the later ones alone
        line += (f"; after the first batch "
                 f"{(n - bs) / (done[-1] - done[0]):.3f} scenes/s over "
                 f"{len(done) - 1} batches")
    print(line)
    if rank != 0:
        # the detections were gathered on rank 0, which writes alone
        return {"dets": [], "gts": [], "metrics": {}, "stats": stats,
                "rank": rank, "world_size": W}

    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(dets, f)
        print(f"wrote {args.out}")
    if args.show_dir:
        from ..utils.visualize import save_results_bev
        save_results_bev(dataset, dets, args.show_dir,
                         score_thr=args.show_score_thr,
                         class_names=list(cfg.class_names))
    metrics = {}
    if args.format_only:
        evaluator.evaluate(dets, gts, cfg, dataset,
                           out_prefix=args.out or "work_dirs/results",
                           format_only=True, device=device)
    elif args.eval:
        metrics = evaluator.evaluate(
            dets, gts, cfg, dataset,
            out_prefix=args.out or "work_dirs/results", device=device)
        print(json.dumps({k: float(v) for k, v in metrics.items()},
                         indent=2))
    return {"dets": dets, "gts": gts, "metrics": metrics, "stats": stats,
            "rank": rank, "world_size": W}


if __name__ == "__main__":
    main()
