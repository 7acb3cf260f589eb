"""FLOPs and memory of a config's model (after
``uni3detr_tpu/cli/get_flops.py``):

    python -m uni3detr_tpu_torch.cli.get_flops CONFIG [--batch N] \\
        [--cfg-options k=v ...] [--device cuda|cpu]

One eval forward of the config's model (its default initialisation) on
the JAX CLI's input: a zeros batch of ``num_points`` points (and, for a
camera model, zero images with identity poses), all valid, and the
random query group at 0.5. Prints the parameter count, the forward's
GFLOP and the GB it moves (``utils.profiling.flops_of``) and, on the
card, the peak of the allocated memory. The encoder's site budgets are
static, so the count does not depend on the input. The FLOPs are those
of ``torch.utils.flop_counter`` plus the kernels' records
(``ops.cost``): a sparse conv counts all of its taps, ``2 B Vout K C
Cout``, as the dense function that the TPU kernel computes, and the card
and the CPU give the same count. The bytes are the card's own
operations' and the kernels' operands and results; on the CPU the plain
versions move more. Neither figure compares with the JAX CLI's, which
are XLA's cost analysis of fused computations.
"""
from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FLOPs of a config's model")
    p.add_argument("config")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (the default) runs the kernels on the card; "
                        "cpu runs their plain versions")
    return p.parse_args(argv)


def zeros_batch(model_cfg, B: int, device):
    """The JAX CLI's input: (model arguments, random points)."""
    from ..train.evaluator import is_ov

    dev = torch.device(device)
    batch = {"points": torch.zeros((B, model_cfg.num_points,
                                    model_cfg.in_point_features),
                                   device=dev),
             "pts_mask": torch.ones((B, model_cfg.num_points),
                                    dtype=torch.bool, device=dev)}
    rp = torch.full((B, model_cfg.num_query, 3), 0.5, device=dev)
    if not is_ov(model_cfg):
        return (batch["points"], batch["pts_mask"], rp)
    if model_cfg.use_camera:
        H, W = model_cfg.img_size
        batch["images"] = torch.zeros((B, model_cfg.num_cams, H, W, 3),
                                      device=dev)
        batch["lidar2img"] = torch.eye(4, device=dev).repeat(
            B, model_cfg.num_cams, 1, 1)
        batch["uni_rot_aug"] = torch.eye(3, device=dev).repeat(B, 1, 1)
        if not model_cfg.use_lidar:
            del batch["points"], batch["pts_mask"]
    return (batch, rp)


def main(argv=None):
    """Run the CLI; returns ``{"params", "flops", "bytes_accessed",
    "peak_memory_bytes", "kernels"}``."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("cli.get_flops: no CUDA device; pass --device cpu to run "
                 "the plain versions of the kernels on the CPU")
    from ..config_file import build_model_config, load_config, \
        merge_cfg_options
    from ..models.detector import Uni3DETR
    from ..models.ov_detector import OV_Uni3DETR
    from ..train.evaluator import is_ov
    from ..utils.profiling import flops_of

    cfg = merge_cfg_options(load_config(args.config), args.cfg_options)
    mc = build_model_config(cfg)
    model = (OV_Uni3DETR if is_ov(mc) else Uni3DETR)(mc)
    model = model.eval().to(args.device)
    inputs = zeros_batch(mc, args.batch, args.device)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        cost = flops_of(model, *inputs)
    peak = cost["peak_memory_bytes"]
    print(f"params:        {n_params / 1e6:.2f} M")
    print(f"forward flops: {cost['flops'] / 1e9:.2f} GFLOP "
          f"(batch {args.batch})")
    print(f"bytes moved:   {cost['bytes_accessed'] / 1e9:.2f} GB")
    print("peak memory:   " + (f"{peak / 1e9:.2f} GB on the card"
                               if peak >= 0 else "not measured (CPU)"))
    return {"params": n_params, "flops": cost["flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "peak_memory_bytes": peak, "kernels": cost["kernels"]}


if __name__ == "__main__":
    main()
