"""Import a released reference checkpoint (after
``tools/import_torch_ckpt.py``):

    python -m uni3detr_tpu_torch.cli.import_ckpt CKPT.pth OUT_DIR \\
        --preset uni3detr_sunrgbd

Reads an mmdet3d ``.pth`` (``{"meta", "state_dict"}`` or a bare state
dict; sparse convs in mmcv's or spconv-v2's layout) on the CPU, maps it
onto the port's model of the preset
(``train.torch_import.load_reference_state_dict``, which raises on a
missing or stray key and on a wrong shape, naming the key), and writes a
``train.checkpoint`` directory: the model's weights with no optimizer
state, and ``meta.json`` with the class names of the shipped config
under ``configs/`` that names the preset, the preset, the source and the
``.pth``'s meta keys. ``cli.test`` scores it; ``cli.train
--resume-from`` starts from its weights at step 0 with a fresh
optimizer.
"""
from __future__ import annotations

import argparse
import glob
import os

import torch

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Import a reference .pth into a checkpoint of the port")
    p.add_argument("ckpt")
    p.add_argument("out_dir")
    p.add_argument("--preset", default="uni3detr_sunrgbd",
                   help="a preset of presets.PRESETS")
    return p.parse_args(argv)


def preset_classes(preset: str):
    """The class names of the first shipped config (``configs/*/*.py``,
    by name) whose ``preset`` is ``preset``."""
    from ..config_file import load_config

    for path in sorted(glob.glob(os.path.join(CONFIG_DIR, "*", "*.py"))):
        cfg = load_config(path)
        if cfg.get("preset") == preset:
            return list(cfg.class_names)
    raise ValueError(f"no config under {CONFIG_DIR} uses preset {preset!r}")


def main(argv=None):
    """Run the CLI; returns the number of tensors written."""
    args = parse_args(argv)
    from ..models.detector import Uni3DETR
    from ..models.ov_detector import OV_Uni3DETR
    from ..presets import PRESETS
    from ..train.checkpoint import save_checkpoint
    from ..train.evaluator import is_ov
    from ..train.torch_import import load_reference_state_dict

    model_cfg = PRESETS[args.preset]
    classes = preset_classes(args.preset)
    raw = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = load_reference_state_dict(raw, model_cfg)
    model = (OV_Uni3DETR if is_ov(model_cfg) else Uni3DETR)(model_cfg)
    model.load_state_dict(sd, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"imported {n_params / 1e6:.2f}M parameters ({len(sd)} tensors) "
          f"from {args.ckpt}")
    torch_meta = raw.get("meta", {}) if isinstance(raw, dict) else {}
    save_checkpoint(args.out_dir, model, meta={
        "epoch": 0, "step": 0, "classes": classes, "preset": args.preset,
        "imported_from": os.path.abspath(args.ckpt),
        "torch_meta_keys": sorted(torch_meta)
        if isinstance(torch_meta, dict) else []})
    print(f"saved a checkpoint of the port at {args.out_dir}")
    return len(sd)


if __name__ == "__main__":
    main()
