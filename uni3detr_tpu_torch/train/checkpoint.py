"""Checkpoints of the port (counterpart of
``uni3detr_tpu/train/checkpoint.py``).

A checkpoint is a directory: ``checkpoint.pt`` (``torch.save`` of the
model's ``state_dict`` with its BN buffers, the optimizer's state and the
step) and, when given, ``meta.json`` (the config text, class names, ...),
where the JAX package writes an orbax tree and the same ``meta.json``.
Restoring puts every tensor back bit for bit, so a resumed run takes the
same steps as an uninterrupted one. The OV staged branch loading
(``load_branch``) is not ported.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .step import Optimizer

_FILE = "checkpoint.pt"


def save_checkpoint(path: str, model: nn.Module,
                    opt: Optional[Optimizer] = None,
                    meta: Optional[Dict] = None) -> None:
    """Write the model (and the optimizer with its step) under ``path``."""
    os.makedirs(path, exist_ok=True)
    tree = {"model": model.state_dict()}
    if opt is not None:
        tree["optimizer"] = opt.state_dict()
        tree["step"] = opt.steps
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            # default=str keeps arbitrary config values serializable
            json.dump(meta, f, default=str)


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict, Optional[Dict]]:
    """Returns (the tree ``{"model", ["optimizer", "step"]}``, meta or
    None)."""
    tree = torch.load(os.path.join(path, _FILE), map_location=map_location,
                      weights_only=True)
    meta = None
    mpath = os.path.join(path, "meta.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    return tree, meta


def restore(model: nn.Module, tree: Dict,
            opt: Optional[Optimizer] = None) -> None:
    """Load a loaded tree into ``model`` and, when given, ``opt`` (eval
    restores the model alone). The optimizer must be built over this
    model's parameters; its state moves to their device."""
    model.load_state_dict(tree["model"], strict=True)
    if opt is not None:
        opt.load_state_dict(tree["optimizer"])
