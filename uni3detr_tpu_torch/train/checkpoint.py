"""Checkpoints of the port (counterpart of
``uni3detr_tpu/train/checkpoint.py``).

A checkpoint is a directory: ``checkpoint.pt`` (``torch.save`` of the
model's ``state_dict`` with its BN buffers and, for OV, the CLIP text
embeddings ``zs_weights``; the optimizer's state, every parameter group
with its multiplier; the step; and optionally the state of the OV
modality generator) and, when given, ``meta.json`` (the config text,
class names, ...), where the JAX package writes an orbax tree and the
same ``meta.json``. Restoring puts every tensor back bit for bit, so a
resumed run takes the same steps as an uninterrupted one.

:func:`load_branch` is the OV staged initialisation: it copies a
pretrained branch out of another checkpoint's model by key prefix.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..parallel import dist
from .step import Optimizer

_FILE = "checkpoint.pt"


def save_checkpoint(path: str, model: nn.Module,
                    opt: Optional[Optimizer] = None,
                    meta: Optional[Dict] = None,
                    generator: Optional[torch.Generator] = None) -> None:
    """Write the model (and the optimizer with its step, and the state of
    ``generator``, the OV modality draw's) under ``path``. Under a process
    group rank 0 writes (the ranks hold the same state) and every rank
    waits until it has."""
    if dist.is_main_process():
        _write(path, model, opt, meta, generator)
    dist.barrier()


def _write(path, model, opt, meta, generator) -> None:
    os.makedirs(path, exist_ok=True)
    tree = {"model": model.state_dict()}
    if opt is not None:
        tree["optimizer"] = opt.state_dict()
        tree["step"] = opt.steps
    if generator is not None:
        tree["generator"] = generator.get_state()
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            # default=str keeps arbitrary config values serializable
            json.dump(meta, f, default=str)


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict, Optional[Dict]]:
    """Returns (the tree ``{"model", ["optimizer", "step"],
    ["generator"]}``, meta or None). Every rank of a process group loads
    it for itself; ``restore`` moves it to the rank's device."""
    tree = torch.load(os.path.join(path, _FILE), map_location=map_location,
                      weights_only=True)
    meta = None
    mpath = os.path.join(path, "meta.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    return tree, meta


def restore(model: nn.Module, tree: Dict,
            opt: Optional[Optimizer] = None,
            generator: Optional[torch.Generator] = None) -> None:
    """Load a loaded tree into ``model`` and, when given, ``opt`` and
    ``generator`` (eval restores the model alone). The optimizer must be
    built over this model's parameters, with the same groups; its state
    moves to their device. A tree without an optimizer (an imported
    reference checkpoint, ``cli.import_ckpt``) leaves ``opt`` as built,
    at step 0."""
    model.load_state_dict(tree["model"], strict=True)
    if opt is not None and "optimizer" in tree:
        opt.load_state_dict(tree["optimizer"])
    if generator is not None and "generator" in tree:
        generator.set_state(tree["generator"])


def load_branch(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                src_prefix: str, dst_prefix: str) -> int:
    """Copy a branch of a pretrained model into ``model``: every entry of
    ``model.state_dict()`` under ``dst_prefix`` takes the entry of
    ``state_dict`` (a checkpoint's ``tree["model"]``) under
    ``src_prefix`` with the same rest of the key, where one exists with
    the same shape; the others keep their values. Returns the number of
    tensors copied.

    As ``uni3detr_tpu/train/checkpoint.py::load_branch`` (the OV configs'
    ``load_img`` / ``load_pts`` prefixes), but the BN running statistics
    come with the parameters, as the reference loads the branches' state
    dicts; the JAX package copies the parameters only (ROADMAP Queue 3).
    """
    own = model.state_dict()
    new = {}
    for key, value in own.items():
        if not key.startswith(dst_prefix):
            continue
        src = state_dict.get(src_prefix + key[len(dst_prefix):])
        if src is not None and tuple(src.shape) == tuple(value.shape):
            new[key] = src
    model.load_state_dict(new, strict=False)
    return len(new)
