"""Import of a reference checkpoint (the port's counterpart of
``uni3detr_tpu/train/torch_import.py``).

The port names its parameters after the reference's ``state_dict`` keys
(Uni3DETR: ``pts_middle_encoder / pts_backbone / pts_neck /
pts_bbox_head``; OV-Uni3DETR adds ``img_backbone / img_neck /
input_proj / depth_net / view_trans / conv_trans_head_1`` and the CLIP
head's ``zs_weights``), so a released mmdet3d ``.pth`` loads almost as
it is. :func:`load_reference_state_dict` does what is left and checks
the rest:

- unwraps mmdet3d's ``{"meta", "state_dict", ...}`` and a DDP
  ``module.`` prefix;
- takes every sparse-conv weight in mmcv's ``(kd, kh, kw, in, out)``
  layout, turning spconv-v2's ``(out, kd, kh, kw, in)`` into it (told
  apart by where the output channels sit, as the JAX importer does) and
  raising on any other layout;
- folds the eval-mode BN of the view transformer's ``trans_conv`` /
  ``time_conv`` into its 1x1 conv ``.0`` and drops the BN ``.1``, which
  the port does not have, as the JAX importer folds them into a Dense,
  so both packages hold the same numbers;
- carries the OV head's ``zs_weights`` buffer;
- drops the reference's unused ``pts_conv`` / ``img_conv`` modules of
  OV-Uni3DETR, and the BN ``num_batches_tracked`` counts (the port's BN
  uses a fixed momentum, as the JAX importer keeps no count);
- raises on a missing key, on a key left over (other than
  ``num_batches_tracked`` and ``code_weights``) and on a shape that does
  not match the model of ``cfg``.

The result equals ``weights.state_dict_from_jax(import_torch_state_dict(
sd, cfg))`` (``_ov`` for OV) tensor for tensor.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# keys a reference checkpoint may hold that the model does not use
EXPECTED_LEFTOVERS = ("num_batches_tracked", "code_weights")
# OV-Uni3DETR modules the reference builds but never calls
DEAD_PREFIXES = ("pts_conv.", "img_conv.")
# the eps of the folded BN
_BN_EPS = 1e-5
# the view transformer's 1x1 convs whose reference BN folds into them
_FOLDED = ("view_trans.trans_conv", "view_trans.time_conv")


def unwrap_checkpoint(raw) -> Dict:
    """A loaded ``.pth`` -> its flat ``state_dict``: mmdet3d's
    ``{"state_dict": ..., "meta": ...}`` or a bare state dict, with a
    DDP ``module.`` prefix removed."""
    sd = raw.get("state_dict", raw) if isinstance(raw, Mapping) else raw
    if not isinstance(sd, Mapping):
        raise ValueError(f"not a state dict: {type(sd).__name__}")
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def model_keys(cfg) -> Dict[str, tuple]:
    """The port model's ``state_dict`` keys of ``cfg`` -> (shape, dtype),
    from a model built on the meta device (no memory, no init)."""
    from ..models.detector import Uni3DETR
    from ..models.ov_detector import OV_Uni3DETR

    cls = OV_Uni3DETR if hasattr(cfg, "clip_dim") else Uni3DETR
    with torch.device("meta"):
        model = cls(cfg)
    return {k: (tuple(v.shape), v.dtype)
            for k, v in model.state_dict().items()}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _spconv(key: str, w: np.ndarray, shape: tuple) -> np.ndarray:
    """A sparse-conv weight in mmcv's (kd, kh, kw, in, out) layout of
    ``shape``, from mmcv's or spconv-v2's (out, kd, kh, kw, in)."""
    out = shape[-1]
    if w.ndim != 5:
        raise ValueError(f"{key}: expected a 5D sparse-conv weight, got "
                         f"shape {w.shape}")
    if w.shape[-1] == out and w.shape[0] != out:
        return w
    if w.shape[0] == out:
        return np.ascontiguousarray(w.transpose(1, 2, 3, 4, 0))
    raise ValueError(f"{key}: cannot identify the sparse-conv layout of "
                     f"shape {w.shape} (out={out})")


def _fold_conv_bn(sd: Dict[str, np.ndarray], prefix: str, out: Dict):
    """``prefix`` = the reference's Sequential(Conv3d 1x1x1, BN3d, ReLU):
    the conv ``.0`` takes the eval BN (a = gamma / sqrt(var + eps), W a,
    (b - mean) a + beta)."""
    w = sd[f"{prefix}.0.weight"].astype(np.float32)       # (out, in, 1,1,1)
    b = sd[f"{prefix}.0.bias"].astype(np.float32)
    g = sd[f"{prefix}.1.weight"].astype(np.float32)
    beta = sd[f"{prefix}.1.bias"].astype(np.float32)
    mean = sd[f"{prefix}.1.running_mean"].astype(np.float32)
    var = sd[f"{prefix}.1.running_var"].astype(np.float32)
    a = g / np.sqrt(var + _BN_EPS)
    kern = w.reshape(w.shape[0], w.shape[1]).T * a[None, :]   # (in, out)
    out[f"{prefix}.0.weight"] = kern.T.reshape(w.shape)
    out[f"{prefix}.0.bias"] = (b - mean) * a + beta


def load_reference_state_dict(sd: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (a loaded ``.pth`` or its ``state_dict``)
    -> the port's ``state_dict`` for the model of ``cfg`` (Uni3DETR or
    OV-Uni3DETR), ready for ``load_state_dict(strict=True)``. See the
    module docstring for what is converted and what raises."""
    src = {k: _np(v) for k, v in unwrap_checkpoint(sd).items()}
    want = model_keys(cfg)
    out: Dict[str, np.ndarray] = {}
    folded = []
    for prefix in _FOLDED:
        if f"{prefix}.0.weight" in want and f"{prefix}.0.weight" in src:
            _fold_conv_bn(src, prefix, out)
            folded.append(f"{prefix}.1.")
    missing = []
    for key, (shape, dtype) in want.items():
        if key in out:
            continue
        if key.endswith("num_batches_tracked"):
            out[key] = np.asarray(0, np.int64)
            continue
        if key not in src:
            missing.append(key)
            continue
        v = src[key]
        if key.startswith("pts_middle_encoder.") and len(shape) == 5:
            v = _spconv(key, v, shape)
        out[key] = v.astype(np.float32) if dtype == torch.float32 else v
    if missing:
        raise KeyError(f"the checkpoint is missing {len(missing)} keys of "
                       f"the model, e.g. {missing[:8]}")
    leftovers = sorted(
        k for k in src if k not in want
        and not k.startswith(DEAD_PREFIXES + tuple(folded))
        and not any(s in k for s in EXPECTED_LEFTOVERS))
    if leftovers:
        raise ValueError(f"{len(leftovers)} checkpoint keys were not "
                         f"consumed, e.g. {leftovers[:8]}")
    wrong = [f"{k}: {tuple(out[k].shape)} != {want[k][0]}"
             for k in want if tuple(out[k].shape) != want[k][0]]
    if wrong:
        raise ValueError(f"{len(wrong)} checkpoint tensors have the wrong "
                         f"shape, e.g. {wrong[:8]}")
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}
