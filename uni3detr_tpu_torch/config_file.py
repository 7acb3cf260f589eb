"""Python-file configs of the port (jax-free copy of
``uni3detr_tpu/config/config.py``).

A config file under ``configs/`` sets plain variables: ``_base_`` lists
files it inherits from, ``preset`` names a model preset
(:data:`uni3detr_tpu_torch.presets.PRESETS`) and ``model = dict(...)``
overrides its dataclass fields; ``--cfg-options a.b.c=value`` overrides
any key. The module is named ``config_file`` because
``uni3detr_tpu_torch/config.py`` already holds the model dataclass, so a
``config/`` package would clash with it.
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import os
from typing import Any, Dict, List


class Config(dict):
    """dict with attribute access (cfg.model.num_query style)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(
            v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v


def _deep_merge(base: Dict, new: Dict) -> Dict:
    """new wins; dicts merge recursively; ``_delete_=True`` resets a key."""
    out = copy.deepcopy(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict) \
                and not v.pop("_delete_", False):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Config:
    """Execute a python config file, resolving ``_base_`` includes."""
    path = os.path.abspath(path)
    ns: Dict[str, Any] = {"__file__": path}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), ns)
    cfg = {k: v for k, v in ns.items()
           if not k.startswith("__") and not callable(v)
           and not isinstance(v, type(os))}
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = os.path.join(os.path.dirname(path), b)
        merged = _deep_merge(merged, load_config(bpath))
    merged = _deep_merge(merged, cfg)
    return Config(merged)


def _parse_value(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def merge_cfg_options(cfg: Config, options: List[str]) -> Config:
    """Apply ``a.b.c=value`` CLI overrides (mmcv DictAction equivalent)."""
    for opt in options:
        key, _, val = opt.partition("=")
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        node[parts[-1]] = _parse_value(val)
    return cfg


def build_model_config(cfg: Config):
    """cfg.preset + cfg.model field overrides -> the port's
    ``Uni3DETRConfig`` / ``OVUni3DETRConfig``. Unknown fields raise a
    KeyError, an unknown ``post_processing`` a ValueError."""
    from .presets import PRESETS
    base = PRESETS[cfg["preset"]]
    overrides = dict(cfg.get("model", {}))
    valid = {f.name for f in dataclasses.fields(base)}
    unknown = set(overrides) - valid
    if unknown:
        raise KeyError(f"unknown model config fields: {sorted(unknown)}")

    def _freeze(v):
        if isinstance(v, list):
            return tuple(_freeze(x) for x in v)
        return v
    overrides = {k: _freeze(v) for k, v in overrides.items()}
    mc = dataclasses.replace(base, **overrides)
    valid_pp = ("nms", "soft_nms", "box_merging", "none")
    if mc.post_processing not in valid_pp:
        raise ValueError(
            f"post_processing={mc.post_processing!r} not in {valid_pp}")
    return mc
