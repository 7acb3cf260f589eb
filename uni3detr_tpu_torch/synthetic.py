"""Seeded synthetic scenes for the port's smoke run and profiles."""
from __future__ import annotations

import numpy as np

from .config import Uni3DETRConfig


def clustered_scene(seed: int, cfg: Uni3DETRConfig):
    """One scene of ``cfg.num_points`` points shaped like a real scan: 24
    tight Gaussian blobs inside ``pc_range``, each squashed along one
    random axis into a planar patch; extra channels uniform in [0, 1).

    Returns (points (1, P, C) float32, random query points (1, nq, 3)).
    """
    rng = np.random.RandomState(seed)
    P = cfg.num_points
    lo = np.asarray(cfg.pc_range[:3])
    span = np.asarray(cfg.pc_range[3:]) - lo
    K = 24
    centers = lo + span * (0.1 + 0.8 * rng.rand(K, 3))
    assign = rng.randint(0, K, P)
    offs = rng.randn(P, 3) * span * 0.02
    squash = 1.0 - 0.95 * np.eye(3)[rng.randint(0, 3, K)]
    xyz = np.clip(centers[assign] + offs * squash[assign],
                  lo + 1e-4, lo + span - 1e-3)
    extra = rng.rand(P, cfg.in_point_features - 3)
    pts = np.concatenate([xyz, extra], -1).astype(np.float32)[None]
    rnd = rng.rand(1, cfg.num_query, 3).astype(np.float32)
    return pts, rnd
