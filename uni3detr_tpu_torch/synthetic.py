"""Seeded synthetic scenes and train batches for the port's smoke run,
profiles and tests."""
from __future__ import annotations

import numpy as np

from .config import Uni3DETRConfig


DISTRIBUTIONS = ("clustered", "uniform")


def _blobs(rng, cfg: Uni3DETRConfig, distribution: str = "clustered"):
    """(points (P, C), blob centres (K, 3), per-blob std (K, 3)).

    ``clustered``: the points lie in the blobs. ``uniform``: the same
    blobs are drawn (they place the GT boxes), then the points are
    uniform over ``pc_range``, as the JAX package's bench draws them
    (``bench.py`` ``uniform``): outdoor sweeps sampled to a few
    thousand points leave nearly every voxel isolated, and only such
    scenes grow the strided site sets past their budgets."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(f"distribution {distribution!r} not in "
                         f"{DISTRIBUTIONS}")
    P = cfg.num_points
    lo = np.asarray(cfg.pc_range[:3])
    span = np.asarray(cfg.pc_range[3:]) - lo
    K = 24
    centers = lo + span * (0.1 + 0.8 * rng.rand(K, 3))
    assign = rng.randint(0, K, P)
    offs = rng.randn(P, 3) * span * 0.02
    squash = 1.0 - 0.95 * np.eye(3)[rng.randint(0, 3, K)]
    if distribution == "uniform":
        xyz = lo + span * rng.rand(P, 3)
    else:
        xyz = centers[assign] + offs * squash[assign]
    xyz = np.clip(xyz, lo + 1e-4, lo + span - 1e-3)
    extra = rng.rand(P, cfg.in_point_features - 3)
    pts = np.concatenate([xyz, extra], -1).astype(np.float32)
    return pts, centers, span * 0.02 * squash


def clustered_scene(seed: int, cfg: Uni3DETRConfig,
                    distribution: str = "clustered"):
    """One scene of ``cfg.num_points`` points shaped like a real scan: 24
    tight Gaussian blobs inside ``pc_range``, each squashed along one
    random axis into a planar patch (or, with ``distribution="uniform"``,
    points uniform over the range); extra channels uniform in [0, 1).

    Returns (points (1, P, C) float32, random query points (1, nq, 3)).
    """
    rng = np.random.RandomState(seed)
    pts, _, _ = _blobs(rng, cfg, distribution)
    rnd = rng.rand(1, cfg.num_query, 3).astype(np.float32)
    return pts[None], rnd


def _gt_boxes(rng, centers, std, cfg: Uni3DETRConfig):
    """One box around each of the first ``min(24, 3 * max_gt // 4)``
    blobs: (boxes (n, 7|9) float32, bottom-z storage layout; labels (n,)
    int32 cycling over the classes)."""
    n_gt = min(24, max(1, 3 * cfg.max_gt // 4))
    size = np.maximum(4.0 * std[:n_gt], 0.05)
    bottom = centers[:n_gt, 2] - size[:, 2] / 2
    cols = [centers[:n_gt, :2], bottom[:, None], size, np.zeros((n_gt, 1))]
    if cfg.code_size > 8:
        cols.append(rng.uniform(-2, 2, (n_gt, 2)))
    return (np.concatenate(cols, -1).astype(np.float32),
            (np.arange(n_gt) % cfg.num_classes).astype(np.int32))


def clustered_scene_gt(seed: int, cfg: Uni3DETRConfig,
                       distribution: str = "clustered"):
    """The GT of ``clustered_scene(seed, cfg, distribution)``: its blobs'
    boxes as :func:`clustered_train_batch` draws them, as a dict of
    'boxes' (n, 7|9) and 'labels' (n,)."""
    rng = np.random.RandomState(seed)
    _, centers, std = _blobs(rng, cfg, distribution)
    boxes, labels = _gt_boxes(rng, centers, std, cfg)
    return {"boxes": boxes, "labels": labels}


def clustered_train_batch(seed: int, cfg: Uni3DETRConfig, batch: int,
                          distribution: str = "clustered"):
    """``batch`` clustered scenes with one GT box around each of the
    first ``min(24, 3 * max_gt // 4)`` blobs (centre on the blob, sides
    4 standard deviations, yaw 0, labels cycling over the classes),
    padded to ``max_gt`` rows with ``gt_mask``.

    With ``code_size > 8`` the boxes carry velocity (vx, vy) drawn from
    ``uniform(-2, 2)``, as the JAX package's train bench draws it. With
    ``distribution="uniform"`` the points are uniform over the range and
    the boxes stay on the blobs' centres (see :func:`_blobs`).

    Returns numpy arrays in the layout of the JAX ``make_train_step``:
    points (B, P, C) float32, pts_mask (B, P), gt_boxes (B, G, 7|9)
    float32 with the bottom-z storage centre, gt_labels (B, G) int32,
    gt_mask (B, G)."""
    G = cfg.max_gt
    box_dim = 9 if cfg.code_size > 8 else 7
    pts, boxes = [], np.zeros((batch, G, box_dim), np.float32)
    labels = np.zeros((batch, G), np.int32)
    gmask = np.zeros((batch, G), bool)
    for b in range(batch):
        rng = np.random.RandomState([seed, b])
        p, centers, std = _blobs(rng, cfg, distribution)
        pts.append(p)
        gb, gl = _gt_boxes(rng, centers, std, cfg)
        boxes[b, :len(gb)] = gb
        labels[b, :len(gb)] = gl
        gmask[b, :len(gb)] = True
    pts = np.stack(pts)
    return {"points": pts, "pts_mask": np.ones(pts.shape[:2], bool),
            "gt_boxes": boxes, "gt_labels": labels, "gt_mask": gmask}
