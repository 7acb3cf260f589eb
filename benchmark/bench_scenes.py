"""The scenes of the traffic mixes, drawn from the run's seed.

A frozen copy of the port's synthetic generator
(``uni3detr_tpu_torch/synthetic.py``: ``clustered_scene`` and
``clustered_train_batch``): 24 tight Gaussian blobs inside ``pc_range``,
each squashed along one random axis into a planar patch, the way a scan
shows walls, floors and objects; extra point channels uniform in [0, 1).
Train scenes carry one box around each of the first ``min(24, 3 max_gt
/ 4)`` blobs (sides four standard deviations, yaw 0, labels cycling over
the classes; velocities uniform in (-2, 2) with a 10-dim code). Every
scene has the configuration's full ``num_points``: the sizes are the
same on every seed, the positions differ.
"""
from __future__ import annotations

import numpy as np

TAGS = {"train": 1, "infer": 2}


def _rng(seed: int, tag: str, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), TAGS[tag], int(index)])


def _blobs(rng, cfg):
    P = cfg["num_points"]
    lo = np.asarray(cfg["pc_range"][:3])
    span = np.asarray(cfg["pc_range"][3:]) - lo
    K = 24
    centers = lo + span * (0.1 + 0.8 * rng.random((K, 3)))
    assign = rng.integers(0, K, P)
    offs = rng.standard_normal((P, 3)) * span * 0.02
    squash = 1.0 - 0.95 * np.eye(3)[rng.integers(0, 3, K)]
    xyz = centers[assign] + offs * squash[assign]
    xyz = np.clip(xyz, lo + 1e-4, lo + span - 1e-3)
    extra = rng.random((P, cfg["in_point_features"] - 3))
    pts = np.concatenate([xyz, extra], -1).astype(np.float32)
    return pts, centers, span * 0.02 * squash


def _gt(rng, centers, std, cfg):
    n = min(24, max(1, 3 * cfg["max_gt"] // 4))
    size = np.maximum(4.0 * std[:n], 0.05)
    bottom = centers[:n, 2] - size[:, 2] / 2
    cols = [centers[:n, :2], bottom[:, None], size, np.zeros((n, 1))]
    if cfg["code_size"] > 8:
        cols.append(rng.uniform(-2, 2, (n, 2)))
    return (np.concatenate(cols, -1).astype(np.float32),
            (np.arange(n) % cfg["num_classes"]).astype(np.int32))


def train_batch(seed: int, cfg, batch: int, index: int):
    """Batch ``index`` of the train pool: points (B, P, C) float32,
    pts_mask (B, P), gt_boxes (B, max_gt, 7|9) bottom-z, gt_labels,
    gt_mask."""
    G = cfg["max_gt"]
    dim = 9 if cfg["code_size"] > 8 else 7
    pts = np.zeros((batch, cfg["num_points"], cfg["in_point_features"]),
                   np.float32)
    boxes = np.zeros((batch, G, dim), np.float32)
    labels = np.zeros((batch, G), np.int32)
    mask = np.zeros((batch, G), bool)
    for b in range(batch):
        rng = _rng(seed, "train", index * batch + b)
        pts[b], centers, std = _blobs(rng, cfg)
        gb, gl = _gt(rng, centers, std, cfg)
        boxes[b, :len(gb)], labels[b, :len(gb)] = gb, gl
        mask[b, :len(gb)] = True
    return {"points": pts, "pts_mask": np.ones(pts.shape[:2], bool),
            "gt_boxes": boxes, "gt_labels": labels, "gt_mask": mask}


def infer_batch(seed: int, cfg, batch: int, index: int):
    """Batch ``index`` of the inference pool: points (B, P, C), pts_mask
    (B, P) and the eval query group's random points (B, num_query, 3)
    uniform in [0, 1)."""
    pts, rnd = [], []
    for b in range(batch):
        rng = _rng(seed, "infer", index * batch + b)
        pts.append(_blobs(rng, cfg)[0])
        rnd.append(rng.random((cfg["num_query"], 3)).astype(np.float32))
    pts = np.stack(pts)
    return {"points": pts, "pts_mask": np.ones(pts.shape[:2], bool),
            "random_points": np.stack(rnd)}
