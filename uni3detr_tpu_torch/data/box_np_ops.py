"""Host-side numpy box utilities for the data pipeline (jax-free copy of
``uni3detr_tpu/data/box_np_ops.py``).

Boxes are in the storage layout (cx, cy, cz_bottom, dx, dy, dz, yaw[,
vx, vy]). The hot entry points (``points_in_rbbox``,
``box_collision_test``, ``object_noise_``, ``points_in_any_rbbox``) run
the C++ loops of ``uni3detr_tpu_torch/native`` by default, built on
first use (a failed build raises); ``native=False`` selects the numpy
bodies below, the plain versions the tests hold the C++ to.
"""
from __future__ import annotations

import numpy as np

from .. import native as _native


def rotation_2d(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


def corners_bev(boxes):
    """(N, >=7) -> (N, 4, 2) CCW BEV corners."""
    half = boxes[:, 3:5] * 0.5
    corners = np.stack([
        np.stack([half[:, 0], half[:, 1]], -1),
        np.stack([-half[:, 0], half[:, 1]], -1),
        np.stack([-half[:, 0], -half[:, 1]], -1),
        np.stack([half[:, 0], -half[:, 1]], -1),
    ], 1)  # (N, 4, 2)
    rot = rotation_2d(boxes[:, 6])  # (N, 2, 2)
    return np.einsum("nij,nkj->nki", rot, corners) + boxes[:, None, :2]


def corners_3d(boxes):
    """(N, >=7) storage boxes -> (N, 8, 3) corners: the 4 BEV corners at
    z_bottom then at z_bottom + dz."""
    bev = corners_bev(boxes)  # (N, 4, 2)
    z0 = boxes[:, 2:3]
    z1 = z0 + boxes[:, 5:6]
    lo = np.concatenate([bev, np.broadcast_to(z0[:, None],
                                              bev.shape[:2] + (1,))], -1)
    hi = np.concatenate([bev, np.broadcast_to(z1[:, None],
                                              bev.shape[:2] + (1,))], -1)
    return np.concatenate([lo, hi], 1)


def points_in_rbbox(points, boxes, z_origin="bottom", native=True):
    """(P, >=3) x (N, 7) -> (P, N) bool membership mask."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(points), len(boxes)), bool)
    if native:
        return _native.points_in_rbbox(points, boxes, z_origin)
    d = points[:, None, :2] - boxes[None, :, :2]  # (P, N, 2)
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    in_bev = (np.abs(lx) <= boxes[:, 3] * 0.5) \
        & (np.abs(ly) <= boxes[:, 4] * 0.5)
    z0 = boxes[:, 2] if z_origin == "bottom" else boxes[:, 2] - boxes[:, 5] / 2
    in_z = (points[:, None, 2] >= z0) & (points[:, None, 2] <= z0
                                         + boxes[:, 5])
    return in_bev & in_z


def box_collision_test(boxes_a, boxes_b, native=True):
    """BEV rotated-rectangle overlap via SAT: (Na, 7) x (Nb, 7) ->
    (Na, Nb) bool (True = overlapping)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), bool)
    if native:
        return _native.box_collision_test(boxes_a, boxes_b)
    ca = corners_bev(boxes_a)  # (Na, 4, 2)
    cb = corners_bev(boxes_b)
    overlap = np.ones((len(boxes_a), len(boxes_b)), bool)
    # each rect contributes 2 unique separating-axis candidates
    for k in range(2):
        ang = boxes_a[:, 6] + k * np.pi / 2
        ax = np.stack([np.cos(ang), np.sin(ang)], -1)      # (Na, 2)
        pa = np.einsum("nki,ni->nk", ca, ax)               # (Na, 4)
        pb = np.einsum("mki,ni->nmk", cb, ax)              # (Na, Nb, 4)
        sep = (pa.max(-1)[:, None] < pb.min(-1)) \
            | (pb.max(-1) < pa.min(-1)[:, None])
        overlap &= ~sep
    for k in range(2):
        ang = boxes_b[:, 6] + k * np.pi / 2
        ax = np.stack([np.cos(ang), np.sin(ang)], -1)      # (Nb, 2)
        pb = np.einsum("mki,mi->mk", cb, ax)               # (Nb, 4)
        pa = np.einsum("nki,mi->nmk", ca, ax)              # (Na, Nb, 4)
        sep = (pa.max(-1) < pb.min(-1)[None, :]) \
            | (pb.max(-1)[None, :] < pa.min(-1))
        overlap &= ~sep
    return overlap


def limit_period(val, offset=0.5, period=np.pi * 2):
    return val - np.floor(val / period + offset) * period


def object_noise_(points, boxes, trans, rots, native=True):
    """Per-GT-box perturbation with BEV collision rejection, in place.

    The mmdet3d ``noise_per_object_v3_`` role: for each box take the
    first of T pre-drawn (translation, yaw) trials whose perturbed box
    does not collide with any other box in the current (partially
    updated) list; on acceptance rigidly move the points that were
    inside the original box about its volume centre.

    points (P, pdim) float32 C-contiguous, boxes (G, >=7) float32
    C-contiguous, both modified in place; trans (G, T, 3), rots (G, T)
    are the pre-drawn trials (drawn by the caller, so that the native and
    numpy loops consume the same randomness). Returns the (G,) accepted
    trial indices (-1: unchanged).
    """
    if native:
        return _native.object_noise(points, boxes, trans, rots)
    G, T = rots.shape
    acc = np.full(G, -1, np.int32)
    if not len(points) or not G:
        return acc
    in_box = points_in_rbbox(points[:, :3], boxes[:, :7], native=False)
    orig = boxes[:, :7].copy()
    for i in range(G):
        for t in range(T):
            nb = boxes[i].copy()
            nb[:3] += trans[i, t]
            nb[6] += rots[i, t]
            others = np.delete(boxes, i, axis=0)
            if box_collision_test(nb[None, :7], others[:, :7],
                                  native=False).any():
                continue
            m = in_box[:, i]
            ctr = orig[i, :3].copy()
            ctr[2] += orig[i, 5] / 2
            local = points[m, :3] - ctr
            c, s = np.cos(rots[i, t]), np.sin(rots[i, t])
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            points[m, :3] = local @ rot.T + ctr + trans[i, t]
            boxes[i] = nb
            acc[i] = t
            break
    return acc


def points_in_any_rbbox(points, boxes, z_origin="bottom", native=True):
    """(P, >=3) x (N, 7) -> (P,) bool: point inside any box (the
    ObjectSample background-point removal; the native loop exits early
    per point)."""
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros(len(points), bool)
    if native:
        return _native.points_in_any_rbbox(points, boxes, z_origin)
    return points_in_rbbox(points, boxes, z_origin, native=False).any(-1)
