"""Test-time augmentation: the augmentation grid and the merge of its
detections (port of ``uni3detr_tpu/train/tta.py``).

Each augmentation of the grid (a rotation x scale x flip product, the
reference's MultiRotScaleFlipAug3D) runs its own forward; its detections
are mapped back through the inverse transform, the views' detections
are concatenated, and a per-class rotated BEV NMS at 0.1 keeps the best
500. :func:`merge_aug_detections` concatenates a batch's views and runs
the NMS on :func:`uni3detr_tpu_torch.ops.nms.nms_bev_keep`: on the card
one bitmask and one scan launch for every class and scene of a batch,
where the JAX package runs ``nms_bev_rotated`` once a class and scene.
The cut to ``max_out`` and the final order (:func:`select_merged`,
``np.argsort``) stay numpy on the host, as in JAX, so ties fall alike.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Sequence

import numpy as np
import torch

from ..ops.nms import nms_bev_keep


def make_aug_grid(rot_degrees: Sequence[float] = (0.0,),
                  scales: Sequence[float] = (1.0,),
                  flips: Sequence[bool] = (False,)):
    """List of aug descriptors {rot, scale, flip_h}."""
    return [dict(rot=r, scale=s, flip_h=f)
            for r, s, f in itertools.product(rot_degrees, scales, flips)]


def apply_aug_points(points, aug, box_type="Depth"):
    """Rot-scale first, then flip, the order whose inverse
    :func:`map_boxes_back` applies (numpy, on the host)."""
    pts = points.copy()
    c, s = np.cos(aug["rot"]), np.sin(aug["rot"])
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts[..., :3] = pts[..., :3] @ rot.T * aug["scale"]
    if aug["flip_h"]:
        axis = 0 if box_type == "Depth" else 1
        pts[..., axis] = -pts[..., axis]
    return pts


def map_boxes_back(boxes, aug, box_type="Depth"):
    """Inverse of :func:`apply_aug_points` on detected boxes (..., >=7)
    in storage layout: flip, un-scale, un-rotate (velocities too), on a
    float32 tensor on any device (the evaluator maps a batch's boxes on
    the card). With no rotation and unit scale the result is exact;
    otherwise the rotation's products are rounded on their own, where
    the JAX package's float32 matmul may fuse them (an ulp apart)."""
    b = boxes.clone()
    if aug["flip_h"]:
        axis = 0 if box_type == "Depth" else 1
        b[..., axis] = -b[..., axis]
        b[..., 6] = math.pi - b[..., 6] if axis == 0 else -b[..., 6]
    b[..., :6] = b[..., :6] / aug["scale"]
    a = -aug["rot"]
    # the float32 rotation entries, as the JAX package builds its matrix
    c, s = float(np.float32(np.cos(a))), float(np.float32(np.sin(a)))
    for i, j in ((0, 1), (7, 8)) if b.shape[-1] > 8 else ((0, 1),):
        x, y = b[..., i].clone(), b[..., j].clone()
        b[..., i] = x * c - y * s
        b[..., j] = x * s + y * c
    b[..., 6] = b[..., 6] + a
    return b


def merge_aug_detections(views, num_classes: int, nms_thr: float = 0.1):
    """Each augmentation's detections of a batch, mapped back: a list of
    (boxes (B, K, D), scores (B, K), labels (B, K), valid (B, K)) tensors
    -> the views concatenated (boxes, scores, labels, valid) and the
    per-class BEV NMS's keep (B, sum of K) bool. This is the JAX
    package's ``merge_aug_detections`` for every scene of a batch up to
    its cut, which :func:`select_merged` makes on the host, scene by
    scene. On the card: one bitmask and one scan launch a batch."""
    boxes, scores, labels, valid = (torch.cat(t, dim=1) for t in zip(*views))
    keep = nms_bev_keep(boxes, scores, labels, valid, nms_thr, num_classes)
    return boxes, scores, labels, valid, keep


def select_merged(det: Dict, max_out: int = 500) -> Dict:
    """One scene's concatenated detections ('boxes', 'scores', 'labels'
    and the NMS's 'keep', numpy, from :func:`merge_aug_detections`) ->
    the kept ones, best first, at most ``max_out``."""
    idx = np.where(det["keep"])[0]
    order = idx[np.argsort(-det["scores"][idx])][:max_out]
    return {"boxes": det["boxes"][order], "scores": det["scores"][order],
            "labels": det["labels"][order]}
