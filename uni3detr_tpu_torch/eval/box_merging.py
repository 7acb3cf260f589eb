"""Box-merging post-processing of the KITTI presets (port of
``uni3detr_tpu/data/eval/box_merging.py``).

Detections are ranked by score; each survivor absorbs every lower-ranked
box of its class whose rotated 3D IoU (bottom z) with it exceeds the
threshold and becomes the per-parameter median of its cluster. The IoU
matrix comes from N1's matrix form (``geom.iou.iou3d_rotated_pairwise``)
on the card, or from its plain version on the CPU; the greedy loop runs
on the host, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geom.iou import iou3d_rotated_pairwise


def merge_boxes_3d(labels, boxes, scores, overlap_thr=0.1, top_k=-1, *,
                   iou=None, device="cuda"):
    """labels (N,), boxes (N, 7+) storage layout, scores (N,), numpy.

    ``iou`` is the (N, N) IoU of ``boxes`` in their given order, if the
    caller has it (``eval.postprocess.split_batch`` computes it for a
    whole batch in one launch); otherwise it is computed on ``device``.
    Returns (labels, boxes, scores, kept_indices), as the JAX package's.
    """
    # the JAX package's call: quicksort is not stable, but the same call
    # on the same array gives the same order of tied scores
    order = np.argsort(-scores)
    if top_k > 0:
        order = order[:top_k]
    labels, boxes, scores = labels[order], boxes[order].copy(), scores[order]
    n = len(scores)
    if n == 0:
        return labels, boxes, scores, np.zeros(0, np.int64)
    if iou is None:
        bx = torch.as_tensor(boxes[:, :7], dtype=torch.float32)[None]
        iou = iou3d_rotated_pairwise(bx.to(device))[0].cpu().numpy()
    else:
        iou = np.asarray(iou)[np.ix_(order, order)]
    keep = np.ones(n, bool)
    for i in range(n - 1):
        if not keep[i]:
            continue
        rest = np.arange(i + 1, n)
        rest = rest[keep[rest]]
        absorb = rest[(iou[i, rest] > overlap_thr)
                      & (labels[rest] == labels[i])]
        cluster = np.concatenate([boxes[absorb], boxes[[i]]], axis=0)
        boxes[i] = np.median(cluster, axis=0)
        keep[absorb] = False
    idx = np.where(keep)[0]
    return labels[idx], boxes[idx], scores[idx], order[idx]
