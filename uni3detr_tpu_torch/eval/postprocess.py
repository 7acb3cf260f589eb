"""Per-scene post-processing on the host (port of
``uni3detr_tpu/train/evaluator.py::_postprocess_sample`` and of the
evaluator's split of a batch into scenes, ``:116-121``).

:func:`postprocess_batch` is the path after ``train.coder.post_process``:
the batch's fixed-size outputs come to the host in one copy, split into
per-scene dicts of the valid rows, and each scene is post-processed by
:func:`postprocess_sample`. With ``post_processing="box_merging"`` the
IoU matrices of all scenes come from one N1 launch (the matrix form) in
that same copy.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Uni3DETRConfig
from ..geom.iou import iou3d_rotated_pairwise
from .box_merging import merge_boxes_3d


def split_batch(boxes, scores, labels, valid,
                with_iou: bool = False) -> List[dict]:
    """(B, K, D) boxes, (B, K) scores, labels and valid -> B dicts of the
    valid rows: 'boxes' (n, D) float32, 'scores' (n,) float32, 'labels'
    (n,) int32. With ``with_iou`` each dict also holds 'iou', the (n, n)
    rotated 3D IoU (bottom z) of its boxes, from N1's matrix form over
    the batch in one launch. One device-to-host copy for the batch: the
    columns are packed into one float32 tensor (labels are small
    integers, exact in float32)."""
    B, K, D = boxes.shape
    cols = [boxes.float(), scores.float()[..., None],
            labels.float()[..., None], valid.float()[..., None]]
    if with_iou:
        cols.append(iou3d_rotated_pairwise(boxes[..., :7]))
    host = torch.cat(cols, dim=-1).cpu().numpy()
    out = []
    for b in range(B):
        v = host[b, :, D + 2] > 0.5
        det = {"boxes": host[b, v, :D], "scores": host[b, v, D],
               "labels": host[b, v, D + 1].astype(np.int32)}
        if with_iou:
            det["iou"] = host[b, v][:, D + 3:][:, v]
        out.append(det)
    return out


def postprocess_sample(det: dict, cfg: Uni3DETRConfig,
                       device="cuda") -> dict:
    """Box merging and then the scalar or per-class ``score_thr`` for
    ``post_processing="box_merging"``; any other mode returns ``det``
    (its NMS and thresholds ran in ``post_process``). The merge reads
    ``det['iou']`` where :func:`split_batch` put it, else computes the
    IoU on ``device``."""
    if cfg.post_processing == "box_merging":
        l2, b2, s2, _ = merge_boxes_3d(det["labels"], det["boxes"],
                                       det["scores"], iou=det.get("iou"),
                                       device=device)
        det = {"boxes": b2, "scores": s2, "labels": l2}
        if cfg.score_thr is not None:
            thr = (np.asarray(cfg.score_thr)[det["labels"]]
                   if isinstance(cfg.score_thr, (tuple, list))
                   else cfg.score_thr)
            keep = det["scores"] > thr
            det = {k: det[k][keep] for k in det}
    return det


def postprocess_batch(boxes, scores, labels, valid,
                      cfg: Uni3DETRConfig) -> List[dict]:
    """``train.coder.post_process``'s outputs of a batch -> one
    post-processed dict per scene (:func:`split_batch`, then
    :func:`postprocess_sample`)."""
    merging = cfg.post_processing == "box_merging"
    return [postprocess_sample(d, cfg) for d in
            split_batch(boxes, scores, labels, valid, with_iou=merging)]
