"""Per-scene post-processing on the host (port of
``uni3detr_tpu/train/evaluator.py::_postprocess_sample`` and of the
evaluator's split of a batch into scenes, ``:116-121``).

:func:`postprocess_batch` is the path after ``train.coder.post_process``:
the batch's fixed-size outputs come to the host in one copy, split into
per-scene dicts of the valid rows, and each scene is post-processed by
:func:`postprocess_sample`. With ``post_processing="box_merging"`` the
IoU matrices of all scenes come from one N1 launch (the matrix form) in
that same copy. ``train.evaluator.run_inference`` packs a batch on the
device (:func:`pack_batch`), copies it without waiting and splits it on
the host (:func:`unpack_batch`) while the next batch runs.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Uni3DETRConfig
from ..geom.iou import iou3d_rotated_pairwise
from .box_merging import merge_boxes_3d


def pack_batch(boxes, scores, labels, valid, with_iou: bool = False,
               keep=None) -> torch.Tensor:
    """(B, K, D) boxes, (B, K) scores, labels and valid -> one float32
    tensor on their device, (B, K, D + 3 [+ 1] [+ K]): the boxes, score,
    label (small integers, exact in float32) and valid columns, then with
    ``keep`` (B, K) bool its column, then with ``with_iou`` the (K, K)
    rotated 3D IoU (bottom z) of each scene's boxes, from N1's matrix form
    over the batch in one launch. One copy brings it to the host."""
    cols = [boxes.float(), scores.float()[..., None],
            labels.float()[..., None], valid.float()[..., None]]
    if keep is not None:
        cols.append(keep.float()[..., None])
    if with_iou:
        cols.append(iou3d_rotated_pairwise(boxes[..., :7]))
    return torch.cat(cols, dim=-1)


def unpack_batch(host: np.ndarray, D: int, with_iou: bool = False,
                 with_keep: bool = False) -> List[dict]:
    """:func:`pack_batch`'s array on the host -> B dicts of the valid
    rows: 'boxes' (n, D) float32, 'scores' (n,) float32, 'labels' (n,)
    int32, and 'keep' (n,) bool or 'iou' (n, n) where packed."""
    out = []
    for b in range(host.shape[0]):
        v = host[b, :, D + 2] > 0.5
        det = {"boxes": host[b, v, :D], "scores": host[b, v, D],
               "labels": host[b, v, D + 1].astype(np.int32)}
        if with_keep:
            det["keep"] = host[b, v, D + 3] > 0.5
        if with_iou:
            det["iou"] = host[b, v][:, D + 3 + with_keep:][:, v]
        out.append(det)
    return out


def split_batch(boxes, scores, labels, valid,
                with_iou: bool = False) -> List[dict]:
    """(B, K, D) boxes, (B, K) scores, labels and valid -> B dicts of the
    valid rows: 'boxes' (n, D) float32, 'scores' (n,) float32, 'labels'
    (n,) int32. With ``with_iou`` each dict also holds 'iou', the (n, n)
    rotated 3D IoU (bottom z) of its boxes, from N1's matrix form over
    the batch in one launch. One device-to-host copy for the batch
    (:func:`pack_batch`, :func:`unpack_batch`)."""
    host = pack_batch(boxes, scores, labels, valid, with_iou).cpu().numpy()
    return unpack_batch(host, boxes.shape[-1], with_iou)


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
