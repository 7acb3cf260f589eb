"""NMS-free decode, per-class NMS and the score / count thresholds (port
of the ``nms`` branch of ``uni3detr_tpu/train/coder.py``).

Decode averages decoder layers 1..L-1, takes the ``max_num`` best flat
class scores, denormalizes the boxes, masks them by
``post_center_range`` and blends ``score = cls^alpha * iou^(1-alpha)``.
Post-processing shifts z to the bottom face, runs rotated 3D-IoU NMS
per class and applies ``score_thr`` and ``num_thr``. Outputs stay
fixed-size with validity masks.
"""
from __future__ import annotations

import torch

from ..config import Uni3DETRConfig
from ..geom.boxes import bottom_center_boxes, decode_boxes
from ..geom.iou import iou3d_rotated
from ..ops.nms import _greedy_suppress, _rank_order


def decode_predictions(outs, cfg: Uni3DETRConfig):
    """Head outputs -> (boxes (B, K, 7|9) gravity z, scores (B, K),
    labels (B, K) int32, valid (B, K)), K = min(max_num, Q * ncls)."""
    cls = outs["all_cls_scores"][1:].mean(dim=0)      # (B, Q, ncls)
    box = outs["all_bbox_preds"][1:].mean(dim=0)
    iou = outs["all_iou_preds"][1:].mean(dim=0)
    B, Q, ncls = cls.shape
    scores = torch.sigmoid(cls).reshape(B, -1)
    k = min(cfg.max_num, scores.shape[1])
    # stable descending sort: ties go to the lower index, as lax.top_k
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    labels = (idx % ncls).to(torch.int32)
    bidx = idx // ncls
    boxes = decode_boxes(torch.gather(
        box, 1, bidx[..., None].expand(-1, -1, box.shape[-1])))
    ious = torch.gather(torch.sigmoid(iou), 1, bidx)
    pcr = torch.tensor(cfg.post_center_range, dtype=boxes.dtype,
                       device=boxes.device)
    ok = ((boxes[..., :3] >= pcr[:3]).all(dim=-1)
          & (boxes[..., :3] <= pcr[3:6]).all(dim=-1))
    final = top ** cfg.coder_alpha * ious ** (1 - cfg.coder_alpha)
    return boxes, final, labels, ok


def post_process(boxes, scores, labels, valid, cfg: Uni3DETRConfig):
    """Per-class NMS, then the score and count thresholds; boxes
    gravity-centred.

    ``score_thr`` (scalar, or one per class) keeps scores strictly above
    it; ``num_thr`` keeps the ``num_thr`` best surviving boxes, ties to
    the lower index as ``jnp.argsort``. Returns (boxes with bottom z,
    scores, labels, valid), still fixed size. ``soft_nms`` and
    ``box_merging`` are not ported.
    """
    if cfg.post_processing != "nms":
        raise NotImplementedError("only post_processing='nms' is ported")
    boxes = bottom_center_boxes(boxes)
    cls_ids = torch.arange(cfg.num_classes, device=labels.device)
    out_valid = []
    for bx, s, lab, v in zip(boxes, scores, labels, valid):
        iou = iou3d_rotated(bx[:, :7], bx[:, :7], z_origin="bottom")
        per_cls = v[None, :] & (lab[None, :] == cls_ids[:, None])
        out_valid.append(
            _greedy_suppress(iou, s, per_cls, cfg.nms_thr).any(dim=0))
    valid = torch.stack(out_valid)
    if cfg.score_thr is not None:
        thr = torch.tensor(cfg.score_thr, dtype=scores.dtype,
                           device=scores.device)
        if thr.dim():
            thr = thr[labels.long()]
        valid = valid & (scores > thr)
    if cfg.num_thr is not None:
        order = _rank_order(scores, valid)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=order.device
                                    ).expand_as(order))
        valid = valid & (rank < cfg.num_thr)
    return boxes, scores, labels, valid
