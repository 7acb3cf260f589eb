"""NMS-free decode, per-class NMS or soft-NMS and the score / count
thresholds (port of ``uni3detr_tpu/train/coder.py``).

Decode averages decoder layers 1..L-1, takes the ``max_num`` best flat
class scores, denormalizes the boxes, masks them by
``post_center_range`` and blends ``score = cls^alpha * iou^(1-alpha)``.
Post-processing shifts z to the bottom face, runs rotated 3D-IoU NMS
per class for all scenes at once (``post_processing="nms"``,
``ops.nms.nms_keep``: two kernel launches on the card), or gaussian
soft-NMS per class (``soft_nms``: ``ops.nms.soft_nms``, N1's IoU of
same-class pairs, then N3, one launch each on the card; ``none`` and
``box_merging`` pass the boxes through, box merging runs on the host
afterwards in ``eval.postprocess``) and applies ``score_thr`` and
``num_thr``. Outputs stay fixed-size with validity masks; nothing here
waits on the device.

The JAX coder's soft-NMS drops box 0 (the scene's best candidate)
whenever its class's loop ends before ``max_out`` steps: its keep-mask
scatter writes False to index 0 for every step that keeps nothing. The
port keeps box 0 when its class's soft-NMS keeps it, as the reference
does (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch

from ..config import Uni3DETRConfig
from ..geom.boxes import bottom_center_boxes, decode_boxes
from ..ops.nms import _rank_order, nms_keep, soft_nms


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
    # compared with Python floats: a tensor of the range would be a
    # host-to-device copy, which waits for the device
    pcr = cfg.post_center_range
    ok = torch.ones_like(top, dtype=torch.bool)
    for a in range(3):
        ok = ok & (boxes[..., a] >= pcr[a]) & (boxes[..., a] <= pcr[3 + a])
    final = top ** cfg.coder_alpha * ious ** (1 - cfg.coder_alpha)
    return boxes, final, labels, ok


def post_process(boxes, scores, labels, valid, cfg: Uni3DETRConfig):
    """Per-class NMS or soft-NMS, then the score and count thresholds;
    boxes gravity-centred.

    ``soft_nms`` runs ``min(max_num, N)`` steps at most per class on the
    bottom-z IoU: the kept boxes take their decayed scores, the
    others score 0 and turn invalid. ``score_thr`` (scalar, or one per
    class) keeps scores strictly above it; ``num_thr`` keeps the
    ``num_thr`` best surviving boxes, ties to the lower index as
    ``jnp.argsort``. Returns (boxes with bottom z, scores, labels,
    valid), still fixed size. ``none`` and ``box_merging`` skip the NMS,
    as the JAX coder does.
    """
    boxes = bottom_center_boxes(boxes)
    if cfg.post_processing == "nms":
        valid = nms_keep(boxes, scores, labels, valid, cfg.nms_thr,
                         cfg.num_classes, z_origin="bottom")
    elif cfg.post_processing == "soft_nms":
        N = scores.shape[1]
        scores, valid, _ = soft_nms(
            boxes, scores, labels, valid, cfg.num_classes,
            cfg.soft_nms_sigma, cfg.soft_nms_prune, min(cfg.max_num, N),
            z_origin="bottom")
    if cfg.score_thr is not None:
        thr = cfg.score_thr
        if isinstance(thr, (tuple, list)):
            # an asynchronous copy: a blocking one would wait for the device
            thr = torch.tensor(thr, dtype=scores.dtype).to(
                scores.device, non_blocking=True)[labels.long()]
        valid = valid & (scores > thr)
    if cfg.num_thr is not None:
        order = _rank_order(scores, valid)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=order.device
                                    ).expand_as(order))
        valid = valid & (rank < cfg.num_thr)
    return boxes, scores, labels, valid
