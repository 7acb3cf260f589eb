"""Set-matching losses of Uni3DETR (port of ``uni3detr_tpu/train/losses.py``).

Per decoder layer and sample, the queries are matched to the ground
truth by a Hungarian assignment on a detached cost (focal or soft-focal
class cost, L1 on the first 8 code dims, and an IoU cost: 1 -
nearest-BEV IoU, the rotated 3D IoU, minus the axis-aligned 3D IoU or the
RDIoU penalty; the costs of all layers are matched in one call), then:

- soft focal classification loss against the IoU-aware quality
  (nearest-BEV IoU + z-IoU) / 2;
- L1 on the normalized code, weighted by ``code_weights``;
- IoU loss (1 - nearest-BEV IoU, 1 - rotated 3D IoU, or the RDIoU
  penalty) plus 1 - z-IoU;
- BCE of the IoU branch against the detached rotated 3D IoU, x 1.2;
- with the OV head's uncertainty stack: each query's sigma (its label's
  column, background the last; at least 0.01, with no gradient below)
  weights its L1 term by sqrt(2) exp(-sigma), and ``loss_consistency``
  is the mean sigma. As in the JAX package the term has weight 1:
  ``uncertainty_consistency_weight`` is not read.

Each sum is divided by the batch's positive count (at least 1). Under a
process group of W ranks the count is the global batch's (the JAX
package's one jit over the sharded batch, the reference's
``reduce_mean``) and each rank's sums are multiplied by W, so that the
mean of the ranks' gradients is the global loss's; ``loss_consistency``,
a mean over equal-sized batches, needs no factor. Batched over
B; padded GT rows (``gt_mask`` False) never match.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import Uni3DETRConfig
from ..geom.boxes import decode_boxes, encode_boxes
from ..geom.iou import (axis_aligned_iou3d, iou3d_rotated,
                        iou3d_rotated_aligned, nearest_bev_iou,
                        nearest_bev_iou_aligned, rdiou,
                        z_interval_iou_aligned)
from ..ops.matching import match_queries_to_gt
from ..parallel import dist


def focal_cls_cost(cls_logits, gt_labels, alpha: float = 0.25,
                   gamma: float = 2.0, eps: float = 1e-12):
    """mmdet FocalLossCost: (..., Q, ncls) x (..., Gt) -> (..., Q, Gt)."""
    p = torch.sigmoid(cls_logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return _take_classes(pos - neg, gt_labels)


def soft_focal_cls_cost(cls_logits, gt_labels, iou3d, alpha: float = 0.25,
                        gamma: float = 2.0, eps: float = 1e-12):
    """SoftFocalLossCost: the class probability is modulated by
    iou3d^0.001 before the focal transform. iou3d (..., Q, Gt)."""
    p = _take_classes(torch.sigmoid(cls_logits), gt_labels)
    pi = p * torch.pow(iou3d.clamp(min=eps), 0.001)
    neg = -torch.log(1 - pi + eps) * (1 - alpha) * pi ** gamma
    pos = -torch.log(pi + eps) * alpha * (1 - pi) ** gamma
    return pos - neg


def _take_classes(per_class, gt_labels):
    """(..., Q, ncls) x (..., Gt) -> (..., Q, Gt): column c of GT j."""
    idx = gt_labels.long()[..., None, :].expand(
        *per_class.shape[:-1], gt_labels.shape[-1])
    return torch.gather(per_class, -1, idx)


def soft_focal_loss(logits, labels, quality, num_classes: int,
                    alpha: float = 0.25, gamma: float = 2.0):
    """IoU-aware soft focal loss summed over classes: logits (N, ncls),
    labels (N,) with ``num_classes`` = background, quality (N,) in [0, 1]
    -> (N,)."""
    p = torch.sigmoid(logits)
    onehot = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes]
    t = onehot.to(logits.dtype) * quality[:, None]
    pt = t - p
    scale = (1 - alpha) + (2 * alpha - 1) * t
    focal_w = scale * pt ** 2 if gamma == 2.0 else scale * pt.abs() ** gamma
    bce = logits.clamp(min=0) - logits * t + torch.log1p(
        torch.exp(-logits.abs()))
    return torch.sum(bce * focal_w, dim=-1)


def rdiou_penalty(pred, target):
    """1 - clamp(rdiou - u, -1, 1), the reference's RDIoU cost and loss
    (rdiouloss.py:12-32, match_cost.py:72-83), over broadcast boxes fed
    as they are: ``rdiou`` takes ``exp`` of dims 3:6 of whatever arrives,
    as the reference does."""
    u, rd = rdiou(pred, target)
    return 1.0 - (rd - u).clamp(-1.0, 1.0)


def iou_match_cost(decoded, gt_boxes, cfg: Uni3DETRConfig):
    """The IoU slot of the matching cost (..., Q, Gt), by
    ``cfg.iou_cost_type``, with the reference costs' signs, on decoded
    boxes: 1 - nearest-BEV IoU (``iou3d``), + the rotated 3D IoU
    (``rotated_iou3d``), - the axis-aligned 3D IoU
    (``axis_aligned_iou3d``) or the RDIoU penalty (``rdiou``)."""
    t = cfg.iou_cost_type
    if t == "iou3d":
        return 1.0 - nearest_bev_iou(decoded, gt_boxes)
    if t == "rotated_iou3d":
        return iou3d_rotated(decoded[..., :7], gt_boxes[..., :7],
                             z_origin="center")
    if t == "axis_aligned_iou3d":
        return -axis_aligned_iou3d(decoded[..., :7], gt_boxes[..., :7])
    if t == "rdiou":
        return rdiou_penalty(decoded[..., :, None, :7],
                             gt_boxes[..., None, :, :7])
    raise ValueError(f"unknown iou_cost_type {t!r}")


def match_cost(cls_scores, bbox_preds, gt_boxes, gt_labels,
               cfg: Uni3DETRConfig):
    """The matching cost of a batch: cls (B, Q, ncls), bbox (B, Q, code),
    gravity-centred gt (B, Gt, 7|9) -> (B, Q, Gt), non-finite entries
    replaced by 1e4."""
    norm_gt = encode_boxes(gt_boxes)
    decoded = decode_boxes(bbox_preds)
    if cfg.cls_cost_type == "soft_focal":
        cls_cost = soft_focal_cls_cost(
            cls_scores, gt_labels, nearest_bev_iou(decoded, gt_boxes))
    else:
        cls_cost = focal_cls_cost(cls_scores, gt_labels)
    reg_cost = torch.sum(
        (bbox_preds[..., :, None, :8] - norm_gt[..., None, :, :8]).abs(),
        dim=-1)
    cost = (cls_cost * cfg.cls_cost_weight + reg_cost * cfg.reg_cost_weight
            + iou_match_cost(decoded, gt_boxes, cfg) * cfg.iou_cost_weight)
    return torch.where(torch.isfinite(cost), cost, torch.full_like(cost, 1e4))


@torch.no_grad()
def all_layer_costs(outs, gt_boxes, gt_labels, cfg: Uni3DETRConfig):
    """The detached matching cost of every decoder layer, (L, B, Q, Gt)."""
    return torch.stack([match_cost(c, b, gt_boxes, gt_labels, cfg)
                        for c, b in zip(outs["all_cls_scores"],
                                        outs["all_bbox_preds"])])


@torch.no_grad()
def assign_layers(costs, gt_mask, cfg: Uni3DETRConfig):
    """costs (L, B, Q, Gt) -> (L, B, Q) int64, -1 for background: every
    layer's instances in one matching call (one auction launch)."""
    L, B, Q, Gt = costs.shape
    assigned = match_queries_to_gt(costs.reshape(L * B, Q, Gt),
                                   gt_mask.repeat(L, 1), cfg.num_query,
                                   cfg.gt_repeattimes, method=cfg.matcher,
                                   phases=cfg.matcher_phases)
    return assigned.reshape(L, B, Q)


@torch.no_grad()
def hungarian_assign(cls_scores, bbox_preds, gt_boxes, gt_labels, gt_mask,
                     cfg: Uni3DETRConfig):
    """Grouped assignment of a batch: cls (B, Q, ncls), bbox (B, Q, code),
    gravity-centred gt (B, Gt, 7|9) -> (B, Q) int64, -1 for background.
    The cost carries no gradient (the reference detaches it)."""
    cost = match_cost(cls_scores, bbox_preds, gt_boxes, gt_labels, cfg)
    return assign_layers(cost[None], gt_mask, cfg)[0]


def _layer_loss(cls_scores, bbox_preds, iou_preds, gt_boxes, gt_labels,
                assigned, cfg: Uni3DETRConfig, unc_preds=None,
                num_pos=None) -> Dict[str, torch.Tensor]:
    """Loss of one decoder layer over the batch given its assignment
    (B, Q); shapes (B, Q, .), ``unc_preds`` (B, Q, ncls + 1) or None.
    ``num_pos`` replaces the batch's positive count (at least 1) as the
    divisor of the summed terms."""
    B, Q, ncls = cls_scores.shape
    pos = assigned >= 0
    safe = assigned.clamp(min=0)
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, safe),
                         torch.full_like(safe, cfg.num_classes))
    tgt = torch.gather(gt_boxes, 1,
                       safe[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    tgt = torch.where(pos[..., None], tgt, torch.zeros_like(tgt))

    decoded = decode_boxes(bbox_preds)
    iou_bev = nearest_bev_iou_aligned(decoded, tgt)
    iou_z = z_interval_iou_aligned(decoded, tgt)
    quality = (iou_bev + iou_z) * 0.5
    posf = pos.float()
    if num_pos is None:
        num_pos = posf.sum().clamp(min=1.0)

    loss_cls = soft_focal_loss(cls_scores.reshape(-1, ncls),
                               labels.reshape(-1), quality.reshape(-1),
                               cfg.num_classes)
    loss_cls = loss_cls.sum() / num_pos * cfg.loss_cls_weight

    cw = torch.tensor(cfg.code_weights, dtype=torch.float32,
                      device=bbox_preds.device)
    l1 = (bbox_preds - encode_boxes(tgt)).abs() * cw * posf[..., None]
    l1 = torch.where(torch.isfinite(l1), l1, torch.zeros_like(l1))
    loss_consistency = None
    if unc_preds is not None:
        sigma = torch.gather(unc_preds, -1, labels[..., None])[..., 0]
        sigma = sigma.clamp(min=0.01)                       # (B, Q)
        l1 = l1 * (math.sqrt(2.0) * torch.exp(-sigma))[..., None]
        loss_consistency = sigma.mean()
    loss_bbox = l1.sum() / num_pos * cfg.loss_bbox_weight

    t = cfg.iou_loss_type
    if t == "iou3d":
        iou_term = 1.0 - iou_bev
    elif t == "rotated_iou3d":
        iou_term = 1.0 - iou3d_rotated_aligned(
            decoded[..., :7], tgt[..., :7], z_origin="center")
    elif t == "rdiou":
        iou_term = rdiou_penalty(decoded[..., :7], tgt[..., :7])
    else:
        raise ValueError(f"unknown iou_loss_type {t!r}")
    # the reference collapses the (rows, code) weight by its mean for the
    # IoU slot, and takes code_weights[0] for the z-IoU and IoU-pred terms
    cw_mean = sum(cfg.code_weights) / len(cfg.code_weights)
    cw0 = float(cfg.code_weights[0])
    loss_iou = (iou_term * posf).sum() / num_pos * cfg.loss_iou_weight \
        * cw_mean
    loss_iou = loss_iou + ((1.0 - iou_z) * posf).sum() / num_pos * cw0

    with torch.no_grad():
        iou_true = iou3d_rotated_aligned(decoded, tgt, z_origin="bottom")
    bce = iou_preds.clamp(min=0) - iou_preds * iou_true + torch.log1p(
        torch.exp(-iou_preds.abs()))
    loss_iou_pred = (bce * posf).sum() / num_pos * 1.2 * cw0
    out = {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
           "loss_iou": loss_iou, "loss_iou_pred": loss_iou_pred}
    if loss_consistency is not None:
        out["loss_consistency"] = loss_consistency
    return out


def uni3detr_loss(outs, gt_boxes, gt_labels, gt_mask, cfg: Uni3DETRConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over the decoder layers: outs the head's stacks (with
    the OV head's ``all_uncertainty_preds``, the uncertainty terms),
    gt_boxes (B, Gt, 7|9) gravity-centred, gt_labels (B, Gt), gt_mask
    (B, Gt). Returns (total, per-layer terms; the last layer's unprefixed,
    the others as ``d{i}.loss_*``). The costs of all layers are built
    first and matched in one call; each layer's loss then takes its own
    assignment."""
    L = outs["all_cls_scores"].shape[0]
    assigned = assign_layers(all_layer_costs(outs, gt_boxes, gt_labels, cfg),
                             gt_mask, cfg)
    unc = outs.get("all_uncertainty_preds")
    num_pos = [None] * L
    G = dist.batch_ranks()
    if G > 1:
        # inside dist.sharded_batch(), mmdet's reduce_mean: the global
        # positive count of each layer (at least 1) over the G data
        # groups (the data-axis group: the S ranks of a group hold the
        # same assignments), so that each group's loss is G x its sum
        # over the global count and the groups' mean gradient is the
        # global loss's
        counts = dist.all_reduce_sum(
            (assigned >= 0).sum(dim=(1, 2)).float(), dist.batch_group())
        num_pos = list(counts.clamp(min=1.0) / G)
    logs, total = {}, 0.0
    for l in range(L):
        d = _layer_loss(outs["all_cls_scores"][l], outs["all_bbox_preds"][l],
                        outs["all_iou_preds"][l], gt_boxes, gt_labels,
                        assigned[l], cfg,
                        unc_preds=None if unc is None else unc[l],
                        num_pos=num_pos[l])
        prefix = "" if l == L - 1 else f"d{l}."
        for k, v in d.items():
            logs[prefix + k] = v
            total = total + v
    return total, logs
