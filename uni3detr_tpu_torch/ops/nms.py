"""Greedy NMS on a precomputed IoU matrix (port of
``uni3detr_tpu/ops/nms.py``).

:func:`_greedy_suppress` decides in each round every box whose
higher-ranked overlapping boxes are all decided, so the number of rounds
is the longest suppression chain, not the number of boxes.
:func:`_greedy_suppress_serial` is the one-box-per-step oracle. Both rank
boxes by descending score with a stable sort (lower index first on
ties), as ``jnp.argsort`` does.
"""
from __future__ import annotations

import torch


def _rank_order(scores, valid):
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def _greedy_suppress_serial(iou, scores, valid, iou_thr):
    """Reference greedy NMS, one box per step. Returns the keep mask (N,)."""
    N = scores.shape[0]
    order = _rank_order(scores, valid).tolist()
    alive = torch.ones(N, dtype=torch.bool, device=scores.device)
    keep = torch.zeros(N, dtype=torch.bool, device=scores.device)
    for i in order:
        is_kept = bool(alive[i]) and bool(valid[i])
        keep[i] = is_kept
        if is_kept:
            alive &= ~(iou[i] > iou_thr)
        alive[i] = False
    return keep


def _greedy_suppress(iou, scores, valid, iou_thr):
    """Wavefront greedy NMS. iou (N, N); scores (N,); valid (..., N):
    leading dims of ``valid`` are independent problems over the same
    boxes (the coder passes one per class). Returns keep (..., N), equal
    to :func:`_greedy_suppress_serial` on each problem."""
    N = scores.shape[-1]
    order = _rank_order(scores.expand_as(valid), valid)
    ar = torch.arange(N, device=scores.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ar)
    # M[..., j, k]: valid j ranked above valid k can suppress k
    overl = (iou > iou_thr) & valid[..., :, None] & valid[..., None, :]
    M = overl & (rank[..., :, None] < rank[..., None, :])
    decided = ~valid
    kept = torch.zeros_like(valid)
    while not bool(decided.all()):
        blocked = (M & ~decided[..., :, None]).any(dim=-2)
        ready = ~decided & ~blocked
        sup = (M & kept[..., :, None]).any(dim=-2)
        kept = kept | (ready & ~sup)
        decided = decided | ready
    return kept
