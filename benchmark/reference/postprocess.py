"""Decode and per-class NMS of the plain reference.

Decode (mmdet3d's NMS-free coder as Uni3DETR configures it): average the
decoder layers after the first, take the ``max_num`` best (query, class)
sigmoid scores (ties to the lower index), blend ``score = cls^alpha *
iou^(1 - alpha)``, keep centres inside ``post_center_range``. Then the
bottom-z boxes, greedy rotated-3D-IoU NMS per class one box at a time,
and the ``score_thr`` and ``num_thr`` cuts.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry as G


def decode(outs, cfg):
    """One scene's head stacks (L, Q, .) -> every query's box ``all_box``
    (Q, 7|9) bottom z and blended scores ``all_score`` (Q, ncls), and the
    ``max_num`` candidates by descending class score: ``query``,
    ``label``, ``score``, ``box`` (bottom z), ``valid``."""
    cls = outs["all_cls_scores"][1:].mean(0)
    box = G.decode(outs["all_bbox_preds"][1:].mean(0))
    iou = torch.sigmoid(outs["all_iou_preds"][1:].mean(0))
    Q, ncls = cls.shape
    a = cfg["coder_alpha"]
    p = torch.sigmoid(cls)
    all_score = p ** a * iou[:, None] ** (1 - a)
    s = p.reshape(-1)
    k = min(cfg["max_num"], s.shape[0])
    top, idx = torch.sort(s, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    q = idx // ncls
    b = box[q]
    pcr = cfg["post_center_range"]
    ok = torch.ones_like(top, dtype=torch.bool)
    for d in range(3):
        ok &= (b[:, d] >= pcr[d]) & (b[:, d] <= pcr[3 + d])
    return {"query": q, "label": idx % ncls, "score": top ** a * iou[q] **
            (1 - a), "box": G.bottom_center(b), "valid": ok,
            "all_box": G.bottom_center(box), "all_score": all_score}


def nms(cand, cfg):
    """The kept candidates of one scene (a bool mask over ``cand``)."""
    boxes = cand["box"]
    iou = G.iou3d_pairwise(boxes[:, :7], boxes[:, :7], "bottom").cpu().numpy()
    score = cand["score"].cpu().numpy()
    label = cand["label"].cpu().numpy()
    valid = cand["valid"].cpu().numpy()
    keep = np.zeros(len(score), bool)
    if cfg["post_processing"] == "nms":
        key = np.where(valid, score, -np.inf)
        alive = valid.copy()
        for i in np.argsort(-key, kind="stable"):
            if not alive[i]:
                continue
            keep[i] = True
            alive &= ~((iou[i] > cfg["nms_thr"]) & (label == label[i]))
            alive[i] = False
    else:
        keep = valid.copy()
    thr = cfg.get("score_thr")
    if thr is not None:
        keep &= score > (np.asarray(thr)[label] if isinstance(thr, list)
                         else thr)
    if cfg.get("num_thr") is not None:
        key = np.where(keep, score, -np.inf)
        keep[np.argsort(-key, kind="stable")[cfg["num_thr"]:]] = False
    return keep


def detect(outs, cfg):
    """One scene's head stacks -> its candidates on the host (numpy) with
    the kept mask under ``kept``."""
    cand = decode(outs, cfg)
    keep = nms(cand, cfg)
    out = {k: v.detach().cpu().numpy() for k, v in cand.items()}
    out["kept"] = keep
    return out
