"""Indoor VOC-style AP/AR evaluation (+ open-vocabulary seen/unseen split).

Capability parity with the reference ``indoor_eval_ov``
(core/indoor_eval.py:203-358): per class x IoU-threshold AP with
area-mode integration over the precision envelope, mAP/mAR table, and the
seen/unseen class split used by OV-Uni3DETR (":298-322").

Box overlaps use the exact rotated-3D IoU from ``geom`` (same kernel the
device path uses; the reference calls the mmcv CUDA rotated IoU through
the box structures). Boxes are storage layout (bottom-z).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..geom.iou import iou3d_rotated_sets


def scene_overlaps(det_boxes, gt_boxes, device="cuda"):
    """(D, >=7) x (G, >=7) boxes of one scene -> (D, G) float32 rotated
    3D IoU with bottom z: one N1 launch on the card."""
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)), np.float32)
    a = torch.as_tensor(np.asarray(det_boxes, np.float32)[:, :7])[None]
    b = torch.as_tensor(np.asarray(gt_boxes, np.float32)[:, :7])[None]
    return iou3d_rotated_sets(a.to(device), b.to(device),
                              "bottom")[0].cpu().numpy()


def _average_precision(recalls, precisions):
    """VOC area mode: integral under the precision envelope."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def indoor_eval(gt_list: List[dict], det_list: List[dict],
                classes: Sequence[str],
                iou_thrs: Sequence[float] = (0.25, 0.5),
                seen_classes: Optional[Sequence[str]] = None,
                device="cuda") -> Dict:
    """gt_list[i]:  {'boxes' (G,7+), 'labels' (G,)} per scene.
    det_list[i]: {'boxes' (D,7+), 'labels' (D,), 'scores' (D,)}.

    Returns {'AP_{thr}': {class: ap}, 'mAP_{thr}': float, 'AR_...',
    optionally seen/unseen mAP splits}. The overlaps are computed on
    ``device`` (:func:`scene_overlaps`).
    """
    assert len(gt_list) == len(det_list)
    overlaps = [scene_overlaps(det["boxes"], gt["boxes"], device)
                for gt, det in zip(gt_list, det_list)]
    ncls = len(classes)
    results: Dict = {}
    ap_table = {thr: {} for thr in iou_thrs}
    ar_table = {thr: {} for thr in iou_thrs}

    # precompute per-scene overlaps once per class
    for c in range(ncls):
        scene_entries = []  # (scores, iou_row per det, n_gt)
        n_gt_total = 0
        for gt, det, ov_all in zip(gt_list, det_list, overlaps):
            gmask = gt["labels"] == c
            dmask = det["labels"] == c
            gb = gt["boxes"][gmask]
            db = det["boxes"][dmask]
            sc = det["scores"][dmask]
            n_gt_total += len(gb)
            ov = ov_all[np.ix_(dmask, gmask)]
            scene_entries.append((sc, ov))
        for thr in iou_thrs:
            tp, fp, scores = [], [], []
            for sc, ov in scene_entries:
                order = np.argsort(-sc)
                matched = np.zeros(ov.shape[1], bool)
                for d in order:
                    scores.append(sc[d])
                    if ov.shape[1]:
                        j = int(np.argmax(ov[d]))
                        # strictly greater, like the reference
                        # (indoor_eval.py:141 ``iou_max > thresh``)
                        if ov[d, j] > thr and not matched[j]:
                            matched[j] = True
                            tp.append(1.0)
                            fp.append(0.0)
                            continue
                    tp.append(0.0)
                    fp.append(1.0)
            if n_gt_total == 0:
                ap_table[thr][classes[c]] = float("nan")
                ar_table[thr][classes[c]] = float("nan")
                continue
            order = np.argsort(-np.asarray(scores)) if scores else []
            tp = np.cumsum(np.asarray(tp)[order]) if len(scores) else \
                np.zeros(0)
            fp = np.cumsum(np.asarray(fp)[order]) if len(scores) else \
                np.zeros(0)
            recalls = tp / n_gt_total if len(tp) else np.zeros(0)
            precisions = tp / np.maximum(tp + fp, 1e-9) if len(tp) else \
                np.zeros(0)
            ap_table[thr][classes[c]] = _average_precision(
                recalls, precisions) if len(tp) else 0.0
            ar_table[thr][classes[c]] = float(recalls[-1]) if len(tp) \
                else 0.0

    for thr in iou_thrs:
        vals = [v for v in ap_table[thr].values() if not np.isnan(v)]
        rvals = [v for v in ar_table[thr].values() if not np.isnan(v)]
        results[f"AP_{thr:.2f}"] = ap_table[thr]
        results[f"AR_{thr:.2f}"] = ar_table[thr]
        results[f"mAP_{thr:.2f}"] = float(np.mean(vals)) if vals else 0.0
        results[f"mAR_{thr:.2f}"] = float(np.mean(rvals)) if rvals else 0.0
        if seen_classes is not None:
            seen = [ap_table[thr][c] for c in classes
                    if c in seen_classes and not np.isnan(ap_table[thr][c])]
            unseen = [ap_table[thr][c] for c in classes
                      if c not in seen_classes
                      and not np.isnan(ap_table[thr][c])]
            results[f"mAP_seen_{thr:.2f}"] = float(np.mean(seen)) \
                if seen else 0.0
            results[f"mAP_unseen_{thr:.2f}"] = float(np.mean(unseen)) \
                if unseen else 0.0
    return results


def format_table(results, classes, iou_thrs=(0.25, 0.5)) -> str:
    lines = [f"{'class':<16}" + "".join(
        f"AP@{t:<6.2f}AR@{t:<6.2f}" for t in iou_thrs)]
    for c in classes:
        row = f"{c:<16}"
        for t in iou_thrs:
            row += (f"{results[f'AP_{t:.2f}'][c]:<9.4f}"
                    f"{results[f'AR_{t:.2f}'][c]:<9.4f}")
        lines.append(row)
    row = f"{'Overall':<16}"
    for t in iou_thrs:
        row += (f"{results[f'mAP_{t:.2f}']:<9.4f}"
                f"{results[f'mAR_{t:.2f}']:<9.4f}")
    lines.append(row)
    return "\n".join(lines)
