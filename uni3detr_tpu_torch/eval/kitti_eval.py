"""KITTI-style AP evaluation: 3D / BEV / 2D-bbox AP + AOS, AP11 / AP40
(port of ``uni3detr_tpu/data/eval/kitti_eval.py``, without JAX).

The ``3d`` and ``bev`` overlaps of a scene come from N1's two-set forms
(``geom.iou.iou3d_rotated_sets``, ``iou_bev_rotated_sets``): on the card
one launch of each per scene over all classes, sliced per class on the
host; on the CPU their plain versions. The rest is the JAX package's
host code, unchanged but for a scene without a detection of the class,
where its vectorized second pass raises (:func:`_second_pass_all`).

Capability parity with the KITTI eval the reference delegates to mmdet3d
(SURVEY.md §3.2): per class x difficulty x IoU-threshold AP with the
official recall-point interpolation (11 points for AP11, 40 for AP_R40),
over three overlap modes —

- ``3d``: exact rotated 3D IoU;
- ``bev``: exact rotated bird's-eye IoU (official bev metric);
- ``bbox`` + ``aos``: 2D image-box IoU, plus Average Orientation
  Similarity ( (1+cos dalpha)/2 accumulated over TPs, official
  eval.cpp semantics ) — computed when detections carry projected
  2D boxes ('bbox', from :func:`project_boxes_to_image`) and
  observation angles ('alpha', from :func:`lidar_alpha`).

Assignment and PR construction follow the official ``eval.cpp``
(as transcribed by mmdet3d's kitti eval, the path the reference
delegates to):

- GT cleaning per (class, difficulty): valid (0), ignored (1: same
  class but difficulty exceeded, or a neighboring class — Van for Car,
  Person_sitting for Pedestrian), irrelevant (-1); ``DontCare`` regions
  collected separately.
- Detection cleaning: a det whose projected 2D height is below the
  difficulty minimum is "ignored" (never a FP, may consume a GT).
- Score thresholds: a first GT-MAJOR pass (each valid GT takes its
  highest-scoring overlapping det) collects TP scores; 41
  recall-equally-spaced thresholds are sampled from them
  (``get_thresholds``).
- Per threshold, a second GT-MAJOR pass (each GT takes the
  max-overlap VALID det above threshold; an ignored det only if no
  valid one) accumulates tp/fp; unassigned valid dets above threshold
  are FPs, minus those whose intersection/det-area with a DontCare
  region exceeds the overlap threshold (2D-bbox metric only, as in
  mmdet3d).
- AP11 = mean precision at every 4th threshold index (11 of 41);
  AP40 = mean over indices 1..40; precision is max-smoothed from the
  right. Sparse eval sets leave later recall points empty (zero
  precision) exactly as the official tooling does.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..geom.iou import iou3d_rotated_sets, iou_bev_rotated_sets


def corners_3d(boxes):
    """(N, >=7) storage boxes -> (N, 8, 3) corners: the 4 BEV corners
    (counter-clockwise) at z_bottom, then at z_bottom + dz (the JAX
    package's ``data/box_np_ops.py::corners_3d``)."""
    half = boxes[:, 3:5] * 0.5
    corners = np.stack([
        np.stack([half[:, 0], half[:, 1]], -1),
        np.stack([-half[:, 0], half[:, 1]], -1),
        np.stack([-half[:, 0], -half[:, 1]], -1),
        np.stack([half[:, 0], -half[:, 1]], -1),
    ], 1)                                            # (N, 4, 2)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    bev = np.einsum("nij,nkj->nki", rot, corners) + boxes[:, None, :2]
    z0 = boxes[:, 2:3]
    z1 = z0 + boxes[:, 5:6]
    lo = np.concatenate([bev, np.broadcast_to(z0[:, None],
                                              bev.shape[:2] + (1,))], -1)
    hi = np.concatenate([bev, np.broadcast_to(z1[:, None],
                                              bev.shape[:2] + (1,))], -1)
    return np.concatenate([lo, hi], 1)


def scene_overlaps(det_boxes, gt_boxes, device="cuda"):
    """(D, >=7) detections x (G, >=7) GT boxes of one scene, storage
    layout -> (3D IoU with bottom z, BEV IoU), each (D, G) float32: one
    launch of each N1 two-set form on the card and one copy back."""
    D, G = len(det_boxes), len(gt_boxes)
    if D == 0 or G == 0:
        z = np.zeros((D, G), np.float32)
        return z, z
    a = torch.as_tensor(np.asarray(det_boxes, np.float32)[:, :7])[None]
    b = torch.as_tensor(np.asarray(gt_boxes, np.float32)[:, :7])[None]
    a, b = a.to(device), b.to(device)
    ov = torch.stack([iou3d_rotated_sets(a, b, "bottom")[0],
                      iou_bev_rotated_sets(a, b)[0]]).cpu().numpy()
    return ov[0], ov[1]


def project_boxes_to_image(boxes_lidar, calib, image_shape=None):
    """(N, >=7) lidar storage boxes -> (N, 4) xyxy image boxes.

    Projects the 8 box corners through P2 @ R0_rect @ Tr_velo_to_cam
    (the official kitti.py camera chain). Boxes whose center lands behind
    the image plane get a degenerate (0-height) bbox so every difficulty
    level ignores them — the official eval only scores the camera frustum.
    """
    if len(boxes_lidar) == 0:
        return np.zeros((0, 4), np.float32)
    P2 = np.asarray(calib["P2"], np.float64)       # (3, 4)
    R0 = np.asarray(calib["R0_rect"], np.float64)  # (4, 4)
    Tr = np.asarray(calib["Tr_velo_to_cam"], np.float64)
    corners = corners_3d(np.asarray(boxes_lidar, np.float64))  # (N, 8, 3)
    N = len(corners)
    hom = np.concatenate([corners.reshape(-1, 3),
                          np.ones((N * 8, 1))], 1)
    img = hom @ (P2 @ R0 @ Tr).T                   # (N*8, 3)
    z = img[:, 2].reshape(N, 8)
    px = (img[:, 0] / np.maximum(img[:, 2], 1e-6)).reshape(N, 8)
    py = (img[:, 1] / np.maximum(img[:, 2], 1e-6)).reshape(N, 8)
    bbox = np.stack([px.min(1), py.min(1), px.max(1), py.max(1)], 1)
    if image_shape is not None:
        h, w = image_shape[:2]
        bbox[:, [0, 2]] = np.clip(bbox[:, [0, 2]], 0, w - 1)
        bbox[:, [1, 3]] = np.clip(bbox[:, [1, 3]], 0, h - 1)
    behind = (z <= 0).any(1)
    bbox[behind] = 0.0
    return bbox.astype(np.float32)


def lidar_alpha(boxes_lidar, calib):
    """Observation angle alpha of lidar boxes (official label field:
    alpha = rotation_y - atan2(x_cam, z_cam); rotation_y = -yaw - pi/2
    under the mmdet3d lidar->cam yaw convention)."""
    if len(boxes_lidar) == 0:
        return np.zeros((0,), np.float32)
    R0 = np.asarray(calib["R0_rect"], np.float64)
    Tr = np.asarray(calib["Tr_velo_to_cam"], np.float64)
    ctr = np.asarray(boxes_lidar, np.float64)[:, :3]
    hom = np.concatenate([ctr, np.ones((len(ctr), 1))], 1)
    cam = hom @ (R0 @ Tr).T                         # (N, 4)
    ry = -np.asarray(boxes_lidar)[:, 6] - np.pi / 2
    alpha = ry - np.arctan2(cam[:, 0], np.maximum(cam[:, 2], 1e-6))
    return alpha.astype(np.float32)


# official neighboring-class ignores (eval.cpp clean_data): a det of the
# evaluated class overlapping one of these is neither TP nor FP
NEIGHBOR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}


def kitti_gt_from_info(info, classes):
    """Rebuild a full-annotation GT dict from an info record (the official
    eval scores against raw annotations, not the range-filtered training
    view): boxes_lidar + names + the difficulty/orientation fields.
    Neighbor-class and DontCare rows are retained — the official cleaning
    consumes them (ignored GTs / DontCare regions)."""
    annos = info.get("annos", {})
    names = np.asarray(list(annos.get("name", [])), dtype=object)
    neighbors = {n for c in classes for n in NEIGHBOR_CLASSES.get(c, ())}
    keep = [i for i, n in enumerate(names)
            if n in classes or n in neighbors or n == "DontCare"]
    boxes = np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7))),
                       np.float32).reshape(-1, 7)
    gt = {"boxes": boxes[keep] if len(boxes) else boxes,
          "names": names[keep],
          "labels": np.asarray(
              [classes.index(n) if n in classes else -1
               for n in names[keep]], np.int32)}
    for k in ("bbox", "occluded", "truncated", "alpha"):
        if k in annos:
            gt[k] = np.asarray(annos[k])[keep]
    return gt

# official thresholds: (min 2D height px, max occlusion, max truncation)
DIFFICULTY = {
    0: (40, 0, 0.15),   # easy
    1: (25, 1, 0.30),   # moderate
    2: (25, 2, 0.50),   # hard
}
DEFAULT_IOU_THR = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# official 2D-bbox thresholds match the 3D ones for the shipped classes
DEFAULT_IOU_THR_2D = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


def _gt_ignored(gt: dict, cls: str, level: int):
    """Official clean_data: per-row -1 (irrelevant) / 0 (valid) /
    1 (ignored: same class over difficulty, or neighboring class)."""
    n = len(gt["boxes"])
    names = gt.get("names")
    if names is None:  # labels-only fixtures: every row is this class
        same = np.ones(n, bool)
        neigh = np.zeros(n, bool)
    else:
        names = np.asarray(names, dtype=object)
        same = names == cls
        neigh = np.isin(names, NEIGHBOR_CLASSES.get(cls, ()))
    if "bbox" in gt and "occluded" in gt:
        hmin, occ_max, trunc_max = DIFFICULTY[level]
        h = np.asarray(gt["bbox"])[:, 3] - np.asarray(gt["bbox"])[:, 1]
        # official clean_data ignores GTs with height <= MIN_HEIGHT
        # (boundary inclusive); detection cleaning keeps strict < below
        too_hard = ((h <= hmin) | (np.asarray(gt["occluded"]) > occ_max)
                    | (np.asarray(gt["truncated"]) > trunc_max))
    else:
        too_hard = np.zeros(n, bool)
    out = np.full(n, -1, np.int32)
    out[same & ~too_hard] = 0
    out[(same & too_hard) | neigh] = 1
    return out


def _dc_boxes(gt: dict):
    """DontCare 2D regions (K, 4) xyxy, or empty."""
    names = gt.get("names")
    if names is None or "bbox" not in gt:
        return np.zeros((0, 4), np.float32)
    sel = np.asarray(names, dtype=object) == "DontCare"
    return np.asarray(gt["bbox"], np.float32)[sel]


def _iou2d_matrix(db, gb):
    """(D, 4) x (G, 4) xyxy -> (D, G) IoU."""
    if len(db) == 0 or len(gb) == 0:
        return np.zeros((len(db), len(gb)), np.float32)
    x1 = np.maximum(db[:, None, 0], gb[None, :, 0])
    y1 = np.maximum(db[:, None, 1], gb[None, :, 1])
    x2 = np.minimum(db[:, None, 2], gb[None, :, 2])
    y2 = np.minimum(db[:, None, 3], gb[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1])
    a2 = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-9)


N_SAMPLE_PTS = 41


def _get_thresholds(tp_scores, num_valid_gt):
    """Official get_thresholds: recall-equally-spaced score thresholds
    (eval.cpp getThresholds / mmdet3d get_thresholds)."""
    scores = np.sort(np.asarray(tp_scores))[::-1]
    thresholds, current_recall = [], 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_valid_gt
        r_recall = (i + 2) / num_valid_gt if i < len(scores) - 1 \
            else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return np.asarray(thresholds)


def _first_pass(ov, scores, det_ign, ignored_gt, min_ov):
    """GT-major pass at threshold 0 collecting TP scores (eval.cpp
    computeStatistics with compute_fp=false: each relevant GT takes the
    highest-SCORING overlapping unassigned det)."""
    D = len(scores)
    assigned = np.zeros(D, bool)
    out = []
    for i in range(len(ignored_gt)):
        gi = ignored_gt[i]
        if gi == -1:
            continue
        cand = np.nonzero(~assigned & (ov[:, i] > min_ov))[0]
        if len(cand) == 0:
            continue
        j = cand[int(np.argmax(scores[cand]))]
        if gi == 0 and det_ign[j] == 0:
            out.append(float(scores[j]))
        assigned[j] = True
    return out


def _second_pass(ov, scores, det_ign, ignored_gt, thresh, min_ov,
                 dc_ov=None, sim=None):
    """GT-major pass at a score threshold (compute_fp=true): each
    relevant GT takes the max-OVERLAP valid det; an undersized det only
    when no valid one overlaps. Returns (tp, fp, similarity_sum)."""
    D = len(scores)
    assigned = np.zeros(D, bool)
    ign_thr = scores < thresh
    tp, simsum = 0, 0.0
    for i in range(len(ignored_gt)):
        gi = ignored_gt[i]
        if gi == -1:
            continue
        cand = ~assigned & ~ign_thr & (ov[:, i] > min_ov)
        vi = np.nonzero(cand & (det_ign == 0))[0]
        if len(vi):
            j = vi[int(np.argmax(ov[vi, i]))]
            j_ign = False
        else:
            ii = np.nonzero(cand & (det_ign == 1))[0]
            if len(ii) == 0:
                continue  # fn if gi == 0 (not needed for precision)
            j = ii[0]
            j_ign = True
        assigned[j] = True
        if gi == 0 and not j_ign:
            tp += 1
            if sim is not None:
                simsum += float(sim[j, i])
    fp = int((~assigned & ~ign_thr & (det_ign == 0)).sum())
    if dc_ov is not None and dc_ov.shape[1]:
        stuff = (~assigned & ~ign_thr & (det_ign == 0)
                 & (dc_ov > min_ov).any(axis=1))
        fp -= int(stuff.sum())
    return tp, fp, simsum


def _second_pass_all(ov, scores, det_ign, ignored_gt, thresholds, min_ov,
                     dc_ov=None, sim=None):
    """All-thresholds vectorization of :func:`_second_pass`: one pass over
    the GTs with a (T, D) assignment matrix instead of T independent
    Python passes (mmdet3d numba-jits this loop; at 41 thresholds x 3769
    images x 3 difficulties the per-call Python overhead dominated eval).
    Each threshold row replays the exact greedy GT-major order, so results
    are identical to the scalar pass (pinned in tests)."""
    thresholds = np.asarray(thresholds)
    T, D = len(thresholds), len(scores)
    if D == 0:
        # no detection of the class in this scene: no TP and no FP, as in
        # the scalar pass (the JAX package's argmax over no detection
        # raises here)
        return np.zeros(T, np.int64), np.zeros(T, np.int64), np.zeros(T)
    ign_thr = scores[None, :] < thresholds[:, None]          # (T, D)
    assigned = np.zeros((T, D), bool)
    valid = det_ign == 0
    undersized = det_ign == 1
    tp = np.zeros(T, np.int64)
    simsum = np.zeros(T)
    for i in range(len(ignored_gt)):
        gi = ignored_gt[i]
        if gi == -1:
            continue
        overl = ov[:, i] > min_ov                            # (D,)
        cand = ~assigned & ~ign_thr & overl[None, :]         # (T, D)
        vcand = cand & valid[None, :]
        has_valid = vcand.any(axis=1)
        # max-overlap valid det per threshold (first max in det order,
        # matching the scalar pass's argmax over ascending indices)
        jv = np.argmax(np.where(vcand, ov[None, :, i], -np.inf), axis=1)
        icand = cand & undersized[None, :]
        has_ign = icand.any(axis=1)
        ji = np.argmax(icand, axis=1)                        # first True
        j = np.where(has_valid, jv, ji)
        rows = np.nonzero(has_valid | has_ign)[0]
        assigned[rows, j[rows]] = True
        if gi == 0:
            tp += has_valid
            if sim is not None:
                simsum += np.where(has_valid, sim[jv, i], 0.0)
    free_valid = ~assigned & ~ign_thr & valid[None, :]
    fp = free_valid.sum(axis=1).astype(np.int64)
    if dc_ov is not None and dc_ov.shape[1]:
        fp -= (free_valid & (dc_ov > min_ov).any(axis=1)[None, :]) \
            .sum(axis=1)
    return tp, fp, simsum


def _accumulate_metric(entries, level, thr, ov_key, n_points,
                       with_aos=False, use_dc=False):
    """One (class, difficulty, overlap-mode) official PR accumulation.

    entries: per-scene dicts with 'ignored_gt' (per level), 'scores',
    'det_ign' (per level), overlap matrices under ov_key, 'dc_ov'
    (intersection/det-area vs DontCare regions) and optionally 'sim'.
    Returns (ap*100 or nan, aos*100 or None)."""
    n_gt = 0
    tp_scores = []
    for e in entries:
        ig = e["ignored_gt"][level]
        n_gt += int((ig == 0).sum())
        tp_scores += _first_pass(e[ov_key], e["scores"],
                                 e["det_ign"][level], ig, thr)
    if n_gt == 0:
        return float("nan"), (float("nan") if with_aos else None)
    thresholds = _get_thresholds(tp_scores, n_gt)
    prec = np.zeros(N_SAMPLE_PTS)
    aosp = np.zeros(N_SAMPLE_PTS)
    if len(thresholds):
        tps = np.zeros(len(thresholds))
        fps = np.zeros(len(thresholds))
        sims = np.zeros(len(thresholds))
        for e in entries:
            ig = e["ignored_gt"][level]
            di = e["det_ign"][level]
            dc = e.get("dc_ov") if use_dc else None
            sim = e.get("sim") if with_aos else None
            tp, fp, s = _second_pass_all(e[ov_key], e["scores"], di, ig,
                                         thresholds, thr, dc_ov=dc,
                                         sim=sim)
            tps += tp
            fps += fp
            sims += s
        denom = np.maximum(tps + fps, 1e-9)
        prec[:len(thresholds)] = tps / denom
        aosp[:len(thresholds)] = sims / denom
    # right-max smoothing over the 41 sample points (zeros beyond the
    # last threshold stay zero, as in mmdet3d/eval.cpp)
    for i in range(N_SAMPLE_PTS):
        prec[i] = prec[i:].max()
        aosp[i] = aosp[i:].max()
    if n_points == 11:
        ap = float(prec[0::4].sum() / 11.0 * 100.0)
        aos = float(aosp[0::4].sum() / 11.0 * 100.0)
    else:
        ap = float(prec[1:].sum() / 40.0 * 100.0)
        aos = float(aosp[1:].sum() / 40.0 * 100.0)
    return ap, (aos if with_aos else None)


def kitti_eval(gt_list: List[dict], det_list: List[dict],
               classes: Sequence[str], iou_thr: Dict[str, float] = None,
               n_points: int = 40, device="cuda") -> Dict:
    """gt_list[i]: {'boxes' (G,7) lidar storage layout, 'labels',
    optional 'bbox'/'occluded'/'truncated'/'alpha'}; det_list[i]:
    {'boxes', 'labels', 'scores', optional 'bbox'/'alpha'}.

    Returns {'{cls}_{metric}_{easy|moderate|hard}': AP} for metrics 3d
    and bev always, plus bbox and aos when both sides carry 2D boxes
    (aos additionally needs 'alpha' on both sides). The overlaps are
    computed on ``device`` (:func:`scene_overlaps`).
    """
    iou_thr = iou_thr or DEFAULT_IOU_THR
    overlaps = [scene_overlaps(det["boxes"], gt["boxes"], device)
                for gt, det in zip(gt_list, det_list)]
    results = {}
    for ci, cls in enumerate(classes):
        thr = iou_thr.get(cls, 0.5)
        thr2d = DEFAULT_IOU_THR_2D.get(cls, 0.5)
        entries = []
        have_2d = True
        have_aos = True
        for (gt, det), (ov_all, ovbev_all) in zip(zip(gt_list, det_list),
                                                  overlaps):
            # with per-row names present, keep ALL rows (neighbors /
            # DontCare become ignored GTs / regions); labels-only
            # fixtures keep the current-class rows
            gm = np.ones(len(gt["boxes"]), bool) if "names" in gt \
                else (gt["labels"] == ci)
            dm = det["labels"] == ci
            gb, db = gt["boxes"][gm], det["boxes"][dm]
            ov3d = ov_all[np.ix_(dm, gm)]
            ovbev = ovbev_all[np.ix_(dm, gm)]
            gsub = {k: np.asarray(gt[k])[gm] for k in
                    ("names", "bbox", "occluded", "truncated", "alpha")
                    if k in gt}
            gsub["boxes"] = gb
            e = {"scores": det["scores"][dm],
                 "ov3d": ov3d, "ovbev": ovbev,
                 "ignored_gt": [_gt_ignored(gsub, cls, lvl)
                                for lvl in range(3)]}
            det_h = ((det["bbox"][dm][:, 3] - det["bbox"][dm][:, 1])
                     if "bbox" in det else None)
            e["det_ign"] = [
                np.zeros(len(db), np.int32) if det_h is None
                else (det_h < DIFFICULTY[lvl][0]).astype(np.int32)
                for lvl in range(3)]
            dc = _dc_boxes(gsub)
            if "bbox" in det and len(dc):
                # criterion 0: intersection / detection area
                dbx = np.asarray(det["bbox"])[dm]
                x1 = np.maximum(dbx[:, None, 0], dc[None, :, 0])
                y1 = np.maximum(dbx[:, None, 1], dc[None, :, 1])
                x2 = np.minimum(dbx[:, None, 2], dc[None, :, 2])
                y2 = np.minimum(dbx[:, None, 3], dc[None, :, 3])
                inter = (np.clip(x2 - x1, 0, None)
                         * np.clip(y2 - y1, 0, None))
                da = ((dbx[:, 2] - dbx[:, 0])
                      * (dbx[:, 3] - dbx[:, 1]))[:, None]
                e["dc_ov"] = inter / np.maximum(da, 1e-9)
            else:
                e["dc_ov"] = np.zeros((int(dm.sum()), 0), np.float32)
            if "bbox" in det and "bbox" in gt:
                e["ov2d"] = _iou2d_matrix(np.asarray(det["bbox"])[dm],
                                          np.asarray(gt["bbox"])[gm])
            else:
                have_2d = False
            if "alpha" in det and "alpha" in gt:
                da_ = np.asarray(det["alpha"])[dm]
                ga = np.asarray(gt["alpha"])[gm]
                e["sim"] = (1.0 + np.cos(da_[:, None] - ga[None, :])) / 2.0
            else:
                have_aos = False
            entries.append(e)
        for level, lname in ((0, "easy"), (1, "moderate"), (2, "hard")):
            ap3d, _ = _accumulate_metric(entries, level, thr, "ov3d",
                                         n_points)
            apbev, _ = _accumulate_metric(entries, level, thr, "ovbev",
                                          n_points)
            results[f"{cls}_3d_{lname}"] = ap3d
            results[f"{cls}_bev_{lname}"] = apbev
            if have_2d:
                ap2d, aos = _accumulate_metric(
                    entries, level, thr2d, "ov2d", n_points,
                    with_aos=have_aos, use_dc=True)
                results[f"{cls}_bbox_{lname}"] = ap2d
                if have_aos:
                    results[f"{cls}_aos_{lname}"] = aos
    return results
