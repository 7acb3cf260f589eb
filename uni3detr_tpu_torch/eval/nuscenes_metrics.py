"""Devkit-free nuScenes detection metrics (mAP / TP errors / NDS); a
copy of ``uni3detr_tpu/data/eval/nuscenes_metrics.py``.

The reference delegates nuScenes evaluation to the official devkit
(datasets/nuscenes_dataset.py:479-535 builds a submission JSON and runs
``NuScenesEval``); the devkit is not installable in this image, so this
module re-implements the detection-metric math of
``nuscenes.eval.detection`` (algo.py accumulate/calc_ap/calc_tp,
CVPR-2019 config) directly on our internal det/gt dicts:

- matching by BEV center distance at thresholds {0.5, 1, 2, 4} m,
  greedy over detections sorted by score, one GT matched once;
- AP: 101-point interpolated precision/recall, clipped below
  min_recall = min_precision = 0.1 and renormalized;
- TP errors at the 2 m threshold, cum-mean interpolated onto the recall
  grid and averaged from recall 0.1 to the max achieved recall:
  ATE (BEV center dist), ASE (1 - aligned-size IoU), AOE (yaw diff,
  period pi for barrier), AVE (BEV velocity L2);
- class rules: traffic_cone has no orientation/velocity, barrier no
  velocity/attribute (matching the devkit's exclusions);
- AAE: 1 - attribute accuracy over TPs whose GT carries an attribute;
  the detection attribute is derived with the reference's submission
  rule (speed > 0.2 -> vehicle.moving / cycle.with_rider, else
  pedestrian.standing / vehicle.stopped / class default —
  nuscenes_dataset.py:434-453 + DefaultAttribute :74-85). Requires
  ``attrs`` (GT attribute names) in the gt dicts (the converter records
  them as ``gt_attrs``); without them AAE falls out of the NDS
  denominator as before.
- NDS = (5*mAP + sum(max(1 - err, 0))) / (5 + n_tp_terms) — with
  attributes available n_tp_terms = 5, the official 10-denominator.

Deviation (documented): distances are measured in the lidar frame
rather than global (rigid transforms preserve them).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
NO_ORIENT = {"traffic_cone"}
NO_VELOCITY = {"traffic_cone", "barrier"}
NO_ATTRIBUTE = {"traffic_cone", "barrier"}
YAW_PERIOD_PI = {"barrier"}

# reference DefaultAttribute (nuscenes_dataset.py:74-85)
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider", "barrier": "", "traffic_cone": "",
}


def det_attribute(cls_name: str, box) -> str:
    """Submission attribute rule (nuscenes_dataset.py:434-453)."""
    speed = float(np.hypot(box[7], box[8])) if len(box) > 8 else 0.0
    if speed > 0.2:
        if cls_name in ("car", "construction_vehicle", "bus", "truck",
                        "trailer"):
            return "vehicle.moving"
        if cls_name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE.get(cls_name, "")
    if cls_name == "pedestrian":
        return "pedestrian.standing"
    if cls_name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(cls_name, "")


def _gather_class(det_list, gt_list, ci):
    """Flatten one class over all scenes, keeping scene ids."""
    dets = []
    for si, det in enumerate(det_list):
        m = det["labels"] == ci
        for b, s in zip(det["boxes"][m], det["scores"][m]):
            dets.append((si, b, float(s)))
    dets.sort(key=lambda t: -t[2])
    gts = [gt["boxes"][gt["labels"] == ci] for gt in gt_list]
    attrs = None
    if all("attrs" in gt for gt in gt_list):
        attrs = [np.asarray(gt["attrs"])[gt["labels"] == ci]
                 for gt in gt_list]
    return dets, gts, attrs


def _cummean(x):
    """NaN-skipping cumulative mean (devkit utils.cummean): NaN entries
    (e.g. attribute-less GTs in the AAE curve) don't count."""
    if len(x) == 0:
        return x
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x)
    cnt = np.cumsum(~np.isnan(x)).astype(np.float64)
    return np.divide(s, cnt, out=np.zeros_like(s, np.float64),
                     where=cnt != 0)


def _yaw_diff(a, b, period):
    d = (a - b) % period
    return min(d, period - d)


def _scale_iou(b1, b2):
    """IoU after aligning translation and yaw: pure size comparison
    (devkit utils.scale_iou)."""
    s1 = np.maximum(b1[3:6], 1e-6)
    s2 = np.maximum(b2[3:6], 1e-6)
    inter = np.prod(np.minimum(s1, s2))
    return inter / (np.prod(s1) + np.prod(s2) - inter)


def _accumulate(dets, gts, cls_name, dist_th, with_vel, gt_attrs=None):
    """One (class, distance threshold) accumulation.

    Returns (rec_interp_prec (101,), tp_errs dict of (101,) arrays or
    None when dist_th != DIST_TH_TP, npos)."""
    npos = sum(len(g) for g in gts)
    if npos == 0:
        return None, None, 0
    matched = [np.zeros(len(g), bool) for g in gts]
    tp, fp, conf = [], [], []
    errs = {"ate": [], "ase": [], "aoe": [], "ave": []}
    with_attr = gt_attrs is not None and cls_name not in NO_ATTRIBUTE
    if with_attr:
        errs["aae"] = []
    period = np.pi if cls_name in YAW_PERIOD_PI else 2 * np.pi
    for si, b, score in dets:
        g = gts[si]
        best_j, best_d = -1, float(dist_th)
        for j in range(len(g)):
            if matched[si][j]:
                continue
            d = float(np.hypot(b[0] - g[j][0], b[1] - g[j][1]))
            if d < best_d:
                best_d, best_j = d, j
        conf.append(score)
        if best_j >= 0:
            matched[si][best_j] = True
            tp.append(1.0)
            fp.append(0.0)
            gj = g[best_j]
            errs["ate"].append(best_d)
            errs["ase"].append(1.0 - _scale_iou(b, gj))
            errs["aoe"].append(0.0 if cls_name in NO_ORIENT
                               else _yaw_diff(b[6], gj[6], period))
            if with_vel and len(b) > 8 and len(gj) > 8:
                errs["ave"].append(
                    float(np.hypot(b[7] - gj[7], b[8] - gj[8])))
            else:
                errs["ave"].append(0.0)
            if with_attr:
                ga = str(gt_attrs[si][best_j])
                # devkit attr_acc: NaN (skipped) when the GT carries no
                # attribute; else exact-match accuracy
                errs["aae"].append(
                    np.nan if ga == ""
                    else float(det_attribute(cls_name, b) != ga))
        else:
            tp.append(0.0)
            fp.append(1.0)
    tp = np.asarray(tp)
    fp = np.asarray(fp)
    conf = np.asarray(conf)
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    rec = ctp / npos
    prec = ctp / np.maximum(ctp + cfp, 1e-9)
    rec_interp = np.linspace(0.0, 1.0, 101)
    prec_i = np.interp(rec_interp, rec, prec, right=0.0) if len(rec) \
        else np.zeros(101)
    tp_out = None
    if abs(dist_th - DIST_TH_TP) < 1e-9:
        tp_out = {}
        is_tp = tp > 0
        tconf = conf[is_tp]
        max_rec = rec[-1] if len(rec) else 0.0
        # The devkit first interpolates confidence onto the recall grid
        # (algo.py accumulate: conf = interp(rec_interp, rec, conf,
        # right=0)), then maps each cum-mean error curve through that
        # confidence against the TP-only confidences. Both interps run on
        # reversed arrays because conf descends and np.interp wants
        # ascending xp.
        conf_at_recall = (np.interp(rec_interp, rec, conf, right=0.0)
                          if len(rec) else np.zeros(101))
        for k, v in errs.items():
            v = np.asarray(v, np.float64)
            if len(v) == 0:
                tp_out[k] = np.full(101, 1.0)
                continue
            cm = _cummean(v)
            tp_out[k] = np.interp(conf_at_recall[::-1], tconf[::-1],
                                  cm[::-1])[::-1]
        tp_out["max_recall_ind"] = int(round(100 * max_rec))
    return prec_i, tp_out, npos


def _calc_ap(prec_i):
    p = prec_i[round(100 * MIN_RECALL) + 1:].copy()
    p -= MIN_PRECISION
    p[p < 0] = 0.0
    return float(np.mean(p)) / (1.0 - MIN_PRECISION)


def _calc_tp(tp_out, key):
    first = round(100 * MIN_RECALL) + 1
    last = tp_out["max_recall_ind"]
    if last < first:
        return 1.0
    return float(np.mean(tp_out[key][first:last + 1]))


def nuscenes_detection_metrics(det_list: List[dict], gt_list: List[dict],
                               classes: Sequence[str]) -> Dict[str, float]:
    """det_list[i]/gt_list[i]: {'boxes' (N, 7|9) lidar storage layout
    (bottom-z, optional vx/vy), 'labels', det also 'scores'}.
    Returns per-class AP, mean TP errors, mAP and NDS."""
    out: Dict[str, float] = {}
    aps = []
    tp_means = {"ate": [], "ase": [], "aoe": [], "ave": [], "aae": []}
    for ci, cls in enumerate(classes):
        dets, gts, attrs = _gather_class(det_list, gt_list, ci)
        cls_aps = []
        with_vel = cls not in NO_VELOCITY
        for th in DIST_THRESHOLDS:
            prec_i, tp_out, npos = _accumulate(dets, gts, cls, th,
                                               with_vel, gt_attrs=attrs)
            if npos == 0:
                continue
            cls_aps.append(_calc_ap(prec_i))
            if tp_out is not None:
                for k in ("ate", "ase", "ave"):
                    if k == "ave" and not with_vel:
                        continue
                    tp_means[k].append(_calc_tp(tp_out, k))
                if cls not in NO_ORIENT:
                    tp_means["aoe"].append(_calc_tp(tp_out, "aoe"))
                if "aae" in tp_out:
                    tp_means["aae"].append(_calc_tp(tp_out, "aae"))
        if cls_aps:
            out[f"{cls}_AP"] = float(np.mean(cls_aps))
            aps.append(out[f"{cls}_AP"])
    out["mAP"] = float(np.mean(aps)) if aps else 0.0
    tp_scores = []
    for k, label in (("ate", "mATE"), ("ase", "mASE"), ("aoe", "mAOE"),
                     ("ave", "mAVE"), ("aae", "mAAE")):
        if tp_means[k]:
            out[label] = float(np.mean(tp_means[k]))
            tp_scores.append(max(1.0 - out[label], 0.0))
    # with attributes recorded this is the official 5+5 denominator
    out["NDS"] = (5.0 * out["mAP"] + sum(tp_scores)) \
        / (5.0 + max(len(tp_scores), 1))
    return out
