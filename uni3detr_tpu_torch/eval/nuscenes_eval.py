"""nuScenes evaluation adapter (copy of
``uni3detr_tpu/data/eval/nuscenes_eval.py``).

Capability parity with the reference NuScenesSweepDataset evaluation
(datasets/nuscenes_dataset.py:408-535): format detections into the
official submission JSON (global frame via the info's ego/sensor poses)
and, when the nuscenes-devkit is available, run the official NuScenesEval
for mAP/NDS. The devkit is not in this image, so the official leg is
gated; the JSON writer is always functional.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

DEFAULT_ATTR = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "construction_vehicle": "vehicle.parked", "bus": "vehicle.stopped",
    "trailer": "vehicle.parked", "barrier": "",
    "motorcycle": "cycle.without_rider", "bicycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing", "traffic_cone": "",
}


def _yaw_to_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _rot_mat(q):
    """quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def format_results(det_list: List[dict], infos: Sequence[dict],
                   classes: Sequence[str], out_path: str,
                   score_thr: float = 0.0) -> str:
    """det_list[i]: {'boxes' (D, 9) lidar storage layout with velocity,
    'labels', 'scores'}; infos: the matching nuscenes info records.
    Writes the submission JSON and returns its path."""
    results: Dict[str, list] = {}
    for det, info in zip(det_list, infos):
        token = info["token"]
        l2e_r = _rot_mat(np.asarray(info["lidar2ego_rotation"]))
        l2e_t = np.asarray(info["lidar2ego_translation"])
        e2g_r = _rot_mat(np.asarray(info["ego2global_rotation"]))
        e2g_t = np.asarray(info["ego2global_translation"])
        anns = []
        for b, lab, sc in zip(det["boxes"], det["labels"], det["scores"]):
            if sc < score_thr:
                continue
            center = np.asarray(b[:3], np.float64)
            center[2] += b[5] / 2  # bottom -> gravity center (nusc boxes)
            center = e2g_r @ (l2e_r @ center + l2e_t) + e2g_t
            yaw = float(b[6])
            # rotate yaw into global frame (z rotations compose)
            dyaw = np.arctan2(l2e_r[1, 0], l2e_r[0, 0]) \
                + np.arctan2(e2g_r[1, 0], e2g_r[0, 0])
            vel = np.asarray([b[7], b[8], 0.0]) if len(b) > 8 \
                else np.zeros(3)
            vel = e2g_r @ (l2e_r @ vel)
            name = classes[int(lab)]
            anns.append({
                "sample_token": token,
                "translation": center.tolist(),
                "size": [float(b[4]), float(b[3]), float(b[5])],  # w, l, h
                "rotation": _yaw_to_quat(yaw + dyaw),
                "velocity": vel[:2].tolist(),
                "detection_name": name,
                "detection_score": float(sc),
                "attribute_name": DEFAULT_ATTR.get(name, ""),
            })
        results[token] = anns
    sub = {"meta": {"use_camera": False, "use_lidar": True,
                    "use_radar": False, "use_map": False,
                    "use_external": False},
           "results": results}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(sub, f)
    return out_path


def nuscenes_official_eval(result_json, data_root, version, eval_set):
    """Run the official NuScenesEval (requires nuscenes-devkit)."""
    try:
        from nuscenes import NuScenes
        from nuscenes.eval.detection.evaluate import NuScenesEval
        from nuscenes.eval.detection.config import config_factory
    except ImportError:
        raise RuntimeError(
            "nuscenes-devkit is not installed in this environment; the "
            "submission JSON at {} can be evaluated offline with the "
            "official devkit.".format(result_json))
    nusc = NuScenes(version=version, dataroot=data_root, verbose=False)
    ev = NuScenesEval(nusc, config=config_factory("detection_cvpr_2019"),
                      result_path=result_json, eval_set=eval_set,
                      output_dir=os.path.dirname(result_json),
                      verbose=False)
    metrics = ev.main(render_curves=False)
    return metrics
