"""KITTI results writer: detections -> official label-format txt files
(copy of ``uni3detr_tpu/data/eval/kitti_submission.py``).

The reference inherits this from mmdet3d's ``KittiDataset.format_results``
(used by ``--format-only``/server submission): one ``<frame_id>.txt`` per
frame with lines

    type trunc occ alpha x1 y1 x2 y2 h w l x_cam y_cam z_cam ry score

Detections arrive in lidar storage layout (cx, cy, cz_bottom, dx, dy,
dz, yaw); the camera-frame fields reuse the same calib chain as the
evaluator (kitti_eval.py::project_boxes_to_image / lidar_alpha).
Location is the CAMERA-frame BOTTOM-center of the box (KITTI labels
anchor y at the box bottom in cam coords, which is the larger y since
the cam y axis points down).
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from .kitti_eval import project_boxes_to_image, lidar_alpha


def kitti_result_lines(det: Dict, calib: Dict, classes: Sequence[str],
                       image_shape=None) -> List[str]:
    """One detection dict -> list of label lines (sorted as given)."""
    boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 7)
    labels = np.asarray(det["labels"], np.int64).reshape(-1)
    scores = np.asarray(det["scores"], np.float64).reshape(-1)
    if not len(boxes):
        return []
    bbox2d = project_boxes_to_image(boxes, calib, image_shape)
    alpha = lidar_alpha(boxes, calib)
    R0 = np.asarray(calib["R0_rect"], np.float64)
    Tr = np.asarray(calib["Tr_velo_to_cam"], np.float64)
    # bottom-center in lidar coords is the storage center (z is bottom)
    hom = np.concatenate([boxes[:, :3], np.ones((len(boxes), 1))], 1)
    cam = hom @ (R0 @ Tr).T  # (N, 4) camera-frame bottom center
    ry = -boxes[:, 6] - np.pi / 2
    lines = []
    for i in range(len(boxes)):
        # dims: official order is h, w, l = dz, dy, dx
        dx, dy, dz = boxes[i, 3:6]
        lines.append(
            f"{classes[labels[i]]} 0.00 0 {alpha[i]:.2f} "
            f"{bbox2d[i, 0]:.2f} {bbox2d[i, 1]:.2f} "
            f"{bbox2d[i, 2]:.2f} {bbox2d[i, 3]:.2f} "
            f"{dz:.2f} {dy:.2f} {dx:.2f} "
            f"{cam[i, 0]:.2f} {cam[i, 1]:.2f} {cam[i, 2]:.2f} "
            f"{ry[i]:.2f} {scores[i]:.4f}")
    return lines


def write_kitti_results(dets: List[Dict], infos: List[Dict],
                        classes: Sequence[str], out_dir: str) -> int:
    """Write one txt per frame under ``out_dir``; returns frames written.

    ``infos`` are the val-split info records (frame id under
    ``image.image_idx`` or ``sample_idx``, calib under ``calib``).
    """
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for det, info in zip(dets, infos):
        img = info.get("image", {})
        idx = img.get("image_idx", info.get("sample_idx", n))
        shape = img.get("image_shape")
        lines = kitti_result_lines(det, info["calib"], classes,
                                   image_shape=shape)
        with open(os.path.join(out_dir, f"{int(idx):06d}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        n += 1
    return n
