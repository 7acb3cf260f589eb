"""Qualitative BEV result pictures (host-side, matplotlib Agg; copy of
``uni3detr_tpu/utils/visualize.py``).

The role of the reference's ``test.py --show-dir``: one PNG a scene, the
point cloud from above with the GT boxes (green) and the detections
above ``score_thr`` (red, score annotated). Plain numpy corner math.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def bev_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 7+) storage-layout boxes -> (N, 4, 2) BEV corner loops.

    Storage layout (x, y, z_bottom, dx, dy, dz, yaw) — geom/boxes.py.
    """
    boxes = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1])
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    base = np.array([[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5]],
                    np.float32)
    local = base[None] * np.stack([dx, dy], -1)[:, None]        # (N,4,2)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s], -1),
                    np.stack([s, c], -1)], -2)                  # (N,2,2)
    pts = np.einsum("nij,nkj->nki", rot, local)
    return pts + np.stack([x, y], -1)[:, None]


def save_bev(points: np.ndarray, gt_boxes: Optional[np.ndarray],
             det: Optional[dict], path: str, *,
             score_thr: float = 0.3, class_names=None,
             title: Optional[str] = None, max_points: int = 60000):
    """Write one BEV PNG: points (P, >=2), optional GT boxes (G, 7+),
    optional det dict {'boxes','scores','labels'}."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10), dpi=110)
    pts = np.asarray(points)
    if len(pts) > max_points:
        pts = pts[np.random.RandomState(0).choice(len(pts), max_points,
                                                  replace=False)]
    z = pts[:, 2] if pts.shape[1] > 2 else None
    ax.scatter(pts[:, 0], pts[:, 1], s=0.3, c=z, cmap="viridis",
               linewidths=0, rasterized=True)

    def draw(boxes, color, labels=None, scores=None):
        for i, loop in enumerate(bev_corners(boxes)):
            loop = np.concatenate([loop, loop[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=1.2)
            if scores is not None:
                name = (class_names[int(labels[i])]
                        if class_names is not None and labels is not None
                        else "")
                ax.annotate(f"{name} {scores[i]:.2f}".strip(),
                            loop[0], color=color, fontsize=6)

    if gt_boxes is not None and len(gt_boxes):
        draw(np.asarray(gt_boxes), "limegreen")
    if det is not None and len(det.get("boxes", ())):
        keep = np.asarray(det["scores"]) >= score_thr
        if keep.any():
            draw(np.asarray(det["boxes"])[keep], "red",
                 labels=np.asarray(det["labels"])[keep],
                 scores=np.asarray(det["scores"])[keep])
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_results_bev(dataset, dets, out_dir: str, *,
                     score_thr: float = 0.3, class_names=None,
                     log=print):
    """One PNG per evaluated sample (reference --show-dir role)."""
    for i, det in enumerate(dets):
        sample = dataset[i]
        name = sample.get("meta", {}).get("sample_idx", i)
        save_bev(sample["points"], sample.get("gt_boxes"), det,
                 os.path.join(out_dir, f"{name}_bev.png"),
                 score_thr=score_thr, class_names=class_names,
                 title=str(name))
    if log:
        log(f"wrote {len(dets)} BEV visualizations under {out_dir}")
