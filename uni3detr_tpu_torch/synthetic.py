"""Seeded synthetic scenes and train batches for the port's smoke run,
profiles and tests."""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

from .config import Uni3DETRConfig


DISTRIBUTIONS = ("clustered", "uniform")


def _blobs(rng, cfg: Uni3DETRConfig, distribution: str = "clustered"):
    """(points (P, C), blob centres (K, 3), per-blob std (K, 3)).

    ``clustered``: the points lie in the blobs. ``uniform``: the same
    blobs are drawn (they place the GT boxes), then the points are
    uniform over ``pc_range``, as the JAX package's bench draws them
    (``bench.py`` ``uniform``): outdoor sweeps sampled to a few
    thousand points leave nearly every voxel isolated, and only such
    scenes grow the strided site sets past their budgets."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(f"distribution {distribution!r} not in "
                         f"{DISTRIBUTIONS}")
    P = cfg.num_points
    lo = np.asarray(cfg.pc_range[:3])
    span = np.asarray(cfg.pc_range[3:]) - lo
    K = 24
    centers = lo + span * (0.1 + 0.8 * rng.rand(K, 3))
    assign = rng.randint(0, K, P)
    offs = rng.randn(P, 3) * span * 0.02
    squash = 1.0 - 0.95 * np.eye(3)[rng.randint(0, 3, K)]
    if distribution == "uniform":
        xyz = lo + span * rng.rand(P, 3)
    else:
        xyz = centers[assign] + offs * squash[assign]
    xyz = np.clip(xyz, lo + 1e-4, lo + span - 1e-3)
    extra = rng.rand(P, cfg.in_point_features - 3)
    pts = np.concatenate([xyz, extra], -1).astype(np.float32)
    return pts, centers, span * 0.02 * squash


def clustered_scene(seed: int, cfg: Uni3DETRConfig,
                    distribution: str = "clustered"):
    """One scene of ``cfg.num_points`` points shaped like a real scan: 24
    tight Gaussian blobs inside ``pc_range``, each squashed along one
    random axis into a planar patch (or, with ``distribution="uniform"``,
    points uniform over the range); extra channels uniform in [0, 1).

    Returns (points (1, P, C) float32, random query points (1, nq, 3)).
    """
    rng = np.random.RandomState(seed)
    pts, _, _ = _blobs(rng, cfg, distribution)
    rnd = rng.rand(1, cfg.num_query, 3).astype(np.float32)
    return pts[None], rnd


def _gt_boxes(rng, centers, std, cfg: Uni3DETRConfig):
    """One box around each of the first ``min(24, 3 * max_gt // 4)``
    blobs: (boxes (n, 7|9) float32, bottom-z storage layout; labels (n,)
    int32 cycling over the classes)."""
    n_gt = min(24, max(1, 3 * cfg.max_gt // 4))
    size = np.maximum(4.0 * std[:n_gt], 0.05)
    bottom = centers[:n_gt, 2] - size[:, 2] / 2
    cols = [centers[:n_gt, :2], bottom[:, None], size, np.zeros((n_gt, 1))]
    if cfg.code_size > 8:
        cols.append(rng.uniform(-2, 2, (n_gt, 2)))
    return (np.concatenate(cols, -1).astype(np.float32),
            (np.arange(n_gt) % cfg.num_classes).astype(np.int32))


def clustered_scene_gt(seed: int, cfg: Uni3DETRConfig,
                       distribution: str = "clustered"):
    """The GT of ``clustered_scene(seed, cfg, distribution)``: its blobs'
    boxes as :func:`clustered_train_batch` draws them, as a dict of
    'boxes' (n, 7|9) and 'labels' (n,)."""
    rng = np.random.RandomState(seed)
    _, centers, std = _blobs(rng, cfg, distribution)
    boxes, labels = _gt_boxes(rng, centers, std, cfg)
    return {"boxes": boxes, "labels": labels}


def clustered_train_batch(seed: int, cfg: Uni3DETRConfig, batch: int,
                          distribution: str = "clustered"):
    """``batch`` clustered scenes with one GT box around each of the
    first ``min(24, 3 * max_gt // 4)`` blobs (centre on the blob, sides
    4 standard deviations, yaw 0, labels cycling over the classes),
    padded to ``max_gt`` rows with ``gt_mask``.

    With ``code_size > 8`` the boxes carry velocity (vx, vy) drawn from
    ``uniform(-2, 2)``, as the JAX package's train bench draws it. With
    ``distribution="uniform"`` the points are uniform over the range and
    the boxes stay on the blobs' centres (see :func:`_blobs`).

    Returns numpy arrays in the layout of the JAX ``make_train_step``:
    points (B, P, C) float32, pts_mask (B, P), gt_boxes (B, G, 7|9)
    float32 with the bottom-z storage centre, gt_labels (B, G) int32,
    gt_mask (B, G)."""
    G = cfg.max_gt
    box_dim = 9 if cfg.code_size > 8 else 7
    pts, boxes = [], np.zeros((batch, G, box_dim), np.float32)
    labels = np.zeros((batch, G), np.int32)
    gmask = np.zeros((batch, G), bool)
    for b in range(batch):
        rng = np.random.RandomState([seed, b])
        p, centers, std = _blobs(rng, cfg, distribution)
        pts.append(p)
        gb, gl = _gt_boxes(rng, centers, std, cfg)
        boxes[b, :len(gb)] = gb
        labels[b, :len(gb)] = gl
        gmask[b, :len(gb)] = True
    pts = np.stack(pts)
    return {"points": pts, "pts_mask": np.ones(pts.shape[:2], bool),
            "gt_boxes": boxes, "gt_labels": labels, "gt_mask": gmask}


# the synthetic camera: SUN RGB-D's depth coordinates put the camera at
# the origin looking along +y with z up, so camera x = x, camera y (image
# rows, down) = -z and the depth is y; fx = fy = 520 at 640 pixels wide
# (SUN RGB-D's Kinect intrinsics are ~518-529), scaled with the width,
# the principal point at the image centre
CAMERA_FOCAL = 520.0
LIDAR_TO_CAMERA = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                            [0, 0, 0, 1]], np.float32)


def lidar2img(img_size) -> np.ndarray:
    """(4, 4) projection of the synthetic camera for an (H, W) image."""
    H, W = img_size
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = CAMERA_FOCAL * W / 640
    K[0, 2], K[1, 2] = W / 2, H / 2
    return K @ LIDAR_TO_CAMERA


def ov_scene(seed: int, cfg, distribution: str = "clustered"):
    """One OV input batch (B=1) as numpy, with the keys the OV model
    reads: the points of ``clustered_scene(seed, cfg, distribution)``
    (``cfg.use_lidar``) and, with ``cfg.use_camera``, a uniform [0, 1)
    RGB image of ``cfg.img_size`` per camera and sweep, the synthetic
    camera's ``lidar2img`` and an identity ``uni_rot_aug``.

    Returns (batch dict, random query points (1, nq, 3))."""
    pts, rnd = clustered_scene(seed, cfg, distribution)
    batch = {}
    if cfg.use_lidar:
        batch["points"] = pts
        batch["pts_mask"] = np.ones(pts.shape[:2], bool)
    if cfg.use_camera:
        rng = np.random.RandomState([seed, 1])
        N = cfg.num_cams * cfg.num_sweeps
        H, W = cfg.img_size
        batch["images"] = rng.rand(1, N, H, W, 3).astype(np.float32)
        batch["lidar2img"] = np.broadcast_to(
            lidar2img(cfg.img_size), (1, N, 4, 4)).copy()
        batch["uni_rot_aug"] = np.eye(3, dtype=np.float32)[None]
    return batch, rnd


def in_camera_frame(points, l2i, img_size) -> np.ndarray:
    """(..., 3) world points -> (...,) bool: in front of the camera of the
    (4, 4) projection ``l2i`` and inside its (H, W) frame."""
    hom = np.concatenate([points, np.ones_like(points[..., :1])], -1)
    cam = hom @ l2i.T
    depth = cam[..., 2]
    uv = cam[..., :2] / np.maximum(depth, 1e-5)[..., None]
    H, W = img_size
    return (depth > 1e-5) & (uv[..., 0] >= 0) & (uv[..., 0] < W) \
        & (uv[..., 1] >= 0) & (uv[..., 1] < H)


def ov_train_batch(seed: int, cfg, batch: int):
    """An OV train batch as numpy, in the layout of the JAX
    ``make_train_step`` for OV: the scenes and GT boxes of
    ``clustered_train_batch(seed, cfg, batch)`` (the points with
    ``cfg.use_lidar``) and, with ``cfg.use_camera``, a uniform [0, 1) RGB
    image of ``cfg.img_size`` per camera and sweep, the synthetic
    camera's ``lidar2img`` and an identity ``uni_rot_aug``. Only the GT
    boxes whose gravity centre the camera sees (in front of it, inside
    its frame) are kept, packed to the front of their ``max_gt`` rows.

    Returns (batch dict, the share of the scenes' GT boxes kept)."""
    base = clustered_train_batch(seed, cfg, batch)
    l2i = lidar2img(cfg.img_size)
    out = {}
    if cfg.use_lidar:
        out["points"], out["pts_mask"] = base["points"], base["pts_mask"]
    if cfg.use_camera:
        rng = np.random.RandomState([seed, batch, 1])
        N = cfg.num_cams * cfg.num_sweeps
        H, W = cfg.img_size
        out["images"] = rng.rand(batch, N, H, W, 3).astype(np.float32)
        out["lidar2img"] = np.broadcast_to(l2i, (batch, N, 4, 4)).copy()
        out["uni_rot_aug"] = np.broadcast_to(
            np.eye(3, dtype=np.float32), (batch, 3, 3)).copy()
    boxes, labels, gmask = base["gt_boxes"], base["gt_labels"], \
        base["gt_mask"]
    centre = boxes[..., :3].copy()          # bottom -> gravity centre
    centre[..., 2] += boxes[..., 5] / 2
    seen = gmask & in_camera_frame(centre, l2i, cfg.img_size)
    out["gt_boxes"] = np.zeros_like(boxes)
    out["gt_labels"] = np.zeros_like(labels)
    out["gt_mask"] = np.zeros_like(gmask)
    for b in range(batch):
        n = int(seen[b].sum())
        out["gt_boxes"][b, :n] = boxes[b, seen[b]]
        out["gt_labels"][b, :n] = labels[b, seen[b]]
        out["gt_mask"][b, :n] = True
    return out, float(seen.sum()) / max(int(gmask.sum()), 1)


def write_sunrgbd_root(root: str, cfg, class_names, n: int,
                       camera: bool = False, num_points: int = 120000):
    """A SUN RGB-D data root on disk (the JAX package's ``datasets.py:87-111``
    layout) for ``cli.test``: ``sunrgbd_infos_val.pkl`` with
    ``point_cloud.pts_path`` and ``annos.gt_boxes_upright_depth`` /
    ``annos.name``, and ``n`` scenes of ``num_points`` float32 points of 6
    channels (``load_dim=6``) from :func:`clustered_scene` with their GT
    boxes (:func:`clustered_scene_gt`); with ``camera`` a uniform random
    PNG of ``cfg.img_size`` a scene and ``calib.K`` / ``calib.Rt`` of the
    synthetic camera."""
    disk = dataclasses.replace(cfg, num_points=num_points,
                               in_point_features=6)
    for sub in ("points", "image"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    infos = []
    for i in range(n):
        pts, _ = clustered_scene(i, disk)
        pts[0].tofile(os.path.join(root, f"points/{i:06d}.bin"))
        gt = clustered_scene_gt(i, disk)
        info = {"point_cloud": {"pts_path": f"points/{i:06d}.bin"},
                "annos": {"gt_boxes_upright_depth": gt["boxes"],
                          "name": [class_names[c] for c in gt["labels"]]}}
        if camera:
            from PIL import Image
            H, W = cfg.img_size
            img = np.random.RandomState([i, 2]).randint(0, 256, (H, W, 3))
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(root, f"image/{i:06d}.png"))
            f = CAMERA_FOCAL * W / 640
            info["image"] = {"image_path": f"image/{i:06d}.png",
                             "image_shape": (H, W)}
            info["calib"] = {
                "K": np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                              np.float32),
                "Rt": LIDAR_TO_CAMERA[:3, :3].copy()}
        infos.append(info)
    with open(os.path.join(root, "sunrgbd_infos_val.pkl"), "wb") as f:
        pickle.dump(infos, f)
