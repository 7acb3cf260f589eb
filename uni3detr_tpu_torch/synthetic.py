"""Seeded synthetic scenes and train batches for the port's smoke run,
profiles and tests."""
from __future__ import annotations

import dataclasses
import json
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
    camera's ``lidar2img``, an identity ``uni_rot_aug`` and, with several
    sweeps, ``sweep_times`` (:func:`sweep_times`).

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
        if cfg.num_sweeps > 1:
            batch["sweep_times"] = sweep_times(cfg, 1)
    return batch, rnd


def sweep_times(cfg, batch: int) -> np.ndarray:
    """(batch, num_sweeps) float32: each sweep's time before the key
    frame, 0.05 s apart (a 20 Hz sensor), the key frame's 0."""
    t = np.arange(cfg.num_sweeps, dtype=np.float32) * np.float32(0.05)
    return np.broadcast_to(t, (batch, cfg.num_sweeps)).copy()


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
    camera's ``lidar2img``, an identity ``uni_rot_aug`` and, with several
    sweeps, ``sweep_times``. Only the GT
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
        if cfg.num_sweeps > 1:
            out["sweep_times"] = sweep_times(cfg, batch)
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
                       camera: bool = False, num_points: int = 120000,
                       split: str = "val"):
    """A SUN RGB-D data root on disk (the JAX package's ``datasets.py:87-111``
    layout) for the CLIs: ``sunrgbd_infos_<split>.pkl`` with
    ``point_cloud.pts_path`` and ``annos.gt_boxes_upright_depth`` /
    ``annos.name``, and ``n`` scenes of ``num_points`` float32 points of 6
    channels (``load_dim=6``) from :func:`clustered_scene` with their GT
    boxes (:func:`clustered_scene_gt`); with ``camera`` a uniform random
    PNG of ``cfg.img_size`` a scene and ``calib.K`` / ``calib.Rt`` of the
    synthetic camera. The val split's scenes are seeds 0 .. n-1 under
    ``points/`` and ``image/``; the train split's are seeds
    ``TRAIN_SEED0 + i`` under ``points/train_`` and ``image/train_``, so
    both splits can share a root."""
    disk = dataclasses.replace(cfg, num_points=num_points,
                               in_point_features=6)
    for sub in ("points", "image"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    prefix, seed0 = ("", 0) if split == "val" else ("train_", TRAIN_SEED0)
    infos = []
    for i in range(n):
        name = f"{prefix}{i:06d}"
        pts, _ = clustered_scene(seed0 + i, disk)
        pts[0].tofile(os.path.join(root, f"points/{name}.bin"))
        gt = clustered_scene_gt(seed0 + i, disk)
        info = {"point_cloud": {"pts_path": f"points/{name}.bin"},
                "annos": {"gt_boxes_upright_depth": gt["boxes"],
                          "name": [class_names[c] for c in gt["labels"]]}}
        if camera:
            from PIL import Image
            H, W = cfg.img_size
            img = np.random.RandomState([seed0 + i, 2]).randint(
                0, 256, (H, W, 3))
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(root, f"image/{name}.png"))
            f = CAMERA_FOCAL * W / 640
            info["image"] = {"image_path": f"image/{name}.png",
                             "image_shape": (H, W)}
            info["calib"] = {
                "K": np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                              np.float32),
                "Rt": LIDAR_TO_CAMERA[:3, :3].copy()}
        infos.append(info)
    with open(os.path.join(root, f"sunrgbd_infos_{split}.pkl"), "wb") as f:
        pickle.dump(infos, f)


# the first seed of a written root's train scenes (val: 0 .. n-1)
TRAIN_SEED0 = 10000
# a KITTI car (dx, dy, dz in metres) and the GT database's entries
KITTI_CAR = (3.9, 1.6, 1.56)
KITTI_DB_POINTS = 40


def _kitti_car_boxes(rng, cfg, n):
    """``n`` car-sized boxes (n, 7), bottom-z storage layout, inside the
    x / y range of ``cfg.pc_range`` with a margin of 5 m, z bottom at
    -1.7 m (a KITTI lidar's road height), yaw uniform."""
    lo, hi = np.asarray(cfg.pc_range[:2]), np.asarray(cfg.pc_range[3:5])
    xy = rng.uniform(lo + 5, hi - 5, (n, 2))
    size = np.asarray(KITTI_CAR) * rng.uniform(0.9, 1.1, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xy, np.full((n, 1), -1.7), size, yaw],
                          1).astype(np.float32)


def _points_in_box(rng, box, n, channels):
    """``n`` points uniform inside a storage-layout box, relative to its
    (cx, cy, z bottom), with extra channels uniform in [0, 1)."""
    local = rng.uniform(-0.5, 0.5, (n, 3)) * box[3:6]
    local[:, 2] += 0.5 * box[5]
    c, s = np.cos(box[6]), np.sin(box[6])
    xy = local[:, :2] @ np.array([[c, s], [-s, c]])
    xyz = np.concatenate([xy, local[:, 2:]], 1)
    extra = rng.rand(n, channels - 3)
    return np.concatenate([xyz, extra], 1).astype(np.float32)


def write_kitti_root(root: str, cfg, n_train: int, n_val: int,
                     n_gt: int = 3, n_db: int = 40):
    """A KITTI data root on disk for the CLIs, in the layout the port's
    and the JAX package's ``DetDataset`` read for ``kitti``:
    ``kitti_infos_{train,val}.pkl`` with ``point_cloud.velodyne_path``
    and ``annos.gt_boxes_lidar`` / ``annos.name``, and 4-channel float32
    points under ``points/`` (:func:`clustered_scene`'s uniform scenes of
    ``cfg``, seeds as in :func:`write_sunrgbd_root`), each scene with
    ``n_gt`` cars (:func:`_kitti_car_boxes`) and ``KITTI_DB_POINTS``
    points inside each. Also the GT database of ``ObjectSample``:
    ``kitti_dbinfos_train.pkl``, ``{"Car": [{"path", "box3d_lidar",
    "num_points_in_gt", "difficulty"}, ...]}`` with ``n_db`` cars, each
    object's points under ``gt_database/`` relative to its box's (cx,
    cy, z bottom), as ``ObjectSample`` adds ``box[:3]`` back."""
    C = cfg.in_point_features
    for sub in ("points", "gt_database"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for split, n, seed0 in (("train", n_train, TRAIN_SEED0),
                            ("val", n_val, 0)):
        prefix = "train_" if split == "train" else ""
        infos = []
        for i in range(n):
            name = f"points/{prefix}{i:06d}.bin"
            pts, _ = clustered_scene(seed0 + i, cfg, "uniform")
            rng = np.random.RandomState([seed0 + i, 3])
            boxes = _kitti_car_boxes(rng, cfg, n_gt)
            objs = [_points_in_box(rng, b, KITTI_DB_POINTS, C) + np.r_[
                b[:3], np.zeros(C - 3)].astype(np.float32) for b in boxes]
            np.concatenate([pts[0]] + objs).tofile(os.path.join(root, name))
            infos.append({"point_cloud": {"velodyne_path": name},
                          "annos": {"gt_boxes_lidar": boxes,
                                    "name": ["Car"] * n_gt}})
        with open(os.path.join(root, f"kitti_infos_{split}.pkl"), "wb") as f:
            pickle.dump(infos, f)
    rng = np.random.RandomState(4)
    db = {"Car": []}
    for j, box in enumerate(_kitti_car_boxes(rng, cfg, n_db)):
        path = f"gt_database/{j}_Car_0.bin"
        _points_in_box(rng, box, KITTI_DB_POINTS, C).tofile(
            os.path.join(root, path))
        db["Car"].append({"name": "Car", "path": path, "box3d_lidar": box,
                          "num_points_in_gt": KITTI_DB_POINTS,
                          "difficulty": 0})
    with open(os.path.join(root, "kitti_dbinfos_train.pkl"), "wb") as f:
        pickle.dump(db, f)


# ---------------------------------------------------------------------------
# raw dataset layouts, the converters' inputs
# ---------------------------------------------------------------------------

def _rot(axis: int, angle: float) -> np.ndarray:
    """3x3 rotation by ``angle`` about x (0), y (1) or z (2), fp64."""
    c, s = np.cos(angle), np.sin(angle)
    i, j = [a for a in range(3) if a != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


# KITTI's 7-line calib: the lidar -> camera axes (x_cam = -y, y_cam = -z,
# z_cam = x) turned by a few tenths of a degree about each axis, and a
# rectifying rotation of the same size, as the real calibrations have
KITTI_VELO_AXES = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
                            [1.0, 0.0, 0.0]])
KITTI_TR_TURN = (0.0071, -0.0123, 0.0052)     # about x, y, z, rad
KITTI_TR_SHIFT = (-0.0041, -0.0763, -0.2718)
KITTI_R0_TURN = (0.0093, -0.0058, 0.0035)
KITTI_IMAGE = (375, 1242)                      # H, W
KITTI_FOCAL = 721.5377
KITTI_LIDAR_HEIGHT = 1.73                      # the road at z = -1.73


def kitti_calib():
    """(P2 (3, 4), R0_rect (3, 3), Tr_velo_to_cam (3, 4)) fp64 of the
    written root: non-identity rotations, so a transposed or dropped
    matrix in a converter moves every box."""
    r0 = _rot(0, KITTI_R0_TURN[0]) @ _rot(1, KITTI_R0_TURN[1]) @ _rot(
        2, KITTI_R0_TURN[2])
    turn = _rot(0, KITTI_TR_TURN[0]) @ _rot(1, KITTI_TR_TURN[1]) @ _rot(
        2, KITTI_TR_TURN[2])
    tr = np.concatenate([turn @ KITTI_VELO_AXES,
                         np.asarray(KITTI_TR_SHIFT)[:, None]], 1)
    H, W = KITTI_IMAGE
    p2 = np.array([[KITTI_FOCAL, 0.0, W / 2 + 7.6, 44.86],
                   [0.0, KITTI_FOCAL, H / 2 - 14.2, 0.2164],
                   [0.0, 0.0, 1.0, 0.002746]])
    return p2, r0, tr


def _kitti_scan(rng, boxes, n_points):
    """A 64-beam revolution of ``n_points`` (x, y, z, intensity) float32
    points: beams from +2 to -24.8 degrees hitting the road at
    ``-KITTI_LIDAR_HEIGHT`` (or a far wall), then the returns of each box
    (storage layout, bottom z) placed inside it in place of as many
    road returns."""
    beams = 64
    per_beam = n_points // beams
    elev = np.deg2rad(np.linspace(2.0, -24.8, beams))[:, None]
    az = rng.uniform(-np.pi, np.pi, (beams, per_beam))
    ground = KITTI_LIDAR_HEIGHT / np.maximum(-np.tan(elev), 1e-3)
    r = np.where(elev < -0.02, ground, rng.uniform(30.0, 75.0, az.shape))
    r = np.minimum(r, 75.0) * rng.uniform(0.99, 1.01, az.shape)
    pts = np.stack([r * np.cos(elev) * np.cos(az),
                    r * np.cos(elev) * np.sin(az),
                    r * np.sin(elev) + rng.normal(0, 0.01, az.shape),
                    rng.uniform(0, 1, az.shape)], -1).reshape(-1, 4)
    objs = [_points_in_box(rng, b, int(rng.randint(150, 900)), 4)
            + np.r_[b[:3], 0.0].astype(np.float32) for b in boxes]
    n_obj = sum(len(o) for o in objs)
    keep = rng.permutation(len(pts))[:len(pts) - n_obj]
    return np.concatenate([pts[np.sort(keep)]] + objs).astype(np.float32)


def _kitti_boxes(rng, n):
    """``n`` cars (n, 7) fp64 in the lidar frame, storage layout (bottom
    z on the road), inside the camera's field of view, 5-65 m ahead, no
    two closer than 5 m."""
    boxes = []
    while len(boxes) < n:
        x = rng.uniform(5.0, 65.0)
        y = x * np.tan(rng.uniform(-0.6, 0.6))
        if any(np.hypot(x - b[0], y - b[1]) < 5.0 for b in boxes):
            continue
        size = np.asarray(KITTI_CAR) * rng.uniform(0.9, 1.1, 3)
        boxes.append([x, y, -KITTI_LIDAR_HEIGHT, *size,
                      rng.uniform(-np.pi, np.pi)])
    return np.asarray(boxes)


def _kitti_label_rows(boxes, p2, r0, tr, rng, n_dontcare):
    """KITTI label_2 rows of lidar ``boxes``: type, truncated, occluded,
    alpha, the 2D box (the corners projected through P2 R0 Tr, clipped to
    the image), (h, w, l), the bottom centre in the rectified camera
    frame and rot_y = -yaw - pi/2 (mmdet3d's lidar -> camera box),
    written with 6 decimals; then ``n_dontcare`` DontCare rows."""
    H, W = KITTI_IMAGE
    rt = np.eye(4)
    rt[:3, :3] = r0
    velo2rect = rt @ np.vstack([tr, [0, 0, 0, 1]])
    rows = []
    for b in boxes:
        loc = (velo2rect @ np.r_[b[:3], 1.0])[:3]
        rot_y = (-b[6] - np.pi / 2 + np.pi) % (2 * np.pi) - np.pi
        c, s = np.cos(b[6]), np.sin(b[6])
        hx, hy = b[3] / 2, b[4] / 2
        corners = np.array([[b[0] + c * dx - s * dy, b[1] + s * dx + c * dy,
                             b[2] + dz, 1.0]
                            for dx in (-hx, hx) for dy in (-hy, hy)
                            for dz in (0.0, b[5])])
        uvw = corners @ velo2rect.T @ np.vstack([p2, [0, 0, 0, 1]]).T
        uv = uvw[:, :2] / uvw[:, 2:3]
        x0, y0 = np.clip(uv.min(0), 0, [W - 1, H - 1])
        x1, y1 = np.clip(uv.max(0), 0, [W - 1, H - 1])
        alpha = rot_y - np.arctan2(loc[0], loc[2])
        rows.append(f"Car 0.00 0 {alpha:.6f} {x0:.2f} {y0:.2f} {x1:.2f} "
                    f"{y1:.2f} {b[5]:.6f} {b[4]:.6f} {b[3]:.6f} "
                    f"{loc[0]:.6f} {loc[1]:.6f} {loc[2]:.6f} {rot_y:.6f}")
    for _ in range(n_dontcare):
        x0, y0 = rng.uniform(0, W - 60), rng.uniform(100, H - 30)
        rows.append(f"DontCare -1 -1 -10 {x0:.2f} {y0:.2f} {x0 + 50:.2f} "
                    f"{y0 + 20:.2f} -1 -1 -1 -1000 -1000 -1000 -10")
    return rows


def write_kitti_raw(root: str, n_train: int, n_val: int,
                    n_points: int = 120000, cars=(8, 15)):
    """KITTI's raw layout under ``root`` for ``cli.create_data kitti``:
    ``training/velodyne/<id>.bin`` (``n_points`` float32 x, y, z,
    intensity: one 64-beam revolution, :func:`_kitti_scan`),
    ``training/label_2/<id>.txt`` (``cars`` Cars, an inclusive range, and
    1-3 DontCare rows a scan), ``training/calib/<id>.txt``
    (P0-P3, R0_rect, Tr_velo_to_cam, Tr_imu_to_velo; non-identity
    :func:`kitti_calib`) and ``ImageSets/{train,val}.txt`` (ids 0 ..
    n_train-1, then n_val more). Returns what it planted: {id: {"boxes":
    (n, 7) fp64 lidar storage boxes of the Cars, "dontcare": count}}."""
    for sub in ("velodyne", "label_2", "calib"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    p2, r0, tr = kitti_calib()
    p_other = p2.copy()
    p_other[0, 3] = 0.0
    calib = [("P0", p_other), ("P1", p_other), ("P2", p2), ("P3", p2),
             ("R0_rect", r0), ("Tr_velo_to_cam", tr),
             ("Tr_imu_to_velo", np.concatenate(
                 [_rot(2, 0.0083), [[-0.81], [0.32], [-0.80]]], 1))]
    calib_text = "".join(f"{k}: " + " ".join(f"{v:.12e}" for v in m.ravel())
                         + "\n" for k, m in calib)
    planted = {}
    ids = [f"{i:06d}" for i in range(n_train + n_val)]
    for i, idx in enumerate(ids):
        rng = np.random.RandomState(i)
        boxes = _kitti_boxes(rng, rng.randint(cars[0], cars[1] + 1))
        n_dc = rng.randint(1, 4)
        _kitti_scan(rng, boxes.astype(np.float32), n_points).tofile(
            os.path.join(root, "training", "velodyne", f"{idx}.bin"))
        with open(os.path.join(root, "training", "label_2",
                               f"{idx}.txt"), "w") as f:
            f.write("\n".join(_kitti_label_rows(boxes, p2, r0, tr, rng,
                                                n_dc)) + "\n")
        with open(os.path.join(root, "training", "calib",
                               f"{idx}.txt"), "w") as f:
            f.write(calib_text)
        planted[idx] = {"boxes": boxes, "dontcare": n_dc}
    for split, part in (("train", ids[:n_train]), ("val", ids[n_train:])):
        with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("".join(f"{idx}\n" for idx in part))
    return planted


def _yaw_quat(yaw: float):
    """(w, x, y, z) of a rotation by ``yaw`` about z."""
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _rotmat_quat(r: np.ndarray):
    """(w, x, y, z) of a 3x3 rotation matrix."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s]
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
    q = [0.0] * 4
    q[0] = (r[k, j] - r[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (r[j, i] + r[i, j]) / s
    q[k + 1] = (r[k, i] + r[i, k]) / s
    return [float(v) for v in q]


# nuScenes: the raw categories of the 10 detection classes (through the
# converter's NAME_MAPPING), their (w, l, h) in metres and an attribute
NUSCENES_CATEGORIES = (
    ("vehicle.car", (1.9, 4.6, 1.7), "vehicle.moving"),
    ("vehicle.truck", (2.5, 6.9, 2.8), "vehicle.parked"),
    ("vehicle.construction", (2.8, 6.4, 3.2), "vehicle.stopped"),
    ("vehicle.bus.rigid", (2.9, 11.0, 3.5), "vehicle.moving"),
    ("vehicle.trailer", (2.3, 12.3, 3.9), "vehicle.parked"),
    ("movable_object.barrier", (2.5, 0.5, 1.0), ""),
    ("vehicle.motorcycle", (0.8, 2.1, 1.5), "cycle.with_rider"),
    ("vehicle.bicycle", (0.6, 1.7, 1.3), "cycle.without_rider"),
    ("human.pedestrian.adult", (0.7, 0.7, 1.8), "pedestrian.moving"),
    ("movable_object.trafficcone", (0.4, 0.4, 1.1), ""),
)
NUSCENES_CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
NUSCENES_CAMERA_YAW = (0.0, -0.96, 0.96, np.pi, 1.92, -1.92)
NUSCENES_LIDAR_HZ, NUSCENES_KEY_HZ, NUSCENES_CAMERA_HZ = 20, 2, 12
NUSCENES_LIDAR = ((0.943713, 0.0, 1.84023), -1.5708)   # translation, yaw
NUSCENES_POINTS = 34720


def _nuscenes_ego(t: float, heading0: float, origin):
    """The ego pose at ``t`` s: a 6 m/s drive that turns at 0.05 rad/s
    -> (translation (3,), yaw)."""
    yaw = heading0 + 0.05 * t
    v, w = 6.0, 0.05
    x = origin[0] + v / w * (np.sin(yaw) - np.sin(heading0))
    y = origin[1] - v / w * (np.cos(yaw) - np.cos(heading0))
    return np.array([x, y, 0.0]), yaw


def _nuscenes_sweep_points(rng, boxes_lidar, n):
    """``n`` (x, y, z, intensity, ring) float32 lidar points: road returns
    around the sensor and up to 120 returns inside each box (lidar-frame
    (cx, cy, cz, w, l, h, yaw), centre z) in place of road returns."""
    objs = []
    for b in boxes_lidar:
        m = int(rng.randint(20, 120))
        local = rng.uniform(-0.5, 0.5, (m, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        xy = local[:, :2] @ np.array([[c, s], [-s, c]]) + b[:2]
        objs.append(np.concatenate([xy, local[:, 2:] + b[2],
                                    rng.uniform(0, 1, (m, 1)),
                                    rng.randint(0, 32, (m, 1))], 1))
    n_road = max(n - sum(len(o) for o in objs), 0)
    r = rng.uniform(2.0, 52.0, n_road)
    a = rng.uniform(-np.pi, np.pi, n_road)
    road = np.stack([r * np.cos(a), r * np.sin(a),
                     rng.normal(-1.84, 0.02, n_road),
                     rng.uniform(0, 1, n_road),
                     rng.randint(0, 32, n_road)], 1)
    return np.concatenate([road] + objs)[:n].astype(np.float32)


def write_nuscenes_raw(root: str, n_scenes: int = 2, key_frames: int = 4,
                       anns: int = 40, max_sweeps: int = 10,
                       n_points: int = NUSCENES_POINTS):
    """nuScenes' raw layout under ``root`` for ``cli.create_data
    nuscenes``: the JSON tables under ``root/v1.0-trainval`` (log, scene,
    sensor, calibrated_sensor, ego_pose, sample, sample_data,
    sample_annotation, instance, category, attribute), ``n_scenes``
    scenes of ``key_frames`` key frames at 2 Hz, LIDAR_TOP at 20 Hz from
    ``max_sweeps`` sweeps before the first key frame (``n_points`` float32
    points of 5 values a file, ``samples/`` for key frames and
    ``sweeps/`` between them), 6 cameras at 12 Hz with intrinsics and
    poses (no image files), ``anns`` annotations a key frame over the 10
    classes in instance chains with constant global velocities and
    attributes, every 7th with no lidar and no radar point, and
    ``val_scenes.txt`` naming the last scene. The ego and the lidar
    rotate about z only.

    Returns the truth, by key-frame sample token: {"scene", "boxes" (n,
    7) lidar-frame (cx, cy, cz, l, w, h, yaw), "velocity" (n, 2) in the
    lidar frame, "valid" (n,), "names" and "sweeps": the key frame's
    lidar chain, newest first, as (sample_data token, sensor2lidar
    rotation (3, 3), translation (3,)) computed from the planted poses}.
    """
    tdir = os.path.join(root, "v1.0-trainval")
    for sub in (tdir, os.path.join(root, "samples", "LIDAR_TOP"),
                os.path.join(root, "sweeps", "LIDAR_TOP")):
        os.makedirs(sub, exist_ok=True)
    rng = np.random.RandomState(0)
    t = {k: [] for k in ("log", "scene", "sensor", "calibrated_sensor",
                         "ego_pose", "sample", "sample_data",
                         "sample_annotation", "instance", "category",
                         "attribute")}
    for i, (cat, _, _) in enumerate(NUSCENES_CATEGORIES):
        t["category"].append({"token": f"cat{i}", "name": cat,
                              "description": ""})
    attrs = sorted({a for _, _, a in NUSCENES_CATEGORIES if a})
    for a in attrs:
        t["attribute"].append({"token": f"attr_{a}", "name": a,
                               "description": ""})
    (l_t, l_yaw) = NUSCENES_LIDAR
    t["sensor"].append({"token": "se_lidar", "channel": "LIDAR_TOP",
                        "modality": "lidar"})
    t["calibrated_sensor"].append({
        "token": "cs_lidar", "sensor_token": "se_lidar",
        "translation": list(l_t), "rotation": _yaw_quat(l_yaw),
        "camera_intrinsic": []})
    # camera optics: x_cam = -y_ego, y_cam = -z_ego, z_cam = x_ego, then
    # the mount's yaw about the ego z axis and a 1 degree pitch
    optics = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    for c, (cam, cyaw) in enumerate(zip(NUSCENES_CAMERAS,
                                        NUSCENES_CAMERA_YAW)):
        cam2ego = _rot(2, cyaw) @ _rot(1, 0.0175) @ optics.T
        K = [[1266.4 - 3 * c, 0.0, 816.3 + c], [0.0, 1266.4 - 3 * c, 491.5],
             [0.0, 0.0, 1.0]]
        t["sensor"].append({"token": f"se_{cam}", "channel": cam,
                            "modality": "camera"})
        t["calibrated_sensor"].append({
            "token": f"cs_{cam}", "sensor_token": f"se_{cam}",
            "translation": [1.5 * np.cos(cyaw), 0.5 * np.sin(cyaw), 1.51],
            "rotation": _rotmat_quat(cam2ego), "camera_intrinsic": K})
    R_cs, t_cs = _rot(2, l_yaw), np.asarray(l_t)
    truth = {}
    names_out = []
    dt_key = 1.0 / NUSCENES_KEY_HZ
    for s in range(n_scenes):
        scene = f"scene-{s + 1:04d}"
        names_out.append(scene)
        t0_us = 1_532_402_900_000_000 + s * 100_000_000
        origin = rng.uniform(-400, 400, 2)
        heading0 = rng.uniform(-np.pi, np.pi)
        t["log"].append({"token": f"log{s}", "logfile": "", "vehicle": "n",
                         "date_captured": "", "location": "synthetic"})
        keys = [f"s{s}_{k}" for k in range(key_frames)]
        t["scene"].append({
            "token": f"sc{s}", "name": scene, "log_token": f"log{s}",
            "nbr_samples": key_frames, "first_sample_token": keys[0],
            "last_sample_token": keys[-1], "description": ""})
        # the objects: global start pose, velocity and class, ~anns of them
        ego0, _ = _nuscenes_ego(0.0, heading0, origin)
        obj = []
        for j in range(anns):
            ci = j % len(NUSCENES_CATEGORIES)
            cat, wlh, attr = NUSCENES_CATEGORIES[ci]
            wlh = np.asarray(wlh) * rng.uniform(0.9, 1.1, 3)
            r, a = rng.uniform(6.0, 45.0), rng.uniform(-np.pi, np.pi)
            still = cat.startswith("movable") or attr.endswith("parked")
            # on the road (the ego's z = 0), centre z at half the height
            obj.append(dict(
                ci=ci, wlh=wlh,
                p0=ego0 + np.array([r * np.cos(a), r * np.sin(a),
                                    wlh[2] / 2]),
                v=np.zeros(3) if still else np.r_[rng.uniform(-4, 4, 2), 0],
                yaw=rng.uniform(-np.pi, np.pi), attr=attr,
                empty=(j % 7 == 3)))
            t["instance"].append({
                "token": f"in{s}_{j}", "category_token": f"cat{ci}",
                "nbr_annotations": key_frames,
                "first_annotation_token": f"a{s}_0_{j}",
                "last_annotation_token": f"a{s}_{key_frames - 1}_{j}"})

        def boxes_at(tt, ego_t, ego_yaw):
            """Every object's lidar-frame box at time tt from the ego
            pose: (n, 7) (cx, cy, cz, l, w, h, yaw) and its velocity."""
            R_e = _rot(2, ego_yaw)
            out, vel = [], []
            for o in obj:
                ctr = R_cs.T @ (R_e.T @ (o["p0"] + o["v"] * tt - ego_t)
                                - t_cs)
                yaw = o["yaw"] - ego_yaw - l_yaw
                yaw = (yaw + np.pi) % (2 * np.pi) - np.pi
                out.append([*ctr, o["wlh"][1], o["wlh"][0], o["wlh"][2],
                            yaw])
                vel.append((R_cs.T @ R_e.T @ o["v"])[:2])
            return np.asarray(out), np.asarray(vel)

        # LIDAR_TOP at 20 Hz from max_sweeps sweeps before the first key
        # frame; every 10th reading is a key frame
        per_key = NUSCENES_LIDAR_HZ // NUSCENES_KEY_HZ
        n_lidar = max_sweeps + per_key * (key_frames - 1) + 1
        lidar_tokens, poses = [], {}
        for n in range(n_lidar):
            tt = (n - max_sweeps) / NUSCENES_LIDAR_HZ
            us = t0_us + int(round(tt * 1e6))
            ego_t, ego_yaw = _nuscenes_ego(tt, heading0, origin)
            key = n >= max_sweeps and (n - max_sweeps) % per_key == 0
            k = (n - max_sweeps) // per_key
            tok = f"sd{s}_lidar_{n}"
            sub = "samples" if key else "sweeps"
            fname = f"{sub}/LIDAR_TOP/{scene}__LIDAR_TOP__{us}.pcd.bin"
            t["ego_pose"].append({"token": f"ep_{tok}", "timestamp": us,
                                  "translation": ego_t.tolist(),
                                  "rotation": _yaw_quat(ego_yaw)})
            sample = keys[k] if key else keys[min(max(k + 1, 0),
                                                  key_frames - 1)]
            t["sample_data"].append({
                "token": tok, "sample_token": sample,
                "calibrated_sensor_token": "cs_lidar",
                "ego_pose_token": f"ep_{tok}", "timestamp": us,
                "is_key_frame": bool(key), "filename": fname,
                "fileformat": "pcd", "height": 0, "width": 0,
                "prev": lidar_tokens[-1] if lidar_tokens else "",
                "next": ""})
            if lidar_tokens:
                t["sample_data"][-2]["next"] = tok
            lidar_tokens.append(tok)
            poses[tok] = (ego_t, ego_yaw)
            bl, _ = boxes_at(tt, ego_t, ego_yaw)
            live = [b for b, o in zip(bl, obj) if not o["empty"]]
            _nuscenes_sweep_points(rng, live, n_points).tofile(
                os.path.join(root, fname))
        for k, key in enumerate(keys):
            tt = k * dt_key
            us = t0_us + int(round(tt * 1e6))
            t["sample"].append({
                "token": key, "timestamp": us, "scene_token": f"sc{s}",
                "prev": keys[k - 1] if k else "",
                "next": keys[k + 1] if k + 1 < key_frames else ""})
            ego_t, ego_yaw = _nuscenes_ego(tt, heading0, origin)
            R_ek = _rot(2, ego_yaw)
            boxes, vel = boxes_at(tt, ego_t, ego_yaw)
            valid = []
            for j, o in enumerate(obj):
                n_l = 0 if o["empty"] else int(rng.randint(1, 400))
                n_r = 0 if o["empty"] else int(rng.randint(0, 6))
                valid.append(n_l + n_r > 0)
                t["sample_annotation"].append({
                    "token": f"a{s}_{k}_{j}", "sample_token": key,
                    "instance_token": f"in{s}_{j}",
                    "translation": (o["p0"] + o["v"] * tt).tolist(),
                    "size": o["wlh"].tolist(),
                    "rotation": _yaw_quat(o["yaw"]),
                    "prev": f"a{s}_{k - 1}_{j}" if k else "",
                    "next": f"a{s}_{k + 1}_{j}" if k + 1 < key_frames
                    else "", "num_lidar_pts": n_l, "num_radar_pts": n_r,
                    "visibility_token": "4",
                    "attribute_tokens": [f"attr_{o['attr']}"]
                    if o["attr"] else []})
            key_tok = lidar_tokens[max_sweeps + k * per_key]
            chain = []
            for back in range(1, max_sweeps + 1):
                tok = lidar_tokens[max_sweeps + k * per_key - back]
                sw_t, sw_yaw = poses[tok]
                R_es = _rot(2, sw_yaw)
                rot = R_cs.T @ R_ek.T @ R_es @ R_cs
                trans = R_cs.T @ (R_ek.T @ (R_es @ t_cs + sw_t - ego_t)
                                  - t_cs)
                chain.append((tok, rot, trans))
            truth[key] = {
                "scene": scene, "boxes": boxes, "velocity": vel,
                "valid": np.asarray(valid), "lidar_token": key_tok,
                "names": [NUSCENES_CATEGORIES[o["ci"]][0] for o in obj],
                "sweeps": chain}
        # cameras at 12 Hz over the same span; the reading nearest each
        # key frame is that camera's key frame
        span = (n_lidar - 1) / NUSCENES_LIDAR_HZ
        n_cam = int(span * NUSCENES_CAMERA_HZ) + 1
        for cam in NUSCENES_CAMERAS:
            prev = ""
            key_at = {int(round((max_sweeps / NUSCENES_LIDAR_HZ + k * dt_key)
                                * NUSCENES_CAMERA_HZ)): k
                      for k in range(key_frames)}
            for n in range(n_cam):
                tt = n / NUSCENES_CAMERA_HZ - max_sweeps / NUSCENES_LIDAR_HZ
                us = t0_us + int(round(tt * 1e6))
                ego_t, ego_yaw = _nuscenes_ego(tt, heading0, origin)
                tok = f"sd{s}_{cam}_{n}"
                k = key_at.get(n)
                sub = "samples" if k is not None else "sweeps"
                t["ego_pose"].append({"token": f"ep_{tok}", "timestamp": us,
                                      "translation": ego_t.tolist(),
                                      "rotation": _yaw_quat(ego_yaw)})
                near = min(range(key_frames),
                           key=lambda kk: abs(kk * dt_key - tt))
                t["sample_data"].append({
                    "token": tok, "sample_token": keys[
                        k if k is not None else near],
                    "calibrated_sensor_token": f"cs_{cam}",
                    "ego_pose_token": f"ep_{tok}", "timestamp": us,
                    "is_key_frame": k is not None,
                    "filename": f"{sub}/{cam}/{scene}__{cam}__{us}.jpg",
                    "fileformat": "jpg", "height": 900, "width": 1600,
                    "prev": prev, "next": ""})
                if prev:
                    t["sample_data"][-2]["next"] = tok
                prev = tok
    for name, rows in t.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    with open(os.path.join(root, "val_scenes.txt"), "w") as f:
        f.write(f"{names_out[-1]}\n")
    return truth
