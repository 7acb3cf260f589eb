"""Host-side (numpy) data pipeline: the train- and test-time transforms
(jax-free copy of ``uni3detr_tpu/data/pipeline.py``).

Samples are plain dicts: points (P, C) float32, xyz first; gt_boxes (G,
7|9) storage layout (bottom z); gt_labels (G,) int32; uni_rot_aug (3,
3); meta dict. Every transform takes (sample, rng: np.random.Generator),
mutates the dict and draws from ``rng`` in the JAX package's order, so a
dataset seeded alike gives equal arrays. The box-yaw flip and rotation
conventions follow mmdet3d >= 1.0.

Point clouds: ``RandomFlip3D`` / ``UnifiedRandomFlip3D``,
``GlobalRotScaleTrans`` / ``UnifiedRotScaleTrans`` (accumulating
``uni_rot_aug``, which the camera branch inverts), ``GlobalAlignment``
(ScanNet), ``PointsRangeFilter``, ``ObjectRangeFilter``,
``ObjectNameFilter``, ``PointShuffle``, ``PointSample``, ``ObjectNoise``
and ``ObjectSample`` / ``UnifiedObjectSample`` (the GT-database paste;
both on the C++ box ops of ``native``), ``LoadPointsFromMultiSweeps``
(nuScenes). Images: the loaders (``LoadImageFromFile`` and its
multi-view names), ``NormalizeImage``, ``PadImage``, ``ResizeImage``,
``ImageRandomResizeCropFlip``, ``PhotoMetricDistortion`` and
``GridMask``. :func:`build_pipeline` raises a KeyError naming a
transform it does not know.
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Callable, Dict, Sequence

import numpy as np

from . import box_np_ops

TRANSFORMS: Dict[str, Callable] = {}


def register(name):
    def deco(cls):
        TRANSFORMS[name] = cls
        return cls
    return deco


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
            if sample is None:
                return None
        return sample


def build_pipeline(cfgs: Sequence[dict], ctx: dict) -> Compose:
    """cfgs: list of dict(type=..., **kwargs); ctx supplies dataset-level
    values (pc_range, class_names, data_root, box_type)."""
    out = []
    for c in cfgs:
        c = dict(c)
        t = c.pop("type")
        if t not in TRANSFORMS:
            raise KeyError(f"unknown pipeline transform {t!r}")
        out.append(TRANSFORMS[t](ctx=ctx, **c))
    return Compose(out)


def _rot_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return points @ rot.T, rot


@register("RandomFlip3D")
@register("UnifiedRandomFlip3D")
class RandomFlip3D:
    """BEV flips. For Depth boxes horizontal flips x (yaw -> pi - yaw);
    for LiDAR boxes horizontal flips y (yaw -> -yaw); vertical is the
    other axis. Accumulates uni_rot_aug (transform_3d.py:575-579)."""

    def __init__(self, ctx, flip_ratio_bev_horizontal=0.0,
                 flip_ratio_bev_vertical=0.0):
        self.ph = flip_ratio_bev_horizontal
        self.pv = flip_ratio_bev_vertical
        self.box_type = ctx.get("box_type", "Depth")

    def _flip_axis(self, sample, axis):
        pts = sample["points"]
        pts[:, axis] = -pts[:, axis]
        boxes = sample.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes[:, axis] = -boxes[:, axis]
            if axis == 0:
                boxes[:, 6] = np.pi - boxes[:, 6]
            else:
                boxes[:, 6] = -boxes[:, 6]
            if boxes.shape[1] > 7:
                boxes[:, 7 + axis] = -boxes[:, 7 + axis]
        refl = np.eye(3, dtype=np.float32)
        refl[axis, axis] = -1
        sample["uni_rot_aug"] = refl @ sample.get(
            "uni_rot_aug", np.eye(3, dtype=np.float32))

    def __call__(self, sample, rng):
        h_axis = 0 if self.box_type == "Depth" else 1
        if rng.random() < self.ph:
            self._flip_axis(sample, h_axis)
        if rng.random() < self.pv:
            self._flip_axis(sample, 1 - h_axis)
        return sample


@register("GlobalRotScaleTrans")
@register("UnifiedRotScaleTrans")
class GlobalRotScaleTrans:
    """Rotate around z, isotropic scale, optional translation; box yaw +=
    angle, velocities rotate, shift-height feature scales
    (transform_3d.py:325-482 semantics)."""

    def __init__(self, ctx, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05), translation_std=(0, 0, 0),
                 shift_height=False):
        self.rot_range = rot_range
        self.scale_range = scale_ratio_range
        self.tstd = np.asarray(translation_std, np.float32)
        self.shift_height = shift_height

    def __call__(self, sample, rng):
        angle = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_range)
        trans = rng.standard_normal(3).astype(np.float32) * self.tstd

        pts = sample["points"]
        xyz, rot = _rot_z(pts[:, :3], angle)
        pts[:, :3] = xyz * scale + trans
        if self.shift_height and pts.shape[1] > 3:
            pts[:, 3] *= scale
        sample["points"] = pts

        boxes = sample.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes[:, :3] = boxes[:, :3] @ rot.T * scale + trans
            boxes[:, 3:6] *= scale
            boxes[:, 6] += angle
            if boxes.shape[1] > 7:
                boxes[:, 7:9] = boxes[:, 7:9] @ rot[:2, :2].T * scale
        sample["uni_rot_aug"] = rot @ sample.get(
            "uni_rot_aug", np.eye(3, dtype=np.float32))
        sample.setdefault("meta", {})["pcd_scale_factor"] = scale
        return sample


@register("GlobalAlignment")
class GlobalAlignment:
    """Apply the scan's axis_align_matrix (ScanNet)."""

    def __init__(self, ctx, rotation_axis=2):
        self.rotation_axis = rotation_axis

    def __call__(self, sample, rng):
        mat = sample.get("meta", {}).get("axis_align_matrix")
        if mat is None:
            return sample
        pts = sample["points"]
        xyz1 = np.concatenate(
            [pts[:, :3], np.ones((len(pts), 1), np.float32)], 1)
        pts[:, :3] = (xyz1 @ mat.T)[:, :3]
        return sample


@register("PointsRangeFilter")
class PointsRangeFilter:
    def __init__(self, ctx, point_cloud_range=None):
        self.rng_ = np.asarray(point_cloud_range or ctx["pc_range"],
                               np.float32)

    def __call__(self, sample, rng):
        pts = sample["points"]
        m = np.all(pts[:, :3] >= self.rng_[:3], -1) \
            & np.all(pts[:, :3] <= self.rng_[3:6], -1)
        sample["points"] = pts[m]
        return sample


@register("ObjectRangeFilter")
class ObjectRangeFilter:
    def __init__(self, ctx, point_cloud_range=None):
        self.rng_ = np.asarray(point_cloud_range or ctx["pc_range"],
                               np.float32)

    def __call__(self, sample, rng):
        boxes = sample.get("gt_boxes")
        if boxes is None or not len(boxes):
            return sample
        m = np.all(boxes[:, :2] >= self.rng_[:2], -1) \
            & np.all(boxes[:, :2] <= self.rng_[3:5], -1)
        sample["gt_boxes"] = boxes[m]
        sample["gt_labels"] = sample["gt_labels"][m]
        sample["gt_boxes"][:, 6] = box_np_ops.limit_period(
            sample["gt_boxes"][:, 6], 0.5, 2 * np.pi)
        return sample


@register("ObjectNameFilter")
class ObjectNameFilter:
    """Keep GT boxes whose class name is in ``classes`` (mmdet3d
    ObjectNameFilter; reference KITTI pipelines). Labels here are
    already indices into the config's class_names — the loader maps
    names at parse time — so ``classes`` is translated to the set of
    matching label indices (membership by NAME, not index range: the
    kept subset need not be a prefix of class_names)."""

    def __init__(self, ctx, classes=None):
        names = tuple(ctx.get("class_names", ()))
        if classes is None:
            keep = set(range(len(names)))
        else:
            keep = {names.index(c) for c in classes if c in names}
        self.keep = np.array(sorted(keep), np.int64)

    def __call__(self, sample, rng):
        labels = sample.get("gt_labels")
        if labels is None or not len(labels):
            return sample
        m = np.isin(labels, self.keep)
        sample["gt_boxes"] = sample["gt_boxes"][m]
        sample["gt_labels"] = labels[m]
        return sample


@register("PointShuffle")
class PointShuffle:
    def __init__(self, ctx):
        pass

    def __call__(self, sample, rng):
        sample["points"] = sample["points"][
            rng.permutation(len(sample["points"]))]
        return sample


@register("PointSample")
class PointSample:
    def __init__(self, ctx, num_points):
        self.n = num_points

    def __call__(self, sample, rng):
        pts = sample["points"]
        if len(pts) > self.n:
            idx = rng.choice(len(pts), self.n, replace=False)
            sample["points"] = pts[idx]
        return sample


@register("ObjectNoise")
class ObjectNoise:
    """Per-GT-box random perturbation with BEV collision rejection
    (mmdet3d ObjectNoise role; KITTI configs)."""

    def __init__(self, ctx, num_try=100, translation_std=(1.0, 1.0, 0.5),
                 global_rot_range=(0.0, 0.0),
                 rot_range=(-0.785398, 0.785398)):
        self.num_try = num_try
        self.tstd = np.asarray(translation_std, np.float32)
        self.rot_range = rot_range
        if tuple(global_rot_range) != (0.0, 0.0):
            # every shipped reference config disables it
            # (uni3detr_kitti_car.py ObjectNoise global_rot_range=[0,0])
            raise NotImplementedError(
                "ObjectNoise global_rot_range is not supported")

    def __call__(self, sample, rng):
        boxes = sample.get("gt_boxes")
        if boxes is None or not len(boxes):
            return sample
        # draw all trials up front so the native and numpy rejection
        # loops consume identical randomness (box_np_ops.object_noise_)
        G, T = len(boxes), self.num_try
        trans = rng.standard_normal((G, T, 3)).astype(np.float32) \
            * self.tstd
        rots = rng.uniform(self.rot_range[0], self.rot_range[1],
                           (G, T)).astype(np.float32)
        pts = np.ascontiguousarray(sample["points"], np.float32)
        boxes = np.ascontiguousarray(boxes, np.float32)
        box_np_ops.object_noise_(pts, boxes, trans, rots)
        sample["points"] = pts
        sample["gt_boxes"] = boxes
        return sample


@register("LoadPointsFromMultiSweeps")
class LoadPointsFromMultiSweeps:
    """Merge up to sweeps_num previous lidar sweeps with a time-lag
    channel (nuScenes info schema).

    The raw 5th channel (``time_dim``) is overwritten: zeroed on the
    keyframe, set to ``key_ts - sweep_ts`` (seconds) on each sweep, so the
    shipped use_dim=[0,1,2,3,4] configs give 5-feature points. When the
    loader kept fewer channels than ``time_dim + 1`` the lag is appended
    as a new channel instead.
    """

    def __init__(self, ctx, sweeps_num=10, load_dim=5, use_dim=None,
                 pad_empty_sweeps=True, remove_close=1.0, time_dim=4):
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = None if use_dim is None else list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.time_dim = time_dim

    def _load(self, path):
        return np.fromfile(path, np.float32).reshape(-1, self.load_dim)

    def __call__(self, sample, rng):
        pts = sample["points"]
        overwrite = pts.shape[1] > self.time_dim
        if overwrite:
            base = pts.copy()
            base[:, self.time_dim] = 0.0
        else:
            base = np.concatenate(
                [pts, np.zeros((len(pts), 1), np.float32)], 1)
        sweeps = sample.get("meta", {}).get("sweeps", [])
        out = [base]
        if not sweeps and self.pad_empty_sweeps:
            for _ in range(self.sweeps_num):
                m = np.linalg.norm(base[:, :2], axis=1) > self.remove_close
                out.append(base[m])
        else:
            chosen = sweeps[:self.sweeps_num] if len(sweeps) \
                <= self.sweeps_num else [
                    sweeps[i] for i in rng.choice(len(sweeps),
                                                  self.sweeps_num,
                                                  replace=False)]
            for sw in chosen:
                use = self.use_dim if self.use_dim is not None \
                    else list(range(self.load_dim))
                p = self._load(sw["data_path"])[:, use]
                m = np.linalg.norm(p[:, :2], axis=1) > self.remove_close
                p = p[m]
                r = np.asarray(sw["sensor2lidar_rotation"], np.float32)
                t = np.asarray(sw["sensor2lidar_translation"], np.float32)
                p[:, :3] = p[:, :3] @ r.T + t
                lag = (sample["meta"].get("timestamp", 0)
                       - sw.get("timestamp", 0)) * 1e-6
                if p.shape[1] == base.shape[1]:
                    # time_dim indexes the load layout: find its column
                    # in the use_dim-selected array
                    assert self.time_dim in use, (
                        f"sweep width matches keyframe but time_dim "
                        f"{self.time_dim} is not in use_dim {use}")
                    p[:, use.index(self.time_dim)] = lag
                else:
                    assert p.shape[1] == base.shape[1] - 1, (
                        f"sweep width {p.shape[1]} does not align with "
                        f"keyframe width {base.shape[1]}")
                    ts = np.full((len(p), 1), lag, np.float32)
                    p = np.concatenate([p, ts], 1)
                out.append(p)
        sample["points"] = np.concatenate(out)
        return sample


@register("LoadImageFromFile")
@register("LoadMultiViewImageFromFiles")
@register("LoadMultiViewMultiSweepImageFromFilesIndoor")
@register("LoadMultiViewMultiSweepImageFromFiles")
class LoadImageFromFile:
    """Load the sample's image(s) and their per-view lidar2img.

    The dataset parser stashes 'img_paths' (N), 'lidar2img' (N, 4, 4)
    and optionally 'cam_sweeps' (per-camera list of {data_path,
    lidar2img, timestamp}) in meta. With ``sweep_num`` S > 1 previous
    camera frames are appended sweep-major (images [sweep0 cams | sweep1
    cams | ...] with matching lidar2img), the layout the view
    transformer reads with ``num_sweeps=S``; a missing sweep repeats the
    latest frame of its camera. Also records ``sweep_times`` (S,), the
    lags in seconds.
    """

    def __init__(self, ctx, to_float32=True, sweep_num=1,
                 random_sweep=False):
        self.to_float32 = to_float32
        self.sweep_num = sweep_num
        self.random_sweep = random_sweep

    def _read(self, p):
        from PIL import Image
        im = np.asarray(Image.open(p).convert("RGB"))
        return im.astype(np.float32) if self.to_float32 else im

    def __call__(self, sample, rng):
        meta = sample.get("meta", {})
        paths = meta.get("img_paths")
        if not paths:
            return sample
        imgs = [self._read(p) for p in paths]
        l2i = [np.asarray(m, np.float32)
               for m in np.asarray(meta["lidar2img"], np.float32)]
        times = [0.0]
        if self.sweep_num > 1:
            n_sweeps = self.sweep_num - 1
            if self.random_sweep:
                n_sweeps = int(rng.integers(0, self.sweep_num))
            chains = meta.get("cam_sweeps") or [[] for _ in paths]
            t0 = meta.get("timestamp", 0)
            for s in range(n_sweeps):
                lag = 0.0
                for c, chain in enumerate(chains):
                    if s < len(chain):
                        rec = chain[s]
                        imgs.append(self._read(rec["data_path"]))
                        l2i.append(np.asarray(rec["lidar2img"],
                                              np.float32))
                        lag = (t0 - rec.get("timestamp", t0)) * 1e-6
                    else:  # pad with the most recent frame for this cam
                        nc = len(paths)
                        imgs.append(imgs[s * nc + c])
                        l2i.append(l2i[s * nc + c])
                times.append(lag)
        sample["images"] = np.stack(imgs)
        sample["lidar2img"] = np.stack(l2i)
        if len(times) > 1:
            sample["sweep_times"] = np.asarray(times, np.float32)
        sample.setdefault("uni_rot_aug", np.eye(3, dtype=np.float32))
        return sample


@register("NormalizeImage")
@register("NormalizeMultiviewImage")
class NormalizeImage:
    """Per-channel mean/std normalization."""

    def __init__(self, ctx, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample, rng):
        if "images" in sample:
            sample["images"] = (sample["images"] - self.mean) / self.std
        return sample


@register("PadImage")
@register("PadMultiViewImage")
class PadImage:
    """Pad (or crop) images to a fixed (H, W) or to a size divisor."""

    def __init__(self, ctx, size=None, size_divisor=32):
        self.size = size
        self.size_divisor = size_divisor

    def __call__(self, sample, rng):
        imgs = sample.get("images")
        if imgs is None:
            return sample
        N, H, W, C = imgs.shape
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = -(-H // d) * d, -(-W // d) * d
        out = np.zeros((N, th, tw, C), imgs.dtype)
        h, w = min(H, th), min(W, tw)  # crop if larger than target
        out[:, :h, :w] = imgs[:, :h, :w]
        sample["images"] = out
        return sample


@register("ResizeImage")
@register("RandomScaleImageMultiViewImage")
class ResizeImage:
    """Rescale images by one of ``scales`` (drawn from ``rng``), updating
    the lidar2img intrinsics."""

    def __init__(self, ctx, scales=(1.0,)):
        self.scales = scales

    def __call__(self, sample, rng):
        imgs = sample.get("images")
        if imgs is None:
            return sample
        s = self.scales[int(rng.integers(len(self.scales)))]
        if s != 1.0:
            import cv2
            N, H, W, C = imgs.shape
            nh, nw = int(H * s), int(W * s)
            imgs = np.stack([cv2.resize(im, (nw, nh)) for im in imgs])
            sample["images"] = imgs
            scale_mat = np.eye(4, dtype=np.float32)
            scale_mat[0, 0] = scale_mat[1, 1] = s
            sample["lidar2img"] = scale_mat @ sample["lidar2img"]
        return sample


@register("ImageRandomResizeCropFlip")
class ImageRandomResizeCropFlip:
    """Random image resize + horizontal flip + bottom crop, recording the
    accumulated pixel-space transform as ``img_rot_aug`` (2x2) and
    ``img_trans_aug`` (2,) so the view transformer can map projected
    points from original-camera pixel coords into augmented-image coords
    (reference transform_3d.py:244-322; accumulation at :309-320; the
    lift applies ``uv @ img_rot_aug + img_trans_aug``,
    uni3d_viewtrans.py:312-322).

    Forward pixel map: resize by s, then flip u -> W_resized - u, then
    shift by the crop origin. All component matrices are diagonal, so
    the reference's ``scale_mat @ flip_rot`` row-vector composition is
    exact and reproduced here.
    """

    def __init__(self, ctx, flip_ratio=None, resize_scales=None,
                 crop_sizes=None, training=True):
        self.flip_ratio = flip_ratio
        self.resize_scales = resize_scales
        self.crop_sizes = crop_sizes  # (H, W)
        self.training = training

    def __call__(self, sample, rng):
        imgs = sample.get("images")
        if imgs is None:
            return sample
        rot = np.eye(2, dtype=np.float32)
        trans = np.zeros(2, np.float32)
        if self.resize_scales is not None:
            import cv2
            s = float(rng.uniform(*self.resize_scales))
            N, H, W, C = imgs.shape
            nh, nw = int(H * s), int(W * s)
            imgs = np.stack([cv2.resize(im, (nw, nh)) for im in imgs])
            rot = rot @ np.diag([s, s]).astype(np.float32)
        if self.flip_ratio is not None and self.training \
                and rng.random() < self.flip_ratio:
            imgs = imgs[:, :, ::-1].copy()
            W = imgs.shape[2]
            rot = rot @ np.diag([-1.0, 1.0]).astype(np.float32)
            trans = trans + np.array([W, 0], np.float32)
        if self.crop_sizes is not None:
            N, H, W, C = imgs.shape
            ch, cw = self.crop_sizes
            start_h = max(0, H - ch)  # crop from image bottom (:282)
            if self.training:
                start_w = int(rng.uniform(0, max(0, W - cw)))
            else:
                start_w = max(0, W - cw) // 2
            imgs = imgs[:, start_h:start_h + ch, start_w:start_w + cw]
            trans = trans + np.array([-start_w, -start_h], np.float32)
        sample["images"] = imgs
        sample["img_rot_aug"] = rot
        sample["img_trans_aug"] = trans
        return sample


@register("PhotoMetricDistortion")
@register("PhotoMetricDistortionMultiViewImage")
class PhotoMetricDistortion:
    """Brightness / contrast / saturation / hue jitter
    (transform_3d.py:104-201)."""

    def __init__(self, ctx, brightness_delta=32,
                 contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta=18):
        self.bd = brightness_delta
        self.cr = contrast_range
        self.sr = saturation_range
        self.hd = hue_delta

    def __call__(self, sample, rng):
        imgs = sample.get("images")
        if imgs is None:
            return sample
        import cv2
        out = []
        for im in imgs:
            im = im.astype(np.float32)
            if rng.random() < 0.5:
                im = im + rng.uniform(-self.bd, self.bd)
            if rng.random() < 0.5:
                im = im * rng.uniform(*self.cr)
            hsv = cv2.cvtColor(np.clip(im, 0, 255).astype(np.uint8),
                               cv2.COLOR_RGB2HSV).astype(np.float32)
            if rng.random() < 0.5:
                hsv[..., 1] *= rng.uniform(*self.sr)
            if rng.random() < 0.5:
                hsv[..., 0] = (hsv[..., 0]
                               + rng.uniform(-self.hd, self.hd)) % 180
            im = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                              cv2.COLOR_HSV2RGB).astype(np.float32)
            out.append(im)
        sample["images"] = np.stack(out)
        return sample


@register("GridMask")
class GridMaskTransform:
    """Grid-dropout image augmentation (reference grid_mask.py:6-122,
    applied with prob 0.7 in the OV image branch; host-side here).

    Drops a regular grid of square patches (ratio of the cell kept) at a
    random rotation-free offset. sample['images'] is (N, H, W, 3)."""

    def __init__(self, ctx, prob=0.7, ratio=0.5, min_d=2):
        self.prob = prob
        self.ratio = ratio
        self.min_d = min_d

    def __call__(self, sample, rng):
        imgs = sample.get("images")
        if imgs is None or rng.random() > self.prob:
            return sample
        H, W = imgs.shape[-3:-1]
        d = int(rng.integers(self.min_d, max(min(H, W) // 4, self.min_d + 1)))
        keep = int(np.ceil(d * self.ratio))
        oy = int(rng.integers(0, d))
        ox = int(rng.integers(0, d))
        yy = ((np.arange(H) + oy) % d) < keep
        xx = ((np.arange(W) + ox) % d) < keep
        mask = (~(yy[:, None] & xx[None, :])).astype(imgs.dtype)
        sample["images"] = imgs * mask[None, :, :, None]
        return sample


@register("ObjectSample")
@register("UnifiedObjectSample")
class ObjectSample:
    """GT-database copy-paste augmentation (reference
    UnifiedDataBaseSampler, dbsampler.py:17-270): class quotas, min-points
    filter, BEV collision rejection against existing + already-sampled
    boxes, background points inside pasted boxes removed.

    With ``sample_2d=True`` also pastes each sampled object's stored image
    crop into the camera views by descending depth order (reference
    UnifiedObjectSample.unified_sample, transform_3d.py:692-774): every
    box — raw and sampled — is projected to a 2D bbox; raw boxes re-stitch
    their own pixels and sampled boxes paste the (resized) database crop,
    so nearer objects overwrite farther ones."""

    def __init__(self, ctx, db_info_path, rate=1.0, sample_groups=None,
                 min_points=None, difficulty=(-1,), sample_2d=False,
                 sample_method="depth"):
        self.classes = list(ctx["class_names"])
        path = os.path.join(ctx.get("data_root", ""), db_info_path)
        self.db = None
        self.db_path = path
        self.rate = rate
        self.groups = sample_groups or {}
        self.min_points = min_points or {}
        self.difficulty = set(difficulty)
        self.data_root = ctx.get("data_root", "")
        self.sample_2d = sample_2d
        self.sample_method = sample_method
        self._lock = threading.Lock()   # the loader threads share the db

    def _lazy_load(self):
        with self._lock:
            if self.db is not None:
                return
            with open(self.db_path, "rb") as f:
                db = pickle.load(f)
            keep = {}
            for cls, infos in db.items():
                keep[cls] = [i for i in infos
                             if i.get("num_points_in_gt", 1e9)
                             >= self.min_points.get(cls, 0)
                             and (i.get("difficulty", -1) in self.difficulty
                                  or -1 in self.difficulty)]
            self.db = keep

    def __call__(self, sample, rng):
        self._lazy_load()
        boxes = sample.get("gt_boxes")
        labels = sample.get("gt_labels")
        if boxes is None:
            return sample
        new_boxes, new_labels, new_points, new_crops = [], [], [], []
        avoid = boxes[:, :7].copy()
        for cls, quota in self.groups.items():
            if cls not in self.classes or not self.db.get(cls):
                continue
            cls_id = self.classes.index(cls)
            need = int((quota - (labels == cls_id).sum()) * self.rate)
            if need <= 0:
                continue
            cand = rng.choice(len(self.db[cls]), min(need * 2,
                                                     len(self.db[cls])),
                              replace=False)
            taken = 0
            for ci in cand:
                if taken >= need:
                    break
                info = self.db[cls][ci]
                b = np.asarray(info["box3d_lidar"], np.float32)[None]
                if box_np_ops.box_collision_test(b[:, :7],
                                                 avoid).any():
                    continue
                p = np.fromfile(
                    os.path.join(self.data_root, info["path"]),
                    np.float32).reshape(-1, sample["points"].shape[1])
                p[:, :3] += b[0, :3]
                new_boxes.append(b[0])
                new_labels.append(cls_id)
                new_points.append(p)
                new_crops.append(self._load_crop(info))
                avoid = np.concatenate([avoid, b[:, :7]])
                taken += 1
        if new_boxes:
            nb = np.stack(new_boxes)
            # drop background points inside pasted boxes
            pts = sample["points"]
            inside = box_np_ops.points_in_any_rbbox(pts[:, :3],
                                                    nb[:, :7])
            pts = pts[~inside]
            if boxes.shape[1] > 7:
                pad = np.zeros((len(nb), boxes.shape[1] - 7), np.float32)
                nb = np.concatenate([nb[:, :7], pad], 1)
            sample["points"] = np.concatenate([pts] + new_points)
            sample["gt_boxes"] = np.concatenate([boxes, nb])
            sample["gt_labels"] = np.concatenate(
                [labels, np.asarray(new_labels, labels.dtype)])
            if self.sample_2d and sample.get("images") is not None:
                self._paste_crops(sample, new_crops)
        return sample

    def _load_crop(self, info):
        if not self.sample_2d or "img_crop_path" not in info:
            return None
        from PIL import Image
        p = os.path.join(self.data_root, info["img_crop_path"])
        try:
            return np.asarray(Image.open(p).convert("RGB"),
                              dtype=np.float32)
        except OSError:
            return None

    def _paste_crops(self, sample, crops):
        """Depth-ordered 2D paste (transform_3d.py:692-774). All GT boxes
        (raw first, the len(crops) sampled ones last) project to 2D
        bboxes per view; farthest paste first so nearer content wins."""
        import cv2
        imgs = sample["images"]
        l2is = np.asarray(sample["lidar2img"], np.float32)
        boxes = sample["gt_boxes"]
        n_samp = len(crops)
        n_raw = len(boxes) - n_samp
        corners = box_np_ops.corners_3d(boxes[:, :7])  # (G, 8, 3)
        hom = np.concatenate(
            [corners, np.ones_like(corners[..., :1])], -1)
        for v in range(len(imgs)):
            img = imgs[v]
            H, W = img.shape[:2]
            cp = hom @ l2is[v].T  # (G, 8, 4)
            depth = cp[..., 2]
            vis = (depth > 0).all(-1)
            if not vis.any():
                continue
            uv = cp[..., :2] / np.maximum(depth[..., None], 1e-5)
            mn = uv.min(1)
            mx = uv.max(1)
            bb = np.concatenate([mn, mx], -1).astype(int)
            bb[:, 0::2] = np.clip(bb[:, 0::2], 0, W - 1)
            bb[:, 1::2] = np.clip(bb[:, 1::2], 0, H - 1)
            ok = vis & ((bb[:, 2:] - bb[:, :2]) > 1).all(-1)
            idx = np.nonzero(ok)[0]
            if not len(idx):
                continue
            if "depth" in self.sample_method:
                order = np.argsort(depth.mean(1)[idx])[::-1]
                idx = idx[order]
            # crop the raw boxes' pixels before any paste overwrites them
            raw_px = {int(g): img[bb[g, 1]:bb[g, 3],
                                  bb[g, 0]:bb[g, 2]].copy()
                      for g in idx if g < n_raw}
            for g in idx:
                x0, y0, x1, y1 = bb[g]
                if g < n_raw:
                    img[y0:y1, x0:x1] = raw_px[int(g)]
                else:
                    crop = crops[g - n_raw]
                    if crop is None or crop.size == 0:
                        continue
                    img[y0:y1, x0:x1] = cv2.resize(
                        crop, (x1 - x0, y1 - y0)).astype(img.dtype)
            imgs[v] = img
        sample["images"] = imgs
