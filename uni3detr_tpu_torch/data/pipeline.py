"""Host-side (numpy) data pipeline: the test-time transforms (jax-free
copy of the test path of ``uni3detr_tpu/data/pipeline.py``).

Samples are plain dicts: points (P, C) float32, xyz first; gt_boxes (G,
7|9) storage layout (bottom z); gt_labels (G,) int32; uni_rot_aug (3,
3); meta dict. Every transform takes (sample, rng: np.random.Generator),
mutates the dict and draws from ``rng`` in the JAX package's order, so a
dataset seeded alike gives equal arrays.

Ported: ``PointsRangeFilter``, ``PointSample``, ``GlobalAlignment``
(ScanNet), ``LoadPointsFromMultiSweeps`` (nuScenes), the image loaders
(``LoadImageFromFile`` and its multi-view names), ``NormalizeImage``,
``PadImage`` and ``ResizeImage``: every transform a shipped config's
``test_pipeline`` names. The train-time augmentations are not ported
yet; :func:`build_pipeline` raises a KeyError naming any transform it
lacks.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

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
            raise KeyError(f"pipeline transform {t!r} is not ported (the "
                           f"port has the test-time transforms)")
        out.append(TRANSFORMS[t](ctx=ctx, **c))
    return Compose(out)


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
