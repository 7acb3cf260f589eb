"""Datasets over the reference's info pkls, and batching (jax-free copy of
``uni3detr_tpu/data/datasets.py``: SUN RGB-D / ScanNet with the
single-view camera, KITTI, nuScenes with sweeps, attributes and
multi-view cameras, a synthetic dataset that needs no data on disk, and
the train split's ``RepeatDataset`` and ``CBGSDataset``).

Samples feed the numpy pipeline (``data.pipeline``), then
:func:`collate_batch` pads them to the model's static budgets. In test
mode sample ``idx`` draws from ``np.random.default_rng(idx)``, as the JAX
package does, so both give equal arrays. In train mode each sample draws
from a fresh unseeded ``np.random.default_rng(None)`` and a sample left
without GT is redrawn at ``np.random.randint`` (the global generator), as
in the JAX package; ``DetDataset(sample_rng=fn)`` replaces the fresh
generator by ``fn(idx)``, the seam through which the tests and the smoke
run seed the draws.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from .pipeline import build_pipeline


def _load_points(path, load_dim, use_dim):
    pts = np.fromfile(path, np.float32).reshape(-1, load_dim)
    return pts[:, list(use_dim)]


def _lidar2img(cam_info):
    """4x4 lidar->image matrix from a converter cam record (invert
    sensor2lidar, pad the intrinsics)."""
    r = np.asarray(cam_info["sensor2lidar_rotation"], np.float64)
    t = np.asarray(cam_info["sensor2lidar_translation"], np.float64)
    lidar2cam_r = np.linalg.inv(r)
    lidar2cam_t = t @ lidar2cam_r.T
    rt = np.eye(4)
    rt[:3, :3] = lidar2cam_r.T
    rt[3, :3] = -lidar2cam_t
    viewpad = np.eye(4)
    K = np.asarray(cam_info["cam_intrinsic"], np.float64)
    viewpad[:K.shape[0], :K.shape[1]] = K
    return (viewpad @ rt.T).astype(np.float32)


def _shift_height(points):
    """Append the height-above-floor feature (mmdet3d shift_height:
    floor = 0.99-quantile of lowest z)."""
    floor = np.percentile(points[:, 2], 0.99)
    h = (points[:, 2] - floor).astype(np.float32)
    return np.concatenate([points[:, :3], h[:, None]], 1)


class DetDataset:
    """Info-pkl-backed detection dataset."""

    def __init__(self, data_root, ann_file, pipeline_cfg, class_names,
                 pc_range, dataset_type="sunrgbd", box_type="Depth",
                 load_dim=6, use_dim=(0, 1, 2), shift_height=False,
                 test_mode=False, filter_empty_gt=True, use_camera=False,
                 sample_rng=None):
        self.data_root = data_root
        self.sample_rng = sample_rng
        self.use_camera = use_camera
        self.dataset_type = dataset_type
        self.class_names = list(class_names)
        self.load_dim = load_dim
        self.use_dim = use_dim
        self.shift_height = shift_height
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        with open(os.path.join(data_root, ann_file), "rb") as f:
            infos = pickle.load(f)
        if isinstance(infos, dict) and "infos" in infos:  # nuscenes layout
            infos = infos["infos"]
        self.infos = infos
        ctx = dict(pc_range=tuple(pc_range), class_names=self.class_names,
                   data_root=data_root, box_type=box_type)
        self.pipeline = build_pipeline(pipeline_cfg, ctx)

    def __len__(self):
        return len(self.infos)

    def _rel(self, path):
        return path if os.path.isabs(path) \
            else os.path.join(self.data_root, path)

    # --- per-dataset info parsing -------------------------------------
    def _parse(self, info) -> dict:
        t = self.dataset_type
        meta = {}
        if t in ("sunrgbd", "scannet"):
            pts_path = info.get("pts_path") or info["point_cloud"].get(
                "pts_path", "")
            path = os.path.join(self.data_root, pts_path)
            annos = info.get("annos", {})
            boxes = np.asarray(
                annos.get("gt_boxes_upright_depth",
                          np.zeros((0, 7))), np.float32).reshape(-1, 7)
            names = annos.get("name", [])
            labels = np.asarray(
                [self.class_names.index(n) for n in names], np.int32) \
                if len(names) else np.zeros((0,), np.int32)
            if t == "scannet" and "axis_align_matrix" in annos:
                meta["axis_align_matrix"] = np.asarray(
                    annos["axis_align_matrix"], np.float32)
            # camera info for the OV image branch (single view)
            if self.use_camera and "image" in info and "calib" in info:
                meta["img_paths"] = [os.path.join(
                    self.data_root, info["image"]["image_path"])]
                K = np.asarray(info["calib"]["K"],
                               np.float32).reshape(3, 3)
                Rt = np.asarray(info["calib"]["Rt"],
                                np.float32).reshape(3, 3)
                P = np.eye(4, dtype=np.float32)
                P[:3, :3] = K @ Rt
                meta["lidar2img"] = P[None]  # (1, 4, 4)
        elif t == "kitti":
            path = os.path.join(
                self.data_root,
                info["point_cloud"]["velodyne_path"])
            annos = info.get("annos", {})
            boxes = np.asarray(annos.get("gt_boxes_lidar",
                                         np.zeros((0, 7))),
                               np.float32).reshape(-1, 7)
            names = annos.get("name", [])
            keep = [i for i, n in enumerate(names)
                    if n in self.class_names]
            boxes = boxes[keep] if len(boxes) else boxes
            labels = np.asarray(
                [self.class_names.index(names[i]) for i in keep], np.int32)
        elif t == "nuscenes":
            path = info["lidar_path"]
            if not os.path.isabs(path):
                path = os.path.join(self.data_root, path)
            boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                               np.float32)
            if len(boxes):
                # info boxes carry gravity-centre z (devkit convention);
                # the storage layout is bottom z
                boxes = boxes.copy()
                boxes[:, 2] -= boxes[:, 5] / 2.0
            vel = np.asarray(info.get("gt_velocity",
                                      np.zeros((len(boxes), 2))),
                             np.float32)
            vel = np.nan_to_num(vel)
            boxes = np.concatenate([boxes[:, :7], vel], 1) \
                if len(boxes) else np.zeros((0, 9), np.float32)
            names = info.get("gt_names", [])
            valid = np.asarray(info.get("valid_flag",
                                        np.ones(len(boxes), bool)))
            keep = [i for i, n in enumerate(names)
                    if valid[i] and n in self.class_names]
            boxes = boxes[keep] if len(boxes) else boxes
            labels = np.asarray(
                [self.class_names.index(names[i]) for i in keep], np.int32)
            attrs = info.get("gt_attrs")
            if attrs is not None:
                # eval-only (AAE); carried in meta, which the test
                # pipeline leaves untouched, so the keep filter aligns
                meta["gt_attrs"] = np.asarray(attrs)[keep] \
                    if len(keep) else np.asarray([], dtype=object)
            meta["sweeps"] = info.get("sweeps", [])
            meta["timestamp"] = info.get("timestamp", 0)
            meta["token"] = info.get("token")
            if self.use_camera and info.get("cams"):
                # per-cam lidar2img from the sensor2lidar pose and the
                # intrinsics
                img_paths, l2is, cam_sweeps = [], [], []
                for cam, ci in info["cams"].items():
                    img_paths.append(self._rel(ci["data_path"]))
                    l2is.append(_lidar2img(ci))
                    chain = info.get("cam_sweeps_info", {}).get(cam, [])
                    # chain[0] is the keyframe itself when non-empty
                    sw = [{"data_path": self._rel(s["data_path"]),
                           "lidar2img": _lidar2img(s),
                           "timestamp": s.get("timestamp", 0)}
                          for s in chain[1:]]
                    cam_sweeps.append(sw)
                meta["img_paths"] = img_paths
                meta["lidar2img"] = np.stack(l2is)
                meta["cam_sweeps"] = cam_sweeps
        else:
            raise KeyError(t)
        return dict(path=path, gt_boxes=boxes, gt_labels=labels, meta=meta)

    def get_cat_ids(self, idx):
        """The sample's set of labels (the CBGS resampling's input)."""
        return set(self._parse(self.infos[idx])["gt_labels"].tolist())

    def load_sample(self, idx) -> dict:
        """Sample ``idx`` as loaded, before the pipeline."""
        rec = self._parse(self.infos[idx])
        pts = _load_points(rec["path"], self.load_dim, self.use_dim)
        if self.shift_height:
            pts = _shift_height(pts)
        return {
            "points": pts.astype(np.float32),
            "gt_boxes": rec["gt_boxes"],
            "gt_labels": rec["gt_labels"],
            "uni_rot_aug": np.eye(3, dtype=np.float32),
            "meta": dict(rec["meta"], index=idx),
        }

    def __getitem__(self, idx):
        if self.sample_rng is not None:
            rng = self.sample_rng(idx)
        else:
            rng = np.random.default_rng(None if not self.test_mode else idx)
        sample = self.pipeline(self.load_sample(idx), rng)
        if (sample is None or (self.filter_empty_gt and not self.test_mode
                               and len(sample["gt_labels"]) == 0)):
            return self[np.random.randint(len(self))]
        return sample


class SyntheticDataset:
    """Procedural scenes for smoke runs without data on disk."""

    def __init__(self, pipeline_cfg, class_names, pc_range, length=64,
                 n_points=20000, seed=0, with_camera=False,
                 img_size=(32, 32), box_size_m=None, **kw):
        self.length = length
        self.n_points = n_points
        self.class_names = list(class_names)
        self.pc_range = np.asarray(pc_range, np.float32)
        self.seed = seed
        self.with_camera = with_camera
        self.img_size = tuple(img_size)
        # absolute box-size range in metres; by default it scales with
        # the scene span
        self.box_size_m = box_size_m
        ctx = dict(pc_range=tuple(pc_range), class_names=self.class_names,
                   data_root="", box_type=kw.get("box_type", "Depth"))
        self.pipeline = build_pipeline(pipeline_cfg, ctx)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        lo, hi = self.pc_range[:3], self.pc_range[3:]
        nb = rng.integers(2, 6)
        boxes, labels, pts = [], [], []
        for _ in range(nb):
            if self.box_size_m is not None:
                size = rng.uniform(*self.box_size_m, 3)
            else:
                size = rng.uniform(0.3, 1.2, 3) * (hi - lo) / 8
            ctr = rng.uniform(lo + size, hi - size)
            yaw = rng.uniform(-np.pi, np.pi)
            boxes.append([*(ctr - [0, 0, size[2] / 2]), *size, yaw])
            labels.append(rng.integers(len(self.class_names)))
            local = rng.uniform(-0.5, 0.5, (self.n_points // (nb + 1), 3)) \
                * size
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            pts.append(local @ rot.T + ctr)
        pts.append(rng.uniform(lo, hi, (self.n_points // (nb + 1), 3)))
        sample = {
            "points": np.concatenate(pts).astype(np.float32),
            "gt_boxes": np.asarray(boxes, np.float32),
            "gt_labels": np.asarray(labels, np.int32),
            "uni_rot_aug": np.eye(3, dtype=np.float32),
            "meta": {"index": int(idx)},
        }
        if self.with_camera:
            # one pinhole camera behind -y looking +y (depth axis y);
            # the pixels are procedural
            H, W = self.img_size
            K = np.array([[0.6 * W, 0, W / 2, 0], [0, 0.6 * H, H / 2, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
            span = float(self.pc_range[4] - self.pc_range[1])
            T = np.array([[1, 0, 0, 0], [0, 0, -1, 0],
                          [0, 1, 0, span], [0, 0, 0, 1]], np.float32)
            sample["images"] = rng.uniform(
                0, 1, (1, H, W, 3)).astype(np.float32)
            sample["lidar2img"] = (K @ T)[None]
        return self.pipeline(sample, rng)


class RepeatDataset:
    def __init__(self, ds, times):
        self.ds, self.times = ds, times

    def __len__(self):
        return len(self.ds) * self.times

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]


class CBGSDataset:
    """Class-balanced resampling (mmdet3d's CBGSDataset, which the
    reference's nuScenes config uses): each class's samples drawn with
    replacement, by ``RandomState(class).choice``, to an equal share."""

    def __init__(self, ds):
        self.ds = ds
        ncls = len(ds.class_names)
        cat_to_idx = {c: [] for c in range(ncls)}
        for i in range(len(ds)):
            for c in ds.get_cat_ids(i):
                cat_to_idx[c].append(i)
        frac = 1.0 / ncls
        total = sum(len(v) for v in cat_to_idx.values())
        self.indices = []
        for c, idxs in cat_to_idx.items():
            if not idxs:
                continue
            ratio = frac / (len(idxs) / max(total, 1))
            reps = int(np.round(ratio * len(idxs)))
            self.indices += list(np.random.RandomState(c).choice(
                idxs, max(reps, 1)))
        if not self.indices:
            self.indices = list(range(len(ds)))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[self.indices[i]]


def box_type_of(data_cfg: dict) -> str:
    """The box frame of a config's ``data`` dict: ``box_type_3d`` (the
    key the shipped configs set, as mmdet3d names it), else ``box_type``,
    else "Depth". The JAX package reads ``box_type`` alone, so its KITTI
    and nuScenes runs flip and map boxes as Depth (ROADMAP Queue 3)."""
    return data_cfg.get("box_type_3d", data_cfg.get("box_type", "Depth"))


def build_dataset(data_cfg: dict, class_names, pc_range, split="train",
                  sample_rng=None, filter_empty_gt=True):
    """A config's ``data`` split: "train" runs ``train_pipeline`` with
    ``cbgs`` and ``repeat``, any other split ``ann_val`` with
    ``test_pipeline`` in test mode. ``sample_rng`` and
    ``filter_empty_gt``: see :class:`DetDataset` (the synthetic dataset
    seeds itself and always has GT)."""
    t = data_cfg["dataset_type"]
    pipeline = data_cfg["train_pipeline"] if split == "train" \
        else data_cfg["test_pipeline"]
    if t == "synthetic":
        ds = SyntheticDataset(pipeline, class_names, pc_range,
                              length=data_cfg.get("length", 64),
                              n_points=data_cfg.get("n_points", 20000),
                              with_camera=data_cfg.get("with_camera",
                                                       False),
                              img_size=data_cfg.get("img_size", (32, 32)),
                              box_size_m=data_cfg.get("box_size_m"))
    else:
        ann = data_cfg["ann_train"] if split == "train" \
            else data_cfg["ann_val"]
        ds = DetDataset(
            data_cfg["data_root"], ann, pipeline, class_names, pc_range,
            dataset_type=t, box_type=box_type_of(data_cfg),
            load_dim=data_cfg.get("load_dim", 6),
            use_dim=tuple(data_cfg.get("use_dim", (0, 1, 2))),
            shift_height=data_cfg.get("shift_height", False),
            use_camera=data_cfg.get("use_camera", False),
            test_mode=(split != "train"), sample_rng=sample_rng,
            filter_empty_gt=filter_empty_gt)
    if split == "train":
        if data_cfg.get("cbgs") and t != "synthetic":
            ds = CBGSDataset(ds)
        if data_cfg.get("repeat", 1) > 1:
            ds = RepeatDataset(ds, data_cfg["repeat"])
    return ds


def collate_batch(samples: List[dict], num_points: int, max_gt: int,
                  point_features: int, code_size: int = 8):
    """Pad variable-length samples to the model's static budgets.
    Returns (dict of numpy arrays, list of the samples' meta dicts)."""
    B = len(samples)
    box_dim = 7 if code_size <= 8 else 9
    pts = np.zeros((B, num_points, point_features), np.float32)
    pmask = np.zeros((B, num_points), bool)
    boxes = np.zeros((B, max_gt, box_dim), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    gmask = np.zeros((B, max_gt), bool)
    metas = []
    for i, s in enumerate(samples):
        p = s["points"][:, :point_features]
        n = min(len(p), num_points)
        pts[i, :n, :p.shape[1]] = p[:n]
        pmask[i, :n] = True
        g = min(len(s["gt_boxes"]), max_gt)
        if g:
            boxes[i, :g] = s["gt_boxes"][:g, :box_dim]
            labels[i, :g] = s["gt_labels"][:g]
            gmask[i, :g] = True
        metas.append(s.get("meta", {}))
    batch = {"points": pts, "pts_mask": pmask, "gt_boxes": boxes,
             "gt_labels": labels, "gt_mask": gmask}
    # OV multimodal extras
    if "images" in samples[0]:
        batch["images"] = np.stack([s["images"] for s in samples])
        batch["lidar2img"] = np.stack(
            [np.asarray(s["lidar2img"], np.float32) for s in samples])
        batch["uni_rot_aug"] = np.stack(
            [np.asarray(s["uni_rot_aug"], np.float32) for s in samples])
        if "sweep_times" in samples[0]:
            batch["sweep_times"] = np.stack(
                [np.asarray(s["sweep_times"], np.float32)
                 for s in samples])
        if "img_rot_aug" in samples[0]:
            batch["img_rot_aug"] = np.stack(
                [np.asarray(s["img_rot_aug"], np.float32)
                 for s in samples])
            batch["img_trans_aug"] = np.stack(
                [np.asarray(s["img_trans_aug"], np.float32)
                 for s in samples])
    return batch, metas
