"""Data preparation of the port (after ``uni3detr_tpu/cli/create_data.py``):

    python -m uni3detr_tpu_torch.cli.create_data kitti --root data/kitti \\
        [--split train|val|...]
    python -m uni3detr_tpu_torch.cli.create_data gt_database CONFIG \\
        --out-dir DATA_ROOT [--with-image-crops] [--cfg-options k=v ...]
    python -m uni3detr_tpu_torch.cli.create_data nuscenes --root \\
        data/nuscenes [--version v1.0-trainval] [--out-dir DIR] \\
        [--max-sweeps 10] [--train-scenes FILE] [--val-scenes FILE]

``kitti`` writes ``kitti_infos_<split>.pkl`` from the raw layout
(``training/{velodyne,label_2,calib}``, ``ImageSets/<split>.txt``);
``nuscenes`` walks the raw JSON tables (``data.nuscenes_converter``);
``gt_database`` crops each GT object's points out of a config's train
scenes for the ``ObjectSample`` augmentation (the reference's
create_unified_gt_database.py:70-180), with ``--with-image-crops`` also
each object's 2D patch for ``ObjectSample(sample_2d=True)``. SUN RGB-D /
ScanNet info pkls come from the standard mmdet3d preprocessing.

Two choices differ from the JAX CLI. The GT database lands at the
``db_info_path`` of the config's ``ObjectSample`` under ``--out-dir``
(``dbinfos_train.pkl`` when the config has none), where the train
pipeline reads it; the JAX CLI always writes ``dbinfos_train.pkl``. And
the scenes are walked once each, in the plain dataset without ``cbgs``,
``repeat`` or the redraw of a scene without GT, as mmdet3d's
``create_groundtruth_database`` does; the JAX CLI walks the train split
as built for training, whose resampling duplicates objects or files a
random scene's objects under another scene's index. The nuScenes root is
made absolute before the walk, because the infos hold
``os.path.join(root, filename)`` and a relative root would be joined to
the config's ``data_root`` a second time: a converted root must not move.
The whole walk runs on the host; the box ops are the native
``data.box_np_ops`` (g++ at first use, no fallback).
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _parse_kitti_calib(path):
    """KITTI calib txt -> (P2 (3, 4), R0_rect (4, 4), Tr_velo_to_cam
    (4, 4)) float32."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            # np.fromstring(v, sep=" ") of the JAX CLI, without the text
            # mode that numpy has deprecated
            out[k.strip()] = np.array(v.split(), np.float32)
    P2 = out["P2"].reshape(3, 4)
    R0 = np.eye(4, dtype=np.float32)
    R0[:3, :3] = out["R0_rect"].reshape(3, 3)
    Tr = np.eye(4, dtype=np.float32)
    Tr[:3, :4] = out["Tr_velo_to_cam"].reshape(3, 4)
    return P2, R0, Tr


def _cam_box_to_lidar(loc, dims, rot_y, R0, Tr):
    """KITTI camera-frame labels -> lidar storage boxes (bottom z), fp32:
    (N, 7) x, y, z, l, w, h, yaw."""
    cam2lidar = np.linalg.inv(R0 @ Tr)
    xyz1 = np.concatenate([loc, np.ones((len(loc), 1), np.float32)], 1)
    xyz = (xyz1 @ cam2lidar.T)[:, :3]
    h, w, l = dims[:, 0], dims[:, 1], dims[:, 2]
    yaw = -(rot_y + np.pi / 2)
    return np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2],
                     l, w, h, yaw], -1).astype(np.float32)


def create_kitti_infos(root, split_file, out_path):
    """The infos of the scenes listed in ``split_file``: the velodyne
    path, the calib, and where a label file exists the annotations with
    their DontCare rows (kept, as mmdet3d's converter does: the metric
    reads them, the dataset's class filter keeps them out of training)."""
    with open(split_file) as f:
        ids = [line.strip() for line in f if line.strip()]
    infos = []
    for idx in ids:
        P2, R0, Tr = _parse_kitti_calib(
            os.path.join(root, "training", "calib", f"{idx}.txt"))
        info = {
            "point_cloud": {
                "velodyne_path": f"training/velodyne/{idx}.bin",
                "idx": idx},
            "calib": {"P2": P2, "R0_rect": R0, "Tr_velo_to_cam": Tr},
        }
        label_path = os.path.join(root, "training", "label_2", f"{idx}.txt")
        if os.path.exists(label_path):
            names, trunc, occ, bbox, dims, loc, rot = \
                [], [], [], [], [], [], []
            with open(label_path) as f:
                for line in f:
                    v = line.split()
                    names.append(v[0])
                    trunc.append(float(v[1]))
                    occ.append(int(float(v[2])))
                    bbox.append([float(x) for x in v[4:8]])
                    dims.append([float(x) for x in v[8:11]])   # h, w, l
                    loc.append([float(x) for x in v[11:14]])
                    rot.append(float(v[14]))
            if names:
                info["annos"] = {
                    "name": np.asarray(names),
                    "truncated": np.asarray(trunc, np.float32),
                    "occluded": np.asarray(occ, np.int32),
                    "bbox": np.asarray(bbox, np.float32),
                    "gt_boxes_lidar": _cam_box_to_lidar(
                        np.asarray(loc, np.float32),
                        np.asarray(dims, np.float32),
                        np.asarray(rot, np.float32), R0, Tr),
                }
            else:
                info["annos"] = {"name": np.zeros(0, "<U10"),
                                 "gt_boxes_lidar": np.zeros((0, 7),
                                                            np.float32)}
        infos.append(info)
    with open(out_path, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {len(infos)} infos -> {out_path}")
    return infos


DB_INFO_DEFAULT = "dbinfos_train.pkl"


def db_info_path(cfg) -> str:
    """Where ``ObjectSample`` of ``cfg``'s train pipeline reads its GT
    database, relative to the data root (``DB_INFO_DEFAULT`` without an
    ``ObjectSample``)."""
    for t in cfg.data.get("train_pipeline", []):
        if t.get("type") == "ObjectSample":
            return t["db_info_path"]
    return DB_INFO_DEFAULT


def create_gt_database(config_path, out_dir, cfg_options=(),
                       with_image_crops=False):
    """Crop every GT object's points out of the train scenes: one
    ``gt_database/<scene>_<class>_<j>.bin`` under ``out_dir`` an object
    (float32, xyz relative to the box's (cx, cy, z bottom), as
    ``ObjectSample`` adds ``box[:3]`` back) and the records ``{class:
    [{"name", "path", "box3d_lidar", "num_points_in_gt", "difficulty",
    ["img_crop_path"]}]}`` at ``out_dir/db_info_path(cfg)``. Objects
    without a point are left out. With ``with_image_crops`` (and a
    camera-enabled dataset) each object's projected 2D box is cut out of
    the first view that sees it whole and saved as a PNG. Returns the
    records' path."""
    from ..config_file import build_model_config, load_config, \
        merge_cfg_options
    from ..data import box_np_ops
    from ..data.datasets import build_dataset

    cfg = merge_cfg_options(load_config(config_path), list(cfg_options))
    # each train scene once, with no pipeline but image loading: no
    # cbgs, no repeat, a scene without GT kept (not redrawn)
    data_cfg = dict(cfg.data, cbgs=False, repeat=1, train_pipeline=(
        [dict(type="LoadImageFromFile")] if with_image_crops else []))
    ds = build_dataset(data_cfg, cfg.class_names,
                       build_model_config(cfg).pc_range, "train",
                       filter_empty_gt=False)
    os.makedirs(os.path.join(out_dir, "gt_database"), exist_ok=True)
    db = {c: [] for c in cfg.class_names}
    for i in range(len(ds)):
        s = ds[i]
        pts, boxes, labels = s["points"], s["gt_boxes"], s["gt_labels"]
        if not len(boxes):
            continue
        inside = box_np_ops.points_in_rbbox(pts[:, :3], boxes[:, :7])
        crop_paths = [None] * len(boxes)
        if with_image_crops and s.get("images") is not None:
            crop_paths = _save_image_crops(
                s, boxes, labels, cfg.class_names, out_dir, i)
        for j in range(len(boxes)):
            obj = pts[inside[:, j]]
            if not len(obj):
                continue
            obj = obj.copy()
            obj[:, :3] -= boxes[j, :3]
            name = cfg.class_names[labels[j]]
            rel = f"gt_database/{i}_{name}_{j}.bin"
            obj.astype(np.float32).tofile(os.path.join(out_dir, rel))
            rec = {"name": name, "path": rel,
                   "box3d_lidar": boxes[j, :7].astype(np.float32),
                   "num_points_in_gt": int(len(obj)), "difficulty": -1}
            if crop_paths[j]:
                rec["img_crop_path"] = crop_paths[j]
            db[name].append(rec)
        if (i + 1) % 100 == 0:
            print(f"[{i + 1}/{len(ds)}]")
    out = os.path.join(out_dir, db_info_path(cfg))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(db, f)
    print(f"wrote {sum(len(v) for v in db.values())} objects -> {out}")
    return out


def _save_image_crops(sample, boxes, labels, class_names, out_dir, idx):
    """Project each GT box into the first view that sees all its corners
    in front of the camera and save its clipped 2D box as a PNG; returns
    a relative path (or None) a box."""
    from PIL import Image

    from ..data import box_np_ops

    imgs = sample["images"]
    l2is = np.asarray(sample["lidar2img"], np.float32)
    corners = box_np_ops.corners_3d(boxes[:, :7])
    hom = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    out = [None] * len(boxes)
    for v in range(len(imgs)):
        H, W = imgs[v].shape[:2]
        cp = hom @ l2is[v].T
        depth = cp[..., 2]
        vis = (depth > 0).all(-1)
        uv = cp[..., :2] / np.maximum(depth[..., None], 1e-5)
        bb = np.concatenate([uv.min(1), uv.max(1)], -1).astype(int)
        bb[:, 0::2] = np.clip(bb[:, 0::2], 0, W - 1)
        bb[:, 1::2] = np.clip(bb[:, 1::2], 0, H - 1)
        ok = vis & ((bb[:, 2:] - bb[:, :2]) > 1).all(-1)
        for j in np.nonzero(ok)[0]:
            if out[j] is not None:
                continue
            x0, y0, x1, y1 = bb[j]
            patch = np.clip(imgs[v][y0:y1, x0:x1], 0, 255)
            rel = f"gt_database/{idx}_{class_names[labels[j]]}_{j}.png"
            Image.fromarray(patch.astype(np.uint8)).save(
                os.path.join(out_dir, rel))
            out[j] = rel
    return out


def create_nuscenes_infos(root, version="v1.0-trainval", out_dir=None,
                          max_sweeps=10, train_scene_file=None,
                          val_scene_file=None):
    """nuScenes infos from the raw JSON tables under ``root`` (made
    absolute first): ``nuscenes_infos_{train,val}.pkl`` (``_test`` for a
    test version) in ``out_dir`` (default the root). Scene-name files
    pick the splits; without them every scene is train. Returns the
    train infos' path."""
    from ..data.nuscenes_converter import create_nuscenes_infos as convert

    root = os.path.abspath(root)
    return convert(root, version, out_dir or root, max_sweeps,
                   train_scene_file, val_scene_file)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Make the info pkls and the GT database of a dataset")
    sub = p.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kitti")
    k.add_argument("--root", required=True)
    k.add_argument("--split", default="train")
    g = sub.add_parser("gt_database")
    g.add_argument("config")
    g.add_argument("--out-dir", required=True)
    g.add_argument("--with-image-crops", action="store_true")
    g.add_argument("--cfg-options", nargs="*", default=[])
    n = sub.add_parser("nuscenes")
    n.add_argument("--root", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--out-dir", default=None)
    n.add_argument("--max-sweeps", type=int, default=10)
    n.add_argument("--train-scenes", default=None,
                   help="text file of scene names (one per line)")
    n.add_argument("--val-scenes", default=None)
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the path it wrote (the train infos' for
    ``nuscenes``)."""
    args = parse_args(argv)
    if args.cmd == "kitti":
        out = os.path.join(args.root, f"kitti_infos_{args.split}.pkl")
        create_kitti_infos(args.root, os.path.join(
            args.root, "ImageSets", f"{args.split}.txt"), out)
        return out
    if args.cmd == "gt_database":
        return create_gt_database(args.config, args.out_dir,
                                  args.cfg_options, args.with_image_crops)
    return create_nuscenes_infos(args.root, args.version, args.out_dir,
                                 args.max_sweeps, args.train_scenes,
                                 args.val_scenes)


if __name__ == "__main__":
    main()
