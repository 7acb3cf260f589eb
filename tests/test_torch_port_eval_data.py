"""The port's evaluation host side against the JAX package, on the CPU:
config files, the test-time pipeline, the datasets, batching, the BEV
NMS of the TTA merge, the TTA transforms, the nuScenes metrics, the
KITTI and nuScenes submission writers and the metric dispatch. Inputs
are made with numpy from a seed and fed to both.

Tolerances: configs, transforms, dataset samples, collated batches, keep
masks and merge orders equal exactly (the same numpy code on the same
arrays, and the same ``np.random.default_rng`` draws); the TTA point and
box maps within 1e-6 (the JAX package's float32 matmul against the
port's elementwise rotation, exact at rotation 0 and scale 1); metric
dicts within rtol 1e-6; submission files byte-equal.
"""
import copy
import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from uni3detr_tpu import config as jconfig
from uni3detr_tpu.data import datasets as jdatasets
from uni3detr_tpu.data import pipeline as jpipeline
from uni3detr_tpu.data.eval import kitti_submission as jsub
from uni3detr_tpu.data.eval import nuscenes_eval as jnus_eval
from uni3detr_tpu.data.eval import nuscenes_metrics as jnus
from uni3detr_tpu.ops.nms import nms_bev_rotated as j_nms_bev
from uni3detr_tpu.train import evaluator as jevaluator
from uni3detr_tpu.train import tta as jtta
from uni3detr_tpu_torch import config_file as tconfig
from uni3detr_tpu_torch.data import datasets as tdatasets
from uni3detr_tpu_torch.data import pipeline as tpipeline
from uni3detr_tpu_torch.eval import kitti_submission as tsub
from uni3detr_tpu_torch.eval import nuscenes_eval as tnus_eval
from uni3detr_tpu_torch.eval import nuscenes_metrics as tnus
from uni3detr_tpu_torch.ops import nms as tnms
from uni3detr_tpu_torch.train import evaluator as tevaluator
from uni3detr_tpu_torch.train import tta as ttta
from nms_cases import clustered_boxes, indoor_scenes, random_kitti_scenes

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "*", "*.py")) if "_base_" not in p)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """torch on two threads: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def assert_same(a, b, path="sample"):
    """Equal key by key, arrays exactly (dtype and shape too)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a.keys(),
                                                          b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                     b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


# -- config files ----------------------------------------------------------
@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_matches_jax(path):
    path = os.path.join(ROOT, path)
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    assert dict(tc) == dict(jc)
    jm, tm = jconfig.build_model_config(jc), tconfig.build_model_config(tc)
    assert type(tm).__name__ == type(jm).__name__
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)


def test_merge_cfg_options_matches_jax():
    path = os.path.join(ROOT, "configs/uni3detr/uni3detr_kitti_car.py")
    opts = ["model.score_thr=0.2", "data.samples_per_gpu=3",
            "data.data_root=/data/kitti", "new.key.deep=[1, (2, 3)]",
            "model.post_processing=none", "seed=bad value"]
    jc = jconfig.merge_cfg_options(jconfig.load_config(path), list(opts))
    tc = tconfig.merge_cfg_options(tconfig.load_config(path), list(opts))
    assert dict(tc) == dict(jc)
    assert dataclasses.asdict(tconfig.build_model_config(tc)) == \
        dataclasses.asdict(jconfig.build_model_config(jc))
    bad = tconfig.merge_cfg_options(tconfig.load_config(path),
                                    ["model.no_such_field=1"])
    with pytest.raises(KeyError, match="no_such_field"):
        tconfig.build_model_config(bad)
    bad = tconfig.merge_cfg_options(tconfig.load_config(path),
                                    ["model.post_processing=nope"])
    with pytest.raises(ValueError, match="nope"):
        tconfig.build_model_config(bad)


# -- test-time transforms ----------------------------------------------------
def _sample(rng, n=3000, C=6):
    pts = rng.uniform(-4, 4, (n, C)).astype(np.float32)
    boxes = rng.uniform(-2, 2, (3, 7)).astype(np.float32)
    return {"points": pts, "gt_boxes": boxes,
            "gt_labels": np.arange(3, dtype=np.int32),
            "uni_rot_aug": np.eye(3, dtype=np.float32), "meta": {}}


def _write_png(path, rng, hw=(24, 40)):
    from PIL import Image
    Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(path)


def _run_both(cfgs, sample, seed, ctx=None):
    ctx = ctx or dict(pc_range=(-3, -3, -2, 3, 3, 2), class_names=("a",),
                      data_root="", box_type="Depth")
    outs = []
    for mod in (jpipeline, tpipeline):
        pipe = mod.build_pipeline(cfgs, ctx)
        outs.append(pipe(copy.deepcopy(sample),
                         np.random.default_rng(seed)))
    return outs


@pytest.mark.parametrize("cfgs", [
    [dict(type="PointsRangeFilter")],
    [dict(type="PointsRangeFilter", point_cloud_range=(-1, -2, -3, 1, 2, 3))],
    [dict(type="PointSample", num_points=1000)],
    [dict(type="PointSample", num_points=5000)],
    [dict(type="GlobalAlignment", rotation_axis=2),
     dict(type="PointsRangeFilter"), dict(type="PointSample",
                                          num_points=777)],
], ids=["range", "range-explicit", "sample", "sample-fewer", "align"])
def test_point_transforms_match_jax(cfgs):
    rng = np.random.RandomState(0)
    s = _sample(rng)
    th = 0.3
    s["meta"]["axis_align_matrix"] = np.array(
        [[np.cos(th), -np.sin(th), 0, 0.5], [np.sin(th), np.cos(th), 0, -1],
         [0, 0, 1, 0.2], [0, 0, 0, 1]], np.float32)
    j, t = _run_both(cfgs, s, 3)
    assert_same(t, j)


@pytest.mark.parametrize("n_sweeps", [0, 3, 12])
def test_multisweep_loader_matches_jax(tmp_path, n_sweeps):
    """nuScenes sweeps: padding without sweeps, all sweeps, and a random
    choice of 10 of 12 (the rng's draw)."""
    rng = np.random.RandomState(1)
    s = _sample(rng, n=500, C=5)
    sweeps = []
    for i in range(n_sweeps):
        p = str(tmp_path / f"sweep{i}.bin")
        rng.uniform(-5, 5, (300, 5)).astype(np.float32).tofile(p)
        th = rng.uniform(-0.1, 0.1)
        sweeps.append({"data_path": p, "timestamp": 1000 - 50000 * i,
                       "sensor2lidar_rotation": [[np.cos(th), -np.sin(th),
                                                  0], [np.sin(th),
                                                       np.cos(th), 0],
                                                 [0, 0, 1]],
                       "sensor2lidar_translation": rng.randn(3).tolist()})
    s["meta"].update(sweeps=sweeps, timestamp=1000)
    j, t = _run_both([dict(type="LoadPointsFromMultiSweeps", sweeps_num=10,
                           use_dim=(0, 1, 2, 3, 4))], s, 5)
    assert_same(t, j)


def test_image_transforms_match_jax(tmp_path):
    """Image loading with camera sweeps (padded with the latest frame),
    normalisation, padding to a size and to a divisor, and a random
    rescale (cv2) that updates lidar2img."""
    rng = np.random.RandomState(2)
    s = _sample(rng, n=100)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"img{i}.png"))
        _write_png(paths[-1], rng)
    l2i = rng.randn(2, 4, 4).astype(np.float32)
    s["meta"].update(img_paths=paths[:2], lidar2img=l2i, timestamp=10,
                     cam_sweeps=[[{"data_path": paths[2], "timestamp": 4,
                                   "lidar2img": l2i[0] * 2}], []])
    for cfgs in ([dict(type="LoadMultiViewImageFromFiles", sweep_num=3),
                  dict(type="NormalizeMultiviewImage"),
                  dict(type="PadMultiViewImage", size_divisor=32),
                  dict(type="RandomScaleImageMultiViewImage",
                       scales=(0.5, 1.0, 1.5))],
                 [dict(type="LoadImageFromFile"),
                  dict(type="NormalizeImage"),
                  dict(type="PadImage", size=(20, 48)),
                  dict(type="ResizeImage", scales=(0.75,))]):
        for seed in range(3):
            j, t = _run_both(cfgs, s, seed)
            assert_same(t, j)


def test_unported_transform_raises():
    """Every transform name the JAX package registers is the port's
    (the train-time ones too); an unknown name raises a KeyError naming
    it."""
    assert set(tpipeline.TRANSFORMS) == set(jpipeline.TRANSFORMS)
    ctx = dict(pc_range=(0,) * 6, class_names=("a",))
    with pytest.raises(KeyError, match="NoSuchTransform"):
        tpipeline.build_pipeline([dict(type="NoSuchTransform")], ctx)


# -- datasets ----------------------------------------------------------------
def _indoor_root(root, kind, n=3):
    """sunrgbd (with camera: PNG + calib) or scannet
    (axis_align_matrix) infos and points."""
    rng = np.random.RandomState(len(kind))
    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    infos = []
    for i in range(n):
        rng.uniform(-2, 4, (2500, 6)).astype(np.float32).tofile(
            os.path.join(root, f"points/{i:06d}.bin"))
        G = i + 1
        info = {"point_cloud": {"pts_path": f"points/{i:06d}.bin"},
                "annos": {"gt_boxes_upright_depth": rng.uniform(
                    0, 2, (G, 7)).astype(np.float32),
                    "name": ["a", "b", "c"][:G]}}
        if kind == "sunrgbd":
            _write_png(os.path.join(root, f"image/{i:06d}.png"), rng)
            info["image"] = {"image_path": f"image/{i:06d}.png"}
            info["calib"] = {"K": rng.randn(3, 3).astype(np.float32),
                             "Rt": rng.randn(3, 3).astype(np.float32)}
        else:
            info["annos"]["axis_align_matrix"] = np.eye(4) + 0.1 * \
                rng.randn(4, 4)
        infos.append(info)
    with open(os.path.join(root, f"{kind}_infos_val.pkl"), "wb") as f:
        pickle.dump(infos, f)


def _kitti_root(root, n=3):
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    infos = []
    for i in range(n):
        rng.uniform(0, 40, (1500, 4)).astype(np.float32).tofile(
            os.path.join(root, f"velodyne/{i:06d}.bin"))
        infos.append({"point_cloud": {"velodyne_path":
                                      f"velodyne/{i:06d}.bin"},
                      "annos": {"name": ["Car", "DontCare", "Pedestrian",
                                         "Car"][:i + 2],
                                "gt_boxes_lidar": rng.uniform(
                                    0, 10, (i + 2, 7))}})
    with open(os.path.join(root, "kitti_infos_val.pkl"), "wb") as f:
        pickle.dump(infos, f)


def _nuscenes_root(root, n=2):
    """Two keyframes with 2 lidar sweeps each, attributes, velocities, an
    invalid box and two cameras with one camera sweep."""
    rng = np.random.RandomState(4)
    infos = []
    for i in range(n):
        lp = os.path.join(root, f"lidar{i}.bin")
        rng.uniform(-20, 20, (1200, 5)).astype(np.float32).tofile(lp)
        sweeps = []
        for k in range(2):
            sp = os.path.join(root, f"sweep{i}_{k}.bin")
            rng.uniform(-20, 20, (700, 5)).astype(np.float32).tofile(sp)
            sweeps.append({"data_path": sp, "timestamp": 10 ** 6 * i - 5e4,
                           "sensor2lidar_rotation": np.eye(3),
                           "sensor2lidar_translation": rng.randn(3)})
        cams, chains = {}, {}
        for c in ("CAM_FRONT", "CAM_BACK"):
            rec = lambda j: {"data_path": f"{c}_{i}_{j}.png",
                             "sensor2lidar_rotation": np.eye(3) + 0.05
                             * rng.randn(3, 3),
                             "sensor2lidar_translation": rng.randn(3),
                             "cam_intrinsic": np.array(
                                 [[300, 0, 20], [0, 300, 12], [0, 0, 1.0]]),
                             "timestamp": 10 ** 6 * i - 1e5 * j}
            cams[c] = rec(0)
            chains[c] = [rec(0), rec(1)]
            for j in (0, 1):
                _write_png(os.path.join(root, f"{c}_{i}_{j}.png"), rng)
        G = 4
        infos.append({
            "lidar_path": os.path.basename(lp), "token": f"tok{i}",
            "timestamp": 10 ** 6 * i, "sweeps": sweeps,
            "gt_boxes": rng.uniform(-10, 10, (G, 7)),
            "gt_names": np.array(["car", "pedestrian", "barrier", "car"]),
            "gt_velocity": np.where(rng.rand(G, 2) < 0.2, np.nan,
                                    rng.randn(G, 2)),
            "valid_flag": np.array([True, True, False, True]),
            "gt_attrs": np.array(["vehicle.moving", "pedestrian.standing",
                                  "", "vehicle.parked"]),
            "cams": cams, "cam_sweeps_info": chains})
    with open(os.path.join(root, "nuscenes_infos_val.pkl"), "wb") as f:
        pickle.dump({"infos": infos, "metadata": {}}, f)


DATASETS = {
    "sunrgbd": (_indoor_root, dict(
        dataset_type="sunrgbd", ann_val="sunrgbd_infos_val.pkl",
        shift_height=True, use_camera=True, load_dim=6, use_dim=(0, 1, 2),
        test_pipeline=[dict(type="LoadImageFromFile"),
                       dict(type="NormalizeImage"),
                       dict(type="PadImage", size=(32, 48)),
                       dict(type="PointsRangeFilter"),
                       dict(type="PointSample", num_points=2000)]),
        ("a", "b", "c")),
    "scannet": (_indoor_root, dict(
        dataset_type="scannet", ann_val="scannet_infos_val.pkl",
        test_pipeline=[dict(type="GlobalAlignment", rotation_axis=2),
                       dict(type="PointsRangeFilter"),
                       dict(type="PointSample", num_points=2000)]),
        ("a", "b", "c")),
    "kitti": (_kitti_root, dict(
        dataset_type="kitti", ann_val="kitti_infos_val.pkl", load_dim=4,
        use_dim=(0, 1, 2, 3), box_type="LiDAR",
        test_pipeline=[dict(type="PointsRangeFilter"),
                       dict(type="PointSample", num_points=1000)]),
        ("Car", "Pedestrian")),
    "nuscenes": (_nuscenes_root, dict(
        dataset_type="nuscenes", ann_val="nuscenes_infos_val.pkl",
        load_dim=5, use_dim=(0, 1, 2, 3, 4), use_camera=True,
        box_type="LiDAR",
        test_pipeline=[dict(type="LoadPointsFromMultiSweeps", sweeps_num=10),
                       dict(type="LoadMultiViewImageFromFiles", sweep_num=2),
                       dict(type="NormalizeMultiviewImage"),
                       dict(type="PointsRangeFilter"),
                       dict(type="PointSample", num_points=3000)]),
        ("car", "pedestrian", "barrier")),
}


@pytest.mark.parametrize("kind", list(DATASETS))
def test_dataset_matches_jax(tmp_path, kind):
    write, data, classes = DATASETS[kind]
    write(str(tmp_path), kind) if write is _indoor_root else \
        write(str(tmp_path))
    data = dict(data, data_root=str(tmp_path))
    pcr = (-3, -3, -2, 3, 3, 2) if kind != "kitti" and kind != "nuscenes" \
        else (0, -20, -3, 40, 20, 1)
    jd = jdatasets.build_dataset(data, classes, pcr, "val")
    td = tdatasets.build_dataset(data, classes, pcr, "val")
    assert len(td) == len(jd) > 0
    for i in range(len(jd)):
        assert_same(td[i], jd[i])
    assert_same(td.infos, jd.infos, "infos") if kind != "nuscenes" \
        else None
    jb, jm = jdatasets.collate_batch([jd[i] for i in range(len(jd))],
                                     3000, 8, 4, 10 if kind == "nuscenes"
                                     else 8)
    tb, tm = tdatasets.collate_batch([td[i] for i in range(len(td))],
                                     3000, 8, 4, 10 if kind == "nuscenes"
                                     else 8)
    assert_same(tb, jb, "batch")
    assert_same(tm, jm, "metas")


@pytest.mark.parametrize("camera", [False, True])
def test_written_sunrgbd_root_matches_jax(tmp_path, camera):
    """``synthetic.write_sunrgbd_root`` (the data root of the card's CLI
    runs) read through a shipped config's val pipeline: the port's
    dataset equals JAX's sample by sample, GT included."""
    from uni3detr_tpu_torch.presets import PRESETS
    from uni3detr_tpu_torch.synthetic import write_sunrgbd_root

    name = "ov_uni3detr_sunrgbd_mm" if camera else "uni3detr_sunrgbd"
    sub = "ov_uni3detr" if camera else "uni3detr"
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", sub,
                                           name + ".py"))
    write_sunrgbd_root(str(tmp_path), PRESETS[name], cfg.class_names, 2,
                       camera=camera, num_points=3000)
    data = dict(cfg.data, data_root=str(tmp_path))
    pcr = PRESETS[name].pc_range
    jd = jdatasets.build_dataset(data, cfg.class_names, pcr, "val")
    td = tdatasets.build_dataset(data, cfg.class_names, pcr, "val")
    assert len(td) == len(jd) == 2
    for i in range(2):
        assert_same(td[i], jd[i])
        assert len(td[i]["gt_labels"]) > 0
        assert ("images" in td[i]) == camera


@pytest.mark.parametrize("camera", [False, True])
def test_synthetic_dataset_and_collate_match_jax(camera):
    path = os.path.join(ROOT, "configs/ov_uni3detr/ov_uni3detr_synthetic_"
                        "tiny.py" if camera else
                        "configs/uni3detr/uni3detr_synthetic_tiny.py")
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    mc = tconfig.build_model_config(tc)
    jd = jdatasets.build_dataset(jc.data, jc.class_names, mc.pc_range, "val")
    td = tdatasets.build_dataset(tc.data, tc.class_names, mc.pc_range, "val")
    samples = []
    for i in range(3):
        assert_same(td[i], jd[i])
        samples.append(td[i])
    args = (mc.num_points, mc.max_gt, mc.in_point_features, mc.code_size)
    assert_same(tdatasets.collate_batch(samples, *args),
                jdatasets.collate_batch(samples, *args))
    # the train split (seeded per sample) equals JAX's too
    jd = jdatasets.build_dataset(jc.data, jc.class_names, mc.pc_range,
                                 "train")
    td = tdatasets.build_dataset(tc.data, tc.class_names, mc.pc_range,
                                 "train")
    for i in range(3):
        assert_same(td[i], jd[i])


# -- BEV NMS and the TTA merge -------------------------------------------------
def _jax_per_class_bev(boxes, scores, labels, valid, ncls, thr):
    keep = np.zeros(len(boxes), bool)
    for c in range(ncls):
        m = valid & (labels == c)
        if m.any():
            keep |= np.asarray(j_nms_bev(
                jnp.asarray(boxes), jnp.asarray(np.where(m, scores, 0.0)),
                jnp.asarray(m), thr)) & m
    return keep


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_bev_keep_plain_matches_jax(seed):
    """``nms_bev_keep`` on CPU tensors against JAX's ``nms_bev_rotated``
    once a class, on clustered boxes with tied scores and, lifted 3 m,
    their copies (one BEV footprint, no 3D overlap)."""
    b, s, l, v = clustered_boxes(seed, n=120, ncls=4, thr=0.1)
    up = b.copy()
    up[:, 2] += 3.0
    b, s, l, v = (np.concatenate(x) for x in ((b, up), (s, s), (l, l),
                                               (v, v)))
    want = _jax_per_class_bev(b, s, l, v, 4, 0.1)
    got = tnms.nms_bev_keep(*(torch.from_numpy(x)[None] for x in
                              (b, s, l, v)), 0.1, 4)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < v.sum() // 2


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_aug_detections_matches_jax(seed):
    """The batched merge as the evaluator runs it (``merge_aug_detections``
    on the views' (B, K) tensors, ``pack_batch`` / ``unpack_batch``, then
    ``select_merged`` a scene) against JAX's ``merge_aug_detections`` of
    each scene's valid rows: two scenes of three jittered views and one
    with no valid row; the second batch has no valid row at all."""
    from uni3detr_tpu_torch.eval.postprocess import pack_batch, unpack_batch

    rng = np.random.RandomState(seed)
    base, s, l, _ = clustered_boxes(seed, n=60, ncls=3, thr=0.1)
    views = []
    for view in range(4):
        bx = base[None] + rng.randn(2, 60, 7).astype(np.float32) * 0.02
        v = rng.rand(2, 60) < (0.8 if view < 3 else 0.0)
        views.append((bx, np.stack([s, s[::-1]]), np.stack([l, l[::-1]]), v))

    def merged(views, max_out):
        t = [tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in v)
             for v in views]
        *dets, keep = ttta.merge_aug_detections(t, 3, 0.1)
        host = pack_batch(*dets, keep=keep)
        return [ttta.select_merged(d, max_out) for d in
                unpack_batch(host.numpy(), 7, with_keep=True)]

    for max_out in (500, 40):
        got = merged(views, max_out)
        for b in range(2):
            want = jtta.merge_aug_detections(
                [{"boxes": bx[b][v[b]], "scores": sc[b][v[b]],
                  "labels": lb[b][v[b]]} for bx, sc, lb, v in views], 3,
                max_out=max_out)
            assert_same(got[b], want, f"merged[{b}]")
            assert 0 < len(want["scores"]) <= max_out
    empty = [(bx, sc, lb, np.zeros_like(v)) for bx, sc, lb, v in views[:2]]
    want = jtta.merge_aug_detections(
        [{"boxes": bx[0][:0], "scores": sc[0][:0], "labels": lb[0][:0]}
         for bx, sc, lb, _ in empty], 3)
    for got in merged(empty, 500):
        assert_same(got, want, "empty")


@pytest.mark.parametrize("box_type", ["Depth", "LiDAR"])
def test_tta_maps_match_jax(box_type):
    grid = ttta.make_aug_grid((0.0, 0.3, -1.2), (1.0, 1.1), (False, True))
    assert grid == jtta.make_aug_grid((0.0, 0.3, -1.2), (1.0, 1.1),
                                      (False, True))
    rng = np.random.RandomState(5)
    pts = rng.uniform(-3, 3, (2, 400, 4)).astype(np.float32)
    boxes = rng.uniform(-3, 3, (50, 9)).astype(np.float32)
    for aug in grid:
        exact = aug["rot"] == 0.0 and aug["scale"] == 1.0
        tol = dict(rtol=0, atol=0 if exact else 1e-6)
        np.testing.assert_allclose(
            ttta.apply_aug_points(pts, aug, box_type),
            jtta.apply_aug_points(pts, aug, box_type), **tol)
        for D in (7, 9):
            jb = jtta.map_boxes_back(boxes[:, :D], aug, box_type)
            got = ttta.map_boxes_back(torch.from_numpy(boxes[None, :, :D]),
                                      aug, box_type)[0].numpy()
            np.testing.assert_allclose(got, jb, **tol)


# -- metrics and writers -------------------------------------------------------
def _nus_scenes(seed, n=4, classes=3):
    rng = np.random.RandomState(seed)
    attrs = np.array(["vehicle.moving", "vehicle.parked", "",
                      "pedestrian.standing", "cycle.with_rider"])
    dets, gts = [], []
    for _ in range(n):
        G = rng.randint(0, 7)
        gb = np.concatenate([rng.uniform(-30, 30, (G, 2)),
                             rng.uniform(-2, 0, (G, 1)),
                             rng.uniform(0.5, 4, (G, 3)),
                             rng.uniform(-np.pi, np.pi, (G, 1)),
                             rng.uniform(-3, 3, (G, 2))], 1)
        gl = rng.randint(0, classes, G)
        D = G + rng.randint(0, 4)
        db = np.concatenate([gb, rng.uniform(-30, 30, (D - G, 9))])
        db[:, :2] += rng.randn(D, 2) * rng.choice([0.2, 1.5, 3.0])
        db[:, 3:6] = np.abs(db[:, 3:6]) + 0.3
        gts.append({"boxes": gb.astype(np.float32), "labels": gl,
                    "attrs": attrs[rng.randint(0, 5, G)]})
        dets.append({"boxes": db.astype(np.float32),
                     "labels": np.concatenate([gl, rng.randint(
                         0, classes, D - G)]),
                     "scores": np.round(rng.rand(D), 2).astype(np.float32)})
    return dets, gts


def _assert_metrics(t, j):
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_nuscenes_metrics_match_jax(seed):
    classes = ["car", "barrier", "traffic_cone"]
    dets, gts = _nus_scenes(seed)
    _assert_metrics(tnus.nuscenes_detection_metrics(dets, gts, classes),
                    jnus.nuscenes_detection_metrics(dets, gts, classes))
    plain = [{k: v for k, v in g.items() if k != "attrs"} for g in gts]
    _assert_metrics(tnus.nuscenes_detection_metrics(dets, plain, classes),
                    jnus.nuscenes_detection_metrics(dets, plain, classes))


def _nus_infos(n, rng):
    q = lambda: (lambda v: (v / np.linalg.norm(v)).tolist())(rng.randn(4))
    return [{"token": f"tok{i}", "lidar2ego_rotation": q(),
             "lidar2ego_translation": rng.randn(3).tolist(),
             "ego2global_rotation": q(),
             "ego2global_translation": (rng.randn(3) * 100).tolist()}
            for i in range(n)]


def test_nuscenes_submission_matches_jax(tmp_path):
    dets, _ = _nus_scenes(2)
    infos = _nus_infos(len(dets), np.random.RandomState(0))
    classes = ["car", "pedestrian", "barrier"]
    a = jnus_eval.format_results(dets, infos, classes,
                                 str(tmp_path / "j.json"), score_thr=0.2)
    b = tnus_eval.format_results(dets, infos, classes,
                                 str(tmp_path / "t.json"), score_thr=0.2)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(RuntimeError, match="nuscenes-devkit"):
        tnus_eval.nuscenes_official_eval(b, str(tmp_path), "v1.0-mini",
                                         "val")


def _kitti_calib(rng):
    Tr = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, 0.2],
                   [0, 0, 0, 1]]) + np.pad(rng.randn(3, 4) * 0.01,
                                            ((0, 1), (0, 0)))
    P2 = np.array([[720, 0, 610, 45], [0, 720, 175, 0.1], [0, 0, 1, 0.003]])
    R0 = np.eye(4)
    R0[:3, :3] += rng.randn(3, 3) * 0.005
    return {"P2": P2, "R0_rect": R0, "Tr_velo_to_cam": Tr}


def _kitti_infos(gts, rng):
    return [{"annos": {"name": list(g["names"]), "gt_boxes_lidar": g["boxes"],
                       "bbox": g["bbox"], "occluded": g["occluded"],
                       "truncated": g["truncated"], "alpha": g["alpha"]},
             "calib": _kitti_calib(rng),
             "image": {"image_shape": (375, 1242), "image_idx": 10 + i}}
            for i, g in enumerate(gts)]


def test_kitti_submission_matches_jax(tmp_path):
    gts, dets = random_kitti_scenes(3)
    infos = _kitti_infos(gts, np.random.RandomState(1))
    classes = ["Car", "Pedestrian", "Cyclist"]
    for det, info in zip(dets, infos):
        assert tsub.kitti_result_lines(det, info["calib"], classes,
                                       (375, 1242)) == \
            jsub.kitti_result_lines(det, info["calib"], classes, (375, 1242))
    n = jsub.write_kitti_results(dets, infos, classes, str(tmp_path / "j"))
    assert tsub.write_kitti_results(dets, infos, classes,
                                    str(tmp_path / "t")) == n == len(dets)
    for f in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


class _DS:
    def __init__(self, infos):
        self.infos = infos


def _evaluate_both(dets, gts, cfg, ds, tmp_path):
    logs = []
    j = jevaluator.evaluate(copy.deepcopy(dets), gts, cfg, ds,
                            out_prefix=str(tmp_path / "j"),
                            log=logs.append)
    t = tevaluator.evaluate(copy.deepcopy(dets), gts, cfg, ds,
                            out_prefix=str(tmp_path / "t"),
                            log=logs.append, device="cpu")
    return t, j


def test_evaluate_dispatch_matches_jax(tmp_path):
    """indoor (seen / unseen split), KITTI with infos (2D boxes, alpha,
    the label txts) and nuScenes (the submission JSON) dispatches."""
    gts, dets = indoor_scenes(0, ncls=4, n=2)
    cfg = tconfig.Config(class_names=("a", "b", "c", "d"),
                         seen_classes=("a", "c"),
                         data={"dataset_type": "sunrgbd"})
    _assert_metrics(*_evaluate_both(dets, gts, cfg, None, tmp_path))

    kg, kd = random_kitti_scenes(4, n=2)
    infos = _kitti_infos(kg, np.random.RandomState(2))
    cfg = tconfig.Config(class_names=("Car", "Pedestrian", "Cyclist"),
                         data={"dataset_type": "kitti"})
    t, j = _evaluate_both(kd, None, cfg, _DS(infos), tmp_path)
    _assert_metrics(t, j)
    assert any("aos" in k for k in t)
    for f in sorted(os.listdir(tmp_path / "j_kitti")):
        assert (tmp_path / "t_kitti" / f).read_bytes() == \
            (tmp_path / "j_kitti" / f).read_bytes()

    nd, ng = _nus_scenes(3)
    cfg = tconfig.Config(class_names=("car", "barrier", "traffic_cone"),
                         data={"dataset_type": "nuscenes"})
    ds = _DS(_nus_infos(len(nd), np.random.RandomState(3)))
    _assert_metrics(*_evaluate_both(nd, ng, cfg, ds, tmp_path))
    assert json.load(open(tmp_path / "t_nusc.json")) == \
        json.load(open(tmp_path / "j_nusc.json"))
    assert tevaluator.evaluate(nd, ng, cfg, ds, format_only=True,
                               out_prefix=str(tmp_path / "f"),
                               log=lambda *a: None, device="cpu") == {}
