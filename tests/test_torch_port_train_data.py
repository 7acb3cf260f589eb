"""The port's train-time data path against the JAX package, on the CPU.

- ``data.box_np_ops``: the C++ ops of ``uni3detr_tpu_torch/native`` equal
  their numpy versions (``native=False``) and JAX's ``box_np_ops``; a
  failed g++ build raises.
- Every train-time transform of ``data.pipeline`` against JAX's, one
  ``np.random.default_rng(seed)`` each side, with ``box_type`` passed to
  both (Depth and LiDAR; 7- and 9-dim boxes; ``shift_height``): indices
  and masks equal, floats within FLOAT_ATOL (the same numpy calls on the
  same C++ source; observed equal). ``ObjectSample`` on a GT database
  written to ``tmp_path``, with 2D crops; the three image transforms.
- ``RepeatDataset`` / ``CBGSDataset`` indices, and the train split of
  every dataset type, sample by sample, under the same generators (JAX's
  unseeded ``default_rng(None)`` replaced in the test).
- The ``box_type_3d`` read: JAX's gives Depth for the KITTI car config;
  the port's flips KITTI in y and keeps every point in range.
- ``synthetic.write_sunrgbd_root``'s train split and
  ``synthetic.write_kitti_root`` (with its GT database) parse alike in
  both packages.
"""
import copy
import glob
import os
import pickle
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from uni3detr_tpu import config as jconfig
from uni3detr_tpu.data import box_np_ops as jbox
from uni3detr_tpu.data import datasets as jdatasets
from uni3detr_tpu.data import pipeline as jpipeline
from uni3detr_tpu_torch import config_file as tconfig
from uni3detr_tpu_torch import native
from uni3detr_tpu_torch.data import box_np_ops as tbox
from uni3detr_tpu_torch.data import datasets as tdatasets
from uni3detr_tpu_torch.data import pipeline as tpipeline
from uni3detr_tpu_torch.presets import PRESETS
from uni3detr_tpu_torch.synthetic import write_kitti_root, write_sunrgbd_root

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KITTI_CFG = os.path.join(ROOT, "configs/uni3detr/uni3detr_kitti_car.py")
SUNRGBD_CFG = os.path.join(ROOT, "configs/uni3detr/uni3detr_sunrgbd.py")
FLOAT_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """torch on two threads: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def assert_same(a, b, path="sample"):
    """Equal key by key: integer and bool arrays exactly, float arrays
    within FLOAT_ATOL (dtype and shape equal)."""
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
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _rand_boxes(rng, n, span=20.0, dim=7):
    b = np.zeros((n, dim), np.float32)
    b[:, :2] = rng.uniform(-span, span, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if dim > 7:
        b[:, 7:] = rng.uniform(-3, 3, (n, dim - 7))
    return b


def _points_with_members(rng, boxes, n=4000, C=4, span=22.0):
    """Uniform points plus 80 inside each box (so that a move shows)."""
    pts = rng.uniform(-span, span, (n, C)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, n)
    for i, b in enumerate(boxes[: n // 80]):
        m = slice(i * 80, (i + 1) * 80)
        pts[m, :3] = b[:3] + rng.uniform(-0.2, 0.2, (80, 3))
        pts[m, 2] += b[5] / 2
    return pts


# -- box ops: C++ vs numpy vs JAX ---------------------------------------------
@pytest.mark.parametrize("z_origin", ["bottom", "center"])
def test_points_in_rbbox_native_plain_and_jax(z_origin):
    rng = np.random.default_rng(0)
    boxes = _rand_boxes(rng, 37)
    pts = _points_with_members(rng, boxes, 5000)[:, :3]
    got = tbox.points_in_rbbox(pts, boxes, z_origin)
    assert got.any()
    np.testing.assert_array_equal(
        got, tbox.points_in_rbbox(pts, boxes, z_origin, native=False))
    np.testing.assert_array_equal(got, jbox.points_in_rbbox(pts, boxes,
                                                            z_origin))
    # > 512 boxes: the C++ per-box table on the heap
    many = _rand_boxes(rng, 600, span=50)
    np.testing.assert_array_equal(
        tbox.points_in_rbbox(pts, many, z_origin),
        tbox.points_in_rbbox(pts, many, z_origin, native=False))


def test_points_in_any_rbbox_native_plain_and_jax():
    rng = np.random.default_rng(1)
    boxes = _rand_boxes(rng, 20)
    pts = _points_with_members(rng, boxes, 3000, C=3)
    got = tbox.points_in_any_rbbox(pts, boxes)
    assert got.any() and not got.all()
    np.testing.assert_array_equal(
        got, tbox.points_in_any_rbbox(pts, boxes, native=False))
    np.testing.assert_array_equal(got, jbox.points_in_any_rbbox(pts, boxes))
    assert tbox.points_in_any_rbbox(pts, boxes[:0]).shape == (3000,)


def test_box_collision_native_plain_and_jax():
    rng = np.random.default_rng(2)
    a, b = _rand_boxes(rng, 60), _rand_boxes(rng, 45)
    got = tbox.box_collision_test(a, b)
    assert got.any() and not got.all()
    np.testing.assert_array_equal(
        got, tbox.box_collision_test(a, b, native=False))
    np.testing.assert_array_equal(got, jbox.box_collision_test(a, b))
    assert tbox.box_collision_test(a, a).diagonal().all()


@pytest.mark.parametrize("dim", [7, 9])
def test_object_noise_native_plain_and_jax(dim):
    """The rejection loop in place: the C++ loop against the numpy one
    (accepted trials equal; the moved boxes and points within the JAX
    package's own native-vs-numpy tolerances, float32 sums in another
    order) and against JAX's (equal)."""
    rng = np.random.default_rng(3)
    boxes0 = _rand_boxes(rng, 15, dim=dim)
    pts0 = _points_with_members(rng, boxes0)
    trans = rng.standard_normal((15, 20, 3)).astype(np.float32) * 0.8
    rots = rng.uniform(-0.6, 0.6, (15, 20)).astype(np.float32)
    runs = []
    for fn in (tbox.object_noise_,
               lambda *a: tbox.object_noise_(*a, native=False),
               jbox.object_noise_):
        p, b = pts0.copy(), boxes0.copy()
        runs.append((fn(p, b, trans, rots), p, b))
    (acc, p, b), (acc_np, p_np, b_np), (acc_j, p_j, b_j) = runs
    assert (acc == 0).any() and (acc > 0).any()   # some trials rejected
    np.testing.assert_array_equal(acc, acc_np)
    np.testing.assert_allclose(b, b_np, atol=1e-5)
    np.testing.assert_allclose(p, p_np, atol=1e-4)
    np.testing.assert_array_equal(acc, acc_j)
    np.testing.assert_array_equal(b, b_j)
    np.testing.assert_array_equal(p, p_j)
    assert (b[:, 7:] == boxes0[:, 7:]).all()   # velocities untouched
    with pytest.raises(ValueError, match="in place"):
        tbox.object_noise_(pts0.astype(np.float64), boxes0.copy(), trans,
                           rots)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback: a compiler that cannot run (``$CXX`` at a bad
    path), and a source that does not compile, raise with the compiler's
    words."""
    with monkeypatch.context() as m:
        m.setenv("CXX", str(tmp_path / "no-such-g++"))
        with pytest.raises(RuntimeError, match="cannot run"):
            native.build(out_dir=tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" void f( { }\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(src=bad, out_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))
    so = native.build(out_dir=tmp_path)     # the real source builds
    assert so.parent == tmp_path and so.exists()


def test_native_library_builds_under_build_dir():
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "uni3detr_tpu_torch")


# -- train-time transforms -------------------------------------------------------
def _sample(rng, n=3000, C=4, dim=7, G=5, span=4.0):
    boxes = _rand_boxes(rng, G, span=span, dim=dim)
    boxes[:, 3:6] *= 0.4
    pts = _points_with_members(rng, boxes, n, C, span=span + 1)
    return {"points": pts, "gt_boxes": boxes,
            "gt_labels": (np.arange(G) % 3).astype(np.int32),
            "uni_rot_aug": np.eye(3, dtype=np.float32), "meta": {}}


def _run_both(cfgs, sample, seed, box_type, ctx=None):
    ctx = dict(ctx or {}, box_type=box_type)
    ctx.setdefault("pc_range", (-4, -4, -2, 4, 4, 2))
    ctx.setdefault("class_names", ("a", "b", "c"))
    ctx.setdefault("data_root", "")
    outs = []
    for mod in (jpipeline, tpipeline):
        pipe = mod.build_pipeline(cfgs, ctx)
        outs.append(pipe(copy.deepcopy(sample), np.random.default_rng(seed)))
    return outs


POINT_CASES = {
    "flip-h": [dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5)],
    "flip-hv": [dict(type="UnifiedRandomFlip3D",
                     flip_ratio_bev_horizontal=0.5,
                     flip_ratio_bev_vertical=0.5)],
    "rot-scale": [dict(type="GlobalRotScaleTrans")],
    "rot-scale-trans-shift": [dict(type="UnifiedRotScaleTrans",
                                   rot_range=(-0.5, 0.5),
                                   scale_ratio_range=(0.85, 1.15),
                                   translation_std=(0.2, 0.2, 0.1),
                                   shift_height=True)],
    "object-range": [dict(type="ObjectRangeFilter",
                          point_cloud_range=(-2, -2, -2, 2, 2, 2))],
    "object-name": [dict(type="ObjectNameFilter", classes=["c", "a", "z"])],
    "shuffle": [dict(type="PointShuffle")],
    "noise": [dict(type="ObjectNoise", num_try=20,
                   translation_std=(0.5, 0.5, 0.2))],
    "kitti-chain": [dict(type="ObjectNoise", num_try=10),
                    dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5),
                    dict(type="GlobalRotScaleTrans"),
                    dict(type="PointsRangeFilter"),
                    dict(type="ObjectRangeFilter"),
                    dict(type="PointShuffle"),
                    dict(type="PointSample", num_points=1500)],
}


@pytest.mark.parametrize("box_type", ["Depth", "LiDAR"])
@pytest.mark.parametrize("dim", [7, 9])
@pytest.mark.parametrize("case", list(POINT_CASES))
def test_point_train_transforms_match_jax(case, dim, box_type):
    for seed in range(3):
        s = _sample(np.random.default_rng(seed), dim=dim)
        j, t = _run_both(POINT_CASES[case], s, seed, box_type)
        assert_same(t, j)


CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "*", "*.py")) if "_base_" not in p)


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_train_pipeline_builds(path):
    """Every transform a shipped config's ``train_pipeline`` names is in
    the port's registry and takes the config's arguments."""
    cfg = tconfig.load_config(os.path.join(ROOT, path))
    mc = tconfig.build_model_config(cfg)
    ctx = dict(pc_range=mc.pc_range, class_names=cfg.class_names,
               data_root=cfg.data.get("data_root", ""),
               box_type=tdatasets.box_type_of(cfg.data))
    pipe = tpipeline.build_pipeline(cfg.data["train_pipeline"], ctx)
    assert len(pipe.transforms) == len(cfg.data["train_pipeline"])


def test_flip_and_rotation_conventions():
    """Depth flips x (yaw -> pi - yaw), LiDAR flips y (yaw -> -yaw);
    ``uni_rot_aug`` accumulates the reflection; the velocity flips with
    its axis; a rotation turns velocities and scales the shift-height
    channel; ``meta.pcd_scale_factor`` records the scale."""
    s = _sample(np.random.default_rng(0), dim=9)
    flip = [dict(type="RandomFlip3D", flip_ratio_bev_horizontal=1.0)]
    for box_type, axis in (("Depth", 0), ("LiDAR", 1)):
        _, t = _run_both(flip, s, 0, box_type)
        np.testing.assert_array_equal(t["points"][:, axis],
                                      -s["points"][:, axis])
        np.testing.assert_array_equal(t["gt_boxes"][:, 7 + axis],
                                      -s["gt_boxes"][:, 7 + axis])
        want = np.pi - s["gt_boxes"][:, 6] if axis == 0 \
            else -s["gt_boxes"][:, 6]
        np.testing.assert_allclose(t["gt_boxes"][:, 6], want, atol=1e-6)
        assert t["uni_rot_aug"][axis, axis] == -1
    rot = [dict(type="GlobalRotScaleTrans", rot_range=(0.3, 0.3),
                scale_ratio_range=(1.1, 1.1), shift_height=True)]
    _, t = _run_both(rot, s, 0, "LiDAR")
    c, sn = np.cos(0.3), np.sin(0.3)
    v = s["gt_boxes"][:, 7:9]
    np.testing.assert_allclose(
        t["gt_boxes"][:, 7:9], (v @ np.array([[c, sn], [-sn, c]])) * 1.1,
        atol=1e-5)
    np.testing.assert_allclose(t["points"][:, 3], s["points"][:, 3] * 1.1,
                               atol=1e-6)
    assert t["meta"]["pcd_scale_factor"] == pytest.approx(1.1)


def test_object_noise_refuses_global_rotation():
    for mod in (jpipeline, tpipeline):
        with pytest.raises(NotImplementedError):
            mod.build_pipeline([dict(type="ObjectNoise",
                                     global_rot_range=(-0.1, 0.1))], {})


def _write_db(root, n_feat=4, dim=7):
    """Three 'a' objects (one with too few points, one of difficulty 2)
    and one 'b', each with points and an image crop."""
    from PIL import Image
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    rng = np.random.RandomState(0)
    db = {"a": [], "b": []}
    specs = [("a", 255, [2.0, 0, 0, 1.0, 1.0, 1.0, 0.0], 50, 0),
             ("a", 128, [3.0, 2.5, 0, 0.8, 0.8, 0.8, 0.3], 50, 0),
             ("a", 64, [-3.0, -3.0, 0, 0.8, 0.8, 0.8, 0.1], 3, 0),
             ("a", 32, [-3.0, 3.0, 0, 0.8, 0.8, 0.8, 0.2], 50, 2),
             ("b", 200, [0.5, -3.0, 0, 1.2, 0.6, 0.9, 1.0], 50, 0)]
    for j, (cls, color, box, npts, diff) in enumerate(specs):
        pts = rng.uniform(-0.4, 0.4, (npts, n_feat)).astype(np.float32)
        rel = f"gt_database/{j}_{cls}.bin"
        pts.tofile(os.path.join(root, rel))
        crel = f"gt_database/{j}_{cls}.png"
        Image.fromarray(np.full((8, 8, 3), color, np.uint8)).save(
            os.path.join(root, crel))
        db[cls].append({"name": cls, "path": rel,
                        "box3d_lidar": np.asarray(box[:7] + [0.0] * (dim - 7),
                                                  np.float32),
                        "num_points_in_gt": npts, "difficulty": diff,
                        "img_crop_path": crel})
    with open(os.path.join(root, "db.pkl"), "wb") as f:
        pickle.dump(db, f)


def _camera(sample):
    """A pinhole at the origin looking along +x over a 64x64 image."""
    sample["images"] = np.random.RandomState(5).uniform(
        0, 255, (1, 64, 64, 3)).astype(np.float32)
    K = np.array([[40.0, 0, 32], [0, 40.0, 32], [0, 0, 1]], np.float32)
    T = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = K @ T
    sample["lidar2img"] = P[None]
    return sample


@pytest.mark.parametrize("sample_2d", [False, True])
@pytest.mark.parametrize("dim", [7, 9])
def test_object_sample_matches_jax(tmp_path, dim, sample_2d):
    """The GT-database paste: quotas, the min-points and difficulty
    filters, collision rejection, background points inside pasted boxes
    dropped, extra box dims zero-padded, and with ``sample_2d`` the
    depth-ordered crop paste."""
    root = str(tmp_path)
    _write_db(root, dim=dim)
    cfgs = [dict(type="ObjectSample", db_info_path="db.pkl",
                 sample_groups=dict(a=4, b=2), min_points=dict(a=5),
                 difficulty=(0,), sample_2d=sample_2d)]
    ctx = dict(data_root=root, pc_range=(-5, -5, -3, 5, 5, 3))
    for seed in range(4):
        rng = np.random.default_rng(seed)
        s = _sample(rng, dim=dim, G=1, span=2.0)
        s["gt_boxes"][0, :7] = [4.0, -4.0, 0, 0.5, 0.5, 0.5, 0.0]
        if sample_2d:
            _camera(s)
        j, t = _run_both(cfgs, s, seed, "LiDAR", ctx)
        assert_same(t, j)
        # two 'a' pass the filters, the 'b' always fits: 1 + 2 + 1 boxes
        assert len(t["gt_boxes"]) == 4
        assert t["gt_boxes"].shape[1] == dim
        assert (t["gt_boxes"][1:, 7:] == 0).all()
        if sample_2d:
            assert not np.array_equal(t["images"], s["images"])


IMAGE_CASES = {
    "resize-crop-flip": [dict(type="ImageRandomResizeCropFlip",
                              flip_ratio=0.5, resize_scales=(0.8, 1.2),
                              crop_sizes=(40, 56))],
    "crop-eval": [dict(type="ImageRandomResizeCropFlip", flip_ratio=0.5,
                       crop_sizes=(40, 56), training=False)],
    "photometric": [dict(type="PhotoMetricDistortionMultiViewImage")],
    "gridmask": [dict(type="GridMask", prob=0.7)],
    "rgb-chain": [dict(type="PhotoMetricDistortion"),
                  dict(type="NormalizeImage"),
                  dict(type="PadImage", size=(64, 64)),
                  dict(type="GridMask", prob=0.7)],
}


@pytest.mark.parametrize("case", list(IMAGE_CASES))
def test_image_train_transforms_match_jax(case):
    rng = np.random.default_rng(11)
    s = _sample(rng)
    s["images"] = rng.uniform(0, 255, (2, 48, 64, 3)).astype(np.float32)
    s["lidar2img"] = np.broadcast_to(np.eye(4, dtype=np.float32),
                                     (2, 4, 4)).copy()
    outs = set()
    for seed in range(6):
        j, t = _run_both(IMAGE_CASES[case], s, seed, "Depth")
        assert_same(t, j)
        outs.add(t["images"].tobytes())
    # the draws change the images (the eval crop draws nothing)
    assert len(outs) == 1 if case == "crop-eval" else len(outs) > 1


# -- datasets -----------------------------------------------------------------------
class _Labelled:
    """A dataset of given per-sample label sets (CBGS's input)."""

    def __init__(self, cats, ncls):
        self.cats, self.class_names = cats, [str(c) for c in range(ncls)]

    def __len__(self):
        return len(self.cats)

    def get_cat_ids(self, i):
        return set(self.cats[i])

    def __getitem__(self, i):
        return i


def test_repeat_and_cbgs_indices_match_jax():
    rng = np.random.RandomState(0)
    cats = [set(rng.choice(5, rng.randint(0, 3), replace=False).tolist())
            for _ in range(40)]
    j = jdatasets.CBGSDataset(_Labelled(cats, 6))
    t = tdatasets.CBGSDataset(_Labelled(cats, 6))
    assert list(t.indices) == list(j.indices) and len(t) > 0
    jr, tr = jdatasets.RepeatDataset(j, 3), tdatasets.RepeatDataset(t, 3)
    assert len(tr) == len(jr) == 3 * len(t)
    assert [tr[i] for i in range(len(tr))] == [jr[i] for i in range(len(jr))]
    empty = tdatasets.CBGSDataset(_Labelled([set()] * 4, 2))
    assert list(empty.indices) == list(jdatasets.CBGSDataset(
        _Labelled([set()] * 4, 2)).indices) == [0, 1, 2, 3]


@contextmanager
def _seeded_default_rng(seed0):
    """``np.random.default_rng(None)`` (the JAX train split's per-sample
    generator) seeded seed0, seed0 + 1, ... call by call."""
    real = np.random.default_rng
    count = iter(range(seed0, seed0 + 10 ** 6))
    np.random.default_rng = lambda seed=None: real(
        next(count) if seed is None else seed)
    try:
        yield
    finally:
        np.random.default_rng = real


def _counting_rng(seed0):
    """The port's ``sample_rng``: seed0, seed0 + 1, ... call by call."""
    count = iter(range(seed0, seed0 + 10 ** 6))
    return lambda idx: np.random.default_rng(next(count))


def _scannet_root(root, n=3):
    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    infos = []
    for i in range(n):
        rng.uniform(-2, 4, (2500, 6)).astype(np.float32).tofile(
            os.path.join(root, f"points/{i:06d}.bin"))
        infos.append({"point_cloud": {"pts_path": f"points/{i:06d}.bin"},
                      "annos": {"gt_boxes_upright_depth": rng.uniform(
                          0, 2, (i + 1, 7)).astype(np.float32),
                          "name": ["a", "b", "c"][:i + 1],
                          "axis_align_matrix": np.eye(4)
                          + 0.05 * rng.randn(4, 4)}})
    with open(os.path.join(root, "scannet_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)


def _nuscenes_root(root, n=4):
    rng = np.random.RandomState(4)
    infos = []
    for i in range(n):
        lp = os.path.join(root, f"lidar{i}.bin")
        rng.uniform(-20, 20, (1200, 5)).astype(np.float32).tofile(lp)
        sp = os.path.join(root, f"sweep{i}.bin")
        rng.uniform(-20, 20, (700, 5)).astype(np.float32).tofile(sp)
        G = 4
        infos.append({
            "lidar_path": os.path.basename(lp), "token": f"tok{i}",
            "timestamp": 10 ** 6 * i, "sweeps": [{
                "data_path": sp, "timestamp": 10 ** 6 * i - 5e4,
                "sensor2lidar_rotation": np.eye(3),
                "sensor2lidar_translation": rng.randn(3)}],
            "gt_boxes": rng.uniform(-10, 10, (G, 7)),
            "gt_names": np.array(["car", "pedestrian", "barrier", "car"]
                                 if i % 2 else ["car"] * G),
            "gt_velocity": rng.randn(G, 2),
            "valid_flag": np.array([True, True, False, True])})
    with open(os.path.join(root, "nuscenes_infos_train.pkl"), "wb") as f:
        pickle.dump({"infos": infos, "metadata": {}}, f)


def _kitti(root):
    write_kitti_root(root, PRESETS["uni3detr_kitti_car"], 4, 2, n_db=12)


def _sunrgbd(root):
    cfg = tconfig.load_config(SUNRGBD_CFG)
    write_sunrgbd_root(root, PRESETS["uni3detr_sunrgbd"], cfg.class_names, 3,
                       num_points=3000, split="train")


_LIDAR_TRAIN = [dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5),
                dict(type="GlobalRotScaleTrans",
                     rot_range=(-0.3925, 0.3925)),
                dict(type="PointsRangeFilter"),
                dict(type="ObjectRangeFilter"),
                dict(type="PointShuffle"),
                dict(type="PointSample", num_points=4000)]
# kind -> (writer, data dict, class names, pc_range); the config files'
# train pipelines where they read no more than the writer puts on disk
TRAIN_SPLITS = {
    "sunrgbd": (_sunrgbd, "config", None, None),
    "kitti": (_kitti, "config", None, None),
    "scannet": (_scannet_root, dict(
        dataset_type="scannet", ann_train="scannet_infos_train.pkl",
        repeat=2, box_type_3d="Depth",
        train_pipeline=[dict(type="GlobalAlignment", rotation_axis=2),
                        dict(type="RandomFlip3D",
                             flip_ratio_bev_horizontal=0.5,
                             flip_ratio_bev_vertical=0.5),
                        dict(type="GlobalRotScaleTrans",
                             rot_range=(-0.087266, 0.087266),
                             scale_ratio_range=(1.0, 1.0)),
                        dict(type="PointsRangeFilter"),
                        dict(type="PointSample", num_points=2000)]),
        ("a", "b", "c"), (-3, -3, -2, 3, 3, 2)),
    "nuscenes": (_nuscenes_root, dict(
        dataset_type="nuscenes", ann_train="nuscenes_infos_train.pkl",
        load_dim=5, use_dim=(0, 1, 2, 3, 4), cbgs=True,
        box_type_3d="LiDAR",
        train_pipeline=[dict(type="LoadPointsFromMultiSweeps",
                             sweeps_num=10)] + _LIDAR_TRAIN),
        ("car", "pedestrian", "barrier"), (-15, -15, -5, 15, 15, 3)),
}


def _train_split(kind, root):
    writer, data, classes, pcr = TRAIN_SPLITS[kind]
    writer(root)
    if data == "config":
        cfg = tconfig.load_config(KITTI_CFG if kind == "kitti"
                                  else SUNRGBD_CFG)
        data, classes = dict(cfg.data), cfg.class_names
        pcr = PRESETS[cfg.preset].pc_range
    data = dict(data, data_root=root)
    # both packages in the config's frame (JAX reads ``box_type`` only)
    data["box_type"] = data["box_type_3d"]
    return data, classes, pcr


@pytest.mark.parametrize("kind", list(TRAIN_SPLITS))
def test_train_split_matches_jax(tmp_path, kind):
    """The train split (its pipeline, ``repeat`` / ``cbgs``) sample by
    sample under the same per-sample generators and global redraw
    generator; every sample keeps GT."""
    data, classes, pcr = _train_split(kind, str(tmp_path))
    jd = jdatasets.build_dataset(data, classes, pcr, "train")
    td = tdatasets.build_dataset(data, classes, pcr, "train",
                                 sample_rng=_counting_rng(100))
    assert type(td).__name__ == type(jd).__name__
    assert len(td) == len(jd) > 0
    wrapped = getattr(td, "ds", td)
    assert not wrapped.test_mode
    for i in range(len(jd)):
        np.random.seed(i)
        with _seeded_default_rng(100 + 1000 * i):
            j = jd[i]
        np.random.seed(i)
        wrapped.sample_rng = _counting_rng(100 + 1000 * i)
        t = td[i]
        assert_same(t, j)
        assert len(t["gt_labels"]) > 0
    if kind == "kitti":
        # ObjectSample pasted cars next to the scene's three
        assert max(len(td[i]["gt_labels"]) for i in range(len(td))) > 3


def test_synthetic_train_split_matches_jax():
    path = os.path.join(ROOT, "configs/uni3detr/uni3detr_synthetic_tiny.py")
    jc, tc = jconfig.load_config(path), tconfig.load_config(path)
    mc = tconfig.build_model_config(tc)
    data = dict(tc.data, repeat=2, cbgs=True)
    jd = jdatasets.build_dataset(data, jc.class_names, mc.pc_range, "train")
    td = tdatasets.build_dataset(data, tc.class_names, mc.pc_range, "train")
    assert type(td) is tdatasets.RepeatDataset and len(td) == len(jd) == 32
    for i in (0, 5, 17, 31):
        assert_same(td[i], jd[i])


# -- the box_type_3d read ---------------------------------------------------------
def test_box_type_3d_read():
    """(a) The JAX package reads ``box_type`` alone: Depth for the KITTI
    car config, which names its frame ``box_type_3d='LiDAR'`` (the
    defect). The port reads ``box_type_3d`` first."""
    jc, tc = jconfig.load_config(KITTI_CFG), tconfig.load_config(KITTI_CFG)
    assert "box_type" not in jc.data and jc.data["box_type_3d"] == "LiDAR"
    assert jc.data.get("box_type", "Depth") == "Depth"
    assert tdatasets.box_type_of(tc.data) == "LiDAR"
    assert tdatasets.box_type_of({"box_type": "LiDAR"}) == "LiDAR"
    assert tdatasets.box_type_of({}) == "Depth"


def test_kitti_forced_flip_keeps_points_in_range(tmp_path):
    """(b) The KITTI train pipeline under a forced horizontal flip: the
    port flips y (LiDAR), every point stays inside ``pc_range`` and yaw
    maps to -yaw; JAX's read flips x and sends every point out of range
    (x starts at 0)."""
    root = str(tmp_path)
    mc = PRESETS["uni3detr_kitti_car"]
    write_kitti_root(root, mc, 2, 0, n_db=2)
    cfg = tconfig.load_config(KITTI_CFG)
    data = dict(cfg.data, data_root=root, train_pipeline=[
        dict(type="RandomFlip3D", flip_ratio_bev_horizontal=1.0),
        dict(type="PointsRangeFilter")])
    with open(os.path.join(root, "kitti_infos_train.pkl"), "rb") as f:
        info = pickle.load(f)[0]
    raw = np.fromfile(os.path.join(root, info["point_cloud"]
                                   ["velodyne_path"]), np.float32)
    raw = raw.reshape(-1, 4)
    t = tdatasets.build_dataset(data, cfg.class_names, mc.pc_range,
                                "train")[0]
    assert len(t["points"]) == len(raw)
    np.testing.assert_array_equal(t["points"][:, 1], -raw[:, 1])
    np.testing.assert_array_equal(t["points"][:, 0], raw[:, 0])
    np.testing.assert_allclose(t["gt_boxes"][:, 6],
                               -info["annos"]["gt_boxes_lidar"][:, 6])
    jd = jdatasets.build_dataset(data, cfg.class_names, mc.pc_range,
                                 "train")
    assert len(jd[0]["points"]) == 0


def test_kitti_tta_flips_y():
    """(c) ``cli.test``'s TTA maps on the KITTI config's frame: the
    flipped view negates y and ``map_boxes_back`` undoes it."""
    from uni3detr_tpu_torch.train import tta as ttta
    box_type = tdatasets.box_type_of(tconfig.load_config(KITTI_CFG).data)
    aug = ttta.make_aug_grid(flips=(True,))[0]
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 40, (50, 4)).astype(np.float32)
    out = ttta.apply_aug_points(pts, aug, box_type)
    np.testing.assert_array_equal(out[:, 1], -pts[:, 1])
    np.testing.assert_array_equal(out[:, 0], pts[:, 0])
    boxes = torch.from_numpy(_rand_boxes(rng, 6))
    back = ttta.map_boxes_back(boxes, aug, box_type)
    np.testing.assert_array_equal(back[:, 1].numpy(), -boxes[:, 1].numpy())
    np.testing.assert_allclose(back[:, 6].numpy(), -boxes[:, 6].numpy())


def test_cli_test_passes_box_type_3d(tmp_path, monkeypatch):
    """``cli.test`` on the KITTI car config hands ``run_inference`` the
    config's LiDAR frame (the model and the loop replaced)."""
    from uni3detr_tpu_torch.cli import test as cli_test
    from uni3detr_tpu_torch.train import evaluator as tevaluator

    root = str(tmp_path)
    write_kitti_root(root, PRESETS["uni3detr_kitti_car"], 0, 1, n_db=1)
    seen = {}

    def fake_run(dataset, model, cfg, **kw):
        seen.update(kw)
        kw["stats"].update(scenes=1, wall_s=1.0, load_ms=[1.0],
                           stream_ms=[], done_s=[0.0], batches=1)
        return [], []

    monkeypatch.setattr(tevaluator, "run_inference", fake_run)
    monkeypatch.setattr(cli_test, "build_model", lambda *a, **k: None)
    cli_test.main([KITTI_CFG, "--device", "cpu", "--cfg-options",
                   f"data.data_root={root}"])
    assert seen["box_type"] == "LiDAR"


# -- the synthetic writers ---------------------------------------------------------
def test_written_kitti_root_matches_jax(tmp_path):
    """``write_kitti_root``: both splits parse alike in both packages
    (the val pipeline), and the GT database holds each car's points
    relative to its (cx, cy, z bottom), inside the box."""
    root = str(tmp_path)
    mc = PRESETS["uni3detr_kitti_car"]
    write_kitti_root(root, mc, 2, 2, n_db=5)
    cfg = tconfig.load_config(KITTI_CFG)
    for split in ("train", "val"):
        data = dict(cfg.data, data_root=root, box_type="LiDAR",
                    ann_val=f"kitti_infos_{split}.pkl")
        jd = jdatasets.build_dataset(data, cfg.class_names, mc.pc_range,
                                     "val")
        td = tdatasets.build_dataset(data, cfg.class_names, mc.pc_range,
                                     "val")
        assert len(td) == len(jd) == 2
        for i in range(2):
            assert_same(td[i], jd[i])
            assert_same(td._parse(td.infos[i]), jd._parse(jd.infos[i]))
            assert td[i]["points"].shape[1] == 4
            assert len(td[i]["gt_labels"]) == 3
    with open(os.path.join(root, "kitti_dbinfos_train.pkl"), "rb") as f:
        db = pickle.load(f)
    assert list(db) == ["Car"] and len(db["Car"]) == 5
    for info in db["Car"]:
        p = np.fromfile(os.path.join(root, info["path"]),
                        np.float32).reshape(-1, 4)
        assert len(p) == info["num_points_in_gt"] >= 5
        box = np.asarray(info["box3d_lidar"], np.float32)
        p[:, :3] += box[:3]
        assert tbox.points_in_rbbox(p[:, :3], box[None]).all()


def test_written_sunrgbd_train_split_matches_jax(tmp_path):
    """``write_sunrgbd_root(split="train")`` beside the val split of PR
    11's callers: other scenes, other files, both parse alike."""
    root = str(tmp_path)
    cfg = tconfig.load_config(SUNRGBD_CFG)
    mc = PRESETS["uni3detr_sunrgbd"]
    write_sunrgbd_root(root, mc, cfg.class_names, 2, num_points=3000,
                       split="train")
    write_sunrgbd_root(root, mc, cfg.class_names, 2, num_points=3000)
    parsed = {}
    for split in ("train", "val"):
        data = dict(cfg.data, data_root=root,
                    ann_val=f"sunrgbd_infos_{split}.pkl")
        jd = jdatasets.build_dataset(data, cfg.class_names, mc.pc_range,
                                     "val")
        td = tdatasets.build_dataset(data, cfg.class_names, mc.pc_range,
                                     "val")
        for i in range(2):
            assert_same(td[i], jd[i])
        parsed[split] = td._parse(td.infos[0])
    assert parsed["train"]["path"] != parsed["val"]["path"]
    assert not np.array_equal(parsed["train"]["gt_boxes"],
                              parsed["val"]["gt_boxes"])
