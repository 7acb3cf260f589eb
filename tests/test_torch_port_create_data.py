"""The port's data preparation (``cli.create_data``,
``data.nuscenes_converter``) against the JAX package's, on the CPU.

The same raw roots go through both packages: JAX's own fixtures
(``test_data_io._write_kitti_fixture``,
``test_nuscenes_converter._write_fixture``, the crop root of
``test_object_sample.py``) and the port's raw writers
(``synthetic.write_kitti_raw`` with a non-identity calibration,
``synthetic.write_nuscenes_raw``). Infos must be equal key by key, arrays
bit-equal in value and dtype; GT databases byte-equal. The writers'
planted truth holds the converters to the geometry itself. The port's two
GT-database choices (the file at the config's ``db_info_path``; each
scene walked once, without CBGS, repeats or redraws) have their tests.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from uni3detr_tpu.cli import create_data as jcd
from uni3detr_tpu_torch import synthetic
from uni3detr_tpu_torch.cli import create_data as tcd
from uni3detr_tpu_torch.data import box_np_ops
from test_data_io import _write_kitti_fixture
from test_nuscenes_converter import _write_fixture as _write_nus_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_CONFIG = os.path.join(REPO, "configs/uni3detr/uni3detr_kitti_car.py")
TINY_CONFIG = os.path.join(REPO, "configs/uni3detr/uni3detr_synthetic_tiny.py")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def assert_same(a, b, where="info"):
    """Equal key by key; arrays equal in dtype, shape and every bit
    (NaN where NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype.kind in "fc":
            assert a.tobytes() == b.tobytes(), where
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), where


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _kitti_infos_both(root, split, tmp_path):
    split_file = os.path.join(root, "ImageSets", f"{split}.txt")
    jcd.create_kitti_infos(root, split_file, str(tmp_path / "j.pkl"))
    tcd.create_kitti_infos(root, split_file, str(tmp_path / "t.pkl"))
    return _load(tmp_path / "j.pkl"), _load(tmp_path / "t.pkl")


# -- KITTI ------------------------------------------------------------------

def test_kitti_infos_match_jax_on_jax_fixture(tmp_path):
    root = str(tmp_path / "kitti")
    _write_kitti_fixture(root)
    j, t = _kitti_infos_both(root, "train", tmp_path)
    assert_same(j, t)
    assert list(t[0]["annos"]["name"]) == ["Car", "DontCare"]


@pytest.mark.parametrize("split", ["train", "val"])
def test_kitti_infos_match_jax_on_raw_writer(tmp_path, split):
    root = str(tmp_path / "kitti")
    synthetic.write_kitti_raw(root, 2, 2, n_points=4096)
    j, t = _kitti_infos_both(root, split, tmp_path)
    assert len(t) == 2
    assert_same(j, t)


def test_kitti_calib_parse_equals_fromstring(tmp_path):
    """The port parses calib values with ``np.array(v.split(),
    float32)``; the JAX CLI's ``np.fromstring(v, sep=" ")`` gives the
    same bits on both calib files."""
    root = str(tmp_path / "kitti")
    synthetic.write_kitti_raw(root, 1, 0, n_points=1024)
    _write_kitti_fixture(str(tmp_path / "jax"))
    for path in (os.path.join(root, "training/calib/000000.txt"),
                 str(tmp_path / "jax/training/calib/000000.txt")):
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                v = line.split(":", 1)[1]
                a = np.array(v.split(), np.float32)
                b = np.fromstring(v, sep=" ", dtype=np.float32)
                assert a.tobytes() == b.tobytes()
        for x, y in zip(tcd._parse_kitti_calib(path),
                        jcd._parse_kitti_calib(path)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_kitti_raw_calib_is_not_identity():
    p2, r0, tr = synthetic.kitti_calib()
    assert np.abs(r0 - np.eye(3)).max() > 1e-3
    assert np.abs(tr[:, :3] - synthetic.KITTI_VELO_AXES).max() > 1e-3
    assert np.abs(tr[:, 3]).max() > 0.1


def test_kitti_infos_recover_planted_boxes(tmp_path):
    """Every Car within 1e-4 m and 1e-5 rad of its planted lidar box;
    the DontCare rows kept after the Cars."""
    root = str(tmp_path / "kitti")
    planted = synthetic.write_kitti_raw(root, 3, 0, n_points=4096)
    infos = tcd.create_kitti_infos(
        root, os.path.join(root, "ImageSets/train.txt"),
        str(tmp_path / "t.pkl"))
    for info in infos:
        want = planted[info["point_cloud"]["idx"]]
        names = info["annos"]["name"]
        n = len(want["boxes"])
        assert list(names) == ["Car"] * n + ["DontCare"] * want["dontcare"]
        got = info["annos"]["gt_boxes_lidar"][:n].astype(np.float64)
        assert np.abs(got[:, :6] - want["boxes"][:, :6]).max() < 1e-4
        dyaw = (got[:, 6] - want["boxes"][:, 6] + np.pi) % (2 * np.pi) \
            - np.pi
        assert np.abs(dyaw).max() < 1e-5
        assert (info["annos"]["bbox"][:n, 2:] >
                info["annos"]["bbox"][:n, :2]).all()


# -- nuScenes ---------------------------------------------------------------

def _nus_infos(pkg, root, version, out, **kw):
    os.makedirs(out, exist_ok=True)
    pkg.create_nuscenes_infos(root, version, out, **kw)
    return (_load(os.path.join(out, "nuscenes_infos_train.pkl")),
            _load(os.path.join(out, "nuscenes_infos_val.pkl")))


@pytest.mark.parametrize("max_sweeps,val", [(1, False), (10, False),
                                            (10, True)])
def test_nuscenes_infos_match_jax_on_jax_fixture(tmp_path, max_sweeps, val):
    root = str(tmp_path / "nus")
    version = _write_nus_fixture(root)
    kw = dict(max_sweeps=max_sweeps)
    if val:
        kw["val_scene_file"] = str(tmp_path / "val.txt")
        with open(kw["val_scene_file"], "w") as f:
            f.write("scene-0001\n")
    j = _nus_infos(jcd, root, version, str(tmp_path / "j"), **kw)
    t = _nus_infos(tcd, root, version, str(tmp_path / "t"), **kw)
    assert_same(j, t)
    assert len(t[1]["infos"]) == (2 if val else 0)


@pytest.fixture(scope="module")
def nus_raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nus_raw"))
    truth = synthetic.write_nuscenes_raw(root, n_points=512, anns=20)
    return root, truth


@pytest.mark.parametrize("max_sweeps", [1, 10])
def test_nuscenes_infos_match_jax_on_raw_writer(nus_raw, tmp_path,
                                                max_sweeps):
    root, _ = nus_raw
    kw = dict(max_sweeps=max_sweeps,
              val_scene_file=os.path.join(root, "val_scenes.txt"))
    j = _nus_infos(jcd, root, "v1.0-trainval", str(tmp_path / "j"), **kw)
    t = _nus_infos(tcd, root, "v1.0-trainval", str(tmp_path / "t"), **kw)
    assert_same(j, t)
    assert len(t[0]["infos"]) == len(t[1]["infos"]) == 4


def test_nuscenes_infos_recover_planted_truth(nus_raw, tmp_path):
    """Boxes within 1e-6 m (yaw 1e-6 rad), velocities within 1e-6 m/s,
    every sweep's transform the planted poses', valid_flag false exactly
    where both point counts are 0, the camera chains starting at the key
    frame itself (kept from the JAX package; the reference file is not
    here to check it)."""
    root, truth = nus_raw
    train, val = _nus_infos(tcd, root, "v1.0-trainval", str(tmp_path),
                            max_sweeps=10, val_scene_file=os.path.join(
                                root, "val_scenes.txt"))
    for split, scenes in ((train, {"scene-0001"}), (val, {"scene-0002"})):
        for info in split["infos"]:
            want = truth[info["token"]]
            assert want["scene"] in scenes
            assert os.path.isabs(info["lidar_path"])
            g = info["gt_boxes"]
            assert np.abs(g[:, :6] - want["boxes"][:, :6]).max() < 1e-6
            dyaw = (g[:, 6] - want["boxes"][:, 6] + np.pi) % (2 * np.pi) \
                - np.pi
            assert np.abs(dyaw).max() < 1e-6
            assert np.abs(info["gt_velocity"] - want["velocity"]).max() \
                < 1e-6
            np.testing.assert_array_equal(info["valid_flag"], want["valid"])
            assert not want["valid"].all()
            assert len(info["sweeps"]) == 10
            for sw, (tok, rot, trans) in zip(info["sweeps"],
                                              want["sweeps"]):
                assert sw["sample_data_token"] == tok
                assert np.abs(sw["sensor2lidar_rotation"] - rot).max() < 1e-9
                assert np.abs(sw["sensor2lidar_translation"]
                              - trans).max() < 1e-9
            assert len(info["cams"]) == 6
            for cam, chain in info["cam_sweeps_info"].items():
                assert chain[0]["sample_data_token"] == \
                    info["cams"][cam]["sample_data_token"]
            assert len(set(info["gt_names"])) == 10


def test_nuscenes_relative_root_made_absolute(tmp_path, monkeypatch):
    """A relative ``--root`` writes absolute paths (the dataset joins a
    relative one to ``data_root`` again)."""
    _write_nus_fixture(str(tmp_path / "nus"))
    monkeypatch.chdir(tmp_path)
    out = tcd.main(["nuscenes", "--root", "nus", "--version", "v1.0-mini",
                    "--max-sweeps", "2"])
    info = _load(out)["infos"][1]
    assert info["lidar_path"] == str(tmp_path / "nus/samples/lidar_1.bin")
    assert all(os.path.isabs(s["data_path"]) for s in info["sweeps"])


# -- the GT database --------------------------------------------------------

def _db_files(out, db):
    return {r["path"]: open(os.path.join(out, r["path"]), "rb").read()
            for recs in db.values() for r in recs}


def _kitti_root(tmp_path, n_train=3):
    root = str(tmp_path / "kitti")
    synthetic.write_kitti_raw(root, n_train, 1, n_points=8192)
    for split in ("train", "val"):
        tcd.main(["kitti", "--root", root, "--split", split])
    return root


def test_gt_database_matches_jax_on_kitti(tmp_path):
    """Every scene has GT and the config has no CBGS or repeat: JAX's
    database equals the port's record for record and byte for byte."""
    root = _kitti_root(tmp_path)
    opts = [f"data.data_root={root}"]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jcd.create_gt_database(KITTI_CONFIG, jout, opts)
    path = tcd.create_gt_database(KITTI_CONFIG, tout, opts)
    assert path == os.path.join(tout, "kitti_dbinfos_train.pkl")
    jdb, tdb = _load(os.path.join(jout, "dbinfos_train.pkl")), _load(path)
    assert_same(jdb, tdb, "db")
    assert len(tdb["Car"]) >= 3 * 8
    assert _db_files(jout, jdb) == _db_files(tout, tdb)


def test_gt_database_object_points_are_points_in_box(tmp_path):
    """Each object's count is ``points_in_rbbox``'s for its box in its
    scene, and its points are the scene's inside the box, less
    ``box[:3]``."""
    root = _kitti_root(tmp_path, n_train=2)
    path = tcd.main(["gt_database", KITTI_CONFIG, "--out-dir", root,
                     "--cfg-options", f"data.data_root={root}"])
    db = _load(path)
    infos = _load(os.path.join(root, "kitti_infos_train.pkl"))
    for rec in db["Car"]:
        scene, _, j = rec["path"].split("/")[1][:-4].split("_")
        info = infos[int(scene)]
        pts = np.fromfile(os.path.join(
            root, info["point_cloud"]["velodyne_path"]),
            np.float32).reshape(-1, 4)
        box = info["annos"]["gt_boxes_lidar"][int(j)]
        inside = box_np_ops.points_in_rbbox(pts[:, :3], box[None])[:, 0]
        obj = np.fromfile(os.path.join(root, rec["path"]),
                          np.float32).reshape(-1, 4)
        assert rec["num_points_in_gt"] == inside.sum() == len(obj)
        np.testing.assert_array_equal(obj[:, :3], pts[inside, :3] - box[:3])
        np.testing.assert_array_equal(obj[:, 3], pts[inside, 3])


def _crop_root(root):
    """The root of ``test_object_sample.py::
    test_gt_database_with_crops_roundtrip`` (two SUN RGB-D scenes with an
    image each) and its config."""
    from PIL import Image
    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    rng = np.random.RandomState(0)
    infos = []
    for i in range(2):
        pts = np.concatenate([
            rng.uniform(-0.3, 0.3, (100, 3)) + [0.0, 1.0, 0.0],
            rng.uniform(-1.5, 1.5, (200, 3))]).astype(np.float32)
        pts6 = np.concatenate(
            [pts, np.zeros((len(pts), 3), np.float32)], 1)
        pts6.tofile(os.path.join(root, f"points/{i:06d}.bin"))
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"image/{i:06d}.jpg"))
        infos.append({
            "pts_path": f"points/{i:06d}.bin",
            "image": {"image_path": f"image/{i:06d}.jpg",
                      "image_shape": (32, 32)},
            "calib": {"K": np.array([[20, 0, 16], [0, 20, 16], [0, 0, 1]],
                                    np.float32),
                      "Rt": np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]],
                                     np.float32)},
            "annos": {
                "gt_boxes_upright_depth": np.array(
                    [[0.0, 1.0, -0.3, 0.6, 0.6, 0.6, 0.0]], np.float32),
                "name": ["a"],
            },
        })
    with open(os.path.join(root, "sunrgbd_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)
    cfg_py = os.path.join(root, "cfg.py")
    with open(cfg_py, "w") as f:
        f.write(
            "preset = 'uni3detr_tiny_synthetic'\n"
            "model = dict(num_classes=1)\n"
            "class_names = ['a']\n"
            f"data = dict(dataset_type='sunrgbd', data_root={root!r},\n"
            "  ann_train='sunrgbd_infos_train.pkl',\n"
            "  ann_val='sunrgbd_infos_train.pkl', use_camera=True,\n"
            "  load_dim=6, use_dim=(0, 1, 2), train_pipeline=[],\n"
            "  test_pipeline=[])\n")
    return cfg_py


@pytest.mark.parametrize("crops", [False, True])
def test_gt_database_matches_jax_with_and_without_crops(tmp_path, crops):
    cfg_py = _crop_root(str(tmp_path / "root"))
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jcd.create_gt_database(cfg_py, jout, with_image_crops=crops)
    path = tcd.create_gt_database(cfg_py, tout, with_image_crops=crops)
    assert path == os.path.join(tout, tcd.DB_INFO_DEFAULT)
    jdb, tdb = _load(os.path.join(jout, "dbinfos_train.pkl")), _load(path)
    assert_same(jdb, tdb, "db")
    assert len(tdb["a"]) == 2
    assert all(("img_crop_path" in r) == crops for r in tdb["a"])
    files = _db_files(tout, tdb)
    assert files == _db_files(jout, jdb)
    if crops:
        for r in tdb["a"]:
            with open(os.path.join(tout, r["img_crop_path"]), "rb") as a, \
                    open(os.path.join(jout, r["img_crop_path"]), "rb") as b:
                assert a.read() == b.read()


def test_gt_database_matches_jax_on_synthetic_config(tmp_path):
    """The synthetic tiny config (no ObjectSample, no repeat): JAX's
    ``dbinfos_train.pkl`` and the port's are equal."""
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    jcd.create_gt_database(TINY_CONFIG, jout)
    path = tcd.create_gt_database(TINY_CONFIG, tout)
    jdb, tdb = _load(os.path.join(jout, "dbinfos_train.pkl")), _load(path)
    assert_same(jdb, tdb, "db")
    assert _db_files(jout, jdb) == _db_files(tout, tdb)


def test_gt_database_lands_at_db_info_path(tmp_path):
    """The port writes where the config's ObjectSample reads
    (``kitti_dbinfos_train.pkl``), and the train pipeline draws from it;
    the JAX CLI writes ``dbinfos_train.pkl`` whatever the config says."""
    from uni3detr_tpu_torch.config_file import (build_model_config,
                                                load_config,
                                                merge_cfg_options)
    from uni3detr_tpu_torch.data.datasets import build_dataset
    root = _kitti_root(tmp_path, n_train=2)
    cfg = merge_cfg_options(load_config(KITTI_CONFIG),
                            [f"data.data_root={root}"])
    assert tcd.db_info_path(cfg) == "kitti_dbinfos_train.pkl"
    assert tcd.db_info_path(load_config(TINY_CONFIG)) == "dbinfos_train.pkl"
    tcd.create_gt_database(KITTI_CONFIG, root, [f"data.data_root={root}"])
    assert os.path.exists(os.path.join(root, "kitti_dbinfos_train.pkl"))
    assert not os.path.exists(os.path.join(root, "dbinfos_train.pkl"))
    ds = build_dataset(cfg.data, cfg.class_names,
                       build_model_config(cfg).pc_range, "train",
                       sample_rng=lambda i: np.random.default_rng(i))
    sample = ds.pipeline.transforms[0](ds.load_sample(0),
                                       np.random.default_rng(0))
    assert len(sample["gt_boxes"]) > len(ds.load_sample(0)["gt_boxes"])


def test_gt_database_walks_each_scene_once(tmp_path):
    """Under ``cbgs=True`` and ``repeat=2`` with a scene without GT (only
    DontCare rows): every object once, each from its own scene's points
    (the JAX CLI walks the resampled split, and redraws the scene
    without GT from a random one under its index)."""
    root = str(tmp_path / "kitti")
    synthetic.write_kitti_raw(root, 3, 0, n_points=8192)
    with open(os.path.join(root, "training/label_2/000001.txt"), "w") as f:
        f.write("DontCare -1 -1 -10 0 0 50 50 -1 -1 -1 -1000 -1000 -1000 "
                "-10\n")
    tcd.main(["kitti", "--root", root, "--split", "train"])
    infos = _load(os.path.join(root, "kitti_infos_train.pkl"))
    opts = [f"data.data_root={root}", "data.cbgs=True", "data.repeat=2"]
    db = _load(tcd.create_gt_database(KITTI_CONFIG, str(tmp_path / "t"),
                                      opts))
    want = []
    for i, info in enumerate(infos):
        pts = np.fromfile(os.path.join(
            root, info["point_cloud"]["velodyne_path"]),
            np.float32).reshape(-1, 4)
        boxes = info["annos"]["gt_boxes_lidar"][
            info["annos"]["name"] == "Car"]
        inside = box_np_ops.points_in_rbbox(pts[:, :3], boxes)
        want += [(f"gt_database/{i}_Car_{j}.bin", int(inside[:, j].sum()))
                 for j in range(len(boxes)) if inside[:, j].any()]
    got = [(r["path"], r["num_points_in_gt"]) for r in db["Car"]]
    assert got == want
    assert not any(p.startswith("gt_database/1_") for p, _ in got)


# -- the CLI ----------------------------------------------------------------

def test_create_data_cli_runs(tmp_path):
    """``python -m uni3detr_tpu_torch.cli.create_data`` for each
    subcommand."""
    kroot = str(tmp_path / "kitti")
    synthetic.write_kitti_raw(kroot, 2, 1, n_points=4096)
    nroot = str(tmp_path / "nus")
    synthetic.write_nuscenes_raw(nroot, n_scenes=2, key_frames=2,
                                 n_points=256, anns=10, max_sweeps=2)
    for argv in (["kitti", "--root", kroot],
                 ["kitti", "--root", kroot, "--split", "val"],
                 ["gt_database", KITTI_CONFIG, "--out-dir", kroot,
                  "--cfg-options", f"data.data_root={kroot}"],
                 ["nuscenes", "--root", nroot, "--max-sweeps", "2",
                  "--val-scenes", os.path.join(nroot, "val_scenes.txt")]):
        r = subprocess.run(
            [sys.executable, "-m", "uni3detr_tpu_torch.cli.create_data",
             *argv], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl"):
        assert os.path.exists(os.path.join(kroot, name))
    assert len(_load(os.path.join(nroot, "nuscenes_infos_val.pkl"))[
        "infos"]) == 2
