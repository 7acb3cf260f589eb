"""nuScenes info-pkl converter without the devkit (the port's copy of
``uni3detr_tpu/data/nuscenes_converter.py``, numpy only, the same
arithmetic in fp64 and in the same order, so both write equal infos).

Writes the reference converter's schema
(extra_tools/data_converter/nuscenes_converter.py:148-305) per key frame:
``lidar_path``, ``token``, up to ``max_sweeps`` lidar ``sweeps`` (the
chain starts at the key frame's predecessor), 6 ``cams`` with
``cam_intrinsic`` and sensor2lidar poses, per-camera ``cam_sweeps_info``
chains (these start at the key frame itself), the ego and lidar pose
records, ``gt_boxes`` in the lidar frame with sizes in (l, w, h) order
(mmdet3d >= 1.0), ``gt_names``, ``gt_velocity`` (a global central
difference over the annotation chain, rotated into the lidar frame),
``gt_attrs``, ``num_lidar_pts`` / ``num_radar_pts`` and ``valid_flag``.

The raw release is a set of plain JSON tables; :class:`NuScenesTables`
indexes them with json + numpy (the quaternion algebra inline). The
paths in the infos are ``os.path.join(root, filename)``: absolute only
when ``root`` is, so ``cli.create_data nuscenes`` makes the root absolute
first.
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

CAMERA_TYPES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def quat_to_rotmat(q):
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)]], np.float64)


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw)


def quat_inv(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def quat_yaw(q):
    """Yaw of the rotated x-axis projected to the xy-plane (matches
    pyquaternion yaw_pitch_roll[0] for the yaw-dominant boxes here)."""
    rot = quat_to_rotmat(q)
    v = rot @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


class NuScenesTables:
    """Indexed loader over the raw nuScenes JSON tables."""

    TABLES = ("scene", "sample", "sample_data", "sample_annotation",
              "calibrated_sensor", "ego_pose", "sensor", "instance",
              "category", "log")
    OPTIONAL_TABLES = ("attribute",)

    def __init__(self, root, version):
        self.root = root
        self.version = version
        tdir = os.path.join(root, version)
        self._t = {}
        for name in self.TABLES + self.OPTIONAL_TABLES:
            path = os.path.join(tdir, f"{name}.json")
            if name in self.OPTIONAL_TABLES and not os.path.exists(path):
                self._t[name] = {}
                continue
            with open(path) as f:
                rows = json.load(f)
            self._t[name] = {r["token"]: r for r in rows}
        # sample -> its sample_data / annotations
        self._sample_data_by_sample = {}
        for sd in self._t["sample_data"].values():
            if sd.get("is_key_frame"):
                sensor = self.get(
                    "sensor",
                    self.get("calibrated_sensor",
                             sd["calibrated_sensor_token"])["sensor_token"])
                self._sample_data_by_sample.setdefault(
                    sd["sample_token"], {})[sensor["channel"]] = sd["token"]
        self._anns_by_sample = {}
        for a in self._t["sample_annotation"].values():
            self._anns_by_sample.setdefault(
                a["sample_token"], []).append(a["token"])

    def get(self, table, token):
        return self._t[table][token]

    def rows(self, table):
        return list(self._t[table].values())

    def sample_data_token(self, sample_token, channel):
        return self._sample_data_by_sample[sample_token][channel]

    def data_path(self, sd_token):
        return os.path.join(self.root,
                            self.get("sample_data", sd_token)["filename"])

    def ann_tokens(self, sample_token):
        return self._anns_by_sample.get(sample_token, [])

    def category_name(self, ann):
        inst = self.get("instance", ann["instance_token"])
        return self.get("category", inst["category_token"])["name"]

    def attribute_name(self, ann):
        """GT attribute name, '' when the annotation carries none
        (devkit convention: at most one attribute per annotation)."""
        toks = ann.get("attribute_tokens", [])
        if not toks or not self._t["attribute"]:
            return ""
        return self.get("attribute", toks[0])["name"]

    def box_in_sensor_frame(self, ann, sd_token):
        """Annotation box (global frame) -> the sample_data's sensor
        frame; returns (center(3), wlh(3), yaw). Mirrors devkit
        get_sample_data: translate/rotate by ego pose then calibrated
        sensor, both inverse."""
        sd = self.get("sample_data", sd_token)
        pose = self.get("ego_pose", sd["ego_pose_token"])
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        ctr = np.asarray(ann["translation"], np.float64)
        q = tuple(ann["rotation"])
        ctr = quat_to_rotmat(quat_inv(pose["rotation"])) @ (
            ctr - np.asarray(pose["translation"]))
        q = quat_mul(quat_inv(pose["rotation"]), q)
        ctr = quat_to_rotmat(quat_inv(cs["rotation"])) @ (
            ctr - np.asarray(cs["translation"]))
        q = quat_mul(quat_inv(cs["rotation"]), q)
        return ctr, np.asarray(ann["size"], np.float64), quat_yaw(q)

    def box_velocity(self, ann_token, max_time_diff=1.5):
        """Global-frame velocity by central difference over the
        annotation chain (devkit box_velocity semantics)."""
        ann = self.get("sample_annotation", ann_token)
        has_prev = bool(ann["prev"])
        has_next = bool(ann["next"])
        if not has_prev and not has_next:
            return np.full(3, np.nan)
        first = self.get("sample_annotation",
                         ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation",
                        ann["next"]) if has_next else ann
        pos_f = np.asarray(first["translation"], np.float64)
        pos_l = np.asarray(last["translation"], np.float64)
        t_f = self.get("sample", first["sample_token"])["timestamp"] / 1e6
        t_l = self.get("sample", last["sample_token"])["timestamp"] / 1e6
        t_c = self.get("sample", ann["sample_token"])["timestamp"] / 1e6
        if max(abs(t_c - t_f), abs(t_l - t_c)) > max_time_diff:
            return np.full(3, np.nan)
        return (pos_l - pos_f) / max(t_l - t_f, 1e-6)


def obtain_sensor2top(nusc: NuScenesTables, sd_token, l2e_t, l2e_r_mat,
                      e2g_t, e2g_r_mat, sensor_type="lidar"):
    """RT from a (possibly non-keyframe) sensor reading to the key
    frame's top lidar (reference nuscenes_converter.py:307-365):
    sweep -> ego -> global -> ego' -> lidar; points map as
    ``pts @ R.T + T``."""
    sd = nusc.get("sample_data", sd_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd["ego_pose_token"])
    sweep = {
        "data_path": os.path.join(nusc.root, sd["filename"]),
        "type": sensor_type,
        "sample_data_token": sd_token,
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd["timestamp"],
    }
    l2e_r_s_mat = quat_to_rotmat(cs["rotation"])
    e2g_r_s_mat = quat_to_rotmat(pose["rotation"])
    l2e_t_s = np.asarray(cs["translation"], np.float64)
    e2g_t_s = np.asarray(pose["translation"], np.float64)
    inv = np.linalg.inv
    R = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ (
        inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
    T = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ (
        inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
    T -= (np.asarray(e2g_t) @ (inv(e2g_r_mat).T @ inv(l2e_r_mat).T)
          + np.asarray(l2e_t) @ inv(l2e_r_mat).T)
    sweep["sensor2lidar_rotation"] = R.T
    sweep["sensor2lidar_translation"] = T
    return sweep


def fill_trainval_infos(nusc: NuScenesTables, train_scenes, val_scenes,
                        test=False, max_sweeps=10):
    """train_scenes/val_scenes: sets of scene *names*. Returns
    (train_infos, val_infos) in the reference schema."""
    train_infos, val_infos = [], []
    samples = sorted(nusc.rows("sample"), key=lambda s: s["timestamp"])
    for sample in samples:
        scene = nusc.get("scene", sample["scene_token"])
        in_train = scene["name"] in train_scenes
        in_val = scene["name"] in val_scenes
        if not (in_train or in_val):
            continue
        lidar_token = nusc.sample_data_token(sample["token"], "LIDAR_TOP")
        sd = nusc.get("sample_data", lidar_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        info = {
            "lidar_path": nusc.data_path(lidar_token),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
        }
        l2e_t, e2g_t = cs["translation"], pose["translation"]
        l2e_r_mat = quat_to_rotmat(cs["rotation"])
        e2g_r_mat = quat_to_rotmat(pose["rotation"])

        for cam in CAMERA_TYPES:
            try:
                cam_token = nusc.sample_data_token(sample["token"], cam)
            except KeyError:
                continue
            cam_info = obtain_sensor2top(nusc, cam_token, l2e_t, l2e_r_mat,
                                         e2g_t, e2g_r_mat, cam)
            cam_cs = nusc.get(
                "calibrated_sensor",
                nusc.get("sample_data",
                         cam_token)["calibrated_sensor_token"])
            cam_info["cam_intrinsic"] = np.asarray(
                cam_cs["camera_intrinsic"], np.float64)
            info["cams"][cam] = cam_info

        # lidar sweeps: walk the prev chain (:218-231)
        rec = sd
        sweeps = []
        while len(sweeps) < max_sweeps and rec["prev"]:
            sweeps.append(obtain_sensor2top(
                nusc, rec["prev"], l2e_t, l2e_r_mat, e2g_t, e2g_r_mat,
                "lidar"))
            rec = nusc.get("sample_data", rec["prev"])
        info["sweeps"] = sweeps

        # camera sweeps (:233-258)
        info["cam_sweeps_info"] = {}
        for cam in info["cams"]:
            rec = nusc.get("sample_data",
                           nusc.sample_data_token(sample["token"], cam))
            chain = []
            while len(chain) < max_sweeps and rec["prev"]:
                cam_info = obtain_sensor2top(
                    nusc, rec["token"], l2e_t, l2e_r_mat, e2g_t,
                    e2g_r_mat, cam)
                cam_cs = nusc.get("calibrated_sensor",
                                  rec["calibrated_sensor_token"])
                cam_info["cam_intrinsic"] = np.asarray(
                    cam_cs["camera_intrinsic"], np.float64)
                chain.append(cam_info)
                rec = nusc.get("sample_data", rec["prev"])
            info["cam_sweeps_info"][cam] = chain

        if not test:
            ann_tokens = nusc.ann_tokens(sample["token"])
            anns = [nusc.get("sample_annotation", t) for t in ann_tokens]
            locs, dims, rots, names, vels = [], [], [], [], []
            for t, a in zip(ann_tokens, anns):
                ctr, wlh, yaw = nusc.box_in_sensor_frame(a, lidar_token)
                locs.append(ctr)
                dims.append(wlh)
                rots.append(yaw)
                names.append(NAME_MAPPING.get(nusc.category_name(a),
                                              nusc.category_name(a)))
                velo = nusc.box_velocity(t)
                # global -> lidar frame (:270-273)
                velo = velo @ np.linalg.inv(e2g_r_mat).T \
                    @ np.linalg.inv(l2e_r_mat).T
                vels.append(velo[:2])
            locs = np.asarray(locs, np.float64).reshape(-1, 3)
            dims = np.asarray(dims, np.float64).reshape(-1, 3)
            rots = np.asarray(rots, np.float64).reshape(-1, 1)
            # mmdet3d >=1.0 convention: sizes reordered wlh -> (l, w, h)
            info["gt_boxes"] = np.concatenate(
                [locs, dims[:, [1, 0, 2]], rots], axis=1)
            info["gt_names"] = np.asarray(names)
            info["gt_velocity"] = np.asarray(
                vels, np.float64).reshape(-1, 2)
            # GT attribute names for devkit-free AAE scoring (the devkit
            # reads these from the DB at eval time; recording them here
            # keeps the metric computable without the devkit)
            info["gt_attrs"] = np.asarray(
                [nusc.attribute_name(a) for a in anns])
            info["num_lidar_pts"] = np.asarray(
                [a["num_lidar_pts"] for a in anns])
            info["num_radar_pts"] = np.asarray(
                [a["num_radar_pts"] for a in anns])
            info["valid_flag"] = np.asarray(
                [(a["num_lidar_pts"] + a["num_radar_pts"]) > 0
                 for a in anns], bool)

        (train_infos if in_train else val_infos).append(info)
    return train_infos, val_infos


# official trainval split is keyed by scene name; without the devkit's
# splits module the caller passes explicit name lists (files or "all")
def create_nuscenes_infos(root, version="v1.0-trainval", out_dir=None,
                          max_sweeps=10, train_scene_file=None,
                          val_scene_file=None):
    out_dir = out_dir or root
    nusc = NuScenesTables(root, version)
    names = sorted({s["name"] for s in nusc.rows("scene")})
    if train_scene_file:
        with open(train_scene_file) as f:
            train_scenes = {l.strip() for l in f if l.strip()}
    else:
        train_scenes = set(names)
    if val_scene_file:
        with open(val_scene_file) as f:
            val_scenes = {l.strip() for l in f if l.strip()}
        train_scenes -= val_scenes
    else:
        val_scenes = set()
    test = "test" in version
    train, val = fill_trainval_infos(nusc, train_scenes, val_scenes,
                                     test=test, max_sweeps=max_sweeps)
    meta = {"version": version}
    tag = "test" if test else "train"
    out_train = os.path.join(out_dir, f"nuscenes_infos_{tag}.pkl")
    with open(out_train, "wb") as f:
        pickle.dump({"infos": train, "metadata": meta}, f)
    print(f"wrote {len(train)} infos -> {out_train}")
    if not test:
        out_val = os.path.join(out_dir, "nuscenes_infos_val.pkl")
        with open(out_val, "wb") as f:
            pickle.dump({"infos": val, "metadata": meta}, f)
        print(f"wrote {len(val)} infos -> {out_val}")
    return out_train
