"""The port's KITTI slice (``uni3detr_kitti_car``,
``uni3detr_kitti_3classes``) and its evaluation against the JAX package,
on the CPU. Inputs are made with numpy and fed to both.

- Box merging (``eval.box_merging.merge_boxes_3d``) on clustered boxes of
  three classes with tied scores, on one box and on none: the same kept
  indices and labels, scores equal, boxes within 1e-6 (medians of the
  same fp32 values; the IoU of each pair in fp32, ~1e-7 apart).
- ``train.coder.post_process`` with ``box_merging`` and ``none`` (and
  ``nms``), a scalar and a per-class ``score_thr``, and the per-scene
  ``eval.postprocess`` against the JAX evaluator's
  ``_postprocess_sample``: masks, labels and scores equal, boxes within
  1e-6.
- ``geom.iou.iou_bev_rotated`` and the two-set 3D and BEV IoU (N1's
  forms, their plain versions here) against JAX within 1e-6 (one pair's
  clip in fp32; the values are O(1)).
- ``eval.kitti_eval`` against JAX's on the fixtures of
  ``tests/test_eval_extras.py`` and on random scenes with names,
  DontCare rows, 2D boxes and alpha, at AP11 and AP40; ``eval.indoor_eval``
  against JAX's: every key equal within 1e-6.
- A tiny KITTI-like model (``uni3detr_tiny_synthetic`` with 9 decoder
  layers, ``coder_alpha`` 0.2, box merging and budget caps) on uniform
  scenes where the first strided site set is cut at its cap: voxels,
  site sets and FPS equal, the three output stacks within 1e-5 in fp32,
  decoding and the merged boxes as above.
- One tiny train step with one-to-many matching (``gt_repeattimes=5``,
  ``max_gt=3``; 3 decoder layers, since JAX's compile of the step grows
  with the layers) against JAX: losses within rtol 1e-4 and gradients
  within 1e-3 of each leaf's largest entry, the tolerances of ``tests/test_torch_port_train.py``; the auction at
  ``matcher_phases=3`` (eps = spread / 512) on 5 identical copies of each
  GT column: the port's assignment equal to the Pallas kernel's (interpret
  mode), rounds of the plain version counted.
"""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import uni3detr_tpu.presets as jpresets
from uni3detr_tpu.data.eval import kitti_eval as jkitti
from uni3detr_tpu.data.eval.box_merging import merge_boxes_3d as j_merge
from uni3detr_tpu.data.eval.indoor_eval import indoor_eval as j_indoor
from uni3detr_tpu.geom.iou import iou3d_rotated as j_iou3d
from uni3detr_tpu.geom.iou import iou_bev_rotated as j_iou_bev
from uni3detr_tpu.models.detector import Uni3DETR as JModel
from uni3detr_tpu.ops import matching as jm
from uni3detr_tpu.ops.fps import farthest_point_sample_xla
from uni3detr_tpu.ops.sparse_conv import downsample_sites as j_downsample
from uni3detr_tpu.ops.voxelize import hard_voxelize as j_voxelize
from uni3detr_tpu.train import coder as jcoder
from uni3detr_tpu.train import step as jstep
from uni3detr_tpu.train.evaluator import _postprocess_sample as j_post_sample
from uni3detr_tpu.train.torch_import import import_torch_state_dict
from uni3detr_tpu_torch import presets as tpresets
from uni3detr_tpu_torch.eval import box_merging, indoor_eval, kitti_eval
from uni3detr_tpu_torch.eval import postprocess
from uni3detr_tpu_torch.geom import iou as tiou
from uni3detr_tpu_torch.models.detector import Uni3DETR as TModel
from uni3detr_tpu_torch.ops import matching as tm
from uni3detr_tpu_torch.synthetic import (clustered_scene,
                                          clustered_train_batch)
from uni3detr_tpu_torch.train import coder as tcoder
from uni3detr_tpu_torch.train import step as tstep
from uni3detr_tpu_torch.weights import state_dict_from_jax
from nms_cases import (KITTI_CLASSES as CLASSES, clustered_boxes,
                       degenerate_pairs, indoor_scenes, random_kitti_scenes)
from test_eval_extras import _dc_fixture, _rep41
from test_torch_import import make_state_dict

BOX_ATOL = 1e-6      # merged / post-processed boxes, fp32
IOU_ATOL = 1e-6      # one pair's clip in fp32
AP_ATOL = 1e-6       # metric dicts
FWD_ATOL = 1e-5      # tiny 9-layer forward, fp32
MERGE_THR = 0.1      # the reference's overlap threshold of box merging


def _t(x):
    return torch.from_numpy(np.array(x))


# -- box merging -------------------------------------------------------------

def _merge_input(kind):
    """(labels, boxes, scores) numpy: three classes, tied scores, chains
    of boxes at IoU ~ MERGE_THR and clusters of jittered copies."""
    if kind == "none":
        return (np.zeros(0, np.int32), np.zeros((0, 7), np.float32),
                np.zeros(0, np.float32))
    boxes, scores, labels, valid = clustered_boxes(11, n=160, ncls=3,
                                                   thr=MERGE_THR)
    if kind == "one":
        return labels[:1], boxes[:1], scores[:1]
    return labels[valid], boxes[valid], scores[valid]


@pytest.mark.parametrize("iou_given", [False, True])
@pytest.mark.parametrize("kind", ["clustered", "one", "none"])
def test_merge_boxes_3d_matches_jax(kind, iou_given):
    labels, boxes, scores = _merge_input(kind)
    jl, jb, js, jidx = j_merge(labels, boxes, scores)
    iou = (tiou.iou3d_rotated(_t(boxes), _t(boxes), "bottom").numpy()
           if iou_given else None)
    tl, tb, ts, tidx = box_merging.merge_boxes_3d(labels, boxes, scores,
                                                  iou=iou, device="cpu")
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=BOX_ATOL)
    if kind == "clustered":          # ties, merges and survivors
        assert len(np.unique(scores)) < len(scores)
        assert 10 < len(tidx) < len(scores) - 20


# -- post-processing ---------------------------------------------------------

THRS = {"scalar": 0.5, "per-class": (0.0, 0.3, 0.65)}


def _kitti3(pkg, mode, thr):
    return dataclasses.replace(pkg.KITTI_3CLASSES, post_processing=mode,
                               score_thr=THRS[thr], max_num=160)


def _decoded(seed, B=2):
    """Gravity-centred decoded outputs (B, 160, ...) of three classes."""
    parts = [clustered_boxes(seed * 7 + b, n=160, ncls=3, thr=MERGE_THR)
             for b in range(B)]
    boxes, scores, labels, valid = (np.stack(a) for a in zip(*parts))
    scores = (0.3 + 0.7 * scores).astype(np.float32)
    return boxes, scores, labels, valid


def _jax_post(boxes, scores, labels, valid, cfg):
    return tuple(np.asarray(a) for a in jcoder.post_process(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
        jnp.asarray(valid), cfg))


@pytest.mark.parametrize("thr", sorted(THRS))
@pytest.mark.parametrize("mode", ["box_merging", "none", "nms"])
def test_post_process_matches_jax(mode, thr):
    inputs = _decoded(1)
    jb, js, jl, jv = _jax_post(*inputs, _kitti3(jpresets, mode, thr))
    tb, ts, tl, tv = tcoder.post_process(*map(_t, inputs),
                                         _kitti3(tpresets, mode, thr))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=BOX_ATOL)
    assert 0 < jv.sum() < inputs[3].sum()


@pytest.mark.parametrize("thr", sorted(THRS))
@pytest.mark.parametrize("mode", ["box_merging", "none", "nms"])
def test_postprocess_sample_matches_jax(mode, thr):
    """Each scene's dict of valid rows through the JAX evaluator's
    ``_postprocess_sample`` and the port's ``postprocess_sample``; and the
    whole batch through ``postprocess_batch`` (one split, the IoU of all
    scenes at once)."""
    jcfg, tcfg = _kitti3(jpresets, mode, thr), _kitti3(tpresets, mode, thr)
    jb, js, jl, jv = _jax_post(*_decoded(2), jcfg)
    want = [j_post_sample({"boxes": jb[b][jv[b]], "scores": js[b][jv[b]],
                           "labels": jl[b][jv[b]]}, jcfg)
            for b in range(jb.shape[0])]
    one = [postprocess.postprocess_sample(
        {"boxes": jb[b][jv[b]], "scores": js[b][jv[b]],
         "labels": jl[b][jv[b]]}, tcfg, device="cpu")
        for b in range(jb.shape[0])]
    batch = postprocess.postprocess_batch(*map(_t, (jb, js, jl, jv)), tcfg)
    for got_list in (one, batch):
        for got, ref in zip(got_list, want):
            assert sorted(got) == sorted(ref)
            np.testing.assert_array_equal(got["labels"], ref["labels"])
            np.testing.assert_array_equal(got["scores"], ref["scores"])
            np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0,
                                       atol=BOX_ATOL)
    n_in = [int(v.sum()) for v in jv]
    n_out = [len(r["scores"]) for r in want]
    assert sum(n_out) > 0
    if mode == "box_merging":
        assert all(o < i for o, i in zip(n_out, n_in))


def test_split_batch_valid_rows_and_ious():
    """``split_batch``: each scene's valid rows, as the JAX evaluator
    slices them, and with ``with_iou`` their plain IoU matrix."""
    boxes, scores, labels, valid = _decoded(3, B=3)
    dets = postprocess.split_batch(*map(_t, (boxes, scores, labels, valid)),
                                   with_iou=True)
    for b, d in enumerate(dets):
        v = valid[b]
        np.testing.assert_array_equal(d["boxes"], boxes[b][v])
        np.testing.assert_array_equal(d["scores"], scores[b][v])
        np.testing.assert_array_equal(d["labels"], labels[b][v])
        ref = tiou.iou3d_rotated(_t(boxes[b][v]), _t(boxes[b][v]), "bottom")
        np.testing.assert_array_equal(d["iou"], ref.numpy())


# -- rotated IoU: BEV and two sets -------------------------------------------

def _iou_sets(kind):
    """Two box sets (M, 7), (N, 7) numpy, M != N."""
    if kind == "degenerate":
        pairs = degenerate_pairs()
        return (np.stack([a for a, _ in pairs]),
                np.stack([b for _, b in pairs[:-3]]))
    a = clustered_boxes(21, n=70, ncls=3)[0]
    b = clustered_boxes(22, n=33, ncls=3)[0]
    return a, np.concatenate([b, a[:5]])


@pytest.mark.parametrize("kind", ["clustered", "degenerate"])
def test_iou_bev_and_two_set_iou_match_jax(kind):
    a, b = _iou_sets(kind)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a)[None], _t(b)[None]
    got = tiou.iou_bev_rotated_sets(ta, tb)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(j_iou_bev(ja, jb)), rtol=0,
                               atol=IOU_ATOL)
    # 5-dim (x, y, dx, dy, yaw) boxes
    a5, b5 = (np.concatenate([x[:, 0:2], x[:, 3:5], x[:, 6:7]], -1)
              for x in (a, b))
    np.testing.assert_allclose(
        tiou.iou_bev_rotated(_t(a5), _t(b5)).numpy(),
        np.asarray(j_iou_bev(jnp.asarray(a5), jnp.asarray(b5))), rtol=0,
        atol=IOU_ATOL)
    for z in ("bottom", "center"):
        got = tiou.iou3d_rotated_sets(ta, tb, z)[0].numpy()
        np.testing.assert_allclose(
            got, np.asarray(j_iou3d(ja, jb, z_origin=z)), rtol=0,
            atol=IOU_ATOL)
    assert got.shape == (len(a), len(b)) and (got > 0.3).sum() >= 5


# -- KITTI and indoor metrics ------------------------------------------------

def _kitti_fixture(name):
    car = np.array([5, 0, -1, 4, 2, 1.5, 0.3], np.float32)
    gt1 = {"boxes": car[None], "labels": np.array([0])}
    det1 = {"boxes": car[None].copy(), "labels": np.array([0]),
            "scores": np.array([0.9], np.float32)}
    if name == "perfect":
        return _rep41(gt1, det1)
    if name == "one":
        return [gt1], [det1]
    if name == "miss":
        miss = dict(det1, boxes=car[None] + [45, 0, 0, 0, 0, 0, 0])
        return _rep41(gt1, miss)
    if name.startswith("dontcare"):
        return _rep41(*_dc_fixture(with_dc=name != "dontcare-absent",
                                   stray_in_dc=name != "dontcare-outside"))
    if name == "van":
        van = np.array([20, 10, -1, 5, 2.2, 2.0, 0.0], np.float32)
        gt = {"boxes": np.stack([car, van]),
              "names": np.array(["Car", "Van"], dtype=object),
              "labels": np.array([0, -1])}
        det = {"boxes": np.stack([car, van]), "labels": np.array([0, 0]),
               "scores": np.array([0.9, 0.8995], np.float32)}
        return _rep41(gt, det)
    return random_kitti_scenes(int(name.split("-")[1]))


def _assert_metrics_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, dict):
            _assert_metrics_equal(g, r)
        elif np.isnan(r):
            assert np.isnan(g), k
        else:
            assert abs(g - r) <= AP_ATOL, (k, g, r)


def _j_second_pass_all_no_raise(ov, scores, *a, **k):
    """The JAX package's ``_second_pass_all``, which raises on a scene
    without a detection of the class (an argmax over no detection) where
    its scalar ``_second_pass`` counts no TP and no FP: that count, as the
    port's gives it."""
    if len(scores) == 0:
        T = len(a[2])
        return np.zeros(T, np.int64), np.zeros(T, np.int64), np.zeros(T)
    return _J_SECOND_PASS_ALL(ov, scores, *a, **k)


_J_SECOND_PASS_ALL = jkitti._second_pass_all


@pytest.mark.parametrize("n_points", [11, 40])
@pytest.mark.parametrize("fixture", ["perfect", "one", "miss", "dontcare",
                                     "dontcare-absent", "dontcare-outside",
                                     "van", "random-0", "random-1"])
def test_kitti_eval_matches_jax(fixture, n_points):
    gts, dets = _kitti_fixture(fixture)
    classes = list(CLASSES) if fixture.startswith("random") else ["Car"]
    with mock.patch.object(jkitti, "_second_pass_all",
                           _j_second_pass_all_no_raise):
        ref = jkitti.kitti_eval(gts, dets, classes, n_points=n_points)
    got = kitti_eval.kitti_eval(gts, dets, classes, n_points=n_points,
                                device="cpu")
    _assert_metrics_equal(got, ref)
    if fixture.startswith("random"):
        assert any(k.endswith("_aos_hard") for k in ref)
        assert 0 < max(v for v in ref.values() if not np.isnan(v)) < 100


def test_second_pass_all_without_detections():
    """A scene with GTs of the class but no detection of it: the port's
    all-thresholds pass counts what the JAX package's scalar pass counts
    at each threshold (no TP, no FP), where JAX's vectorized pass
    raises (ROADMAP Queue 3)."""
    ov = np.zeros((0, 3), np.float32)
    args = (np.zeros(0, np.float32), np.zeros(0, np.int32),
            np.array([0, 1, 0], np.int32))
    with pytest.raises(ValueError):
        _J_SECOND_PASS_ALL(ov, *args, np.array([0.5, 0.2]), 0.7)
    tp, fp, sim = kitti_eval._second_pass_all(ov, *args,
                                              np.array([0.5, 0.2]), 0.7)
    for i, thr in enumerate((0.5, 0.2)):
        assert (tp[i], fp[i], sim[i]) == jkitti._second_pass(ov, *args, thr,
                                                             0.7)


def test_kitti_projection_and_alpha_match_jax():
    """``project_boxes_to_image`` (with its own ``corners_3d``),
    ``lidar_alpha`` and ``kitti_gt_from_info`` against JAX's."""
    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.uniform([-5, -10, -2], [40, 10, 0], (9, 3)),
                            rng.uniform(1, 4, (9, 3)),
                            rng.uniform(-3, 3, (9, 1))], 1)
    Tr = np.eye(4)[[1, 2, 0, 3]] * [[-1], [-1], [1], [1]]
    P2 = np.concatenate([np.array([[700, 0, 600], [0, 700, 180],
                                   [0, 0, 1.0]]), np.zeros((3, 1))], 1)
    calib = {"P2": P2, "R0_rect": np.eye(4), "Tr_velo_to_cam": Tr}
    for fn, args in ((jkitti.project_boxes_to_image, (calib, (375, 1242))),
                     (jkitti.lidar_alpha, (calib,))):
        got = getattr(kitti_eval, fn.__name__)(boxes, *args)
        np.testing.assert_array_equal(got, fn(boxes, *args))
    info = {"annos": {"name": ["Car", "Van", "DontCare", "Tram"],
                      "gt_boxes_lidar": boxes[:4],
                      "bbox": rng.rand(4, 4), "occluded": [0, 1, 2, 0]}}
    got = kitti_eval.kitti_gt_from_info(info, CLASSES)
    ref = jkitti.kitti_gt_from_info(info, CLASSES)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("seen", [False, True])
def test_indoor_eval_matches_jax(seen):
    classes = [f"c{i}" for i in range(10)]
    gts, dets = indoor_scenes(5 + seen)
    kw = {"seen_classes": classes[:6]} if seen else {}
    ref = j_indoor(gts, dets, classes, **kw)
    got = indoor_eval.indoor_eval(gts, dets, classes, device="cpu", **kw)
    _assert_metrics_equal(got, ref)
    assert 0 < ref["mAP_0.25"] < 1


# -- a tiny KITTI-like model -------------------------------------------------

def _kitti_tiny(pkg, **kw):
    """``uni3detr_tiny_synthetic`` with KITTI's 9 layers, coder alpha and
    box merging, and budgets whose cap cuts the first strided site set
    of a uniform scene (954 voxels, ~700 stride-2 sites, cap 512)."""
    fields = dict(num_decoder_layers=9, coder_alpha=0.2,
                  post_processing="box_merging", score_thr=None,
                  num_points=1024, max_voxels_test=1024,
                  encoder_budget_shrink=(2.0, 1.4, 0.6),
                  encoder_budget_caps=(512, 256, 256))
    return dataclasses.replace(pkg.TINY_SYNTHETIC, **{**fields, **kw})


JCFG = _kitti_tiny(jpresets)
TCFG = _kitti_tiny(tpresets)


@pytest.fixture(scope="module")
def kitti_runs():
    v = import_torch_state_dict(
        make_state_dict(JCFG, np.random.RandomState(4)), JCFG)
    model = TModel(TCFG).eval()
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, JCFG).items()},
                          strict=True)
    japply = jax.jit(functools.partial(JModel(JCFG).apply, train=False))
    out = []
    for seed in (0, 1):
        pts, rnd = clustered_scene(seed, TCFG, "uniform")
        mask = np.ones(pts.shape[:2], bool)
        jout = japply(v, jnp.asarray(pts), jnp.asarray(mask),
                      random_points=jnp.asarray(rnd))
        with torch.no_grad():
            tout, inter = model(_t(pts), _t(mask), _t(rnd),
                                return_intermediates=True)
            sets = model.pts_middle_encoder.site_sets(inter["coords"],
                                                      inter["vmask"])
        out.append(((pts, mask), jout, tout, inter, sets))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_kitti_voxels_sites_and_fps_match_jax(kitti_runs, seed):
    (pts, mask), _, _, inter, sets = kitti_runs[seed]
    feats, coords, vmask = j_voxelize(
        jnp.asarray(pts), jnp.asarray(mask), pc_range=JCFG.pc_range,
        voxel_size=JCFG.voxel_size, grid_size=JCFG.grid_size,
        max_points=JCFG.max_points_per_voxel,
        max_voxels=JCFG.max_voxels_test)
    np.testing.assert_array_equal(inter["vmask"].numpy(), np.asarray(vmask))
    np.testing.assert_array_equal(inter["coords"].numpy(), np.asarray(coords))
    # the JAX encoder's site sets (models/sparse_encoder.py:219-228)
    c, m, grid = coords[0], vmask[0], JCFG.grid_size
    V = coords.shape[1]
    for i, pad in enumerate(JCFG.encoder_downsample_paddings):
        budget = -(-int(V * JCFG.encoder_budget_shrink[i]) // 8) * 8
        budget = max(min(budget, JCFG.encoder_budget_caps[i]), 256)
        c, m, grid = j_downsample(c, m, grid, pad, budget)
        s = sets[i + 1]
        assert s["n_sites"] == budget
        np.testing.assert_array_equal(s["mask"][0].numpy(), np.asarray(m))
        np.testing.assert_array_equal(s["coords"][0].numpy(), np.asarray(c))
    # the cap cut the first strided set
    assert int(sets[1]["mask"].sum()) == JCFG.encoder_budget_caps[0]
    vc = jnp.where(vmask[..., None], coords[..., ::-1].astype(jnp.float32),
                   0.0)
    for got, (x, mk) in zip(inter["fps_idx"],
                            ((jnp.asarray(pts[..., :3]), jnp.asarray(mask)),
                             (vc, vmask))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            farthest_point_sample_xla(x, mk, JCFG.num_query)))


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_kitti_forward_and_merge_match_jax(kitti_runs, seed):
    _, jout, tout, _, _ = kitti_runs[seed]
    for k in ("all_cls_scores", "all_bbox_preds", "all_iou_preds"):
        assert tout[k].shape == jout[k].shape and tout[k].shape[0] == 9
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=FWD_ATOL, err_msg=k)
    jdec = [np.asarray(a) for a in jcoder.decode_predictions(jout, JCFG)]
    tdec = tcoder.decode_predictions(tout, TCFG)
    np.testing.assert_array_equal(tdec[2].numpy(), jdec[2])
    np.testing.assert_array_equal(tdec[3].numpy(), jdec[3])
    np.testing.assert_allclose(tdec[0].numpy(), jdec[0], rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(tdec[1].numpy(), jdec[1], rtol=0,
                               atol=FWD_ATOL)
    jb, js, jl, jv = (np.asarray(a) for a in jcoder.post_process(
        *map(jnp.asarray, jdec), JCFG))
    want = j_post_sample({"boxes": jb[0][jv[0]], "scores": js[0][jv[0]],
                          "labels": jl[0][jv[0]]}, JCFG)
    got = postprocess.postprocess_batch(*tcoder.post_process(*tdec, TCFG),
                                        TCFG)[0]
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=FWD_ATOL)
    assert 0 < len(want["scores"]) < int(jv.sum())


# -- one-to-many training ----------------------------------------------------

@pytest.fixture(scope="module")
def kitti_steps():
    kw = dict(dropout=0.0, matcher="scipy", gt_repeattimes=5,
              matcher_phases=3, max_gt=3, num_decoder_layers=3)
    cfg, tcfg = _kitti_tiny(jpresets, **kw), _kitti_tiny(tpresets, **kw)
    v = import_torch_state_dict(
        make_state_dict(cfg, np.random.RandomState(9)), cfg)
    batch = clustered_train_batch(5, tcfg, 2, "uniform")
    lr = 1e-4
    tx = jstep.make_optimizer(lr)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                             params=v["params"],
                             batch_stats=v["batch_stats"],
                             opt_state=tx.init(v["params"]), tx=tx)
    state, jlogs = jstep.make_train_step(cfg, donate=False)(
        state, {k: jnp.asarray(a) for k, a in batch.items()},
        jax.random.PRNGKey(0))
    model = TModel(tcfg)
    model.load_state_dict({k: torch.from_numpy(a) for k, a in
                           state_dict_from_jax(v, cfg).items()}, strict=True)
    opt = tstep.make_optimizer(model, lr)
    tlogs = tstep.train_step(model, opt, {k: _t(a) for k, a in
                                          batch.items()})
    return cfg, state, jlogs, model, opt, tlogs


def test_tiny_kitti_train_step_losses_match_jax(kitti_steps):
    _, _, jlogs, _, _, tlogs = kitti_steps
    assert sorted(tlogs) == sorted(jlogs)
    # d0., d1. and the last layer's unprefixed terms
    assert sum(k.startswith("d1.") for k in jlogs) > 0
    for k in jlogs:
        np.testing.assert_allclose(np.asarray(tlogs[k]),
                                   np.asarray(jlogs[k]), rtol=1e-4, atol=0,
                                   err_msg=k)


def test_tiny_kitti_train_step_grads_match_jax(kitti_steps):
    cfg, state, _, model, opt, _ = kitti_steps
    sd = model.state_dict()
    for name, p in model.named_parameters():
        sd[name] = opt.adamw.state[p]["exp_avg"]
    tmu = import_torch_state_dict(sd, cfg)["params"]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tmu)[0])
    flat_j = jax.tree_util.tree_flatten_with_path(state.opt_state[1][0].mu)[0]
    assert len(flat_t) == len(flat_j)
    for path, ref in flat_j:
        ref, got = np.asarray(ref), np.asarray(flat_t[path])
        tol = 1e-3 * max(np.abs(ref).max(), 1e-5)
        assert np.abs(got - ref).max() <= tol, jax.tree_util.keystr(path)


def test_one_to_many_auction_matches_pallas():
    """eps = spread / 8**3 on 5 identical copies of each GT column: the
    port's instances (``auction_problem``) and plain auction give the
    Pallas kernel's assignment (interpret mode), bidder for bidder."""
    rng = np.random.RandomState(12)
    B, groups, nq, Gt, rep = 1, 3, 40, 6, 5
    cost = rng.randn(B, groups * nq, Gt).astype(np.float32)
    valid = np.ones((B, Gt), bool)
    valid[0, -1] = False
    benefit, spread, eps_div = tm.auction_problem(_t(cost), _t(valid), nq,
                                                  rep, 3)
    assert eps_div == 512.0
    rows, counts = tm.auction_lap_plain(benefit, spread, eps_div,
                                        return_counts=True)
    grouped = jnp.tile(jnp.where(jnp.asarray(valid)[0][None], cost[0], 0.0),
                       (1, rep)).reshape(groups, nq, Gt * rep)
    real = jnp.asarray(valid[0])[jnp.arange(Gt * rep) % Gt]
    ref = np.asarray(jm._match_groups_pallas(grouped, real, interpret=True,
                                             n_phases=3))
    np.testing.assert_array_equal(rows[:, :Gt * rep].numpy(), ref)
    assert (ref >= 0).all() and int(counts[:, 0].max()) > 1


def test_kitti_step_schedule_matches_optax():
    """KITTI's mmcv step policy (milestones at epochs 32 and 38,
    uni3detr_kitti_car.py) with 40 epochs compressed into 16 steps."""
    lr = 2e-5 * 3 / 8 * 18 / 2
    j = jstep.step_lr_schedule(lr, 0.4, [32, 38])
    t = tstep.step_lr_schedule(lr, 0.4, [32, 38])
    vals = [t(s) for s in range(16)]
    for s, got in enumerate(vals):
        np.testing.assert_allclose(got, float(j(s)), rtol=1e-6)
    assert len(set(np.round(vals, 12))) == 3


def test_uniform_kitti_scene_reaches_every_cap():
    """A uniform KITTI scene (18000 near-isolated voxels) at the preset's
    eval budgets: every strided site set is cut at its cap, as the JAX
    preset's comment measures on real sweeps (presets.py:75-84); a
    clustered one stays below."""
    cfg = tpresets.KITTI_CAR
    model = TModel(cfg).eval()
    for dist, cut in (("uniform", True), ("clustered", False)):
        pts = _t(clustered_scene(0, cfg, dist)[0])
        _, coords, vmask = model.voxelize(pts, torch.ones(pts.shape[:2],
                                                          dtype=torch.bool))
        sets = model.pts_middle_encoder.site_sets(coords, vmask)
        n = [int(s["mask"].sum()) for s in sets[1:]]
        assert [s["n_sites"] for s in sets[1:]] == \
            list(cfg.encoder_budget_caps)
        assert (n == list(cfg.encoder_budget_caps)) == cut, n
